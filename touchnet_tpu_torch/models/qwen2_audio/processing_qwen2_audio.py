# Copyright (c) 2026 touchnet_tpu authors.
# Qwen2-Audio prompts, whisper features and the SFT data pipeline.
#
# Port of touchnet_tpu/models/qwen2_audio/processing_qwen2_audio.py:
# QWEN2_AUDIO_TEMPLATE_FOR_S2T (:26), whisper_features (:32),
# ManualQwen2AudioFrontend (:56), HFQwen2AudioFrontend (:83),
# count_audio_spans (:120), dynamic_batch (:127), _pad_stack (:226) and
# qwen2_audio_datapipe (:235). numpy only.
#
# whisper_features has WhisperFeatureExtractor's semantics: the waveform is
# resampled to 16 kHz, padded with zeros to at least 30 s, and turned into
# a whisper log-mel [frames, n_mels] (3000 frames for 30 s); the frame mask
# covers the audio's own frames, or every frame past 30 s (the reference's
# workaround for long audio: the tower then reads the whole padded input).
#
# dynamic_batch turns (audio, instruct, response) samples into right-padded
# rows under a token budget (dataset_batchsize x dataset_text_seqlen): the
# template with <|AUDIO|> repeated once per pooled audio frame, then the
# response; labels shifted by one with the prompt masked (-100) and eos
# supervised; attention_mask 1 on tokens, 0 on padding; every row's whisper
# features padded to 30 s, so each row costs the tower 1500 frames whatever
# its length. A batch is emitted when the next sample would overflow the
# budget; that sample opens the next batch (the root datapipe counts it only
# when the next one is pulled, so a checkpoint taken at the emit resumes
# with it).
#
# Two faults of the JAX batcher are not copied:
#   - with a tokenizer that splits <|AUDIO|> into several ids the JAX
#     batcher switches its span checks off without a word (:133-134, the
#     merge then misplaces the audio); qwen2_audio_datapipe raises at setup
#     unless <|AUDIO|> is exactly the one id audio_token_index
#     (check_audio_token), and dynamic_batch always checks the spans;
#   - a sample whose ids hold more than one <|AUDIO|> span (the instruct or
#     the response text holding the token) raises in the JAX batcher and
#     ends the run (:190-197); here it is logged with its key and skipped,
#     as the zero-span sample is in both packages (the model's cumsum merge
#     takes exactly one span a row).

import numpy as np

from touchnet_tpu_torch.data import DataConfig, dsp
from touchnet_tpu_torch.data.datapipe import LowLevelTouchDatapipe, MidLevelTouchDatapipe
from touchnet_tpu_torch.utils.logging import logger

QWEN2_AUDIO_TEMPLATE_FOR_S2T = "<|audio_bos|><|AUDIO|><|audio_eos|><|INSTRUCT|>"
DEFAULT_INSTRUCT = "Generate the transcription:"
IGNORE_ID = -100
_WHISPER_SR = 16000
_WHISPER_MAX_FRAMES = 3000  # 30 s @ 10 ms hop


def whisper_features(waveform: np.ndarray, sample_rate: int, n_mels: int = 128) -> tuple:
    """(features [T_frames, n_mels] f32, frame mask [T_frames] int32) of one
    waveform, padded to >= 30 s."""
    wav = np.asarray(waveform, dtype=np.float32).reshape(-1)
    if sample_rate != _WHISPER_SR:
        wav = dsp.resample(wav, sample_rate, _WHISPER_SR)
    n_samples = wav.shape[0]
    n_frames = n_samples // 160
    pad_to = max(_WHISPER_MAX_FRAMES * 160, n_frames * 160)
    if n_samples < pad_to:
        wav = np.concatenate([wav, np.zeros(pad_to - n_samples, np.float32)])
    feats = dsp.log_mel_spectrogram(wav, _WHISPER_SR, n_fft=400, hop_length=160,
                                    n_mels=n_mels)
    mask = np.zeros(feats.shape[0], np.int32)
    # the reference's >30 s workaround: an all-ones mask for long audio
    if feats.shape[0] > _WHISPER_MAX_FRAMES:
        mask[:] = 1
    else:
        mask[: max(n_frames, 1)] = 1
    return feats, mask


class ManualQwen2AudioFrontend:
    """The offline frontend (no --processor_model, the recipe's route): the
    run's tokenizer and whisper_features. The tokenizer must know the audio
    special tokens."""

    def __init__(self, tokenizer, n_mels: int = 128, audio_token: str = "<|AUDIO|>",
                 audio_bos: str = "<|audio_bos|>", audio_eos: str = "<|audio_eos|>"):
        self.tokenizer = tokenizer
        self.n_mels = n_mels
        self.audio_token = audio_token
        self.audio_bos = audio_bos
        self.audio_eos = audio_eos

    def extract(self, waveform, sample_rate):
        return whisper_features(waveform, sample_rate, self.n_mels)

    def tokenize(self, text: str):
        return self.tokenizer.tokenize(text, add_special_tokens=False)

    @property
    def pad_id(self):
        return self.tokenizer.pad if self.tokenizer.pad is not None else 0

    @property
    def eos_id(self):
        return self.tokenizer.eos


class HFQwen2AudioFrontend:
    """An HF Qwen2AudioProcessor (--processor_model): its feature extractor
    without truncation, padded to 30 s, and its tokenizer. The JAX frontend
    hands the waveform over as if it were at the extractor's rate; here a
    waveform at another rate is resampled to it first."""

    def __init__(self, processor):
        self.processor = processor
        self.audio_token = "<|AUDIO|>"
        self.audio_bos = "<|audio_bos|>"
        self.audio_eos = "<|audio_eos|>"

    def extract(self, waveform, sample_rate):
        fe = self.processor.feature_extractor
        wav = np.asarray(waveform, dtype=np.float32).reshape(-1)
        if sample_rate != fe.sampling_rate:
            wav = dsp.resample(wav, sample_rate, fe.sampling_rate)
        out = fe(wav, sampling_rate=fe.sampling_rate, truncation=False,
                 return_attention_mask=True, padding="max_length", return_tensors="np")
        feats = out["input_features"][0].T  # [T, mel]
        mask = out["attention_mask"][0]
        if feats.shape[0] > _WHISPER_MAX_FRAMES:
            mask = np.ones(feats.shape[0], mask.dtype)
        return feats, mask

    def tokenize(self, text: str):
        return self.processor.tokenizer(text, add_special_tokens=False).input_ids

    @property
    def pad_id(self):
        return self.processor.tokenizer.pad_token_id

    @property
    def eos_id(self):
        return self.processor.tokenizer.eos_token_id


def check_audio_token(frontend, audio_token_index: int) -> int:
    """Raise unless the frontend's tokenizer maps its audio token to exactly
    [audio_token_index] (the model config's); returns that id. The SFT
    datapipe and the ASR CLI check so at setup."""
    ids = list(frontend.tokenize(frontend.audio_token))
    if ids != [audio_token_index]:
        raise ValueError(f"the tokenizer maps {frontend.audio_token!r} to {ids[:8]}, not to the "
                         f"one id [{audio_token_index}] (the model config's audio_token_index): "
                         "the audio positions of its ids would not be found")
    return audio_token_index


def count_audio_spans(ids: np.ndarray, audio_id: int) -> int:
    """Number of contiguous runs of the audio placeholder token in a row."""
    m = np.asarray(ids) == audio_id
    starts = m & ~np.concatenate([[False], m[:-1]])
    return int(starts.sum())


def _pad_stack(arrs, pad_value, dtype=None):
    maxlen = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), maxlen) + arrs[0].shape[1:], pad_value, dtype or arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def dynamic_batch(data, config: DataConfig, frontend, audio_id: int):
    """Token-budget dynamic batching of (audio, instruct, response) samples
    (the JAX dynamic_batch). Skips a sample with no txt (nor response) or
    whose ids hold zero or more than one <|AUDIO|> span (``audio_id``,
    checked at setup), each logged with its key, and, as JAX, one whose
    audio is past audio_max_length_in_ms_for_filter or whose ids are outside
    the text length filters."""
    ids_buf, mask_buf, labels_buf, slens_buf = [], [], [], []
    feats_buf, feat_mask_buf = [], []
    longest = 0
    budget = config.dataset_batchsize * config.dataset_text_seqlen

    def emit():
        pad = frontend.pad_id
        return {
            "input_ids": _pad_stack(ids_buf, pad),
            "attention_mask": _pad_stack(mask_buf, 0),
            "labels": _pad_stack(labels_buf, IGNORE_ID),
            "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
            "input_features": _pad_stack(feats_buf, 0.0).transpose(0, 2, 1),  # [B, mel, T]
            "feature_attention_mask": _pad_stack(feat_mask_buf, 0),
            "num_sentence": len(ids_buf),
            "sentence_lens": _pad_stack(slens_buf, 1),
        }

    for sample in data:
        key = sample.get("key", "<unknown>")
        if "instruct" not in sample:
            sample["instruct"] = DEFAULT_INSTRUCT
        if "response" not in sample:
            if "txt" not in sample:
                logger.info(f"sample {key!r} has no txt, skip")
                continue
            sample["response"] = sample["txt"]

        feats, feat_mask = frontend.extract(sample["waveform"], sample["sample_rate"])
        audio_length = int(feat_mask.sum())
        if audio_length * 10 > config.audio_max_length_in_ms_for_filter:
            continue
        input_length = (audio_length - 1) // 2 + 1
        num_audio_tokens = (input_length - 2) // 2 + 1
        text = QWEN2_AUDIO_TEMPLATE_FOR_S2T.replace("<|INSTRUCT|>", sample["instruct"])
        expanded = text.replace(frontend.audio_token,
                                frontend.audio_token * int(num_audio_tokens), 1)
        prompt_ids = np.asarray(frontend.tokenize(expanded), np.int32)
        response_ids = np.asarray(frontend.tokenize(sample["response"]), np.int32)
        eos = np.asarray([frontend.eos_id], np.int32)
        input_ids = np.concatenate([prompt_ids, response_ids])
        # the model's merge gives row b's j-th audio position the row's j-th
        # pooled frame: one span a row, or the audio lands in the wrong place
        n_spans = count_audio_spans(input_ids, audio_id)
        if n_spans != 1:
            logger.info(f"sample {key!r} expands to {n_spans} {frontend.audio_token} spans "
                        f"({audio_length} mel frames); the merge takes exactly one, skip")
            continue
        labels = np.concatenate(
            [np.full(len(prompt_ids) - 1, IGNORE_ID, np.int32), response_ids, eos])
        slens = np.full_like(labels, len(response_ids) + 1)

        n = input_ids.shape[0]
        if n < config.text_min_length_in_tokens_for_filter:
            continue
        if n > config.text_max_length_in_tokens_for_filter:
            continue

        longest = max(longest, n)
        if longest * (len(ids_buf) + 1) > budget and ids_buf:
            yield emit()
            ids_buf, mask_buf, labels_buf, slens_buf = [], [], [], []
            feats_buf, feat_mask_buf = [], []
            longest = n
        ids_buf.append(input_ids)
        mask_buf.append(np.ones_like(labels))
        labels_buf.append(labels)
        slens_buf.append(slens)
        feats_buf.append(feats)
        feat_mask_buf.append(feat_mask)

    if (not config.dataloader_drop_last_batch) and ids_buf:
        yield emit()


def qwen2_audio_datapipe(
    data_config: DataConfig,
    tokenizer,
    dp_rank: int,
    dp_world_size: int,
    worker_id: int = 0,
    num_workers: int = 1,
    split: str = "train",
    *,
    audio_token_index: int,
):
    """LowLevelTouchDatapipe -> dynamic_batch. With processor_model set the
    HF processor is the frontend; otherwise the offline frontend wraps
    ``tokenizer``. Raises at setup unless the frontend maps <|AUDIO|> to
    [audio_token_index] (the model config's)."""
    if data_config.processor_model:
        import transformers

        processor = transformers.AutoProcessor.from_pretrained(
            data_config.processor_model, trust_remote_code=True)
        frontend = HFQwen2AudioFrontend(processor)
    else:
        frontend = ManualQwen2AudioFrontend(tokenizer, n_mels=data_config.audiofeat_num_mel_bins)
    audio_id = check_audio_token(frontend, audio_token_index)
    datapipe = LowLevelTouchDatapipe(data_config, dp_rank, dp_world_size, worker_id,
                                     num_workers, split)
    return MidLevelTouchDatapipe(datapipe, dynamic_batch, data_config, frontend, audio_id)
