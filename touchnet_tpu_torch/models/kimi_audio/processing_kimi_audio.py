# Copyright (c) 2026 touchnet_tpu authors.
# Kimi-Audio's speech-to-text prompts and its SFT data pipeline.
#
# Port of touchnet_tpu/models/kimi_audio/processing_kimi_audio.py: the two
# parallel templates (:27-36), dynamic_batch (:40) and kimi_audio_datapipe
# (:156). numpy only.
#
# The text stream holds the instruct and one <|im_kimia_text_blank|> per
# audio token; the audio stream holds a blank per instruct token and the
# audio tokens between <|im_media_begin|> and <|im_media_end|>, where the
# model merges the speech; the response follows in the text stream with a
# blank per response token in the audio stream. An utterance of F whisper
# frames has F[::2][::4] audio tokens (the tower's stride-2 convolution,
# then the 4-frame stack and the tokenizer's 4-frame pool).
#
# dynamic_batch turns (audio, instruct, response) samples into right-padded
# rows of both streams under a token budget (dataset_batchsize x
# dataset_text_seqlen): labels shifted by one with the prompt masked (-100)
# and <|im_kimia_text_eos|> supervised, attention_mask 1 on tokens,
# sentence_lens the response length + 1 on every position of the row, and
# every row's whisper features padded to 30 s (each row costs the tower and
# the frozen tokenizer 1500 frames whatever its length). A batch is emitted
# when the next sample would overflow the budget; that sample opens the next
# batch (the root datapipe counts it only when the next one is pulled, so a
# checkpoint taken at the emit resumes with it).
#
# Faults of the JAX batcher that are not copied:
#   - its setup checks that each media marker is one id, not that the id is
#     the config's kimia_media_begin / kimia_media_end (:56-64): with
#     another id the model's _mask_between_markers switches the speech span
#     off without a word. kimi_audio_datapipe raises at setup unless both
#     markers are exactly the config's ids and <|im_kimia_text_blank|> and
#     <|im_kimia_text_eos|> are one id each (check_special_tokens, which
#     the ASR CLI runs too);
#   - one sample whose audio stream holds other than one begin and one end
#     marker raises and ends the run (:118-125), and one whose two prompt
#     streams differ in length fails an assert (:113-116); here either is
#     logged with its key and skipped (the model's cumsum merge takes
#     exactly one span a row, and the streams are summed position by
#     position);
#   - a wav past 30 s gives the offline extractor more than 3000 frames,
#     which the speech tokenizer's 1500-row position table cannot take (the
#     JAX forward fails the whole batch with a shape error); here it is
#     logged with its key and skipped;
#   - the HF extractor (--processor_model) is handed the waveform as if it
#     were at the extractor's 16 kHz (:170-179); here a waveform at another
#     rate is resampled first, as the qwen2_audio frontend does.

import numpy as np

from touchnet_tpu_torch.data import DataConfig, dsp
from touchnet_tpu_torch.data.datapipe import LowLevelTouchDatapipe, MidLevelTouchDatapipe
from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import (
    DEFAULT_INSTRUCT,
    IGNORE_ID,
    _pad_stack,
    whisper_features,
)
from touchnet_tpu_torch.utils.logging import logger

KIMI_TEXT_TEMPLATE_FOR_S2T = (
    "<|im_kimia_user_msg_start|><|INSTRUCT|><|im_kimia_text_blank|><|AUDIO|>"
    "<|im_kimia_text_blank|><|im_kimia_text_blank|><|im_kimia_text_blank|>"
    "<|im_kimia_text_blank|>"
)
KIMI_AUDIO_TEMPLATE_FOR_S2T = (
    "<|im_kimia_text_blank|><|INSTRUCT|><|im_media_begin|><|AUDIO|>"
    "<|im_media_end|><|im_kimia_speech_ct_id|><|im_msg_end|>"
    "<|im_kimia_assistant_msg_start|>"
)
BLANK = "<|im_kimia_text_blank|>"
EOS = "<|im_kimia_text_eos|>"
MEDIA_BEGIN, MEDIA_END = "<|im_media_begin|>", "<|im_media_end|>"


def _ids(tokenizer, text: str) -> list:
    return list(tokenizer.tokenize(text, add_special_tokens=False))


def check_special_tokens(tokenizer, config) -> tuple:
    """(blank_id, eos_id); raises unless blank and eos are one id each and
    the media markers are exactly the config's ids (``config`` a
    KimiAudioConfig)."""
    found = {}
    for token in (BLANK, EOS):
        ids = _ids(tokenizer, token)
        if len(ids) != 1:
            raise ValueError(f"the tokenizer maps {token!r} to {ids[:8]}, not to one id")
        found[token] = ids[0]
    for token, want in ((MEDIA_BEGIN, config.kimia_media_begin),
                        (MEDIA_END, config.kimia_media_end)):
        ids = _ids(tokenizer, token)
        if ids != [want]:
            raise ValueError(f"the tokenizer maps {token!r} to {ids[:8]}, not to [{want}] (the "
                             "config's marker id): the speech span would not be found")
    return found[BLANK], found[EOS]


def dynamic_batch(data, config: DataConfig, extract_fn, tokenizer, media_begin: int,
                  media_end: int, max_frames: int):
    """Token-budget dynamic batching of (audio, instruct, response) samples
    (the JAX dynamic_batch). ``extract_fn(waveform, sample_rate)`` ->
    (features [T, mel], frame mask [T]); ``media_begin``/``media_end`` the
    marker ids (checked at setup); ``max_frames`` the most feature frames
    the speech tokenizer takes. Skips, each logged with its key, a sample
    with no txt (nor response), one past max_frames, one whose streams
    differ in length and one whose audio stream holds other than one begin
    and one end marker; and, as JAX, one whose ids are outside the text
    length filters."""
    text_ids_buf, mask_buf, labels_buf, slens_buf = [], [], [], []
    audio_ids_buf, feats_buf, feat_mask_buf = [], [], []
    longest = 0
    budget = config.dataset_batchsize * config.dataset_text_seqlen
    eos = np.asarray(_ids(tokenizer, EOS), np.int32)

    def tok(text):
        return np.asarray(_ids(tokenizer, text), np.int32)

    def emit():
        pad = tokenizer.pad if tokenizer.pad is not None else 0
        return {
            "text_input_ids": _pad_stack(text_ids_buf, pad),
            "audio_input_ids": _pad_stack(audio_ids_buf, pad),
            "attention_mask": _pad_stack(mask_buf, 0),
            "labels": _pad_stack(labels_buf, IGNORE_ID),
            "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
            "whisper_input_features": _pad_stack(feats_buf, 0.0).transpose(0, 2, 1),
            "whisper_attention_mask": _pad_stack(feat_mask_buf, 0),
            "num_sentence": len(text_ids_buf),
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

        feats, feat_mask = extract_fn(sample["waveform"], sample["sample_rate"])
        if feats.shape[0] > max_frames:
            logger.info(f"sample {key!r} has {feats.shape[0]} whisper frames; the speech "
                        f"tokenizer takes {max_frames} ({max_frames // 100} s), skip")
            continue
        num_audio_tokens = int(feat_mask[::2][::4].sum())  # conv/2 then pool/4

        instruct_len = len(tok(sample["instruct"]))
        response_ids = tok(sample["response"])
        text_prompt = KIMI_TEXT_TEMPLATE_FOR_S2T.replace(
            "<|INSTRUCT|>", sample["instruct"]).replace("<|AUDIO|>", BLANK * num_audio_tokens)
        audio_prompt = KIMI_AUDIO_TEMPLATE_FOR_S2T.replace(
            "<|INSTRUCT|>", BLANK * instruct_len).replace("<|AUDIO|>", BLANK * num_audio_tokens)
        text_prompt_ids = tok(text_prompt)
        audio_prompt_ids = tok(audio_prompt)
        audio_response_ids = tok(BLANK * len(response_ids))
        if (len(text_prompt_ids) != len(audio_prompt_ids)
                or len(response_ids) != len(audio_response_ids)):
            logger.info(f"sample {key!r}: its text and audio streams are "
                        f"{len(text_prompt_ids) + len(response_ids)} and "
                        f"{len(audio_prompt_ids) + len(audio_response_ids)} ids long; the model "
                        "sums them position by position, skip")
            continue
        text_input_ids = np.concatenate([text_prompt_ids, response_ids])
        audio_input_ids = np.concatenate([audio_prompt_ids, audio_response_ids])
        # the model merges the speech strictly between the first begin and
        # the first end marker of the audio stream: one span a row
        n_begin = int((audio_input_ids == media_begin).sum())
        n_end = int((audio_input_ids == media_end).sum())
        if n_begin != 1 or n_end != 1:
            logger.info(f"sample {key!r} expands to {n_begin} {MEDIA_BEGIN} / {n_end} "
                        f"{MEDIA_END} markers in its audio stream; the merge takes exactly "
                        "one span, skip")
            continue
        labels = np.concatenate(
            [np.full(len(text_prompt_ids) - 1, IGNORE_ID, np.int32), response_ids, eos])
        slens = np.full_like(labels, len(response_ids) + 1)

        n = text_input_ids.shape[0]
        if n < config.text_min_length_in_tokens_for_filter:
            continue
        if n > config.text_max_length_in_tokens_for_filter:
            continue

        longest = max(longest, n)
        if longest * (len(text_ids_buf) + 1) > budget and text_ids_buf:
            yield emit()
            text_ids_buf, mask_buf, labels_buf, slens_buf = [], [], [], []
            audio_ids_buf, feats_buf, feat_mask_buf = [], [], []
            longest = n
        text_ids_buf.append(text_input_ids)
        audio_ids_buf.append(audio_input_ids)
        mask_buf.append(np.ones_like(labels))
        labels_buf.append(labels)
        slens_buf.append(slens)
        feats_buf.append(feats)
        feat_mask_buf.append(feat_mask)

    if (not config.dataloader_drop_last_batch) and text_ids_buf:
        yield emit()


def hf_extractor(processor_model: str):
    """extract_fn of the HF WhisperFeatureExtractor saved at
    ``processor_model``: padded to 30 s (and truncated there, its default),
    a waveform at another rate resampled to the extractor's first."""
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor.from_pretrained(processor_model)

    def extract_fn(waveform, sample_rate):
        wav = np.asarray(waveform, dtype=np.float32).reshape(-1)
        if sample_rate != fe.sampling_rate:
            wav = dsp.resample(wav, sample_rate, fe.sampling_rate)
        out = fe(wav, sampling_rate=fe.sampling_rate, return_attention_mask=True,
                 return_tensors="np", padding="max_length")
        return out["input_features"][0].T, out["attention_mask"][0]

    return extract_fn


def kimi_audio_datapipe(
    data_config: DataConfig,
    tokenizer,
    dp_rank: int,
    dp_world_size: int,
    worker_id: int = 0,
    num_workers: int = 1,
    split: str = "train",
    *,
    model_config,
):
    """LowLevelTouchDatapipe -> dynamic_batch. The features are the HF
    extractor's with processor_model set, otherwise the offline numpy
    whisper_features at audiofeat_num_mel_bins. Raises at setup unless the
    tokenizer holds Kimi's special tokens as ``model_config`` (a
    KimiAudioConfig) needs them (check_special_tokens)."""
    check_special_tokens(tokenizer, model_config)
    if data_config.processor_model:
        extract_fn = hf_extractor(data_config.processor_model)
    else:
        n_mels = data_config.audiofeat_num_mel_bins

        def extract_fn(waveform, sample_rate):
            return whisper_features(waveform, sample_rate, n_mels)

    max_frames = 2 * model_config.speech_tokenizer_config.max_source_positions
    datapipe = LowLevelTouchDatapipe(data_config, dp_rank, dp_world_size, worker_id,
                                     num_workers, split)
    return MidLevelTouchDatapipe(datapipe, dynamic_batch, data_config, extract_fn, tokenizer,
                                 model_config.kimia_media_begin, model_config.kimia_media_end,
                                 max_frames)
