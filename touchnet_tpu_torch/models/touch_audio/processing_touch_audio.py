# Copyright (c) 2026 touchnet_tpu authors.
# Port of touchnet_tpu/models/touch_audio/processing_touch_audio.py
# (framework-free: numpy), with its imports pointed at the port: _ntp_labels,
# the four batchers and touch_audio_datapipe (:27-317). The batchers are the
# JAX ones; they hold one look-ahead sample and yield a batch only when the
# sample just pulled does not fit (or at the end), so the port's root
# datapipe, which counts a sample when the next one is pulled, resumes them
# exactly. Two changes: a batch's feature width is the frontend's width
# times the stack (functions.feature_width: num_ceps for mfcc, where the
# JAX buffer takes the mel bins and then fails to broadcast), and the
# datapipe raises at setup when a BestRQ tokenizer's input size is not that
# width.
#
# TouchAudio batchers: packed + dynamic batching for audio pretrain (BEST-RQ
# NTP) and audio-text SFT (ASR pairs).
#
# Capability parity: reference touchnet/models/touch_audio/
# processing_touch_audio.py:25-490 —
#   batch_audio_packed: fixed [B, A, mel*stack] buffers; labels = BEST-RQ
#     codes shifted by one (next-token prediction), last position ignored;
#   batch_pairaudio_pairtext_packed: ASR pairs — audio features at the
#     segment head, text (bos+ids) right-aligned in the same span (the
#     padding+addition trick), labels over the text span only,
#     sentence_lens = text_len;
#   batch_audio / batch_pairaudio_pairtext: non-packed dynamic batching with
#     token-budget trigger (n+1)*max_len > batchsize*seqlen;
#   touch_audio_datapipe: the full audio DSP chain.

import numpy as np

from touchnet_tpu_torch.data import DataConfig, functions
from touchnet_tpu_torch.data.datapipe import LowLevelTouchDatapipe, MidLevelTouchDatapipe
from touchnet_tpu_torch.tokenizer.tokenizer import BaseTokenizer, BestRQTokenizer

IGNORE_ID = -100


def _ntp_labels(sample, tokenizer: BestRQTokenizer) -> np.ndarray:
    """Next-code labels for one utterance: position i predicts the code of
    frame i+1. Prefers the shard's precomputed offline codes ("audiotoken"
    datatype, bin/make_data.py) — skipping the per-epoch BestRQ projection +
    codebook argmin, the CPU-heaviest step after the frontend — and falls
    back to online tokenization. Codes may be LONGER than the (possibly
    SpecTrim-shortened) features; offline codes then supervise the final
    position too, where the online path must emit IGNORE."""
    audio_len = sample["audiofeat"].shape[0]
    codes = sample.get("audiotoken")
    if codes is not None:
        assert len(codes) >= audio_len, (
            f"offline audiotoken codes ({len(codes)}) shorter than the "
            f"features ({audio_len}): shards were built with a different "
            "frontend config than this run"
        )
        lab = np.full(audio_len, IGNORE_ID, np.int32)
        n = min(audio_len, len(codes) - 1)
        lab[:n] = codes[1 : n + 1]
        return lab
    labels = tokenizer.tokenize(sample["audiofeat"])
    assert len(labels) == audio_len
    return np.asarray(list(labels[1:]) + [IGNORE_ID], np.int32)


def _audio_buffer(config: DataConfig, pad_id=None):
    B = config.dataset_batchsize
    A = config.dataset_audio_seqlen
    feat = functions.feature_width(config)
    buf = {
        "input_ids": None if pad_id is None else np.full([B, A], pad_id, np.int32),
        "input_features": np.zeros([B, A, feat], np.float32),
        "labels": np.full([B, A], IGNORE_ID, np.int32),
        "position_ids": np.zeros([B, A], np.int32),
        "attention_mask": np.zeros([B, A], np.int32),
        "sentence_lens": np.ones([B, A], np.int32),
        "num_sentence": 0,
    }
    return buf


def batch_audio_packed(data, config: DataConfig, tokenizer: BestRQTokenizer):
    """Packed BEST-RQ pretraining batches."""
    B = config.dataset_batchsize
    A = config.dataset_audio_seqlen
    buffer = _audio_buffer(config)
    cur_batch_idx = 0
    cur_audio_idx = 0
    cur_sentence_idx = 1
    for sample in data:
        audio_len = sample["audiofeat"].shape[0]
        if audio_len > A:
            continue
        if cur_batch_idx == B - 1:
            if cur_audio_idx + audio_len > A:
                buffer["shift_labels"] = buffer["labels"]
                yield buffer
                buffer = _audio_buffer(config)
                cur_batch_idx = 0
                cur_audio_idx = 0
                cur_sentence_idx = 1
        else:
            if cur_audio_idx + audio_len > A:
                cur_batch_idx += 1
                cur_audio_idx = 0
                cur_sentence_idx = 1
        sl = slice(cur_audio_idx, cur_audio_idx + audio_len)
        buffer["input_features"][cur_batch_idx, sl] = sample["audiofeat"]
        # NTP: predict the next code; last output ignored (unless offline
        # codes cover it — _ntp_labels)
        buffer["labels"][cur_batch_idx, sl] = _ntp_labels(sample, tokenizer)
        buffer["position_ids"][cur_batch_idx, sl] = np.arange(audio_len, dtype=np.int32)
        buffer["attention_mask"][cur_batch_idx, sl] = cur_sentence_idx
        buffer["sentence_lens"][cur_batch_idx, sl] = audio_len
        buffer["num_sentence"] += 1
        cur_audio_idx += audio_len
        cur_sentence_idx += 1
    if (not config.dataloader_drop_last_batch) and (cur_batch_idx > 0 or cur_audio_idx > 0):
        buffer["shift_labels"] = buffer["labels"]
        yield buffer


def batch_pairaudio_pairtext_packed(data, config: DataConfig, tokenizer: BaseTokenizer):
    """Packed ASR pairs: audio at segment head, text right-aligned in span."""
    assert config.dataset_audio_seqlen == config.dataset_text_seqlen
    B = config.dataset_batchsize
    A = config.dataset_audio_seqlen
    pad = tokenizer.pad if tokenizer.pad is not None else 0
    buffer = _audio_buffer(config, pad_id=pad)
    cur_batch_idx = 0
    cur_audio_idx = 0
    cur_sentence_idx = 1
    for sample in data:
        audio_len = sample["audiofeat"].shape[0]
        text_len = len(sample["input_ids"]) + 1  # +1 for bos/eos
        total_len = audio_len + text_len
        if total_len > A:
            continue
        if cur_batch_idx == B - 1:
            if cur_audio_idx + total_len > A:
                buffer["shift_labels"] = buffer["labels"]
                yield buffer
                buffer = _audio_buffer(config, pad_id=pad)
                cur_batch_idx = 0
                cur_audio_idx = 0
                cur_sentence_idx = 1
        else:
            if cur_audio_idx + total_len > A:
                cur_batch_idx += 1
                cur_audio_idx = 0
                cur_sentence_idx = 1
        a_sl = slice(cur_audio_idx, cur_audio_idx + audio_len)
        t_sl = slice(cur_audio_idx + total_len - text_len, cur_audio_idx + total_len)
        full_sl = slice(cur_audio_idx, cur_audio_idx + total_len)
        buffer["input_features"][cur_batch_idx, a_sl] = sample["audiofeat"]
        buffer["input_ids"][cur_batch_idx, t_sl] = np.asarray(
            [tokenizer.bos] + list(sample["input_ids"]), np.int32
        )
        buffer["labels"][cur_batch_idx, t_sl] = np.asarray(
            list(sample["input_ids"]) + [tokenizer.eos], np.int32
        )
        buffer["position_ids"][cur_batch_idx, full_sl] = np.arange(
            total_len, dtype=np.int32
        )
        buffer["attention_mask"][cur_batch_idx, full_sl] = cur_sentence_idx
        buffer["sentence_lens"][cur_batch_idx, full_sl] = text_len
        buffer["num_sentence"] += 1
        cur_audio_idx += total_len
        cur_sentence_idx += 1
    if (not config.dataloader_drop_last_batch) and (cur_batch_idx > 0 or cur_audio_idx > 0):
        buffer["shift_labels"] = buffer["labels"]
        yield buffer


def _pad_stack(arrs, pad_value, dtype=None):
    """pad_sequence(batch_first=True, right padding) in numpy."""
    maxlen = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), maxlen) + arrs[0].shape[1:], pad_value,
                  dtype or arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def batch_audio(data, config: DataConfig, tokenizer: BestRQTokenizer):
    """Non-packed BEST-RQ pretraining: dynamic batching with token budget."""
    feats_buf, labels_buf, slens_buf = [], [], []
    max_len = 0
    budget = config.dataset_batchsize * config.dataset_audio_seqlen
    for sample in data:
        audio_len = sample["audiofeat"].shape[0]
        max_len = max(max_len, audio_len)
        if audio_len > config.dataset_audio_seqlen:
            continue
        feats = np.asarray(sample["audiofeat"], np.float32)
        labels_arr = _ntp_labels(sample, tokenizer)
        slens = np.full(audio_len, audio_len, np.int32)
        if (len(feats_buf) + 1) * max_len > budget and feats_buf:
            yield {
                "input_ids": None,
                "input_features": _pad_stack(feats_buf, 0.0),
                "labels": _pad_stack(labels_buf, IGNORE_ID),
                "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
                "position_ids": None,
                "attention_mask": None,
                "sentence_lens": _pad_stack(slens_buf, 1),
                "num_sentence": len(feats_buf),
            }
            feats_buf, labels_buf, slens_buf = [feats], [labels_arr], [slens]
            max_len = audio_len
        else:
            feats_buf.append(feats)
            labels_buf.append(labels_arr)
            slens_buf.append(slens)
    if (not config.dataloader_drop_last_batch) and feats_buf:
        yield {
            "input_ids": None,
            "input_features": _pad_stack(feats_buf, 0.0),
            "labels": _pad_stack(labels_buf, IGNORE_ID),
            "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
            "position_ids": None,
            "attention_mask": None,
            "sentence_lens": _pad_stack(slens_buf, 1),
            "num_sentence": len(feats_buf),
        }


def batch_pairaudio_pairtext(data, config: DataConfig, tokenizer: BaseTokenizer):
    """Non-packed ASR pairs with dynamic batching."""
    assert config.dataset_audio_seqlen == config.dataset_text_seqlen
    pad = tokenizer.pad if tokenizer.pad is not None else 0
    ids_buf, feats_buf, labels_buf, mask_buf, slens_buf = [], [], [], [], []
    max_len = 0
    budget = config.dataset_batchsize * config.dataset_audio_seqlen
    for sample in data:
        audio_len = sample["audiofeat"].shape[0]
        text_len = len(sample["input_ids"])
        total_len = audio_len + text_len + 1  # +1 for bos/eos
        max_len = max(max_len, total_len)
        if total_len > config.dataset_audio_seqlen:
            continue
        feats = np.zeros((total_len, sample["audiofeat"].shape[1]), np.float32)
        feats[:audio_len] = sample["audiofeat"]
        ids = np.full(total_len, pad, np.int32)
        ids[audio_len:] = np.asarray([tokenizer.bos] + list(sample["input_ids"]),
                                     np.int32)
        labels = np.full(total_len, IGNORE_ID, np.int32)
        labels[audio_len:] = np.asarray(list(sample["input_ids"]) + [tokenizer.eos],
                                        np.int32)
        mask = np.ones(total_len, np.int32)
        slens = np.full(total_len, text_len, np.int32)
        if (len(feats_buf) + 1) * max_len > budget and feats_buf:
            yield {
                "input_ids": _pad_stack(ids_buf, pad),
                "input_features": _pad_stack(feats_buf, 0.0),
                "labels": _pad_stack(labels_buf, IGNORE_ID),
                "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
                "position_ids": None,
                "attention_mask": _pad_stack(mask_buf, 0),
                "sentence_lens": _pad_stack(slens_buf, 1),
                "num_sentence": len(feats_buf),
            }
            ids_buf, feats_buf, labels_buf = [ids], [feats], [labels]
            mask_buf, slens_buf = [mask], [slens]
            max_len = total_len
        else:
            ids_buf.append(ids)
            feats_buf.append(feats)
            labels_buf.append(labels)
            mask_buf.append(mask)
            slens_buf.append(slens)
    if (not config.dataloader_drop_last_batch) and feats_buf:
        yield {
            "input_ids": _pad_stack(ids_buf, pad),
            "input_features": _pad_stack(feats_buf, 0.0),
            "labels": _pad_stack(labels_buf, IGNORE_ID),
            "shift_labels": _pad_stack(labels_buf, IGNORE_ID),
            "position_ids": None,
            "attention_mask": _pad_stack(mask_buf, 0),
            "sentence_lens": _pad_stack(slens_buf, 1),
            "num_sentence": len(feats_buf),
        }


def touch_audio_datapipe(
    data_config: DataConfig,
    tokenizer: BaseTokenizer,
    dp_rank: int,
    dp_world_size: int,
    worker_id: int = 0,
    num_workers: int = 1,
    split: str = "train",
):
    """Full audio chain: [tokenize] -> filter -> resample -> [speed perturb]
    -> {fbank | mfcc | logmel} -> [specaug/sub/trim] -> stack -> batcher."""
    if isinstance(tokenizer, BestRQTokenizer):
        width = functions.feature_width(data_config)
        if tokenizer.config.tokenizer_bestrq_input_size != width:
            raise ValueError(
                f"tokenizer_bestrq_input_size {tokenizer.config.tokenizer_bestrq_input_size}: "
                f"the stacked features are {width} wide ({data_config.audio_feat_type}, "
                f"stack {data_config.audiofeat_stack_length})")
    datapipe = LowLevelTouchDatapipe(
        data_config, dp_rank, dp_world_size, worker_id, num_workers, split
    )
    if not isinstance(tokenizer, BestRQTokenizer):
        datapipe = MidLevelTouchDatapipe(datapipe, functions.text_tokenize, tokenizer)
    datapipe = MidLevelTouchDatapipe(datapipe, functions.filter_samples, data_config)
    datapipe = MidLevelTouchDatapipe(datapipe, functions.audio_resample, data_config)
    if data_config.audio_speed_perturb:
        datapipe = MidLevelTouchDatapipe(
            datapipe, functions.audio_speed_perturb, data_config
        )
    datapipe = MidLevelTouchDatapipe(datapipe, functions.feature_function(data_config),
                                     data_config)
    if data_config.audiofeat_spec_aug:
        datapipe = MidLevelTouchDatapipe(datapipe, functions.audiofeat_spec_aug, data_config)
    if data_config.audiofeat_spec_sub:
        datapipe = MidLevelTouchDatapipe(datapipe, functions.audiofeat_spec_sub, data_config)
    if data_config.audiofeat_spec_trim:
        datapipe = MidLevelTouchDatapipe(datapipe, functions.audiofeat_spec_trim, data_config)
    datapipe = MidLevelTouchDatapipe(datapipe, functions.audiofeat_stack, data_config)

    if isinstance(tokenizer, BestRQTokenizer):
        # audio pretrain (BEST-RQ NTP); pack flag picks the packed batcher
        batcher = batch_audio_packed if data_config.dataset_enable_pack else batch_audio
    else:
        # audio SFT (ASR/TTS pairs)
        batcher = (
            batch_pairaudio_pairtext_packed
            if data_config.dataset_enable_pack
            else batch_pairaudio_pairtext
        )
    return MidLevelTouchDatapipe(datapipe, batcher, data_config, tokenizer)
