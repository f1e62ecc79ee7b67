# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/models/llama/processing_llama.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# Packed text batching for causal LM pretraining.
#
# Capability parity: reference touchnet/models/llama/processing_llama.py:24-127.
# Greedy row-fill packing into a fixed [B, seqlen] buffer with:
#   input_ids   : bos + ids            (pad rows filled with tokenizer.pad)
#   labels      : ids + eos            (ignore positions = -100)
#   position_ids: restart at 0 per sentence
#   attention_mask: per-sentence segment id 1,2,3,... (0 = pad) — this is the
#       document mask consumed by the packed attention kernel
#   sentence_lens: per-position length of its sentence (for pack loss)
#   num_sentence: number of packed sentences in the batch (python int)
# Buffers are numpy int32 — TPU-native (int64 indices buy nothing on TPU and
# double the host->device transfer bytes).

import numpy as np

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data import functions
from touchnet_tpu_torch.data.datapipe import LowLevelTouchDatapipe, MidLevelTouchDatapipe
from touchnet_tpu_torch.tokenizer.tokenizer import BaseTokenizer

IGNORE_ID = -100


def _new_buffer(batchsize: int, seqlen: int, pad_id: int):
    return {
        "input_ids": np.full([batchsize, seqlen], pad_id, dtype=np.int32),
        "inputs_embeds": None,
        "labels": np.full([batchsize, seqlen], IGNORE_ID, dtype=np.int32),
        "position_ids": np.zeros([batchsize, seqlen], dtype=np.int32),
        "attention_mask": np.zeros([batchsize, seqlen], dtype=np.int32),
        "sentence_lens": np.ones([batchsize, seqlen], dtype=np.int32),
        "num_sentence": 0,
    }


def batch_text(data, config: DataConfig, tokenizer: BaseTokenizer):
    """Greedy packing of tokenized sentences into fixed [B, seqlen] buffers."""
    batchsize = config.dataset_batchsize
    seqlen = config.dataset_text_seqlen
    pad_id = tokenizer.pad if tokenizer.pad is not None else 0
    buffer = _new_buffer(batchsize, seqlen, pad_id)
    cur_batch_idx = 0
    cur_text_idx = 0
    cur_sentence_idx = 1
    for sample in data:
        text_len = len(sample["input_ids"]) + 1  # +1 for bos/eos
        if text_len > seqlen:
            # sentence longer than a whole row: drop (cannot pack)
            continue
        if cur_batch_idx == batchsize - 1:
            if cur_text_idx + text_len > seqlen:
                yield buffer
                buffer = _new_buffer(batchsize, seqlen, pad_id)
                cur_batch_idx = 0
                cur_text_idx = 0
                cur_sentence_idx = 1
        else:
            if cur_text_idx + text_len > seqlen:
                cur_batch_idx += 1
                cur_text_idx = 0
                cur_sentence_idx = 1
        sl = slice(cur_text_idx, cur_text_idx + text_len)
        buffer["input_ids"][cur_batch_idx, sl] = np.asarray(
            [tokenizer.bos] + list(sample["input_ids"]), dtype=np.int32
        )
        buffer["labels"][cur_batch_idx, sl] = np.asarray(
            list(sample["input_ids"]) + [tokenizer.eos], dtype=np.int32
        )
        buffer["position_ids"][cur_batch_idx, sl] = np.arange(text_len, dtype=np.int32)
        buffer["attention_mask"][cur_batch_idx, sl] = cur_sentence_idx
        buffer["sentence_lens"][cur_batch_idx, sl] = text_len
        buffer["num_sentence"] += 1
        cur_text_idx += text_len
        cur_sentence_idx += 1
    if (not config.dataloader_drop_last_batch) and (cur_text_idx > 0 or cur_batch_idx > 0):
        yield buffer


def causal_lm_datapipe(
    data_config: DataConfig,
    tokenizer: BaseTokenizer,
    dp_rank: int,
    dp_world_size: int,
    worker_id: int = 0,
    num_workers: int = 1,
    split: str = "train",
):
    """LowLevel -> [tokenize] -> filter -> batch_text."""
    datapipe = LowLevelTouchDatapipe(
        data_config, dp_rank, dp_world_size, worker_id, num_workers, split
    )
    datapipe = MidLevelTouchDatapipe(datapipe, functions.text_tokenize, tokenizer)
    datapipe = MidLevelTouchDatapipe(datapipe, functions.filter_samples, data_config)
    datapipe = MidLevelTouchDatapipe(datapipe, batch_text, data_config, tokenizer)
    return datapipe
