# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/functions.py (framework-free: numpy and the standard
# library), with its imports pointed at the port. Only text_tokenize and
# filter_samples are kept; the audio functions come with the audio slice.
#
# Generator map functions of the data pipeline (CPU workers, numpy).
#
# Capability parity: reference touchnet/data/functions.py:32-316 — tokenize,
# length/ratio filters, resample, speed perturb, fbank/mfcc/log-mel frontends,
# SpecAug/SpecSub/SpecTrim, low-frame-rate stacking. Torch/sox/librosa-free:
# the DSP lives in touchnet_tpu/data/dsp.py.

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.tokenizer.tokenizer import BaseTokenizer


def text_tokenize(data, tokenizer: BaseTokenizer):
    """Tokenize sample['txt'] into sample['input_ids'] (bos/eos added later in
    the batchers)."""
    for sample in data:
        if "txt" in sample:
            sample["input_ids"] = tokenizer.tokenize(
                sample["txt"], add_special_tokens=False
            )
            yield sample
        else:
            yield sample


def filter_samples(data, config: DataConfig):
    """Filter by token count, audio duration, and text/audio ratio."""
    for sample in data:
        if "input_ids" in sample:
            num_tokens = len(sample["input_ids"])
            if num_tokens < config.text_min_length_in_tokens_for_filter:
                continue
            if num_tokens > config.text_max_length_in_tokens_for_filter:
                continue
        if "waveform" in sample:
            assert "sample_rate" in sample
            duration = sample["waveform"].shape[1] / sample["sample_rate"] * 1000.0
            if config.audio_speed_perturb:
                duration *= max(config.audio_speed_perturb_speeds)
            if duration < config.audio_min_length_in_ms_for_filter:
                continue
            if duration > config.audio_max_length_in_ms_for_filter:
                continue
            if "input_ids" in sample:
                num_tokens = len(sample["input_ids"])
                if duration > 1e-7:
                    ratio = num_tokens / (duration / 10)
                    if ratio < config.min_text_audio_ratio:
                        continue
                    if ratio > config.max_text_audio_ratio:
                        continue
        yield sample
