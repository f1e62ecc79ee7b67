# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/__init__.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# Data configuration.
#
# Capability parity: reference touchnet/data/__init__.py:8-495 (field-for-field;
# defaults match). TPU additions are marked "TPU:".

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataConfig:
    """All knobs of the data pipeline (storage, sharding, DSP, batching)."""

    datapipe_type: str = field(
        default="causal_lm",
        metadata={"help": "one of {causal_lm, touch_audio, qwen2_audio, kimi_audio}"},
    )
    processor_model: Optional[str] = field(
        default=None,
        metadata={"help": "HF processor path (qwen2_audio / kimi_audio pipelines)"},
    )
    dataset_enable_pack: bool = field(
        default=False, metadata={"help": "pack sentences into fixed [B, seqlen] buffers"}
    )
    datalist_path: Optional[str] = field(default=None, metadata={"help": "train data.list"})
    datalist_dev_path: Optional[str] = field(default=None, metadata={"help": "dev data.list"})
    datalist_test_path: Optional[str] = field(default=None, metadata={"help": "test data.list"})
    datalist_sharding: bool = field(default=True, metadata={"help": "stride shards over dp ranks"})
    datalist_epoch: int = field(default=1, metadata={"help": "number of epochs over the list"})
    datalist_shuffling: bool = field(default=True, metadata={"help": "shuffle shard list per epoch"})
    dataset_shuffling: bool = field(default=True, metadata={"help": "shuffle samples within a shard"})
    dataset_mmap: bool = field(default=True, metadata={"help": "mmap .bin files"})
    dataset_load_audio_via_segments: bool = field(
        default=False, metadata={"help": "randomly pick a labeled segment from metainfo"}
    )
    dataset_random_cut_audio: bool = field(
        default=False, metadata={"help": "random crop long audio (pretrain)"}
    )
    dataset_random_cut_audio_min_length_in_ms: int = field(default=5000)
    dataset_random_cut_audio_max_length_in_ms: int = field(default=3600000)
    dataset_batchsize: int = field(default=8)
    dataset_audio_seqlen: int = field(default=8192)
    dataset_text_seqlen: int = field(default=2048)
    audio_max_length_in_ms_for_filter: int = field(default=800000)
    audio_min_length_in_ms_for_filter: int = field(default=200)
    text_max_length_in_tokens_for_filter: int = field(default=800000)
    text_min_length_in_tokens_for_filter: int = field(default=1)
    max_text_audio_ratio: float = field(default=1.0)
    min_text_audio_ratio: float = field(default=0.0005)
    audio_resample_rate: int = field(default=16000)
    audio_speed_perturb: bool = field(default=True)
    audio_speed_perturb_speeds: List[float] = field(default_factory=lambda: [0.9, 1.0, 1.1])
    audio_feat_type: str = field(
        default="fbank", metadata={"help": "fbank | mfcc | log_mel_spectrogram"}
    )
    audiofeat_spec_aug: bool = field(default=True)
    audiofeat_spec_aug_num_t_mask: int = field(default=2)
    audiofeat_spec_aug_num_f_mask: int = field(default=2)
    audiofeat_spec_aug_max_t: int = field(default=50)
    audiofeat_spec_aug_max_f: int = field(default=10)
    audiofeat_spec_sub: bool = field(default=True)
    audiofeat_spec_sub_num_t_sub: int = field(default=3)
    audiofeat_spec_sub_max_t: int = field(default=20)
    audiofeat_spec_trim: bool = field(default=False)
    audiofeat_spec_trim_max_t: int = field(default=20)
    audiofeat_num_mel_bins: int = field(default=23)
    audiofeat_frame_length: int = field(default=25, metadata={"help": "ms"})
    audiofeat_frame_shift: int = field(default=10, metadata={"help": "ms"})
    audiofeat_dither: float = field(default=0.0)
    audiofeat_num_ceps: int = field(default=40)
    audiofeat_high_freq: float = field(default=0.0)
    audiofeat_low_freq: float = field(default=20.0)
    audiofeat_padding: int = field(default=0)
    audiofeat_n_fft: int = field(default=400)
    audiofeat_hop_length: int = field(default=160)
    audiofeat_stack_length: int = field(default=7)
    audiofeat_stride_length: int = field(default=6)
    audiofeat_normalize: bool = field(default=True)
    dataloader_drop_last_batch: bool = field(default=True)
    dataloader_num_workers: int = field(default=6)
    dataloader_prefetch_factor: int = field(default=6)
    # TPU: background prefetch depth for device_put double buffering.
    dataloader_device_prefetch: int = field(
        default=2, metadata={"help": "batches staged on device ahead of the train step"}
    )
