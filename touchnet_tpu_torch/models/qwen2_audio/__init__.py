# Copyright (c) 2026 touchnet_tpu authors.
# Qwen2-Audio family of the port (Qwen2AudioForConditionalGeneration: the
# whisper tower, a projector and the port's Llama with Qwen2's biases):
# configuration, the module and training forward, converters, whisper
# features, the SFT datapipe, the ASR CLI, and the qwen2_audio TrainSpec the
# trainer looks up by name.
#
# The TrainSpec registration ports touchnet_tpu/models/qwen2_audio/
# __init__.py:22-40: data-parallel only (dp_only), feature_attention_mask
# among the forward's batch keys, and no head_weight_fn, so the trainer
# takes the full-logits pack loss and never the fused lm-head (K3), whatever
# --training_enable_liger_kernel says (touchnet_tpu/bin/train.py:485-498).
# additional_pre_init_fn checks, before any work, that the datapipe's mel
# bins are the tower's.

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig


def check_mel_bins(model_config: Qwen2AudioConfig, data_config: DataConfig) -> None:
    """Raise when the offline frontend's whisper features
    (audiofeat_num_mel_bins) are not as wide as the tower's first
    convolution takes (audio_config.num_mel_bins)."""
    want = model_config.audio_config.num_mel_bins
    if data_config.audiofeat_num_mel_bins != want:
        raise ValueError(f"audiofeat_num_mel_bins {data_config.audiofeat_num_mel_bins}: the "
                         f"whisper tower takes {want} mel bins (audio_config.num_mel_bins)")


def _register() -> None:
    from touchnet_tpu_torch.data.dataloader import build_dataloader
    from touchnet_tpu_torch.loss import accuracy, cross_entropy_loss
    from touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio import (
        forward,
        get_num_flop_per_token,
        get_num_params,
        init_params,
    )
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.train_spec import TrainSpec, register_train_spec

    register_train_spec(
        TrainSpec(
            name="qwen2_audio",
            config_cls=Qwen2AudioConfig,
            init_params_fn=init_params,
            forward_fn=forward,
            loss_fn=cross_entropy_loss,
            acc_fn=accuracy,
            build_dataloader_fn=build_dataloader,
            build_tokenizer_fn=build_tokenizer,
            get_num_flop_per_token_fn=get_num_flop_per_token,
            get_num_params_fn=get_num_params,
            dp_only=True,
            forward_batch_keys=("input_ids", "inputs_embeds", "input_features",
                                "feature_attention_mask"),
            additional_pre_init_fn=check_mel_bins,
        )
    )


_register()

__all__ = ["Qwen2AudioConfig", "check_mel_bins"]
