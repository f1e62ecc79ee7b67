# Copyright (c) 2026 touchnet_tpu authors.
# Kimi-Audio family of the port (MoonshotKimiaForCausalLM: a Qwen2 backbone
# with the mimo audio stream, the whisper speech encoder, the frozen
# WhisperVQ speech tokenizer, the VQAdaptor): configuration, the module and
# training forward, converters, the S2T templates and the SFT datapipe,
# dual-stream generation, the ASR CLI, and the kimi_audio TrainSpec the
# trainer looks up by name.
#
# The TrainSpec registration ports touchnet_tpu/models/kimi_audio/
# __init__.py:22-43: data-parallel only (dp_only), the four kimi batch keys
# among the forward's, no head_weight_fn (so the trainer takes the
# full-logits pack loss and never the fused lm-head, K3, whatever
# --training_enable_liger_kernel says: touchnet_tpu/bin/train.py:555-581),
# and frozen_params_re with JAX's regex text, r"speech_tokenizer/.*",
# matched on a parameter's name with "." read as "/" (the way JAX's
# _path_str spells a tree path): the trainer gives those tensors no
# gradient and no update. additional_pre_init_fn checks, before any work,
# that the datapipe's mel bins are the tower's.

from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import (
    KimiAudioConfig,
    WhisperVQConfig,
)


def check_mel_bins(model_config: KimiAudioConfig, data_config: DataConfig) -> None:
    """Raise when the offline frontend's whisper features
    (audiofeat_num_mel_bins) are not as wide as the speech encoder's first
    convolution takes (speech_encoder_config.num_mel_bins)."""
    want = model_config.speech_encoder_config.num_mel_bins
    if data_config.audiofeat_num_mel_bins != want:
        raise ValueError(f"audiofeat_num_mel_bins {data_config.audiofeat_num_mel_bins}: the "
                         f"speech encoder takes {want} mel bins "
                         "(speech_encoder_config.num_mel_bins)")


def _register() -> None:
    from touchnet_tpu_torch.data.dataloader import build_dataloader
    from touchnet_tpu_torch.loss import accuracy, cross_entropy_loss
    from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import (
        forward,
        get_num_flop_per_token,
        get_num_params,
        init_params,
    )
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.utils.train_spec import TrainSpec, register_train_spec

    register_train_spec(
        TrainSpec(
            name="kimi_audio",
            config_cls=KimiAudioConfig,
            init_params_fn=init_params,
            forward_fn=forward,
            loss_fn=cross_entropy_loss,
            acc_fn=accuracy,
            build_dataloader_fn=build_dataloader,
            build_tokenizer_fn=build_tokenizer,
            get_num_flop_per_token_fn=get_num_flop_per_token,
            get_num_params_fn=get_num_params,
            dp_only=True,
            forward_batch_keys=("text_input_ids", "audio_input_ids", "whisper_input_features",
                                "whisper_attention_mask"),
            frozen_params_re=(r"speech_tokenizer/.*",),
            additional_pre_init_fn=check_mel_bins,
        )
    )


_register()

__all__ = ["KimiAudioConfig", "WhisperVQConfig", "check_mel_bins"]
