# Copyright (c) 2026 touchnet_tpu authors.
# TouchAudio family of the port (TouchAudioForCausalLM: a bias-free audio
# projector in front of the Llama): configuration, the module and training
# forward, converters, batchers, the ASR CLI, and the touch_audio TrainSpec
# the trainer looks up by name.
#
# The TrainSpec registration ports touchnet_tpu/models/touch_audio/
# __init__.py:39-62, with input_features among the forward's batch keys.
# Its param_rules is the tensor-parallel plan (parallel/sharding.apply_tp:
# the llama layers', the projector rowwise); pipelining_fn
# (pipeline_touch_audio.py) waits for pipeline parallelism.
# additional_pre_init_fn checks, before any
# work, that the data's stacked features are as wide as the projector.

from touchnet_tpu_torch.data import DataConfig, functions
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig


def check_feature_width(model_config: TouchAudioConfig, data_config: DataConfig) -> None:
    """Raise when the frontend's width times the stack length is not the
    projector's input_size (examples/audio/sft/asr/wenetspeech/run.sh sets
    log-mel with 128 bins and the default stack 7, 896 wide, against
    Touch-Audio-7B's 400)."""
    width = functions.feature_width(data_config)
    if width != model_config.audio_config.input_size:
        raise ValueError(
            f"the stacked audio features are {width} wide ({data_config.audio_feat_type}, "
            f"{data_config.audiofeat_num_mel_bins} mel bins, {data_config.audiofeat_num_ceps} "
            f"ceps for mfcc, stack {data_config.audiofeat_stack_length}) but the model's "
            f"projector takes input_size {model_config.audio_config.input_size}")


def _register() -> None:
    from touchnet_tpu_torch.data.dataloader import build_dataloader
    from touchnet_tpu_torch.loss import accuracy, cross_entropy_loss
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import (
        forward,
        get_num_flop_per_token,
        get_num_params,
        head_weight,
        init_params,
    )
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.parallel.sharding import apply_tp
    from touchnet_tpu_torch.utils.train_spec import TrainSpec, register_train_spec

    register_train_spec(
        TrainSpec(
            name="touch_audio",
            config_cls=TouchAudioConfig,
            init_params_fn=init_params,
            forward_fn=forward,
            loss_fn=cross_entropy_loss,
            acc_fn=accuracy,
            build_dataloader_fn=build_dataloader,
            build_tokenizer_fn=build_tokenizer,
            get_num_flop_per_token_fn=get_num_flop_per_token,
            get_num_params_fn=get_num_params,
            head_weight_fn=head_weight,
            param_rules=apply_tp,
            forward_batch_keys=("input_ids", "inputs_embeds", "input_features"),
            additional_pre_init_fn=check_feature_width,
        )
    )


_register()
