# Copyright (c) 2026 touchnet_tpu authors.
# Kimi-Audio family of the port (MoonshotKimiaForCausalLM: a Qwen2 backbone
# with the mimo audio stream, the whisper speech encoder, the frozen
# WhisperVQ speech tokenizer, the VQAdaptor): configuration, the module,
# converters, the S2T templates, dual-stream generation and the ASR CLI.
# Exports only: the kimi_audio TrainSpec (touchnet_tpu/models/kimi_audio/
# __init__.py, with the frozen tokenizer) is registered with the SFT slice.

from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import (
    KimiAudioConfig,
    WhisperVQConfig,
)

__all__ = ["KimiAudioConfig", "WhisperVQConfig"]
