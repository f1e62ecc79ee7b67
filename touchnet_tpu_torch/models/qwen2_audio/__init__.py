# Copyright (c) 2026 touchnet_tpu authors.
# Qwen2-Audio family of the port (Qwen2AudioForConditionalGeneration: the
# whisper tower, a projector and the port's Llama with Qwen2's biases):
# configuration, the module, converters, whisper features and the ASR CLI.
# Exports only: the qwen2_audio TrainSpec (touchnet_tpu/models/qwen2_audio/
# __init__.py) is registered with the training slice.

from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig

__all__ = ["Qwen2AudioConfig"]
