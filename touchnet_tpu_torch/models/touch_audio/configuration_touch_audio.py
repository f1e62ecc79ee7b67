# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/models/touch_audio/configuration_touch_audio.py
# (framework-free), with its imports pointed at the port, so the same config
# files load in both packages.
#
# TouchAudioForCausalLM configuration.
#
# Capability parity: reference touchnet/models/touch_audio/
# configuration_touch_audio.py:8-58 — TouchAudioConfig holds an audio
# projector config (input_size) and a nested text (backbone) config.

import json
from dataclasses import dataclass, field

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig


@dataclass
class TouchAudioProjectorConfig:
    input_size: int = 560  # mel bins * stack length by default

    @classmethod
    def from_dict(cls, d: dict) -> "TouchAudioProjectorConfig":
        return cls(input_size=d.get("input_size", 560))

    def to_dict(self):
        return {"input_size": self.input_size}


@dataclass
class TouchAudioConfig:
    audio_config: TouchAudioProjectorConfig = field(
        default_factory=TouchAudioProjectorConfig
    )
    text_config: LlamaConfig = field(default_factory=LlamaConfig)
    model_type: str = "touch_audio"
    pad_token_id: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "TouchAudioConfig":
        return cls(
            audio_config=TouchAudioProjectorConfig.from_dict(
                d.get("audio_config", {})
            ),
            text_config=LlamaConfig.from_dict(d.get("text_config", {})),
            pad_token_id=d.get("pad_token_id", 0) or 0,
        )

    @classmethod
    def from_json_file(cls, path: str) -> "TouchAudioConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        return {
            "model_type": self.model_type,
            "audio_config": self.audio_config.to_dict(),
            "text_config": self.text_config.to_dict(),
            "pad_token_id": self.pad_token_id,
        }
