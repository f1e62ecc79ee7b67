# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/models/qwen2_audio/configuration_qwen2_audio.py
# (framework-free), with its imports pointed at the port, so the same config
# files load in both packages.
#
# Qwen2-Audio configuration (HF-compatible JSON schema).
#
# Capability parity: HF Qwen2AudioConfig as consumed by the reference
# (touchnet/models/qwen2_audio/__init__.py). audio_config = whisper encoder;
# text_config = Qwen2 (llama-architecture with q/k/v biases).

import json
from dataclasses import dataclass, field

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.whisper_encoder import WhisperEncoderConfig


@dataclass
class Qwen2AudioConfig:
    audio_config: WhisperEncoderConfig = field(default_factory=WhisperEncoderConfig)
    text_config: LlamaConfig = field(default_factory=LlamaConfig)
    audio_token_index: int = 151646
    model_type: str = "qwen2_audio"

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen2AudioConfig":
        text = dict(d.get("text_config", {}))
        # Qwen2 backbone: q/k/v biases on
        text.setdefault("attention_bias", True)
        return cls(
            audio_config=WhisperEncoderConfig.from_dict(d.get("audio_config", {})),
            text_config=LlamaConfig.from_dict(text),
            audio_token_index=d.get("audio_token_index", 151646),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "Qwen2AudioConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        return {
            "model_type": self.model_type,
            "audio_token_index": self.audio_token_index,
            "audio_config": dict(self.audio_config.__dict__),
            "text_config": self.text_config.to_dict(),
        }
