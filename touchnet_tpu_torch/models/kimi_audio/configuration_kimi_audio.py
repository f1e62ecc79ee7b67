# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/models/kimi_audio/configuration_kimi_audio.py
# (framework-free), with its imports pointed at the port's LlamaConfig and
# WhisperEncoderConfig, so the same config files load in both packages.
#
# Kimi-Audio (MoonshotKimia) configuration.
#
# Capability parity: reference touchnet/models/kimi_audio/
# configuration_kimi_audio.py — a Qwen2 text backbone config + mimo
# (dual-stream audio head) knobs + two whisper sub-configs: speech_encoder
# (continuous features) and speech_tokenizer (WhisperVQ discrete codes).

import json
from dataclasses import dataclass, field

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.whisper_encoder import WhisperEncoderConfig


@dataclass
class WhisperVQConfig:
    """Frozen WhisperVQ speech tokenizer (GLM-4-Voice lineage)."""

    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    activation_function: str = "gelu"
    pooling_kernel_size: int = 4
    pooling_type: str = "avg"
    pooling_position: int = 16
    quantize_vocab_size: int = 16384
    quantize_position: int = 16
    quantize_causal_block_size: int = 200
    encoder_causal_convolution: bool = True
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "WhisperVQConfig":
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class KimiAudioConfig:
    text_config: LlamaConfig = field(default_factory=LlamaConfig)
    speech_encoder_config: WhisperEncoderConfig = field(
        default_factory=WhisperEncoderConfig
    )
    speech_tokenizer_config: WhisperVQConfig = field(default_factory=WhisperVQConfig)
    kimia_mimo_layers: int = 6
    kimia_mimo_audiodelaytokens: int = 5
    kimia_mimo_transformer_from_layer_index: int = 21
    kimia_audio_output_vocab: int = 16896
    kimia_text_output_vocab: int = 152064
    num_audio_special_tokens: int = 512
    num_base_tokens: int = 151643
    kimia_token_offset: int = 152064
    use_whisper_feature: bool = True
    kimia_adaptor_input_dim: int = 5120
    kimia_media_begin: int = 151661
    kimia_media_end: int = 151663
    model_type: str = "kimi_audio"

    @classmethod
    def from_dict(cls, d: dict) -> "KimiAudioConfig":
        # the reference flattens the Qwen2 text fields at the top level
        text_keys = set(LlamaConfig.__dataclass_fields__)
        text = {k: v for k, v in d.items() if k in text_keys}
        text.setdefault("attention_bias", True)  # Qwen2 backbone
        own = {
            k: v
            for k, v in d.items()
            if k in cls.__dataclass_fields__
            and k not in ("text_config", "speech_encoder_config",
                          "speech_tokenizer_config")
        }
        return cls(
            text_config=LlamaConfig.from_dict(text),
            speech_encoder_config=WhisperEncoderConfig.from_dict(
                d.get("speech_encoder_config", {})
            ),
            speech_tokenizer_config=WhisperVQConfig.from_dict(
                d.get("speech_tokenizer_config", {})
            ),
            **own,
        )

    @classmethod
    def from_json_file(cls, path: str) -> "KimiAudioConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        out = dict(self.text_config.to_dict())
        out.update(
            {
                k: getattr(self, k)
                for k in self.__dataclass_fields__
                if k not in ("text_config", "speech_encoder_config",
                             "speech_tokenizer_config")
            }
        )
        out["speech_encoder_config"] = self.speech_encoder_config.__dict__
        out["speech_tokenizer_config"] = self.speech_tokenizer_config.__dict__
        out["model_type"] = "kimi_audio"
        return out
