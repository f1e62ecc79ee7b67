# Copyright (c) 2026 touchnet_tpu authors.
# Llama model configuration (HF-style JSON).
#
# A copy of touchnet_tpu/models/llama/configuration_llama.py with the same
# JSON schema, so the same config files load in both packages. Copied, not
# imported: importing the JAX package's module runs
# touchnet_tpu/models/__init__.py, which registers every family and imports
# jax.
#
# attn_implementation: "flash" or "eager", kept so the JAX package's config
# files load and round-trip. Neither the training forward nor serving reads
# it: on the card both always go through the CUDA kernels, and for CPU
# tensors the wrappers take their plain versions. The JAX package's "flash_static" and
# "flash_grouped" are TPU layout variants of the same computation (static
# grid vs dynamic trip count, and a grouped-IO layout), so both load as
# "flash".

import json
from dataclasses import dataclass
from typing import Optional

_ATTN_ALIASES = {"flash_static": "flash", "flash_grouped": "flash"}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None  # HF llama3 frequency scaling
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    initializer_range: float = 0.02
    attn_implementation: str = "flash"  # flash | eager
    model_type: str = "llama"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        impl = _ATTN_ALIASES.get(self.attn_implementation,
                                 self.attn_implementation)
        if impl not in ("flash", "eager"):
            raise ValueError(
                f"attn_implementation {self.attn_implementation!r}: "
                "expected 'flash' or 'eager'"
            )
        self.attn_implementation = impl

    @classmethod
    def from_dict(cls, d: dict) -> "LlamaConfig":
        names = {f.name for f in cls.__dataclass_fields__.values()}
        known = {k: v for k, v in d.items() if k in names}
        # HF configs carry an _attn_implementation key
        if "_attn_implementation" in d:
            impl = d["_attn_implementation"]
            known["attn_implementation"] = (
                "flash" if impl in ("flex_attention", "sdpa", "flash_attention_2",
                                    "flash") else "eager"
            )
        return cls(**known)

    @classmethod
    def from_json_file(cls, path: str) -> "LlamaConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}
