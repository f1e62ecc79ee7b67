# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/tokenizer/__init__.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# Tokenizer configuration.
#
# Capability parity: reference touchnet/tokenizer/__init__.py:7-64.

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TokenizerConfig:
    tokenizer_model: Optional[str] = field(
        default=None, metadata={"help": "HF tokenizer path (HuggingFaceTokenizer)"}
    )
    tokenizer_type: str = field(
        default="HuggingFaceTokenizer",
        metadata={"help": "HuggingFaceTokenizer | BestRQTokenizer"},
    )
    tokenizer_bestrq_vocab_size: int = field(default=8192)
    tokenizer_bestrq_input_size: int = field(default=560)
    tokenizer_bestrq_emb_size: int = field(default=16)
    tokenizer_bestrq_init_seed: int = field(default=2025)
    tokenizer_bestrq_init_method: str = field(default="default")
    # RawTokenizer: pre-tokenized streams (texttoken datatype) without an HF
    # tokenizer dependency — ids pass through, only special ids are needed.
    tokenizer_raw_vocab_size: int = field(default=32768)
    tokenizer_raw_bos_id: int = field(default=1)
    tokenizer_raw_eos_id: int = field(default=2)
    tokenizer_raw_pad_id: int = field(default=0)
