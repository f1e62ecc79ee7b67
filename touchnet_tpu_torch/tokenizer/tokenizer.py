# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/tokenizer/tokenizer.py (framework-free: numpy and the standard
# library), with its imports pointed at the port: BaseTokenizer,
# RawTokenizer, HuggingFaceTokenizer (transformers is imported on first
# use, so only a run that names an HF tokenizer needs the package) and
# BestRQTokenizer.
#
# Tokenizers: HF text tokenizer wrapper + BEST-RQ training-free audio tokenizer.
#
# Capability parity: reference touchnet/tokenizer/tokenizer.py:20-334.
# BestRQTokenizer draws its frozen projection and codebook from
# torch.Generator().manual_seed(seed) with xavier_uniform_ and normal_, the
# original TouchNet's construction (the JAX package replays that generator
# in numpy, tokenizer/torch_rng.py, which the port does not need), and
# tokenizes in numpy on the CPU inside the dataloader workers, with the JAX
# package's arithmetic, so the two give the same codes.

import json
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Any

import numpy as np

from touchnet_tpu_torch.tokenizer import TokenizerConfig


class BaseTokenizer(ABC):
    """Abstract tokenizer: tokenize/detokenize + vocab + special-token ids."""

    def __init__(self, *tokenizer_paths: str, **tokenizer_options: Any):
        self.unique_identifiers = OrderedDict()
        self.unique_identifiers["class"] = type(self).__name__
        self.unique_identifiers["tokenizer_path"] = list(tokenizer_paths)
        for option in tokenizer_options:
            self.unique_identifiers[option] = str(tokenizer_options[option])
        self.unique_description = json.dumps(self.unique_identifiers, indent=4)
        super().__init__()

    @abstractmethod
    def tokenize(self, inputs: Any):
        ...

    def detokenize(self, ids) -> Any:
        raise NotImplementedError(f"{type(self).__name__} has no method 'detokenize'")

    @property
    @abstractmethod
    def vocab(self):
        ...

    @property
    @abstractmethod
    def inv_vocab(self):
        ...

    @property
    @abstractmethod
    def vocab_size(self):
        ...

    @property
    def cls(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'cls'")

    @property
    def sep(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'sep'")

    @property
    def pad(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'pad'")

    @property
    def eod(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'eod'")

    @property
    def bos(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'bos'")

    @property
    def eos(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'eos'")

    @property
    def mask(self):
        raise NotImplementedError(f"{type(self).__name__} has no attribute 'mask'")


class BestRQTokenizer(BaseTokenizer):
    """BEST-RQ training-free audio tokenizer (arXiv:2202.01855): a frozen
    random projection [input, emb] and an L2-normalized random codebook
    [vocab, emb]; tokenize = project -> L2-normalize -> nearest codeword."""

    def __init__(self, config: TokenizerConfig, **kwargs):
        super().__init__(f"BestRQ-{config.tokenizer_bestrq_init_method}-init", **kwargs)
        self.kwargs = kwargs
        self.config = config
        self._quantizer = None
        self._codebook = None

    def _build_quantizer_and_codebook(self):
        if self._quantizer is None:
            import torch

            cfg = self.config
            if cfg.tokenizer_bestrq_init_method != "default":
                raise NotImplementedError(
                    f"Initialization method {cfg.tokenizer_bestrq_init_method} "
                    "is not implemented.")
            gen = torch.Generator().manual_seed(cfg.tokenizer_bestrq_init_seed)
            quantizer = torch.empty(cfg.tokenizer_bestrq_input_size,
                                    cfg.tokenizer_bestrq_emb_size)
            codebook = torch.empty(cfg.tokenizer_bestrq_vocab_size,
                                   cfg.tokenizer_bestrq_emb_size)
            torch.nn.init.xavier_uniform_(quantizer, generator=gen)
            torch.nn.init.normal_(codebook, generator=gen)
            codebook = codebook.numpy()
            norm = np.maximum(np.linalg.norm(codebook, axis=1, keepdims=True), 1e-8)
            self._quantizer = quantizer.numpy()
            self._codebook = codebook / norm

    @property
    def vocab_size(self):
        self._build_quantizer_and_codebook()
        return self._codebook.shape[0]

    @property
    def vocab(self):
        self._build_quantizer_and_codebook()
        return None

    @property
    def inv_vocab(self):
        self._build_quantizer_and_codebook()
        return self._codebook

    @property
    def decoder(self):
        self._build_quantizer_and_codebook()
        return self._codebook

    def tokenize(self, inputs, **kwargs):
        """inputs: [T, input_size] float array -> list[int] codes of len T."""
        self._build_quantizer_and_codebook()
        xs = np.asarray(inputs, dtype=np.float32) @ self._quantizer  # [T, D]
        xs = xs / np.maximum(np.linalg.norm(xs, axis=-1, keepdims=True), 1e-8)
        # nearest neighbor in L2; both unit-normalized => argmax dot product
        codes = np.argmax(xs @ self._codebook.T, axis=-1)
        return codes.tolist()

    def detokenize(self, token_ids, **kwargs):
        self._build_quantizer_and_codebook()
        return self._codebook[np.asarray(token_ids)]

    @property
    def eos(self):
        return None

    @property
    def bos(self):
        return None

    @property
    def pad(self):
        return None


class RawTokenizer(BaseTokenizer):
    """Identity tokenizer for pre-tokenized (texttoken) pipelines: exposes
    vocab size and special ids without any external model."""

    def __init__(self, config: TokenizerConfig, **kwargs):
        super().__init__("raw", **kwargs)
        self._config = config

    def tokenize(self, inputs, **kwargs):
        return list(inputs)

    def detokenize(self, ids, **kwargs):
        return list(ids)

    @property
    def vocab(self):
        return None

    @property
    def inv_vocab(self):
        return None

    @property
    def vocab_size(self):
        return self._config.tokenizer_raw_vocab_size

    @property
    def bos(self):
        return self._config.tokenizer_raw_bos_id

    @property
    def eos(self):
        return self._config.tokenizer_raw_eos_id

    @property
    def pad(self):
        return self._config.tokenizer_raw_pad_id


class HuggingFaceTokenizer(BaseTokenizer):
    """Lazy AutoTokenizer wrapper (transformers imported on first use)."""

    def __init__(self, config: TokenizerConfig, **kwargs):
        super().__init__(config.tokenizer_model, **kwargs)
        self.pretrained_model_name_or_path = config.tokenizer_model
        self.kwargs = kwargs
        self._tokenizer = None
        self._vocab = None
        self._inv_vocab = None

    def _build_hugging_face(self):
        if self._tokenizer is None:
            import transformers

            self._tokenizer = transformers.AutoTokenizer.from_pretrained(
                pretrained_model_name_or_path=self.pretrained_model_name_or_path,
                trust_remote_code=True,
                **self.kwargs,
            )
            self._vocab = self._tokenizer.get_vocab()
            self._inv_vocab = {tid: tok for tok, tid in self._vocab.items()}

    @property
    def vocab_size(self):
        self._build_hugging_face()
        return len(self._tokenizer)

    @property
    def vocab(self):
        self._build_hugging_face()
        return self._vocab

    @property
    def inv_vocab(self):
        self._build_hugging_face()
        return self._inv_vocab

    @property
    def decoder(self):
        self._build_hugging_face()
        return self._inv_vocab

    def tokenize(self, inputs, **kwargs):
        self._build_hugging_face()
        return self._tokenizer(inputs, **kwargs).input_ids

    def detokenize(self, token_ids, **kwargs):
        self._build_hugging_face()
        return self._tokenizer.decode(token_ids, **kwargs)

    @property
    def eos(self):
        self._build_hugging_face()
        return self._tokenizer.eos_token_id

    @property
    def bos(self):
        self._build_hugging_face()
        return self._tokenizer.bos_token_id

    @property
    def pad(self):
        self._build_hugging_face()
        return self._tokenizer.pad_token_id


def build_tokenizer(args: TokenizerConfig, **kwargs):
    if args.tokenizer_type == "RawTokenizer":
        return RawTokenizer(args, **kwargs)
    if args.tokenizer_type == "HuggingFaceTokenizer":
        return HuggingFaceTokenizer(args, **kwargs)
    if args.tokenizer_type == "BestRQTokenizer":
        return BestRQTokenizer(args, **kwargs)
    raise NotImplementedError(f"{args.tokenizer_type} tokenizer not implemented")
