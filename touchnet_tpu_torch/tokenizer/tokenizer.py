# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/tokenizer/tokenizer.py (framework-free: numpy and the standard
# library), with its imports pointed at the port: BaseTokenizer,
# RawTokenizer and HuggingFaceTokenizer (transformers is imported on first
# use, so only a run that names an HF tokenizer needs the package).
# BestRQTokenizer is the audio slice.
#
# Tokenizers: HF text tokenizer wrapper + BEST-RQ training-free audio tokenizer.
#
# Capability parity: reference touchnet/tokenizer/tokenizer.py:20-334.
# BestRQTokenizer is numpy (runs on CPU inside dataloader workers, decoupled
# from the model forward — reference docs/audio_pretrain.md item 3), drawing
# its frozen projection/codebook from a torch-CPU-compatible RNG
# (tokenizer/torch_rng.py) so token ids agree with the reference for the
# same seed — datasets tokenized by either framework interoperate.

import json
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Any

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
        raise NotImplementedError(
            "BestRQTokenizer: the audio tokenizer is ported with the audio slice of "
            "touchnet_tpu_torch")
    raise NotImplementedError(f"{args.tokenizer_type} tokenizer not implemented")
