# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/utils/inference.py (framework-free: numpy and the
# standard library), with its imports pointed at the port: InferenceConfig
# with the same fields and defaults, AudioJsonlDataset, batched,
# prefetch_map, pad_right, part_file and write_results. jnp_dtype becomes
# torch_dtype, which refuses float16 (the kernels take bf16 and f32).
# The port's own: resolve_model_files, which lets the ASR CLIs run stage 4
# of the SFT recipe as run.sh writes it (no config and no tokenizer flag:
# both are read from the export), and load_state_streamed, the strict
# state_dict load that casts on the model's device.
#
# Batch-inference utilities + InferenceConfig.
#
# Capability parity: reference touchnet/utils/inference.py:28-146
# (InferenceConfig, jsonl AudioDataset, DistributedSampler sharding,
# left/right padded batching, per-rank part files). Padding is right-side
# (generate masks by true length, so left padding is unnecessary).

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np


@dataclass
class InferenceConfig:
    model_path: Optional[str] = field(default=None, metadata={"help": "ckpt or HF dir"})
    model_dtype: str = field(default="bfloat16")
    instruct: str = field(default="Generate the transcription:")
    data_list: Optional[str] = field(default=None, metadata={"help": "jsonl path"})
    output_dir: str = field(default="./exp/inference")
    batch_size: int = field(default=8)
    num_workers: int = field(
        default=2,
        metadata={"help": "threads for wav load + feature extraction"},
    )
    prefetch: int = field(
        default=2, metadata={"help": "batches prepared ahead of the device"}
    )
    inference_enable_liger_kernel: bool = field(
        default=False,
        metadata={"help": (
            "accepted for recipe parity; the memory-efficient-logits "
            "behavior liger provides is structurally always on here — "
            "prefill projects logits only at each row's last prompt "
            "position, never the full [B, T, V] tensor"
        )},
    )
    max_length: int = field(
        default=512,
        metadata={"help": (
            "max NEW tokens per utterance. Deviation from the reference "
            "(touchnet/utils/inference.py:92, where HF generate treats it "
            "as the TOTAL length cap and over-long inputs are skipped): "
            "the decode here always grants the full decode budget "
            "regardless of prompt length, so long-audio prompts are "
            "transcribed instead of silently dropped"
        )},
    )
    inference_prefill_chunk: int = field(
        default=0,
        metadata={"help": (
            "0 = single-shot prefill. >0 = chunked prefill: the prompt is "
            "consumed in [B, chunk] steps, each attending the cache prefix "
            "through K1, so peak prefill activations are O(chunk)"
        )},
    )
    training_model_config_path: Optional[str] = field(default=None)
    output_type: str = field(
        default="text",
        metadata={"help": (
            "kimi_audio only: 'text' (ASR; audio stream held at blank, "
            "cheap single-stream decode) or 'both' (dual-stream decode — "
            "samples the mimo audio head too and writes VQ audio codes per "
            "utterance, reference _generate_loop semantics)"
        )},
    )


class AudioJsonlDataset:
    """jsonl of {key, wav, txt?} records, sharded across processes."""

    def __init__(self, jsonl_path: str, rank: int = 0, world_size: int = 1):
        self.samples: List[dict] = []
        with open(jsonl_path) as f:
            for i, line in enumerate(f):
                if i % world_size == rank:
                    self.samples.append(json.loads(line))

    def __len__(self):
        return len(self.samples)

    @staticmethod
    def load(s: dict) -> dict:
        from touchnet_tpu_torch.bin.make_data import load_audio

        wav = load_audio(s["wav"], 16000).astype(np.float32) / 32768.0
        return {**s, "waveform": wav, "sample_rate": 16000}

    def __iter__(self) -> Iterator[dict]:
        for s in self.samples:
            yield self.load(s)


def batched(iterable, batch_size: int):
    buf = []
    for x in iterable:
        buf.append(x)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def prefetch_map(
    fn: Callable,
    items: Iterable,
    num_workers: int = 2,
    prefetch: int = 2,
) -> Iterator:
    """Order-preserving threaded map with bounded lookahead — keeps
    `prefetch` batches of CPU work (wav decode + feature extraction) in
    flight ahead of the device (reference DataLoader num_workers/prefetch,
    touchnet/utils/inference.py:74-85)."""
    if num_workers <= 0:
        for x in items:
            yield fn(x)
        return
    it = iter(items)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = []
        for x in it:
            pending.append(pool.submit(fn, x))
            if len(pending) > max(prefetch, 1):
                yield pending.pop(0).result()
        for f in pending:
            yield f.result()


def torch_dtype(name: str):
    """The torch dtype of --model_dtype: bfloat16, float32 or float16 (the
    JAX CLIs' jnp_dtype; each is a dtype of K1 and K4). Another name raises
    a ValueError."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
    if name not in dtypes:
        raise ValueError(f"model_dtype {name!r}: bfloat16, float32 or float16")
    return dtypes[name]


def pad_right(arrays: List[np.ndarray], pad_value) -> np.ndarray:
    maxlen = max(a.shape[0] for a in arrays)
    out = np.full((len(arrays), maxlen) + arrays[0].shape[1:], pad_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def part_file(output_dir: str, rank: int) -> str:
    os.makedirs(output_dir, exist_ok=True)
    return os.path.join(output_dir, f"part_{rank}")


def write_results(path: str, results: List[dict]):
    with open(path, "w", encoding="utf8") as f:
        for r in results:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


HF_TOKENIZER_FILES = ("tokenizer_config.json", "tokenizer.json")


def resolve_model_files(config: InferenceConfig, tok_config, config_cls, model_type: str):
    """(model config, tokenizer config) of an ASR CLI. Stage 4 of the SFT
    recipe (examples/audio/sft/asr/wenetspeech/run.sh:172-181) passes
    neither --training_model_config_path nor --tokenizer_model: unset, they
    are the export's <model_path>/config.json (read with ``config_cls``) and
    the tokenizer saved beside it (stage 3's --tokenizer_model). A missing
    file raises a ValueError naming the flag that would have given it.
    config_cls.from_dict drops unknown keys and fills defaults, so a file of
    another form would load as a default config without a word: the
    export's config.json must name ``model_type``, and a file named by the
    flag may omit it (the JAX package's config files name it) but not name
    another."""
    if config.model_path is None:
        raise ValueError("--model_path is required: the HF directory of the export")
    path = config.training_model_config_path
    implicit = path is None
    if implicit:
        path = os.path.join(config.model_path, "config.json")
        if not os.path.isfile(path):
            raise ValueError(f"--training_model_config_path is unset and {path} does not "
                             "exist: pass the model config")
    with open(path) as f:
        raw = json.load(f)
    found = raw.get("model_type")
    if found != model_type and (implicit or found is not None):
        raise ValueError(f"{path}: model_type {found!r}, this CLI serves {model_type!r} (a "
                         f"config of another model would load as a default one); pass "
                         f"--training_model_config_path")
    model_config = config_cls.from_dict(raw)
    if tok_config.tokenizer_type == "HuggingFaceTokenizer" and tok_config.tokenizer_model is None:
        if not any(os.path.isfile(os.path.join(config.model_path, n))
                   for n in HF_TOKENIZER_FILES):
            raise ValueError(f"--tokenizer_model is unset and {config.model_path} holds no "
                             f"tokenizer ({' or '.join(HF_TOKENIZER_FILES)}): pass "
                             "--tokenizer_model, or export with convert_ckpt_to_hf "
                             "--tokenizer_model")
        tok_config = dataclasses.replace(tok_config, tokenizer_model=config.model_path)
    return model_config, tok_config


def load_state_streamed(model, state: dict) -> None:
    """model.load_state_dict(state, strict=True) for a model whose storage
    is already on its device, one tensor at a time: each is moved there in
    its stored dtype, then cast there (a cross-device copy that also casts
    converts on the host first, which for an f32 model of a bf16 file is an
    f32 copy of each tensor in host memory). Raises, before any copy, on a
    missing or unexpected key or a shape that differs."""
    import torch

    params = model.state_dict()
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"state dict: missing {missing[:4]}, unexpected {unexpected[:4]}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the model has "
                             f"{tuple(params[name].shape)}")
    with torch.no_grad():
        for name, t in state.items():
            dst = params[name]
            dst.copy_(t.to(dst.device))
