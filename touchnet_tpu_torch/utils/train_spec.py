# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/utils/train_spec.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# TrainSpec: the function-pointer bundle wiring a model family into the
# trainer.
#
# Capability parity: reference touchnet/utils/train_spec.py:25-68. Pointers
# are adapted to the functional JAX model contract (init/forward instead of
# an nn.Module class):
#   config_cls(path)           -> model config
#   init_params_fn(config,key) -> param pytree (on host or sharded via jit)
#   forward_fn(params, batch-kwargs, config, ...) -> logits
#   param_rules                -> the tensor-parallel plan: fn(model, tp_mesh, log)
#   loss_fn / acc_fn           -> pack CE + accuracy
#   build_dataloader_fn        -> per-model datapipe chain
#   build_tokenizer_fn         -> tokenizer factory
#   get_num_flop_per_token_fn / get_num_params_fn -> telemetry
#   additional_pre_init_fn(model_config, data_config) -> the port's trainer
#                                 calls it before building anything; it
#                                 raises on a data config the model cannot
#                                 take (touch_audio: the feature width)
#   additional_post_init_fn    -> hook (e.g. NaN checks, HF processor)
#   pipelining_fn              -> one pipeline stage on one microbatch:
#                                 fn(model, layer_ids, x, batch, config=,
#                                 compute_dtype=, remat_mode=,
#                                 selective_ac_option=, first=, last=)
#                                 (llama, touch_audio; parallel/pipeline.py)

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

_train_specs: Dict[str, "TrainSpec"] = {}


@dataclass
class TrainSpec:
    name: str
    config_cls: Any
    init_params_fn: Callable
    forward_fn: Callable
    loss_fn: Callable
    acc_fn: Callable
    build_dataloader_fn: Callable
    build_tokenizer_fn: Callable
    get_num_flop_per_token_fn: Callable
    get_num_params_fn: Callable
    param_rules: Any = None
    dp_only: bool = False  # model supports FSDP/DDP only (no tp/cp/pp)
    # batch keys (beyond the universal ones) forwarded into forward_fn
    forward_batch_keys: tuple = ("input_ids", "inputs_embeds")
    # regexes over param paths whose updates are zeroed (frozen submodules,
    # e.g. kimi_audio's WhisperVQ speech tokenizer; is_frozen)
    frozen_params_re: tuple = ()
    # (params, model_config) -> lm_head weight [V, E]; set when forward_fn
    # supports return_hidden=True, enabling the fused linear+CE path
    # (parallel/loss_parallel.py — liger / loss-parallel analog)
    head_weight_fn: Optional[Callable] = None
    pipelining_fn: Optional[Callable] = None
    additional_pre_init_fn: Optional[Callable] = None
    additional_post_init_fn: Optional[Callable] = None
    build_optimizers_fn: Optional[Callable] = None
    build_lr_schedulers_fn: Optional[Callable] = None
    build_metrics_processor_fn: Optional[Callable] = None
    extra: dict = field(default_factory=dict)


def register_train_spec(spec: TrainSpec) -> None:
    if spec.name in _train_specs:
        raise ValueError(f"TrainSpec {spec.name} is already registered")
    _train_specs[spec.name] = spec


def get_train_spec(name: str) -> TrainSpec:
    # model packages self-register on import
    import touchnet_tpu_torch.models.kimi_audio  # noqa: F401
    import touchnet_tpu_torch.models.llama  # noqa: F401
    import touchnet_tpu_torch.models.qwen2_audio  # noqa: F401
    import touchnet_tpu_torch.models.touch_audio  # noqa: F401

    if name not in _train_specs:
        raise ValueError(
            f"TrainSpec {name} not registered; known: {sorted(_train_specs)}"
        )
    return _train_specs[name]


def is_frozen(spec: TrainSpec, name: str) -> bool:
    """Whether the parameter ``name`` (a state_dict key) is one of the
    spec's frozen_params_re: a regex matched at the start of the name with
    "." read as "/", as the JAX trainer matches its tree paths
    (touchnet_tpu/bin/train.py:659-663)."""
    path = name.replace(".", "/")
    return any(re.match(r, path) for r in spec.frozen_params_re)


def apply_to_train_specs(fn: Callable) -> None:
    for name, spec in _train_specs.items():
        _train_specs[name] = fn(spec)
