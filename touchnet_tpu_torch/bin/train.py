# Copyright (c) 2026 touchnet_tpu authors.
# The training binary of the port.
#
#     python -m touchnet_tpu_torch.bin.train <the JAX trainer's flags>
#     torchrun --nproc_per_node N -m touchnet_tpu_torch.bin.train <flags>
#
# Port of touchnet_tpu/bin/train.py: Trainer (:299-481), _loss_and_acc
# (:556-582, the fused-CE route of --training_enable_liger_kernel and the
# full-logits route), _value_and_grad (:592-612), the train step (:645-780)
# with _grads_and_metrics (:702-735) and the eval step (:782-787),
# GlobalBatchLoader (:96-171) with this process's data-parallel stream,
# DevicePrefetcher (:174-220), _AccumBatcher (:223-281),
# _PrefetchStateView (:284), _put_batch
# (:790-859), train with its SIGTERM preemption and watchdogs (:884-942),
# the train loop (:944-1022) with checkpoints, dev evaluation, profiling,
# memory snapshots and GC, dev (:1024-1072) and main. The flags and the
# batch contract are the JAX trainer's (TrainConfig, DataConfig,
# TokenizerConfig). Four model families train: llama (causal_lm
# datapipe), touch_audio (touch_audio datapipe: packed BEST-RQ audio
# pretraining, its input_features cast to the compute dtype by the model),
# qwen2_audio (qwen2_audio datapipe: dynamic_batch's right-padded SFT rows
# with whisper features and feature_attention_mask, the full-logits loss)
# and kimi_audio (kimi_audio datapipe: right-padded rows of two streams,
# text_input_ids and audio_input_ids, with whisper features and
# whisper_attention_mask, the full-logits loss, the speech tokenizer
# frozen); the TrainSpec's additional_pre_init_fn checks the data config
# against the model's (touch_audio: the stacked feature width against the
# projector's input; qwen2_audio and kimi_audio: the mel bins against the
# tower's) before anything is built, the loaders get the model config (the
# qwen2_audio and kimi_audio datapipes check the tokenizer's special ids
# against it), and float batch arrays are checked for NaN/inf on the host
# before they reach the card.
#
# Frozen parameters (the TrainSpec's frozen_params_re; kimi_audio's speech
# tokenizer) get no gradient, no update and no AdamW moments, so they stay
# bit-unchanged and count zero in the gradient norm: the JAX chain zeroes
# their gradients and then their updates, weight decay included
# (touchnet_tpu/bin/train.py:741-771), and holds zero moments for them.
# A trainable tensor the loss does not reach (kimi_audio's mimo stack, its
# norm and head: the forward returns text logits only) has a None gradient,
# read as zero by the norm and by AdamW, which still decays it by lr * wd
# each step, as optax's adamw, which has no mask, decays JAX's
# zero-gradient leaves. With frozen tensors the JAX trainer swaps its fused
# AdamW for the optax chain under any optimizer_impl (:626-634); the port's
# one AdamW computes the chain's update, and a log line says so.
#
# One step: forward (K1 attention) -> pack loss (K3 when fused) -> backward
# (K2, K3) -> global-norm clip min(1, max_norm / (gnorm + 1e-6)) -> AdamW
# with every tensor held when the norm is not finite. The clip scale, the
# finite flag, the schedule's lr and the hold stay on the device: the loop
# reads the device (.item()) only on logging steps.
#
# Resume: with --training_enable_ckpt true a Trainer loads the latest
# step_<N> of <trace_dump_folder>/<ckpt_folder> (or --training_ckpt_load_step
# N) at init: params, AdamW moments and count, the step and the loader
# state, so the run goes on with the batch after the last trained one.
#
# The single-device modes of the JAX trainer:
#   --training_gradient_accumulation_steps G: _AccumBatcher stacks G host
#     batches to [G, B, ...]; the step runs forward and backward per
#     microbatch, each loss normalised by the group's sentence count, and
#     the gradients add up in .grad: exactly the G*B batch's, at the
#     activation memory of B. A checkpoint records the loader after the
#     whole group.
#   --training_mixed_precision_reduce bfloat16: the step differentiates with
#     respect to bf16 copies of the f32 masters (torch.func.functional_call
#     swaps them in for the forward and the backward), so every backward
#     tensor and every gradient is bf16; the norm and AdamW read each
#     gradient as f32 (the upcast at the optimizer boundary, tensor by
#     tensor). Under accumulation each microbatch's bf16 gradients are
#     upcast and summed in f32, as the JAX scan does.
#   --training_enable_cpu_offload: on the card the AdamW moments live in
#     pinned host memory and streamed_adamw_step streams them through the
#     card (ops/fused_adamw.py); the same arithmetic, so the run equals the
#     resident one bit for bit. On the CPU the flag changes nothing.
#
# Data and tensor parallelism (torchrun, one process per card; the layout is
# parallel/dims.py's mesh, the plan parallel/sharding.py's): under torchrun
# the model is wrapped in FSDP2 over the data-parallel ranks, even at world
# 1, so one card runs the code that eight would (JAX applies its shardings
# on a mesh of size 1); llama and touch_audio get the tensor-parallel plan
# first at tp > 1. JAX's one controller assembles the global batch from
# every dp stream (GlobalBatchLoader); here each process builds the stream
# of its own dp rank (ParallelDims.dp_rank), and the step's collectives
# make the rest global:
#   - num_sentence is summed over the dp group before the loss (JAX
#     :131-132), so each rank's loss is its rows over the global count and
#     FSDP's reduction, set to sum, gives the global batch's gradient;
#   - the logged loss_per_sample, loss_per_token and accuracy are the global
#     batch's (the loss's sums summed over dp, values only), the gradient
#     norm the whole gradient's (utils/optimizer.global_grad_norm), so the
#     clip and the non-finite hold decide the same on every rank;
#   - the NaN guard on the batches and SIGTERM's preemption are agreed over
#     the ranks at each step's start (one all-reduce with num_sentence), so
#     every rank raises, or saves and stops, at the same step;
#   - AdamW runs on each DTensor's local shard; checkpoints are sharded DCP
#     with every dp rank's loader state (utils/checkpoint.py);
#   - logs and TensorBoard on rank 0; peak memory the max over ranks.
# Without torchrun's environment (or a process group the caller started)
# the trainer runs on one device as before.
#
# What the port does not run raises a ValueError naming the flag
# (check_supported): context and pipeline parallelism, and float16.

import copy
import json
import os
import queue
import signal
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.llama import check_finite_params
from touchnet_tpu_torch.models.llama.modeling_llama import remat_layers
from touchnet_tpu_torch.ops.fused_adamw import (
    StreamedMoments,
    fused_adamw_step,
    streamed_adamw_step,
)
from touchnet_tpu_torch.parallel.dims import MESH_AXES, ParallelDims
from touchnet_tpu_torch.parallel.loss_parallel import fused_linear_cross_entropy
from touchnet_tpu_torch.parallel.sharding import (
    apply_fsdp,
    dp_mesh_of,
    local,
    on_host,
    reshard,
    sum_forward,
    tp_group,
    vocab_start,
)
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.utils.checkpoint import CheckpointManager, export_weights_only
from touchnet_tpu_torch.utils.cli import dump_config_json, parse_args_into_dataclasses
from touchnet_tpu_torch.utils.distributed import (
    GarbageCollection,
    StepWatchdog,
    init_distributed,
    local_cuda_device,
    rank_and_world,
    set_determinism,
)
from touchnet_tpu_torch.utils.logging import init_logger, logger
from touchnet_tpu_torch.utils.metrics import MetricsProcessor
from touchnet_tpu_torch.utils.optimizer import build_optimizer, global_grad_norm
from touchnet_tpu_torch.utils.profiling import (
    maybe_enable_memory_snapshot,
    maybe_enable_profiling,
)
from touchnet_tpu_torch.utils.train_spec import get_train_spec, is_frozen

_BATCH_ARRAY_KEYS = (
    "input_ids",
    "inputs_embeds",
    "input_features",
    "labels",
    "shift_labels",
    "position_ids",
    "attention_mask",
    "feature_attention_mask",
    "sentence_lens",
    "text_input_ids",
    "audio_input_ids",
    "whisper_input_features",
    "whisper_attention_mask",
)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(job_config: TrainConfig) -> None:
    """Raise a ValueError naming the first flag the port does not run."""
    later = "is a later slice of touchnet_tpu_torch"
    cfg = job_config
    for name, what in (("training_context_parallel_degree", "context parallelism"),
                       ("training_pipeline_parallel_degree", "pipeline parallelism")):
        if getattr(cfg, name) > 1:
            raise ValueError(f"{name}={getattr(cfg, name)}: {what} {later}")
    if cfg.training_mixed_precision_param not in _DTYPES:
        raise ValueError(f"training_mixed_precision_param {cfg.training_mixed_precision_param}: "
                         f"the kernels take bfloat16 or float32; float16 {later}")


# flags the trainer accepts and never reads: set away from their default
# (what the port does), each logs one warning saying so. The layout flags
# of the parallelisms the port does not run (rotate method, pipeline
# schedule and microbatches) are inert at degree 1 here as in the JAX
# trainer on one device, and stay silent; so does async TP at tp 1 (at
# tp > 1 it warns once: the port runs no XLA scheduler it could set).
UNREAD_FLAGS = {
    "training_compile": "the port's step runs eagerly (no torch.compile)",
    "training_enable_compiled_autograd": "the port's step runs eagerly (no compiled autograd)",
    "training_trace_buf_size": "the port writes no XLA comm trace (the JAX trainer's dump "
                               "under <training_trace_dump_folder>/comm_trace)",
}


def warn_unread(job_config: TrainConfig) -> list:
    """Log one warning for each UNREAD_FLAGS flag set away from its default;
    returns their names. Results do not change."""
    fields = type(job_config).__dataclass_fields__
    names = [n for n in UNREAD_FLAGS if getattr(job_config, n) != fields[n].default]
    for name in names:
        logger.warning(f"{name}={getattr(job_config, name)}: {UNREAD_FLAGS[name]}; the flag "
                       "changes nothing")
    if job_config.training_enable_async_tensor_parallel and \
            job_config.training_tensor_parallel_degree > 1:
        # in JAX the flag sets only XLA scheduler flags (:1095-1105)
        names.append("training_enable_async_tensor_parallel")
        logger.warning("training_enable_async_tensor_parallel=True: the port's tensor-parallel "
                       "collectives run in order with the compute; the flag changes nothing")
    return names


class GlobalBatchLoader:
    """This process's part of the global batch: the loader stream of its dp
    rank of dp_degree (JAX's one controller builds all of them)."""

    def __init__(self, build_fn, data_config, tokenizer, split: str, model_config=None,
                 dp_rank: int = 0, dp_degree: int = 1):
        self.dp_degree = dp_degree
        self.loaders = [build_fn(data_config, tokenizer, dp_rank, dp_degree, split,
                                 model_config=model_config)]

    def __iter__(self):
        return iter(self.loaders[0])

    def state_dict(self):
        state = dict(self.loaders[0].state_dict())
        state["world_size"] = self.dp_degree
        return state

    def load_state_dict(self, state):
        self.loaders[0].load_state_dict(state)

    def shutdown(self):
        self.loaders[0].shutdown()


class DevicePrefetcher:
    """Stages the next batches on the device while the current step runs.

    A background thread pulls host batches and runs ``put_fn`` on them; on
    a CUDA device it does so on a copy stream of its own (pinned host
    memory, non-blocking copies) and records an event. ``__next__`` makes
    the compute stream wait on that event and marks every staged tensor as
    used by the compute stream (record_stream), so the allocator does not
    hand its memory out again while the step still reads it.

    Exact resume: each staged item carries the loader state taken right
    after its pull; ``consumed_state`` is the state of the last batch handed
    to the training loop, never of a staged but untrained one."""

    def __init__(self, loader, put_fn, depth: int = 2, device=torch.device("cpu")):
        self.put_fn = put_fn
        self.device = device
        self.queue = queue.Queue(maxsize=max(1, depth))
        self.error = None
        self._done = object()
        self._stop = threading.Event()
        self.consumed_state = copy.deepcopy(loader.state_dict())
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.thread = threading.Thread(target=self._fill, args=(loader,), daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, loader):
        try:
            for batch in loader:
                state = copy.deepcopy(loader.state_dict())
                event = None
                if self.stream is not None:
                    with torch.cuda.stream(self.stream):
                        staged = self.put_fn(batch)
                        event = torch.cuda.Event()
                        event.record(self.stream)
                else:
                    staged = self.put_fn(batch)
                if not self._put((staged, event, state)):
                    return
        except Exception as e:  # surfaced on next()
            self.error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._done:
            if self.error is not None:
                raise self.error
            raise StopIteration
        staged, event, state = item
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in staged[0].values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(compute)
        self.consumed_state = state
        return staged

    def close(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=10.0)


class _AccumBatcher:
    """Gradient accumulation's loader: pulls G host batches and stacks every
    array to [G, B, ...], summing num_sentence so each microbatch loss is
    normalised by the group's sentence count. A trailing partial group is
    dropped. state_dict reads through to the real loader, so a checkpoint
    taken after a group resumes at the next group."""

    def __init__(self, loader, accum: int):
        self.loader = loader
        self.accum = accum

    def __iter__(self):
        it = iter(self.loader)
        while True:
            parts = []
            for _ in range(self.accum):
                try:
                    parts.append(next(it))
                except StopIteration:
                    return
            batch: Dict[str, Any] = {}
            for key in parts[0]:
                vals = [p[key] for p in parts]
                if key == "num_sentence":
                    batch[key] = int(sum(vals))
                elif vals[0] is None:
                    batch[key] = None
                elif isinstance(vals[0], np.ndarray):
                    try:
                        batch[key] = np.stack(vals, axis=0)
                    except ValueError as e:
                        raise ValueError(
                            "gradient accumulation requires static batch shapes; key "
                            f"`{key}` varies across microbatches ({[v.shape for v in vals]}): "
                            "dynamic-batch datapipes are unsupported with "
                            "training_gradient_accumulation_steps > 1") from e
                else:
                    batch[key] = vals
            yield batch

    def state_dict(self):
        return self.loader.state_dict()

    def load_state_dict(self, state):
        self.loader.load_state_dict(state)


def _dp_group(pd: ParallelDims, rank: int):
    """The group of the ranks that share this rank's tp (and pp, cp)
    coordinates: the data-parallel ranks, over which num_sentence and the
    loss's sums are summed. Every rank creates every group, in one order."""
    mine = None
    others = ("pp", "cp", "tp")
    key = tuple(pd.coords(rank)[a] for a in others)
    groups = {}
    for r in range(pd.world_size):
        groups.setdefault(tuple(pd.coords(r)[a] for a in others), []).append(r)
    for k, ranks in sorted(groups.items()):
        g = dist.new_group(ranks)
        if k == key:
            mine = g
    return mine


def _grads_of(leaves):
    """The leaves' gradients; None where the loss does not reach a leaf (the
    norm and AdamW read it as zero, with no tensor of zeros allocated)."""
    return [p.grad for p in leaves]


class _Reparametrized(torch.nn.Module):
    """functional_call's handle on the model: forward(fn) runs fn while the
    model's parameters are the tensors functional_call was given."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn()


class _PrefetchStateView:
    """The loader as the CheckpointManager sees it during training: its
    state is the prefetcher's consumed_state (the last trained batch, never
    a staged one); a loaded state goes to the real loader."""

    def __init__(self, prefetcher, loader):
        self.prefetcher = prefetcher
        self.loader = loader

    def state_dict(self):
        return self.prefetcher.consumed_state

    def load_state_dict(self, state):
        self.loader.load_state_dict(state)


class Trainer:
    def __init__(self, tokenizer_config: TokenizerConfig, data_config: DataConfig,
                 job_config: TrainConfig, device: Optional[torch.device] = None):
        self.job_config = job_config
        self.data_config = data_config
        self.tokenizer_config = tokenizer_config
        job_config.validate()
        check_supported(job_config)
        init_logger(os.path.join(job_config.training_trace_dump_folder, "touchnet_train.log"))
        warn_unread(job_config)
        self.gc_handler = GarbageCollection(job_config.training_gc_freq)
        if device is None:
            device = local_cuda_device()  # cuda:LOCAL_RANK; raises without a card
        self.device = device
        started_here = not dist.is_initialized()
        # under a process group the model is wrapped in FSDP2, even at world 1
        self.fsdp = init_distributed(device, job_config.training_init_timeout_seconds)
        self._owns_group = started_here and self.fsdp  # close() ends it
        self.rank, self.world = rank_and_world()
        self.parallel_dims = ParallelDims(
            dp_replicate=job_config.training_data_parallel_replicate_degree,
            dp_shard=job_config.training_data_parallel_shard_degree,
            cp=job_config.training_context_parallel_degree,
            tp=job_config.training_tensor_parallel_degree,
            pp=job_config.training_pipeline_parallel_degree,
            world_size=self.world,
            enable_loss_parallel=job_config.training_enable_loss_parallel)
        pd = self.parallel_dims
        self.dp_group = self.host_group = self.ckpt_group = self.mesh = None
        if self.fsdp:
            self.mesh = pd.build_mesh(device.type)
            self.dp_group = _dp_group(pd, self.rank)
            # the loop's agreements (num_sentence, the NaN guard, the end of
            # the data, SIGTERM): gloo over every rank, on the host
            self.host_group = dist.new_group(backend="gloo")
            # DCP's collectives, also from the async save's thread: gloo, a
            # group of their own, never interleaved with the step's
            self.ckpt_group = dist.new_group(backend="gloo")
        logger.info(f"job: {job_config.training_description}")
        logger.info("device: " + (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"))
        logger.info(f"mesh {dict(zip(MESH_AXES, pd.shape))} over {self.world} rank(s); this is "
                    f"rank {self.rank}, dp rank {pd.dp_rank(self.rank)} of {pd.dp_degree}"
                    + ("" if self.fsdp else " (no process group)"))
        if job_config.training_print_args:
            for cfg_obj in (tokenizer_config, data_config, job_config):
                logger.info(f"{type(cfg_obj).__name__}: {cfg_obj}")
        set_determinism(job_config.training_seed, job_config.training_deterministic)

        self.train_spec = get_train_spec(job_config.training_model_name)
        self.model_config = self.train_spec.config_cls.from_json_file(
            job_config.training_model_config_path)
        if self.train_spec.additional_pre_init_fn is not None:
            self.train_spec.additional_pre_init_fn(self.model_config, data_config)
        self.compute_dtype = _DTYPES[job_config.training_mixed_precision_param]
        # an unknown remat mode or option raises here, before any work
        backbone = getattr(self.model_config, "text_config", self.model_config)
        remat_layers(job_config.training_activation_checkpoint_mode,
                     job_config.training_activation_checkpoint_selective_ac_option,
                     backbone.num_hidden_layers)
        dump_dir = job_config.training_trace_dump_folder
        for name, cfg in (("tokenizer_config", tokenizer_config),
                          ("data_config", data_config), ("train_config", job_config)):
            dump_config_json(cfg, os.path.join(dump_dir, f"{name}.json"))

        self.tokenizer = self.train_spec.build_tokenizer_fn(tokenizer_config)
        self.dataloader = self._loader("train")
        self.has_dev = data_config.datalist_dev_path is not None
        self.metrics_processor = MetricsProcessor(job_config, device,
                                                  non_data_parallel_size=pd.non_data_parallel_size)

        # f32 master weights from a seeded generator on the device
        gen = torch.Generator(device=device).manual_seed(job_config.training_seed)
        self.model = self.train_spec.init_params_fn(
            self.model_config, gen, torch.float32, device, requires_grad=True, train=True)
        check_finite_params(self.model)
        # frozen tensors (frozen_params_re) take no gradient, no AdamW update
        # and no moments: they stay bit-unchanged, as the JAX chain zeroes
        # their gradients and their updates (:741-771); checkpoints hold them
        frozen = [p for n, p in self.model.named_parameters() if is_frozen(self.train_spec, n)]
        for p in frozen:
            p.requires_grad_(False)
        if frozen:
            logger.info(f"frozen (frozen_params_re {self.train_spec.frozen_params_re}): "
                        f"{len(frozen)} tensors, {sum(p.numel() for p in frozen):,} params; no "
                        "gradient, update or moments")
            if job_config.optimizer_impl in ("fused", "foreach"):
                logger.info(f"optimizer_impl {job_config.optimizer_impl} with frozen params: "
                            "the optax chain's semantics apply (the JAX trainer turns its fused "
                            "AdamW off): clip, AdamW with weight decay on every trainable "
                            "tensor, the frozen ones untouched")
        self.accum = job_config.training_gradient_accumulation_steps
        self.reduce_dtype = _DTYPES[job_config.training_mixed_precision_reduce]
        self._reparam = _Reparametrized(self.model)
        head_w = (self.train_spec.head_weight_fn(self.model, self.model_config)
                  if self.train_spec.head_weight_fn is not None else None)
        # the module holding the head (its tp group and vocab shard)
        self._head = None if head_w is None else next(
            m for m in self.model.modules() if getattr(m, "weight", None) is head_w)
        if self.fsdp:
            self._parallelize()
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        num_params = self.train_spec.get_num_params_fn(self.model_config)
        num_params_wo_emb = self.train_spec.get_num_params_fn(
            self.model_config, exclude_embedding=True)
        seq_len = (data_config.dataset_text_seqlen if data_config.datapipe_type == "causal_lm"
                   else data_config.dataset_audio_seqlen)
        self.num_flop_per_token = self.train_spec.get_num_flop_per_token_fn(
            num_params_wo_emb, self.model_config, seq_len)
        self.metrics_processor.num_flop_per_token = self.num_flop_per_token
        logger.info(f"model {self.train_spec.name}: {num_params / 1e6:.1f}M params, "
                    f"{self.num_flop_per_token / 1e9:.2f} GFLOP/token")

        self.opt = build_optimizer(job_config)
        self.offload = None
        if job_config.training_enable_cpu_offload and device.type == "cuda":
            # the moments of each local shard, in pinned host memory; the
            # checkpoint sees them as DTensors laid out as their params
            self.offload = StreamedMoments([local(p) for p in self.params])
            self.mu = [on_host(p, m) for p, m in zip(self.params, self.offload.mu)]
            self.nu = [on_host(p, v) for p, v in zip(self.params, self.offload.nu)]
            logger.info(f"cpu offload: AdamW moments in pinned host memory "
                        f"({self.offload.pinned_bytes / 1e9:.2f} GB), streamed through the "
                        "card each step")
        else:
            if job_config.training_enable_cpu_offload:
                logger.info("cpu offload: the device is the CPU, where the moments live "
                            "already; the flag changes nothing")
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.step = 0

        self.checkpointer = CheckpointManager(self.dataloader, job_config,
                                              group=self.ckpt_group)
        loaded = self.checkpointer.load(self._model_state(), self._opt_state())
        self.step = loaded["step"]
        if loaded["loaded"]:
            check_finite_params(self.model)

    def _loader(self, split: str) -> "GlobalBatchLoader":
        pd = self.parallel_dims
        return GlobalBatchLoader(self.train_spec.build_dataloader_fn, self.data_config,
                                 self.tokenizer, split, self.model_config,
                                 dp_rank=pd.dp_rank(self.rank), dp_degree=pd.dp_degree)

    def _parallelize(self) -> None:
        """The plan of parallel/sharding.py: the TrainSpec's tensor-parallel
        plan (llama, touch_audio) at tp > 1, then FSDP2 over the data ranks
        with this run's dtypes; the bf16 casts and reductions are FSDP's
        MixedPrecisionPolicy then."""
        pd, cfg = self.parallel_dims, self.job_config
        if pd.tp > 1:
            if self.train_spec.param_rules is not None:
                self.train_spec.param_rules(self.model, self.mesh["tp"], log=logger.info)
            else:
                logger.info(f"{self.train_spec.name} has no tensor-parallel plan (FSDP/HSDP/DDP "
                            f"only): training_tensor_parallel_degree={pd.tp} leaves its weights "
                            "replicated over tp")
        apply_fsdp(self._reparam, self.model, dp_mesh_of(self.mesh, pd.dp_replicate),
                   param_dtype=self.compute_dtype, reduce_dtype=self.reduce_dtype,
                   reshard_after_forward=cfg.training_fsdp_reshard_after_forward)
        logger.info(f"FSDP2 over dp_replicate {pd.dp_replicate} x dp_shard {pd.dp_shard} "
                    f"(reshard_after_forward {cfg.training_fsdp_reshard_after_forward}, "
                    f"params {self.compute_dtype}, reduce {self.reduce_dtype}, sum), tp {pd.tp}")

    def _model_state(self) -> Dict[str, torch.Tensor]:
        """The model's tensors by name, as the checkpoint holds them (under
        FSDP the shards: every unit is resharded first)."""
        if self.fsdp:
            reshard(self._reparam)
        return self.model.state_dict()

    def _opt_state(self) -> Dict[str, torch.Tensor]:
        """The AdamW state by name, as the checkpoint holds it."""
        state = {f"mu.{n}": m for n, m in zip(self.param_names, self.mu)}
        state.update({f"nu.{n}": v for n, v in zip(self.param_names, self.nu)})
        state["count"] = self.count
        return state

    # ------------------------------------------------------------------
    @property
    def _fused_ce(self) -> bool:
        """Fused linear + CE (K3) under the liger flag, or under loss
        parallel at tp > 1, as the JAX trainer (:484-497)."""
        cfg, pd = self.job_config, self.parallel_dims
        wanted = cfg.training_enable_liger_kernel or pd.loss_parallel_enabled
        return wanted and self._head is not None

    def _forward(self, batch, return_hidden: bool = False):
        cfg = self.job_config
        kwargs = dict(
            segment_ids=batch.get("attention_mask"),
            position_ids=batch.get("position_ids"),
            config=self.model_config,
            compute_dtype=self.compute_dtype,
            remat_mode=cfg.training_activation_checkpoint_mode,
            selective_ac_option=cfg.training_activation_checkpoint_selective_ac_option,
            return_hidden=return_hidden,
        )
        for key in self.train_spec.forward_batch_keys:
            if batch.get(key) is not None:
                kwargs[key] = batch[key]
        return self.train_spec.forward_fn(self.model, **kwargs)

    def _loss_and_acc(self, batch, num_sentence):
        """(loss_per_sample, loss_per_token, acc) of the global batch: the
        fused lm-head + CE when enabled, otherwise the full-logits pack
        loss. Under FSDP it runs inside the root unit's forward, which
        gathers the parameters no layer holds (embeddings, norm, head)."""
        if self.fsdp:
            return self._reparam(lambda: self._local_loss_and_acc(batch, num_sentence))
        return self._local_loss_and_acc(batch, num_sentence)

    def _local_loss_and_acc(self, batch, num_sentence):
        if self._fused_ce:
            hidden = self._forward(batch, return_hidden=True)
            head = self._head
            return fused_linear_cross_entropy(
                hidden, local(head.weight), batch["labels"], batch["sentence_lens"],
                num_sentence, compute_dtype=self.compute_dtype, tp_group=tp_group(head),
                vocab_start=vocab_start(head), dp_group=self.dp_group)
        logits = self._forward(batch)
        loss_ps, loss_pt = self.train_spec.loss_fn(
            logits, batch["labels"], batch["sentence_lens"], num_sentence)
        acc = self.train_spec.acc_fn(logits, batch["labels"])
        if self.dp_group is None:
            return loss_ps, loss_pt, acc
        # the global batch's values (the gradient stays this rank's rows):
        # per-sample sums, per-token loss and accuracy weighted by tokens
        ntok = (batch["labels"] != -100).sum().double()
        vals = sum_forward(torch.stack([loss_ps.double(), loss_pt.detach() * ntok,
                                        acc.detach() * ntok, ntok]), self.dp_group)
        n = vals[3].clamp(min=1)
        return vals[0].float(), (vals[1] / n).float(), (vals[2] / n).float()

    def _loss_backward(self, batch, num_sentence):
        """Forward and backward of one microbatch; its metrics, detached."""
        loss_ps, loss_pt, acc = self._loss_and_acc(batch, num_sentence)
        loss_ps.backward()
        return loss_ps.detach(), loss_pt.detach(), acc.detach()

    def _microbatch(self, batch, num_sentence):
        """(leaves, metrics) of one microbatch. Under bf16 reduction the
        leaves are fresh bf16 copies of the masters, swapped into the model
        for the forward and the backward alike (so a remat recompute reads
        them too), and their .grad is bf16; otherwise they are the masters."""
        if self.reduce_dtype == torch.float32 or self.fsdp:  # FSDP: its reduce dtype
            return self.params, self._loss_backward(batch, num_sentence)
        leaves = [p.detach().to(self.reduce_dtype).requires_grad_() for p in self.params]
        low = {f"model.{n}": t for n, t in zip(self.param_names, leaves)}
        metrics = torch.func.functional_call(
            self._reparam, low, (lambda: self._loss_backward(batch, num_sentence),))
        return leaves, metrics

    def _grads_and_metrics(self, batch, num_sentence):
        """(grads, loss_per_sample, loss_per_token, acc) of one step: the
        batch, or its G slices of the leading axis under accumulation. With
        G=1 the gradients are the leaves' (bf16 under bf16 reduction; the
        norm and AdamW read them as f32). With G>1 they add up in the
        masters' f32 .grad; under bf16 reduction each microbatch's bf16
        gradients are upcast as they are added, as the JAX scan sums them in
        f32. The per-sample loss is the sum over microbatches (each
        normalised by the group's sentence count), the per-token loss and
        acc the mean."""
        if self.accum == 1:
            leaves, metrics = self._microbatch(batch, num_sentence)
            return (_grads_of(leaves), *metrics)
        sums = None
        for g in range(self.accum):
            mb = {k: (v[g] if v is not None else None) for k, v in batch.items()}
            leaves, metrics = self._microbatch(mb, num_sentence)
            if leaves is not self.params:
                for p, leaf in zip(self.params, leaves):
                    if leaf.grad is None:
                        continue
                    if p.grad is None:
                        p.grad = leaf.grad.float()
                    else:
                        p.grad.add_(leaf.grad)
            vals = [x.float() for x in metrics]
            sums = vals if sums is None else [a + b for a, b in zip(sums, vals)]
        return _grads_of(self.params), sums[0], sums[1] / self.accum, sums[2] / self.accum

    def train_step(self, batch: Dict[str, torch.Tensor], num_sentence: float) -> dict:
        """One optimizer step; returns the step's metrics as device tensors.
        Every optimizer_impl runs the same single-pass AdamW (the JAX
        'for-loop' optax chain computes the same update)."""
        grads, loss_ps, loss_pt, acc = self._grads_and_metrics(batch, num_sentence)
        gnorm = global_grad_norm(grads)
        scale = torch.clamp(self.job_config.training_max_norm / (gnorm + 1e-6), max=1.0)
        finite = torch.isfinite(gnorm)
        ob = self.opt
        # the update writes params and moments in place: not before a
        # pending checkpoint's staging copies have read them
        self.checkpointer.maybe_wait_for_staging()
        hyper = dict(lr=ob.schedule(self.count), b1=ob.b1, b2=ob.b2, eps=ob.eps,
                     weight_decay=ob.weight_decay, clip_scale=scale, finite=finite)
        # each DTensor's local shard (FSDP's, TP's): the update is elementwise
        grads = [None if g is None else local(g) for g in grads]
        params = [local(p) for p in self.params]
        with torch.no_grad():
            if self.offload is not None:
                self.count = streamed_adamw_step(grads, params, self.offload, self.count,
                                                 **hyper)
            else:
                self.count = fused_adamw_step(grads, params, [local(m) for m in self.mu],
                                              [local(v) for v in self.nu], self.count,
                                              **hyper)
        for p in self.params:
            p.grad = None
        return {
            "loss/per_sample": loss_ps,
            "loss/per_token": loss_pt,
            "acc": acc,
            "grad_norm": gnorm,
            "lr": ob.schedule(self.step),
        }

    # ------------------------------------------------------------------
    def _put_batch(self, batch: Dict[str, Any]):
        """Host batch -> (device tensors, this rank's num_sentence), after
        the NaN guard on float arrays, which raises here."""
        device_batch, num_sentence, bad = self._stage_batch(batch)
        if bad is not None:
            raise ValueError(f"NaN/inf in data batch `{bad}`.")
        return device_batch, num_sentence

    def _stage_batch(self, batch: Dict[str, Any]):
        """Host batch -> (device tensors (int32 buffers stay int32), this
        rank's num_sentence, the first float array holding NaN/inf or None).
        Runs on the prefetcher's thread, so it raises nothing for the NaN
        guard: the loop agrees on it over the ranks first
        (_global_batch)."""
        arrays = {k: batch[k] for k in _BATCH_ARRAY_KEYS
                  if isinstance(batch.get(k), np.ndarray)}
        bad = next((k for k, a in arrays.items()
                    if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all()), None)
        cuda = self.device.type == "cuda"
        device_batch = {}
        for k, a in arrays.items():
            t = torch.from_numpy(a)
            device_batch[k] = t.pin_memory().to(self.device, non_blocking=True) if cuda else t
        for k in _BATCH_ARRAY_KEYS:
            device_batch.setdefault(k, None)
        return device_batch, float(batch.get("num_sentence", 0)), bad

    def _agree(self, *vals: float) -> list:
        """``vals`` summed over every rank, on the host: a gloo all-reduce on
        the main thread, which never waits for the card."""
        if self.host_group is None:
            return list(vals)
        t = torch.tensor(vals, dtype=torch.float64)
        dist.all_reduce(t, group=self.host_group)
        return t.tolist()

    def _global_batch(self, num_sentence: float, bad: Optional[str], ended: bool):
        """(global num_sentence, whether a rank's loader ran dry), so every
        rank stops at the same step; raises on every rank when any rank's
        batch holds NaN/inf (JAX :131-132; the guard :804-811). The ranks
        of a tp group hold one batch: the sum over every rank counts each
        dp rank's sentences non_data_parallel_size times (exact in f64)."""
        total, n_bad, n_ended = self._agree(num_sentence, float(bad is not None), float(ended))
        total /= self.parallel_dims.non_data_parallel_size
        if n_bad:
            raise ValueError(f"NaN/inf in data batch `{bad}`." if bad is not None
                             else "NaN/inf in another data-parallel rank's batch.")
        return total, n_ended > 0

    def train(self):
        cfg = self.job_config
        total_steps = cfg.lr_scheduler_steps
        logger.info(f"training starts at step {self.step + 1}/{total_steps}")
        # preemption: SIGTERM saves at the next step boundary and exits
        self._sigterm = False
        self._preempted = False

        def on_sigterm(signum, frame):
            self._sigterm = True
            logger.warning("SIGTERM received; checkpointing at the next step boundary, then "
                           "exiting")

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        # step 1 (kernel builds, allocator warm-up) gets the init timeout and
        # never aborts; the steps after it the train timeout
        watchdog = StepWatchdog(cfg.training_train_timeout_seconds,
                                cfg.training_trace_dump_folder,
                                abort=cfg.training_abort_on_timeout)
        init_watchdog = StepWatchdog(cfg.training_init_timeout_seconds,
                                     cfg.training_trace_dump_folder, abort=False)

        def stage(batch):
            ntokens = int((batch["labels"] != -100).sum())
            device_batch, num_sentence, bad = self._stage_batch(batch)
            return device_batch, num_sentence, bad, ntokens

        loader = self.dataloader
        if self.accum > 1:
            loader = _AccumBatcher(loader, self.accum)
        data_iter = DevicePrefetcher(loader, stage,
                                     depth=self.data_config.dataloader_device_prefetch,
                                     device=self.device)
        # checkpoints record the state of the last trained batch
        self.checkpointer.dataloader = _PrefetchStateView(data_iter, self.dataloader)
        try:
            self._train_loop(data_iter, total_steps, watchdog, init_watchdog)
        finally:
            data_iter.close()
            self.checkpointer.dataloader = self.dataloader
            watchdog.close()
            init_watchdog.close()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        if cfg.training_ckpt_model_weights_only and self.checkpointer.enabled:
            self.checkpointer.wait_until_finished()
            export_weights_only(self._model_state(),
                                os.path.join(self.checkpointer.folder, "weights_only"),
                                cfg.training_ckpt_export_dtype, group=self.ckpt_group)
        self.checkpointer.wait_until_finished()
        self._write_summary()
        logger.info("training completed")

    def _write_summary(self) -> None:
        """<dump>/train_summary_rank<R>.json: this process's logged lines,
        dev lines, kernel launches and checkpoint times, for a caller that
        ran the trainer in another process (torchrun)."""
        from touchnet_tpu_torch.ops import attention, fused_ce

        mp = self.metrics_processor
        summary = {
            "rank": self.rank, "world": self.world, "step": self.step,
            "history": mp.history, "dev_history": mp.dev_history,
            "launches": {"K1": attention.flash_attention.launches,
                         "K2": attention.flash_attention_bwd.launches,
                         "K3 fwd": fused_ce.fused_ce_fwd.launches,
                         "K3 bwd": fused_ce.fused_ce_bwd.launches},
            "checkpoint_times": {str(k): v for k, v in self.checkpointer.times.items()},
        }
        path = os.path.join(self.job_config.training_trace_dump_folder,
                            f"train_summary_rank{self.rank}.json")
        with open(path, "w") as f:
            json.dump(summary, f)

    def _next_batch(self, data_iter):
        """The next staged batch with the global num_sentence, or None when
        a rank's loader is exhausted."""
        try:
            device_batch, num_sentence, bad, ntokens = next(data_iter)
        except StopIteration:
            device_batch, num_sentence, bad, ntokens = None, 0.0, None, 0
        total, ended = self._global_batch(num_sentence, bad, device_batch is None)
        return None if ended else (device_batch, total, ntokens)

    def _train_loop(self, data_iter, total_steps, watchdog, init_watchdog):
        cfg = self.job_config
        mp = self.metrics_processor
        metrics, logged = None, True
        with maybe_enable_profiling(cfg, self.device) as profiler, \
                maybe_enable_memory_snapshot(cfg, self.step, self.device) as mem_profiler:
            while self.step < total_steps:
                self.gc_handler.run(self.step)
                (init_watchdog if self.step < 2 else watchdog).arm()
                t0 = time.perf_counter()
                item = self._next_batch(data_iter)
                if item is None:
                    logger.info("dataloader exhausted; ending training")
                    break
                device_batch, num_sentence, ntokens = item
                mp.data_loading_times.append(time.perf_counter() - t0)
                mp.ntokens_since_last_log += ntokens
                mp.steps_since_last_log += 1
                self.step += 1
                metrics = self.train_step(device_batch, num_sentence)
                logged = mp.should_log(self.step)
                if logged:
                    mp.log(self.step, metrics)
                init_watchdog.disarm()
                watchdog.disarm()
                # a SIGTERM on any rank preempts every rank after this step
                self._preempted = self._agree(float(self._sigterm))[0] > 0
                saved = self.save(force=self.step == total_steps or self._preempted)
                if profiler is not None:
                    profiler.step(self.step)
                if mem_profiler is not None:
                    mem_profiler.step(self.step)
                if saved and self.has_dev:
                    self.dev()
                if self._preempted:
                    logger.warning(f"exiting on preemption at step {self.step} (checkpoint "
                                   f"{'saved' if saved else 'DISABLED'})")
                    break
        if not logged:
            mp.log(self.step, metrics)

    def save(self, force: bool = False) -> bool:
        """The checkpoint of this step, if the cadence (or force) says so."""
        return self.checkpointer.save(
            self.step, self._model_state(), self._opt_state(), force=force,
            before_stage=self.offload.synchronize if self.offload is not None else None)

    @torch.no_grad()
    def dev(self):
        """The dev-set pass (the JAX Trainer.dev, :1024-1072): the eval step
        (_loss_and_acc, forward only: K1 and K3's forward on the card) over
        every batch of datalist_dev_path (never stacked, whatever the
        accumulation), averaged, logged as one [dev] line. Each rank reads
        its dp rank's dev stream; the ranks stop together when one runs
        dry, and each batch's metrics are the global batch's."""
        dev_loader = self._loader("dev")
        totals = {"loss_per_sample": 0.0, "loss_per_token": 0.0, "acc": 0.0}
        n = 0
        it = iter(dev_loader)
        try:
            while True:
                batch = next(it, None)
                device_batch, num_sentence, bad = (self._stage_batch(batch) if batch is not None
                                                   else (None, 0.0, None))
                num_sentence, ended = self._global_batch(num_sentence, bad, batch is None)
                if ended:
                    break
                loss_ps, loss_pt, acc = self._loss_and_acc(device_batch, num_sentence)
                for k, v in zip(totals, (loss_ps, loss_pt, acc)):
                    totals[k] += float(v)
                n += 1
        finally:
            dev_loader.shutdown()
        if n:
            self.metrics_processor.log_dev(self.step, {k: v / n for k, v in totals.items()})

    def close(self):
        """Waits for a pending checkpoint write (raising its error)."""
        try:
            self.checkpointer.close()
        finally:
            self.dataloader.shutdown()
            self.gc_handler.close()
            self.metrics_processor.close()
            if self._owns_group:
                dist.destroy_process_group()


def main(argv: Optional[list] = None, device: Optional[torch.device] = None) -> Trainer:
    """Parse the flags and train; the device is the card unless the caller
    names another (Trainer raises when there is no card)."""
    tokenizer_config, data_config, job_config = parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    trainer = Trainer(tokenizer_config, data_config, job_config, device)
    try:
        trainer.train()
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
