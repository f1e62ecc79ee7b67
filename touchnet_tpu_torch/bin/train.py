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
# Context parallelism (--training_context_parallel_degree cp, llama and
# touch_audio): the cp ranks of one dp rank load the same rows (dp_rank is
# cp-free, JAX's DP_CP) and each keeps its [r*T/cp, (r+1)*T/cp) slice of
# every per-position array (_stage_batch, context_parallel.split_sequence:
# JAX's batch_specs; a T that cp does not divide raises, where JAX would
# leave the array unsplit). Each Llama stack attends over its cp group by
# --training_context_parallel_rotate_method (context_parallel.apply_cp:
# allgather or the ring, alltoall); FSDP2 shards over dp_shard x cp; the
# loss's four sums are summed over dp x cp (the loss group), num_sentence
# counted over dp only (the cp ranks share rows). tps and MFU count, as
# JAX's metrics do, the dp rank's tokens over the non-data-parallel ranks
# (cp x tp x pp).
#
# Pipeline parallelism (--training_pipeline_parallel_degree S, llama and
# touch_audio; parallel/pipeline.py): each pp rank builds the layers of its
# stages only (modeling_llama.init_params(layers=...): the held tensors get
# the numbers the whole model would, and keep their global names, so
# checkpoints and exports do not depend on S) and every rank holds the
# embeddings, the final norm, the head (and touch_audio's projector). The
# pp ranks of one dp rank load the same rows (dp_rank is pp-free); the step
# splits them into --training_pipeline_parallel_microbatches M (default S)
# and runs the schedule (--training_pipeline_parallel_schedule 1F1B, GPipe
# or Interleaved1F1B; --training_pipeline_parallel_split_points). The last
# stage computes each microbatch's full-logits pack loss, normalised by the
# global num_sentence (K3 does not run under pp, as in JAX); its metrics,
# summed over dp x cp, go to every pp rank. After the backward the held
# tensors' gradients are summed over pp in f32 (a tied embedding: the
# lookup's part on the first stage, the head's on the last), so every pp
# rank updates them alike; the gradient norm sums the stages' layers over pp
# and counts those tensors once. FSDP2 wraps each stage's layers and the
# root over the dp mesh of the rank's pp coordinate; the TP plan and
# apply_cp act on each stage's layers. The dev pass runs the pipeline's
# forwards alone.
#
# --training_compile true compiles the step as the reference does (TP -> AC
# -> compile -> FSDP): parallel/sharding.apply_compile gives every trainable
# decoder and encoder layer one torch.compile graph of its checkpoint and
# block, in which K1 and K2 run as custom ops, and the pack loss (the
# full-logits cross_entropy_loss, or the fused linear + CE with K3 as custom
# ops) is compiled too; the dev pass runs the same graphs (with grad
# enabled, see dev; under FSDP2 no_grad graphs of their own).
# num_sentence enters a compiled loss as a device
# tensor, so its value is no guard. Batches whose shapes change every step
# (the SFT loaders' dynamic_batch: datapipes other than causal_lm without
# packing) compile with symbolic sizes from the first call, so a resumed
# process takes the graph an uninterrupted one has. A frame past dynamo's
# recompile limit raises (fail_on_recompile_limit_hit) instead of running
# eagerly; a failed compile raises. The summary records the compiled
# frames, graph breaks, cache entries and compile seconds. The default
# (false) is the eager step.
#
# --training_mixed_precision_param takes float32, bfloat16 and float16 (the
# compute dtype of K1-K4 and the matmuls; the masters and AdamW stay f32).
# What the port does not run raises a ValueError naming the flag: a dp_only
# TrainSpec (qwen2_audio, kimi_audio) at tp, cp or pp above 1
# (check_dp_only), and a pipeline schedule or split the port does not run
# (parallel/pipeline.py).

import copy
import json
import os
import queue
import re
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
from touchnet_tpu_torch.parallel.context_parallel import apply_cp, split_sequence
from touchnet_tpu_torch.parallel.dims import MESH_AXES, ParallelDims
from touchnet_tpu_torch.parallel.loss_parallel import fused_linear_cross_entropy
from touchnet_tpu_torch.parallel.pipeline import (
    Pipeline,
    check_microbatches,
    parse_split_points,
    stage_layers,
    validate_pp_composition,
    virtual_stages_of,
)
from touchnet_tpu_torch.parallel.sharding import (
    apply_compile,
    apply_fsdp,
    configure_compile,
    dp_mesh_of,
    local,
    mark_rows_dynamic,
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
    flight_recorder_state,
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
# --training_mixed_precision_param's compute dtypes (the masters stay f32,
# and there is no loss scaler in float16, as in JAX)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# a decoder layer's tensors (a pipeline stage's); the others every pp rank holds
_LAYER = re.compile(r"(^|\.)layers\.\d+\.")


def check_dp_only(spec, job_config: TrainConfig) -> None:
    """A dp_only TrainSpec (FSDP, HSDP and DDP only: qwen2_audio, kimi_audio)
    raises a ValueError naming the first of tp, cp and pp above 1, as the
    JAX trainer asserts (touchnet_tpu/bin/train.py:353-358)."""
    if not spec.dp_only:
        return
    for name in ("training_tensor_parallel_degree", "training_context_parallel_degree",
                 "training_pipeline_parallel_degree"):
        if getattr(job_config, name) > 1:
            raise ValueError(f"{name}={getattr(job_config, name)}: {spec.name}'s TrainSpec is "
                             "dp_only (FSDP, HSDP and DDP only)")


# flags the trainer accepts and never reads: set away from their default
# (what the port does), each logs one warning saying so; the JAX trainer
# too only logs compiled autograd as a no-op (:334-337). The pipeline's
# schedule, microbatch and split flags at pp 1 and the rotate method at cp
# 1 are inert here as in the JAX trainer, and stay silent; so does async TP
# at tp 1 (at tp > 1 it warns once: the port runs no XLA scheduler it could
# set).
UNREAD_FLAGS = {
    "training_enable_compiled_autograd": "the port's backward runs without compiled autograd "
                                         "(as the JAX trainer, which logs it as a no-op)",
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


def _loss_group(pd: ParallelDims, rank: int):
    """The group of the ranks that share this rank's tp and pp coordinates:
    dp_replicate x dp_shard x cp (JAX's DP_CP), each with its own rows or
    its own slice of their sequence, over which the loss's sums are summed.
    Every rank creates every group, in one order."""
    mine = None
    others = ("pp", "tp")
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
        check_dp_only(get_train_spec(job_config.training_model_name), job_config)
        init_logger(os.path.join(job_config.training_trace_dump_folder, "touchnet_train.log"))
        warn_unread(job_config)
        self.gc_handler = GarbageCollection(job_config.training_gc_freq)
        if device is None:
            device = local_cuda_device()  # cuda:LOCAL_RANK; raises without a card
        self.device = device
        started_here = not dist.is_initialized()
        # under a process group the model is wrapped in FSDP2, even at world 1
        self.fsdp = init_distributed(device, job_config.training_init_timeout_seconds,
                                     trace_buf_size=job_config.training_trace_buf_size,
                                     dump_folder=job_config.training_trace_dump_folder)
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
        self.loss_group = self.host_group = self.ckpt_group = self.mesh = None
        if self.fsdp:
            self.mesh = pd.build_mesh(device.type)
            self.loss_group = _loss_group(pd, self.rank)
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

        self.pipeline = None
        held = {}
        if pd.pp > 1:
            held["layers"] = self._pipeline_setup(backbone.num_hidden_layers)
        # f32 master weights from a seeded generator on the device
        gen = torch.Generator(device=device).manual_seed(job_config.training_seed)
        self.model = self.train_spec.init_params_fn(
            self.model_config, gen, torch.float32, device, requires_grad=True, train=True,
            **held)
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
        self._setup_compile()
        if self.fsdp:
            self._parallelize()
        else:
            self._compile()
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # under pp: the tensors every pp rank holds, their gradients summed over pp
        self.pp_replicated = [self.pipeline is not None and not _LAYER.search(n)
                              for n in self.param_names]
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

    def _pipeline_setup(self, num_layers: int) -> list:
        """Pipeline parallelism's checks (each a ValueError naming its flag)
        and this rank's Pipeline; returns the global indices of the layers
        its stages hold."""
        cfg, pd = self.job_config, self.parallel_dims
        validate_pp_composition(cfg)
        if self.train_spec.pipelining_fn is None:
            raise ValueError(f"training_pipeline_parallel_degree={pd.pp}: {self.train_spec.name} "
                             "has no pipelining_fn (llama and touch_audio have one)")
        schedule, split = (cfg.training_pipeline_parallel_schedule,
                           cfg.training_pipeline_parallel_split_points)
        V = virtual_stages_of(split, num_layers, pd.pp, schedule)
        parse_split_points(split, num_layers, pd.pp, V)
        M = cfg.training_pipeline_parallel_microbatches or pd.pp
        check_microbatches(self.data_config.dataset_batchsize, M, pd.pp, V)
        stage = pd.coords(self.rank)["pp"]
        self.chunks = stage_layers(num_layers, pd.pp, V, stage)
        self.pipeline = Pipeline(schedule, pd.pp, M, V, stage, self.mesh["pp"].get_group(),
                                 self.device)
        logger.info(f"pipeline: {schedule}, pp {pd.pp} x {V} virtual stage(s), {M} "
                    f"microbatches; this is stage {stage}, layers {self.chunks}")
        return [i for chunk in self.chunks for i in chunk]

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
        if pd.tp > 1:  # a spec without param_rules is dp_only (check_dp_only)
            self.train_spec.param_rules(self.model, self.mesh["tp"], log=logger.info)
        if pd.cp > 1:
            apply_cp(self.model, self.mesh["cp"].get_group(),
                     cfg.training_context_parallel_rotate_method)
        self._compile()
        # compiled, the layers too are gathered in the dtype one process
        # differentiates and cast at use inside the graph, as one process
        # casts its masters: one graph for both, so world 1 under FSDP2
        # keeps one process's bits (with bf16 parameters the graph, and
        # inductor's reductions in it, would differ); the all-gathers move
        # twice the bytes of bf16
        param_dtype = self.reduce_dtype if self.compiled else self.compute_dtype
        apply_fsdp(self._reparam, self.model, dp_mesh_of(self.mesh, pd.dp_replicate),
                   param_dtype=param_dtype, reduce_dtype=self.reduce_dtype,
                   reshard_after_forward=cfg.training_fsdp_reshard_after_forward)
        logger.info(f"FSDP2 over dp_replicate {pd.dp_replicate} x dp_shard {pd.dp_shard} x cp "
                    f"{pd.cp} (reshard_after_forward {cfg.training_fsdp_reshard_after_forward}, "
                    f"params {param_dtype}, reduce {self.reduce_dtype}, sum), tp {pd.tp}"
                    + (f", cp {cfg.training_context_parallel_rotate_method}" if pd.cp > 1 else ""))

    def _setup_compile(self) -> None:
        """--training_compile: torch.compile's settings for this trainer
        (parallel/sharding.configure_compile: its caches and counters
        reset, so the summary counts this run's graphs) and the pack losses
        the step calls, compiled or not."""
        self.compiled = self.job_config.training_compile
        self._loss_fn = self.train_spec.loss_fn
        self._fused_loss = fused_linear_cross_entropy
        self.compile_seconds0 = 0.0
        self.dynamic_rows = False
        self.compiled_layers = {}
        if not self.compiled:
            return
        configure_compile()
        dc = self.data_config
        # symbolic rows and lengths from the first call where every batch has
        # its own shape (the dynamic batchers'; packed batches are fixed)
        self.dynamic_rows = not (dc.datapipe_type == "causal_lm" or dc.dataset_enable_pack)
        self._loss_fn = torch.compile(self._loss_fn)
        self._fused_loss = torch.compile(fused_linear_cross_entropy)
        self.compile_seconds0 = _compile_seconds()

    def _compile(self) -> None:
        """The compiled blocks (parallel/sharding.apply_compile), after the
        TP plan and cp, before FSDP. A block holds no graph break, except
        under cp, whose attention (the ring's point-to-point through host
        buffers, the allgather's collectives) is the graph's boundary, and
        under tp, whose collectives run eagerly between graphs."""
        if not self.compiled:
            return
        fullgraph = self.parallel_dims.cp == 1 and self.parallel_dims.tp == 1
        self.compiled_layers = apply_compile(self.model, fullgraph=fullgraph,
                                             dynamic_rows=self.dynamic_rows)
        names = {cls.__name__: n for cls, n in self.compiled_layers.items()}
        logger.info(f"training_compile: layers compiled {names} (fullgraph "
                    f"{fullgraph}, dynamic rows {self.dynamic_rows}) and the pack loss; the first "
                    "step includes the compile")

    def _compile_summary(self) -> dict:
        """What dynamo compiled for this trainer: frames compiled (each
        first compile and recompile of a function, and the resume frames
        after a graph break), graph breaks by reason, the cache entries of
        the compiled functions (a recompile adds one) and the seconds spent
        compiling (dynamo's frames and the lazy backward compiles)."""
        if not self.compiled:
            return {"enabled": False}
        from torch._dynamo.eval_frame import _debug_get_cache_entry_list
        from torch._dynamo.utils import counters

        fns = {"loss": self.train_spec.loss_fn, "fused_loss": fused_linear_cross_entropy}
        for cls in self.compiled_layers:
            fns[cls.__name__] = cls.checkpointed_block
        entries = {k: len(_debug_get_cache_entry_list(f.__code__)) for k, f in fns.items()}
        breaks = dict(counters["graph_break"])
        return {
            "enabled": True,
            "dynamic": self.dynamic_rows,
            "frames": counters["frames"]["ok"],
            "unique_graphs": counters["stats"]["unique_graphs"],
            "graph_breaks": sum(breaks.values()),
            "graph_break_reasons": breaks,
            "cache_entries": entries,
            "recompiles": sum(max(0, n - 1) for n in entries.values()),
            "seconds": _compile_seconds() - self.compile_seconds0,
        }

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
        parallel at tp > 1, and never under pp, as the JAX trainer
        (:484-497)."""
        cfg, pd = self.job_config, self.parallel_dims
        wanted = cfg.training_enable_liger_kernel or pd.loss_parallel_enabled
        return wanted and self._head is not None and pd.pp == 1

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

    def _num_sentence(self, num_sentence):
        """A compiled loss takes the global sentence count as a device
        tensor (a float would be a guard, recompiled every step); an eager
        one the float."""
        if not self.compiled:
            return num_sentence
        return torch.full((), num_sentence, dtype=torch.float32, device=self.device)

    def _local_loss_and_acc(self, batch, num_sentence):
        num_sentence = self._num_sentence(num_sentence)
        if self.dynamic_rows:  # the batch arrays as the blocks and the loss see them
            mark_rows_dynamic(*(t for t in batch.values() if t is not None))
        if self._fused_ce:
            hidden = self._forward(batch, return_hidden=True)
            if self.dynamic_rows:
                mark_rows_dynamic(hidden)
            head = self._head
            return self._fused_loss(
                hidden, local(head.weight), batch["labels"], batch["sentence_lens"],
                num_sentence, compute_dtype=self.compute_dtype, tp_group=tp_group(head),
                vocab_start=vocab_start(head), dp_group=self.loss_group)
        logits = self._forward(batch)
        if self.dynamic_rows:
            mark_rows_dynamic(logits)
        loss_ps, loss_pt = self._loss_fn(
            logits, batch["labels"], batch["sentence_lens"], num_sentence)
        acc = self.train_spec.acc_fn(logits, batch["labels"])
        if self.loss_group is None:
            return loss_ps, loss_pt, acc
        # the global batch's values (the gradient stays this rank's tokens):
        # per-sample sums, per-token loss and accuracy weighted by tokens
        ntok = (batch["labels"] != -100).sum().double()
        vals = sum_forward(torch.stack([loss_ps.double(), loss_pt.detach() * ntok,
                                        acc.detach() * ntok, ntok]), self.loss_group)
        n = vals[3].clamp(min=1)
        return vals[0].float(), (vals[1] / n).float(), (vals[2] / n).float()

    def _pipeline_pass(self, batch, num_sentence, train: bool = True):
        """(loss_per_sample, loss_per_token, acc) of the global batch through
        the pipeline: the rows split into M microbatches, the schedule's
        forwards (and, with ``train``, backwards; then the gradients of the
        tensors every pp rank holds summed over pp in f32). The last stage's
        per-sample losses add up (each over the global num_sentence), its
        per-token loss and accuracy are weighted by their tokens; the sums
        go over dp x cp (the loss group), then to every pp rank."""
        pipe, spec, cfg = self.pipeline, self.train_spec, self.job_config
        rows, T = batch["labels"].shape[:2]
        check_microbatches(rows, pipe.M, pipe.S, pipe.V, "the batch's rows")
        b = rows // pipe.M
        mbs = [{k: (v[m * b:(m + 1) * b] if isinstance(v, torch.Tensor) else v)
                for k, v in batch.items()} for m in range(pipe.M)]
        sums = torch.zeros(4, dtype=torch.float64, device=self.device)
        last_stage = pipe.S * pipe.V - 1
        num_sentence = self._num_sentence(num_sentence)

        def forward_fn(v, m, x):
            t = v * pipe.S + pipe.stage

            def body():
                mb = mbs[m]
                out = spec.pipelining_fn(
                    self.model, self.chunks[v], x, mb, config=self.model_config,
                    compute_dtype=self.compute_dtype,
                    remat_mode=cfg.training_activation_checkpoint_mode,
                    selective_ac_option=cfg.training_activation_checkpoint_selective_ac_option,
                    first=t == 0, last=t == last_stage)
                if t != last_stage:
                    return out
                loss_ps, loss_pt = self._loss_fn(out, mb["labels"], mb["sentence_lens"],
                                                 num_sentence)
                acc = spec.acc_fn(out, mb["labels"])
                ntok = (mb["labels"] != -100).sum().double()
                sums.add_(torch.stack([loss_ps.detach().double(), loss_pt.detach() * ntok,
                                       acc.detach() * ntok, ntok]))
                return loss_ps

            return self._reparam(body)

        hidden = getattr(self.model_config, "text_config", self.model_config).hidden_size
        pipe.run(forward_fn, (b, T, hidden), self.compute_dtype, train)
        if train:
            self._sum_held_grads()
        dist.all_reduce(sums, group=self.loss_group)
        dist.all_reduce(sums, group=pipe.group)  # only the last stage's are not 0
        n = sums[3].clamp(min=1)
        return sums[0].float(), (sums[1] / n).float(), (sums[2] / n).float()

    def _sum_held_grads(self) -> None:
        """The gradients of the tensors every pp rank holds, summed over pp
        in f32 (one flat buffer); a rank the loss did not reach adds zeros."""
        held = [p for p, r in zip(self.params, self.pp_replicated) if r]
        for p in held:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [local(p.grad) for p in held]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.pipeline.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

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
        if self.pipeline is None:
            grads, loss_ps, loss_pt, acc = self._grads_and_metrics(batch, num_sentence)
            gnorm = global_grad_norm(grads)
        else:
            loss_ps, loss_pt, acc = self._pipeline_pass(batch, num_sentence)
            grads = _grads_of(self.params)
            gnorm = global_grad_norm(grads, self.pipeline.group, self.pp_replicated)
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

    def _stage_batch(self, batch: Dict[str, Any], stacked: bool = False):
        """Host batch -> (device tensors (int32 buffers stay int32), this
        rank's num_sentence, the first float array holding NaN/inf or None).
        Under cp each array keeps this rank's slice of the sequence (axis 1,
        axis 2 of an accumulation stack); num_sentence counts the whole
        rows. Runs on the prefetcher's thread, so it raises nothing for the
        NaN guard: the loop agrees on it over the ranks first
        (_global_batch)."""
        pd = self.parallel_dims
        cp_rank = pd.coords(self.rank)["cp"]
        arrays = {k: split_sequence(batch[k], pd.cp, cp_rank, 2 if stacked else 1)
                  for k in _BATCH_ARRAY_KEYS if isinstance(batch.get(k), np.ndarray)}
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
            device_batch, num_sentence, bad = self._stage_batch(batch, self.accum > 1)
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
        dev lines, kernel launches, checkpoint times, what it compiled
        (_compile_summary) and its NCCL flight recorder's settings, for a
        caller that ran the trainer in another process (torchrun)."""
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
            "compile": self._compile_summary(),
            "flight_recorder": flight_recorder_state(),
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

    def dev(self):
        """The dev-set pass (the JAX Trainer.dev, :1024-1072): the eval step
        (_loss_and_acc, forward only: K1 and K3's forward on the card; under
        pp the pipeline's forwards, _pipeline_pass) over every batch of
        datalist_dev_path (never stacked, whatever the
        accumulation), averaged, logged as one [dev] line. Each rank reads
        its dp rank's dev stream; the ranks stop together when one runs
        dry, and each batch's metrics are the global batch's. Under no_grad,
        except a compiled step without FSDP, whose pass runs its training
        graphs with grad enabled and drops each batch's graph with its
        metrics: under no_grad dynamo would compile every graph once more
        (FSDP2 keeps no_grad: a forward that records for a backward that
        never comes would leave its units waiting for that backward)."""
        with torch.enable_grad() if self.compiled and not self.fsdp else torch.no_grad():
            self._dev()

    def _dev(self):
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
                if self.pipeline is None:
                    loss_ps, loss_pt, acc = self._loss_and_acc(device_batch, num_sentence)
                else:
                    loss_ps, loss_pt, acc = self._pipeline_pass(device_batch, num_sentence,
                                                                train=False)
                for k, v in zip(totals, (loss_ps, loss_pt, acc)):
                    totals[k] += float(v)
                del loss_ps, loss_pt, acc  # and with them any graph they record
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


def _compile_seconds() -> float:
    """Seconds dynamo has spent compiling in this process: its frames
    (tracing, AOTAutograd, the forward graphs' inductor compiles) and the
    backward graphs, compiled at their first backward."""
    from torch._dynamo.utils import compilation_time_metrics

    return sum(sum(compilation_time_metrics.get(k, ()))
               for k in ("_compile.compile_inner", "compile_fx.<locals>.bw_compiler"))


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
