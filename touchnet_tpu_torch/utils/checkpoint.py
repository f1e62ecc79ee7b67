# Copyright (c) 2026 touchnet_tpu authors.
# Checkpoints of the port's trainer on torch.distributed.checkpoint (DCP).
#
# Port of touchnet_tpu/utils/checkpoint.py: CheckpointManager (:28), its
# cadence (:65-69: step 1 to fail fast, every training_ckpt_interval steps,
# and forced at the last), save (:71), load (:106) with the shape and dtype
# checks of _from_savable (:202-236), and export_weights_only (:255). DCP
# is the original TouchNet's format. One process writes and reads it with
# no process group; a sharded trainer (``group``: a gloo group over every
# rank, apart from the step's) writes each rank's shards of its DTensors
# (FSDP's, TP's) and every rank reads its own, so a resume at the same
# world size is exact; and any one process reads the whole tensors back
# (bin/convert_ckpt_to_hf.py). Every rank's loader state goes into the same
# step: the states are gathered, merged (each is keyed by its dp rank) and
# written once; a resume at another data-parallel world size raises in the
# loader, as JAX's does. The layout is the JAX manager's (Orbax) one:
#   <dump>/<ckpt_folder>/step_<N>/model/        DCP, keyed by state_dict name
#                                 optimizer/    DCP: mu.<name>, nu.<name>, count
#                                 train_state/metadata   JSON {"step": N}
#                                 dataloader/metadata    JSON loader state
# A step is written under step_<N>.partial and renamed when complete, so a
# crash mid-write never leaves a step that load would take.
#
# Saving copies every tensor to host memory first (staging; on the card
# into pinned buffers on a copy stream of its own), then writes the host
# copies: in the calling thread, or in a background thread under
# training_ckpt_async_mode async. The trainer's AdamW updates params and
# moments in place, so the next update must not start before the staging
# copies have read them: maybe_wait_for_staging makes the compute stream
# wait for the staging's event (a fence on the card, the host never
# blocks). Host tensors (the AdamW moments under CPU offload) are read
# after ``before_stage`` (the trainer's wait for the moments'
# device-to-host copies): under async a host copy in save() itself stages
# them, so no later update can change them under the writer; a sync save
# writes them as they are, since no update runs before it returns (a copy
# would hold a second 8 bytes a parameter of pinned memory). Loading validates every key, shape and dtype against the
# checkpoint's metadata before it reads a byte: a checkpoint that does not
# fit raises naming the key and never loads partially.

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader, FileSystemWriter

from touchnet_tpu_torch.parallel.sharding import local, on_host
from touchnet_tpu_torch.utils.logging import logger

MODEL = "model"
OPTIMIZER = "optimizer"
DATALOADER = "dataloader"
TRAIN_STATE = "train_state"
_STEP_DIR = re.compile(r"step_(\d+)$")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class CheckpointManager:
    """Save and load of {model, optimizer, dataloader, step}.

    ``model`` and ``optimizer`` are flat dicts of tensors (or DTensors)
    keyed by name; load copies into them in place. ``dataloader`` has
    state_dict() and load_state_dict() (the trainer swaps in a view of its
    prefetcher). ``group``: the process group of a sharded run, used only
    here (also from the async writer's thread), or None for one process."""

    def __init__(self, dataloader, job_config, group=None):
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.enabled = job_config.training_enable_ckpt
        self.job_config = job_config
        self.dataloader = dataloader
        self.folder = os.path.join(job_config.training_trace_dump_folder,
                                   job_config.training_ckpt_folder)
        self.interval = job_config.training_ckpt_interval
        self.keep_latest_k = job_config.training_ckpt_keep_latest_k
        self.async_mode = job_config.training_ckpt_async_mode.lower() == "async"
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._staged: Optional[torch.cuda.Event] = None
        self._buffers: Dict[str, torch.Tensor] = {}
        self._stream = None
        # per saved step: ms the caller blocked in save (of it, waiting for
        # the previous write) and the write's seconds (telemetry)
        self.times: Dict[int, Dict[str, float]] = {}
        if self.enabled:
            os.makedirs(self.folder, exist_ok=True)
            logger.info(f"CheckpointManager at {self.folder} (async={self.async_mode}, "
                        f"keep={self.keep_latest_k})")

    # -- cadence -----------------------------------------------------------
    def _should_save(self, step: int, force: bool = False) -> bool:
        if not self.enabled:
            return False
        # step-1 fail-fast save proves checkpointing works before a long run
        return force or step == 1 or step % self.interval == 0

    def save(self, step: int, model: Dict[str, torch.Tensor],
             optimizer: Dict[str, torch.Tensor], force: bool = False,
             before_stage: Optional[Callable[[], None]] = None) -> bool:
        """Stage the state and write step_<step> (in the background under
        async). ``before_stage`` runs first when the step saves. Returns
        whether the cadence saved this step."""
        if not self._should_save(step, force):
            return False
        t0 = time.perf_counter()
        self.wait_until_finished()  # one write at a time; it reuses the buffers
        waited = time.perf_counter() - t0
        if before_stage is not None:
            before_stage()
        tensors = {f"{MODEL}.{k}": v for k, v in model.items()}
        tensors.update({f"{OPTIMIZER}.{k}": v for k, v in optimizer.items()})
        host = self._stage(tensors, copy_host=self.async_mode)
        items = {TRAIN_STATE: {"step": int(step)}}
        if self.dataloader is not None:
            items[DATALOADER] = self._loader_state()
        staged = self._staged

        def write():
            if staged is not None:
                staged.synchronize()
            w0 = time.perf_counter()
            self._write(step, host, items)
            self.times[step]["write_s"] = time.perf_counter() - w0

        self.times[step] = {"waited_ms": waited * 1e3}
        if self.async_mode:
            self._thread = threading.Thread(target=self._run, args=(write,), daemon=True)
            self._thread.start()
            logger.info(f"checkpoint queued for step {step}")
        else:
            write()
            logger.info(f"checkpoint saved for step {step}")
        self.times[step]["blocked_ms"] = (time.perf_counter() - t0) * 1e3
        return True

    def _loader_state(self) -> dict:
        """The loader state of every rank, merged (each rank's entries are
        keyed by its dp rank; the ranks of a tp group hold the same)."""
        state = _jsonify(self.dataloader.state_dict())
        if self.group is None:
            return state
        states = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(states, state, group=self.group)
        merged = {}
        for st in states:
            merged.update(st)
        return merged

    def _stage(self, tensors: Dict[str, torch.Tensor],
               copy_host: bool = True) -> Dict[str, torch.Tensor]:
        """Host copies of ``tensors`` (of a DTensor, of its local shard,
        laid out as it: parallel/sharding.on_host): clones on the CPU; on
        the card copies into pinned buffers (kept for the next save) on a
        copy stream that first waits for the compute stream, with an event
        recorded after them (self._staged). A host tensor among card tensors
        is copied into its buffer by the host, before this returns, or,
        without ``copy_host``, handed over as it is."""
        self._staged = None
        cuda = [local(t) for t in tensors.values() if local(t).is_cuda]
        if not cuda:
            return {k: on_host(t, local(t).detach().clone()) for k, t in tensors.items()}
        device = cuda[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        host = {}
        with torch.cuda.stream(self._stream):
            for k, whole in tensors.items():
                t = local(whole)
                if not t.is_cuda and not copy_host:
                    host[k] = whole.detach()
                    continue
                buf = self._buffers.get(k)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    self._buffers[k] = buf
                if t.is_cuda:
                    buf.copy_(t.detach(), non_blocking=True)
                    t.record_stream(self._stream)
                else:
                    buf.copy_(t.detach())
                host[k] = on_host(whole, buf)
            self._staged = torch.cuda.Event()
            self._staged.record(self._stream)
        return host

    def _write(self, step: int, host: Dict[str, torch.Tensor], items: Dict[str, Any]):
        """Every rank writes its shards; rank 0 the JSON items and the
        rename, between barriers of the checkpoint group."""
        final = os.path.join(self.folder, f"step_{step}")
        tmp = final + ".partial"
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            for part in (MODEL, OPTIMIZER):
                os.makedirs(os.path.join(tmp, part))
        self._barrier()
        for part in (MODEL, OPTIMIZER):
            prefix = part + "."
            _save({k[len(prefix):]: v for k, v in host.items() if k.startswith(prefix)},
                  FileSystemWriter(os.path.join(tmp, part), thread_count=4), self.group)
        if self.rank == 0:
            for name, obj in items.items():
                os.makedirs(os.path.join(tmp, name))
                with open(os.path.join(tmp, name, "metadata"), "w") as f:
                    json.dump(obj, f)
        self._barrier()
        if self.rank == 0:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._purge()
        self._barrier()

    def _barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # raised by the next save / wait
            self._error = e

    def _purge(self):
        if self.keep_latest_k > 0:
            for step in self.all_steps()[:-self.keep_latest_k]:
                shutil.rmtree(os.path.join(self.folder, f"step_{step}"))

    def maybe_wait_for_staging(self):
        """Fence before the optimizer mutates params and moments in place:
        the compute stream waits for the last save's staging copies."""
        if self._staged is not None:
            torch.cuda.current_stream(self._stream.device).wait_event(self._staged)
            self._staged = None

    def wait_until_finished(self):
        """Join the background write; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # -- load --------------------------------------------------------------
    def all_steps(self) -> list:
        if not os.path.isdir(self.folder):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(self.folder))
                      if m)

    def _find_load_step(self) -> Optional[int]:
        steps = self.all_steps()
        step = self.job_config.training_ckpt_load_step
        if step != -1:
            return step if step in steps else None
        return steps[-1] if steps else None

    def load(self, model: Dict[str, torch.Tensor],
             optimizer: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Restore into the given tensors in place and apply the loader
        state. Returns {"step", "loaded"}. Step 0 is a seed checkpoint: the
        model only."""
        out = {"step": 0, "loaded": False}
        if not self.enabled:
            return out
        step = self._find_load_step()
        if step is None:
            logger.info("no checkpoint found; starting fresh")
            return out
        exclude = {s.strip() for s in
                   self.job_config.training_ckpt_exclude_from_loading.split(",") if s.strip()}
        root = os.path.join(self.folder, f"step_{step}")
        parts = {}
        if MODEL not in exclude:
            parts[MODEL] = model
        if step != 0 and OPTIMIZER not in exclude:
            parts[OPTIMIZER] = optimizer
        if not parts and step == 0:
            logger.info("everything excluded from loading; starting fresh")
            return out
        for part, tensors in parts.items():  # every check before any read
            _check_fits(os.path.join(root, part), tensors, part)
        for part, tensors in parts.items():
            reader = FileSystemReader(os.path.join(root, part))
            if self.group is None:
                dcp.load(tensors, storage_reader=reader, no_dist=True)
            else:
                dcp.load(tensors, storage_reader=reader, process_group=self.group)
        if step != 0:
            if DATALOADER not in exclude and self.dataloader is not None:
                self.dataloader.load_state_dict(_read_json(root, DATALOADER))
            out["step"] = int(_read_json(root, TRAIN_STATE)["step"])
        out["loaded"] = True
        logger.info(f"restored checkpoint step {step}")
        return out

    def close(self):
        self.wait_until_finished()


def _read_json(root: str, name: str):
    with open(os.path.join(root, name, "metadata")) as f:
        return json.load(f)


def _check_fits(path: str, tensors: Dict[str, torch.Tensor], what: str) -> None:
    """Raise naming the key unless the checkpoint at ``path`` holds exactly
    ``tensors``' keys with their shapes and dtypes."""
    saved = FileSystemReader(path).read_metadata().state_dict_metadata
    missing = sorted(set(tensors) - set(saved))
    if missing:
        extra = sorted(set(saved) - set(tensors))
        raise ValueError(f"checkpoint {what}: missing keys {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}; checkpoint-only keys "
                         f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    for key, ref in tensors.items():
        md = saved[key]
        shape, dtype = tuple(md.size), md.properties.dtype
        if shape != tuple(ref.shape):
            raise ValueError(f"checkpoint {what}/{key}: shape {shape} != expected "
                             f"{tuple(ref.shape)}")
        if dtype != ref.dtype:
            raise ValueError(f"checkpoint {what}/{key}: dtype {dtype} != expected {ref.dtype}")


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if hasattr(obj, "item"):  # numpy scalars
        return obj.item()
    return obj


def _save(state: Dict[str, torch.Tensor], writer, group) -> None:
    if group is None:
        dcp.save(state, storage_writer=writer, no_dist=True)
    else:
        dcp.save(state, storage_writer=writer, process_group=group)


def export_weights_only(model: Dict[str, torch.Tensor], folder: str,
                        dtype: Optional[str] = None, group=None) -> None:
    """The final weights-only export (DCP, keyed by state_dict name), cast
    to ``dtype`` (float32 | bfloat16 | float16) when given; a sharded run
    (``group``) writes each rank's shards."""
    cast = _DTYPES[dtype] if dtype is not None else None
    host = {k: on_host(v, local(v).detach().to("cpu", cast) if cast is not None
                       else local(v).detach().cpu()) for k, v in model.items()}
    if group is None or dist.get_rank(group) == 0:
        os.makedirs(folder, exist_ok=True)
    if group is not None:
        dist.barrier(group=group)
    _save(host, FileSystemWriter(folder), group)
