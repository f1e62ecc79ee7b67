# Copyright (c) 2026 touchnet_tpu authors.
# Run-time services of the trainer: the process group, garbage-collection
# control, seeding and determinism, and the step watchdog.
#
# Port of touchnet_tpu/utils/distributed.py: init_distributed (:36-67),
# GarbageCollection (:21), set_determinism (:99), StepWatchdog (:114),
# barrier and the dist_* metric reductions (:198-230). JAX starts one
# controller per host from COORDINATOR_ADDRESS; here every card is a
# process started by torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT), on cuda:LOCAL_RANK over NCCL, or over gloo when the caller
# passes the CPU device (the tests). Without torchrun's environment there is
# no process group: world 1, as before. The XLA-flag helpers have no
# counterpart; --training_trace_buf_size, which the JAX trainer turns into
# an XLA dump under <training_trace_dump_folder>/comm_trace (:54-64), sizes
# NCCL's flight recorder here, as in the reference (flight_recorder_env):
# the last N collectives of every NCCL group, dumped into comm_trace/ when
# a collective times out and when the step watchdog fires.

import datetime
import faulthandler
import gc
import logging
import os
import random
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from touchnet_tpu_torch.utils.logging import logger


def torchrun_env() -> bool:
    """Whether this process was started by torchrun (its RANK and
    WORLD_SIZE are in the environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size): the process group's when there is one, else
    torchrun's environment, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if torchrun_env():
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return 0, 1


def local_cuda_device() -> torch.device:
    """cuda:LOCAL_RANK (cuda:0 without torchrun), the card of this process;
    raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is False); pass "
                           "device=torch.device('cpu') to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


# the NCCL flight recorder's variables, each under the names torch reads
# for it: the first is the one every torch since 2.3 reads, the second the
# later TORCH_FR_* name, where there is one. A variable set under either
# name is the user's and is left alone.
FR_BUFFER_SIZE = ("TORCH_NCCL_TRACE_BUFFER_SIZE", "TORCH_FR_BUFFER_SIZE")
FR_DUMP_ON_TIMEOUT = ("TORCH_NCCL_DUMP_ON_TIMEOUT",)
FR_DUMP_FILE = ("TORCH_NCCL_DEBUG_INFO_TEMP_FILE", "TORCH_FR_DUMP_TEMP_FILE")


def flight_recorder_env(trace_buf_size: int, dump_folder: str, backend: str,
                        environ=os.environ) -> dict:
    """Size NCCL's flight recorder before the process group starts (the
    reference's --training_trace_buf_size): a nonzero size sets
    TORCH_NCCL_TRACE_BUFFER_SIZE to it, TORCH_NCCL_DUMP_ON_TIMEOUT to 1 and
    the dump-file prefix to <dump_folder>/comm_trace/nccl_trace_rank_
    (the folder is made), each unless ``environ`` holds it already under
    one of its names. 0 leaves the recorder off; another backend than NCCL
    has none, and gets a log line saying so. Returns what it set."""
    if trace_buf_size <= 0:
        return {}
    if backend != "nccl":
        logger.info(f"training_trace_buf_size={trace_buf_size}: the flight recorder is "
                    f"NCCL's; the {backend} process group records nothing")
        return {}
    prefix = os.path.join(dump_folder, "comm_trace", "nccl_trace_rank_")  # + <rank>
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    wanted = ((FR_BUFFER_SIZE, str(trace_buf_size)), (FR_DUMP_ON_TIMEOUT, "1"),
              (FR_DUMP_FILE, prefix))
    done = {}
    for names, value in wanted:
        if not any(n in environ for n in names):
            environ[names[0]] = done[names[0]] = value
    return done


def flight_recorder_state(environ=os.environ) -> dict:
    """The recorder's settings in effect: buffer size (0: off) and dump
    prefix, whichever of their names set them."""
    def first(names):
        return next((environ[n] for n in names if n in environ), None)

    return {"buffer_size": int(first(FR_BUFFER_SIZE) or 0),
            "dump_on_timeout": first(FR_DUMP_ON_TIMEOUT) == "1",
            "dump_prefix": first(FR_DUMP_FILE)}


def dump_flight_recorder(path: str) -> bool:
    """Write the NCCL flight recorder's trace (torch's pickled dump) to
    ``path``; False when this process records nothing (no NCCL group or a
    buffer of 0)."""
    if not (dist.is_initialized() and dist.get_backend() == "nccl"
            and flight_recorder_state()["buffer_size"] > 0):
        return False
    from torch._C import _distributed_c10d as c10d

    dump = getattr(c10d, "_dump_nccl_trace", None) or getattr(c10d, "_dump_fr_trace")
    with open(path, "wb") as f:
        f.write(dump())
    return True


def init_distributed(device: torch.device, timeout_s: float = 300.0, *,
                     trace_buf_size: int = 0, dump_folder: str = ".") -> bool:
    """Start the process group from torchrun's environment (env://): NCCL
    with this process on ``device`` (cuda:LOCAL_RANK), or gloo when
    ``device`` is the CPU, the flight recorder sized first
    (flight_recorder_env). A group that is already up (a test's FileStore
    rendezvous) is kept. Returns whether there is a group: False without
    torchrun's environment, where the trainer runs as one process."""
    if dist.is_initialized():
        return True
    if not torchrun_env():
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    flight_recorder_env(trace_buf_size, dump_folder, backend)
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if device.type == "cuda":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    logger.info(f"process group up: rank {dist.get_rank()}/{dist.get_world_size()}, "
                f"{backend} on {device}")
    return True


def barrier(group=None) -> None:
    """Every rank of ``group`` waits for the others; no-op without a group."""
    if dist.is_initialized():
        dist.barrier(group=group)


def _reduce(x, op, group) -> float:
    if not dist.is_initialized():
        return float(x)
    device = torch.device("cpu")
    if dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(x, dtype=torch.float64).detach().to(device).reshape(())
    dist.all_reduce(t, op=op, group=group)
    return float(t)


def dist_max(x, group=None) -> float:
    """The largest of a scalar over the ranks of ``group``."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def dist_min(x, group=None) -> float:
    return _reduce(x, dist.ReduceOp.MIN, group)


def dist_sum(x, group=None) -> float:
    return _reduce(x, dist.ReduceOp.SUM, group)


def dist_mean(x, group=None) -> float:
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    return dist_sum(x, group) / n


def start_p2p(sends, recvs, group):
    """Start point-to-point transfers over ``group`` (the transport of the
    ring attention and of the pipeline): ``sends`` are (tensor, peer, tag),
    ``recvs`` (shape, dtype, device, peer, tag), peers as global ranks.
    Over gloo the tensors travel through host buffers (gloo's send and recv
    abort on CUDA tensors); under NCCL they stay on the device. Returns
    wait(), which waits for every transfer and gives the received tensors
    on their devices."""
    host = dist.get_backend(group) == "gloo"
    out = [t.detach().contiguous() for t, _, _ in sends]
    out = [t.cpu() if host else t for t in out]
    bufs = [torch.empty(shape, dtype=dtype, device="cpu" if host else device)
            for shape, dtype, device, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, t, peer, group, tag=tag)
           for t, (_, peer, tag) in zip(out, sends)]
    ops += [dist.P2POp(dist.irecv, b, peer, group, tag=tag)
            for b, (_, _, _, peer, tag) in zip(bufs, recvs)]
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait():
        for req in reqs:
            req.wait()
        return [b.to(r[2], non_blocking=True) if host else b for b, r in zip(bufs, recvs)]

    return wait


class GarbageCollection:
    """Disable automatic Python GC and collect generation 1 every
    ``gc_freq`` steps (straggler avoidance, reference distributed.py:54-69).
    close() restores the collector's state from before."""

    def __init__(self, gc_freq: int = 1000):
        if gc_freq <= 0:
            raise ValueError(f"training_gc_freq must be positive, got {gc_freq}")
        self.gc_freq = gc_freq
        self._was_enabled = gc.isenabled()
        gc.disable()
        gc.collect(1)

    def run(self, step_count: int):
        if step_count > 1 and step_count % self.gc_freq == 0:
            gc.collect(1)

    def close(self):
        if self._was_enabled:
            gc.enable()


def set_determinism(seed: Optional[int], deterministic: bool = False) -> int:
    """Seed torch (every device), numpy and random; returns the seed.
    ``deterministic`` also makes PyTorch take deterministic algorithms
    only (an op without one raises) with cuBLAS's fixed workspace, the
    counterpart of the JAX function's --xla_gpu_deterministic_ops."""
    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
        logger.info("deterministic algorithms only (may degrade throughput)")
    if seed is None:
        seed = int(time.time())
    torch.manual_seed(seed)
    np.random.seed(seed % 2**32)
    random.seed(seed)
    logger.info(f"root seed = {seed}")
    return seed


class StepWatchdog:
    """Step-timeout failure detector.

    When a training-loop iteration stays armed past ``timeout_s``, a
    watcher thread dumps every Python thread's stack (faulthandler) to
    ``{dump_folder}/comm_trace/stuck_step_<time>.txt``, the NCCL flight
    recorder's trace beside it (``nccl_trace_<time>.pkl``, where the
    process records one) and logs an error; with ``abort``
    (training_abort_on_timeout) it then ends the process with exit code
    124, so a supervisor can restart it from the last
    checkpoint. The reference tightens its process-group timeouts to the
    same end (set_pg_timeouts, touchnet/utils/distributed.py:399-423)."""

    def __init__(self, timeout_s: float, dump_folder: str, abort: bool = False):
        self.timeout_s = timeout_s
        self.abort = abort
        self.dump_folder = os.path.join(dump_folder, "comm_trace")
        self.fired = 0
        self._deadline = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def arm(self) -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def _watch(self) -> None:
        while not self._stop.wait(min(5.0, self.timeout_s / 4 + 0.01)):
            with self._lock:
                expired = self._deadline is not None and time.monotonic() > self._deadline
                if expired:
                    self._deadline = None  # one report per armed step
            if not expired:
                continue
            self.fired += 1
            os.makedirs(self.dump_folder, exist_ok=True)
            stamp = int(time.time())
            path = os.path.join(self.dump_folder, f"stuck_step_{stamp}.txt")
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f)
            try:  # the stacks are written; a failed dump must not stop the abort
                dump_flight_recorder(os.path.join(self.dump_folder, f"nccl_trace_{stamp}.pkl"))
            except Exception:
                logger.exception("the NCCL flight recorder's dump failed")
            logger.error(f"train step exceeded {self.timeout_s}s "
                         f"(training_train_timeout_seconds); thread dump: {path}")
            if self.abort:
                logger.error("training_abort_on_timeout: ending the hung job (exit 124); "
                             "a restart resumes from the last checkpoint")
                # os._exit skips interpreter teardown, which would wait
                # behind the hung main thread; flush the log handlers first
                logging.shutdown()
                os._exit(124)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
