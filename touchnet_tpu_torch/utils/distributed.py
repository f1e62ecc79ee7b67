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
# counterpart.

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


def init_distributed(device: torch.device, timeout_s: float = 300.0) -> bool:
    """Start the process group from torchrun's environment (env://): NCCL
    with this process on ``device`` (cuda:LOCAL_RANK), or gloo when
    ``device`` is the CPU. A group that is already up (a test's FileStore
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
    ``{dump_folder}/comm_trace/stuck_step_<time>.txt`` and logs an error;
    with ``abort`` (training_abort_on_timeout) it then ends the process
    with exit code 124, so a supervisor can restart it from the last
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
            path = os.path.join(self.dump_folder, f"stuck_step_{int(time.time())}.txt")
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f)
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
