# Copyright (c) 2026 touchnet_tpu authors.
# Profiling: cyclic torch.profiler traces and CUDA memory snapshots.
#
# Port of touchnet_tpu/utils/profiling.py (maybe_enable_profiling,
# maybe_enable_memory_snapshot), on the tools of the original TouchNet
# (reference touchnet/utils/profiling.py:26-137): Chrome traces of
# torch.profiler, and the CUDA caching allocator's memory history, dumped
# as a snapshot pickle (torch.cuda.memory._dump_snapshot; open it at
# pytorch.org/memory_viz).

import contextlib
import os

import torch

from touchnet_tpu_torch.utils.logging import logger

_MAX_MEMORY_EVENTS = 100000


class _Profiler:
    def __init__(self, folder: str, freq: int, keep_first_k: int, device: torch.device):
        self.folder = folder
        self.freq = freq
        self.keep_first_k = keep_first_k
        self.cycles_done = 0
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None
        self.out = None
        os.makedirs(folder, exist_ok=True)

    def step(self, step: int):
        """Trace the step right before each multiple of freq (the reference
        schedule: wait, warmup, active 1), for the first keep_first_k
        cycles (0: every cycle). A trace lands in
        <folder>/iteration_<N>/trace.json."""
        if self.prof is not None:
            self._stop()
        if self.keep_first_k and self.cycles_done >= self.keep_first_k:
            return
        if (step + 1) % self.freq == 0:
            self.out = os.path.join(self.folder, f"iteration_{step + 1}")
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()

    def _stop(self):
        self.prof.stop()
        os.makedirs(self.out, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.out, "trace.json"))
        self.prof = None
        self.cycles_done += 1
        logger.info(f"profiler: trace cycle {self.cycles_done} in {self.out}")

    def close(self):
        if self.prof is not None:
            self._stop()


@contextlib.contextmanager
def maybe_enable_profiling(job_config, device: torch.device = torch.device("cpu")):
    """Yields a _Profiler under training_enable_profiling (the trainer calls
    its step(n) after step n), else None."""
    if not job_config.training_enable_profiling:
        yield None
        return
    prof = _Profiler(os.path.join(job_config.training_trace_dump_folder,
                                  job_config.training_profiling_traces_folder),
                     job_config.training_profiling_freq,
                     job_config.training_profiling_keep_first_k, device)
    try:
        yield prof
    finally:
        prof.close()


class _MemorySnapshotter:
    def __init__(self, folder: str, freq: int, device: torch.device):
        self.folder = folder
        self.freq = freq
        self.device = device
        os.makedirs(folder, exist_ok=True)

    def step(self, step: int, exit_ctx: bool = False):
        """Dump the allocator's history at every multiple of freq, and when
        the training loop raises (<folder>/step_<N>[_oom].pickle)."""
        if exit_ctx or step % self.freq == 0:
            tag = f"step_{step}" + ("_oom" if exit_ctx else "")
            path = os.path.join(self.folder, f"{tag}.pickle")
            torch.cuda.memory._dump_snapshot(path)
            logger.info(f"memory snapshot: {path}")


@contextlib.contextmanager
def maybe_enable_memory_snapshot(job_config, global_step: int = 0,
                                 device: torch.device = torch.device("cpu")):
    """Records the CUDA allocator's history under
    training_enable_memory_snapshot and yields a _MemorySnapshotter, else
    None. Raises on a device other than a CUDA card: there is no device
    memory to record."""
    if not job_config.training_enable_memory_snapshot:
        yield None
        return
    if device.type != "cuda":
        raise ValueError(f"training_enable_memory_snapshot: records the CUDA allocator; the "
                         f"trainer runs on {device}")
    snap = _MemorySnapshotter(os.path.join(job_config.training_trace_dump_folder,
                                           job_config.training_memory_snapshot_folder),
                              job_config.training_profiling_freq, device)
    torch.cuda.memory._record_memory_history(max_entries=_MAX_MEMORY_EVENTS, device=device)
    try:
        yield snap
    except BaseException:
        snap.step(global_step, exit_ctx=True)
        raise
    finally:
        torch.cuda.memory._record_memory_history(enabled=None, device=device)
