# Copyright (c) 2026 touchnet_tpu authors.
# Training telemetry: loss, grad norm, lr, tokens/s, MFU and device memory.
#
# Port of touchnet_tpu/utils/metrics.py (MetricsProcessor, with log_dev,
# and the logger backends BaseLogger, TensorBoardLogger, WandBLogger and
# _build_logger, :89-173). The JAX module's peak-flops table holds TPU
# generations; here it holds the one card the port targets, and memory comes
# from torch.cuda's allocator statistics. The trainer hands it device
# tensors and it reads them (.item(), a host sync) only on logging steps.
# Under torchrun every rank keeps its history and rank 0 alone prints the
# line; TensorBoard runs on rank 0 under training_tb_rank_0_only (JAX
# :160-163); the peak memory is the max
# over the ranks, and tokens/s is per card: each process counts the tokens
# of its one loader stream (JAX divides its count by the streams it holds,
# :191-195), which the ranks of a tp group share (non_data_parallel_size).
#
# The backends are host services: every logged line also goes to wandb
# (training_enable_wandb) or TensorBoard (training_enable_tensorboard,
# torch.utils.tensorboard, under <dump>/<training_save_tb_folder>/<stamp>),
# dev lines under dev/. As in JAX, a backend whose package is missing is a
# warning and the next one is tried (wandb, then TensorBoard, then none);
# the packages are imported only when their flag is on.

import os
import time
from datetime import datetime
from typing import Any, Dict, List, Optional

import torch

from touchnet_tpu_torch.utils.distributed import dist_max, rank_and_world
from touchnet_tpu_torch.utils.logging import _process_index, logger

# bf16 dense peak, a spec constant and not a measurement: NVIDIA H100 SXM
# datasheet, 989 TFLOP/s at the card's 700 W limit (the f16 dense peak is
# the same, so MFU keeps it under --training_mixed_precision_param float16)
GPU_PEAK_FLOPS = {"H100": 989e12}
_GIB = 1024**3


def get_peak_flops(device: torch.device) -> Optional[float]:
    """bf16 dense peak of the card, or None (no MFU) off a known card."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, flops in GPU_PEAK_FLOPS.items():
        if key in name:
            return flops
    logger.warning(f"no peak flops for {name!r}; MFU is not reported")
    return None


class BaseLogger:
    def log(self, metrics: Dict[str, Any], step: int) -> None:
        pass

    def close(self) -> None:
        pass


class TensorBoardLogger(BaseLogger):
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir, max_queue=1000)
        logger.info(f"TensorBoard logging to {log_dir}")

    def log(self, metrics, step):
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)

    def close(self):
        self.writer.close()


class WandBLogger(BaseLogger):
    def __init__(self, log_dir: str):
        import wandb

        self.wandb = wandb
        self.wandb.init(project=os.getenv("WANDB_PROJECT", "touchnet_tpu"), dir=log_dir)

    def log(self, metrics, step):
        self.wandb.log(dict(metrics), step=step)

    def close(self):
        if self.wandb.run is not None:
            self.wandb.finish()


def _build_logger(job_config, dump_dir: str) -> BaseLogger:
    """wandb, else TensorBoard, else nothing, by the flags; a backend that
    cannot start (its package missing) is a warning and the next is tried."""
    if job_config.training_enable_wandb:
        try:
            return WandBLogger(dump_dir)
        except Exception as e:
            logger.warning(f"wandb unavailable ({e}); falling back")
    if job_config.training_enable_tensorboard:
        if job_config.training_tb_rank_0_only and _process_index() != 0:
            return BaseLogger()
        try:
            folder = os.path.join(dump_dir, job_config.training_save_tb_folder,
                                  datetime.now().strftime("%Y%m%d-%H%M"))
            return TensorBoardLogger(folder)
        except Exception as e:
            logger.warning(f"tensorboard unavailable ({e}); falling back")
    return BaseLogger()


class MetricsProcessor:
    """Accumulates per-interval counters and logs one line per logging step:
    loss, acc, grad norm, lr, peak memory, tokens/s, MFU, data-loading share.
    Every logged line is also kept in ``history`` (a dict per step)."""

    def __init__(self, job_config, device: torch.device, non_data_parallel_size: int = 1):
        self.job_config = job_config
        self.device = device
        self.rank = rank_and_world()[0]
        self.non_data_parallel_size = non_data_parallel_size
        self.peak_flops = get_peak_flops(device)
        self.logger_backend = _build_logger(job_config, job_config.training_trace_dump_folder)
        self.num_flop_per_token = 0  # set by the trainer
        self.ntokens_since_last_log = 0
        self.steps_since_last_log = 0
        self.data_loading_times: List[float] = []
        self.time_last_log = time.perf_counter()
        self.history: List[Dict[str, float]] = []
        self.dev_history: List[Dict[str, float]] = []
        if device.type == "cuda":
            self.total_memory = torch.cuda.get_device_properties(device).total_memory

    def should_log(self, step: int) -> bool:
        return step == 1 or step % self.job_config.training_log_freq == 0

    def log(self, step: int, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Reads the step's device metrics (the only host sync of the loop)
        and logs them with the interval's rates."""
        out = {k: float(v) for k, v in metrics.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        time_delta = time.perf_counter() - self.time_last_log
        tps = (self.ntokens_since_last_log / time_delta / self.non_data_parallel_size
               if time_delta else 0.0)
        out["step"] = step
        out["throughput/tps"] = tps
        out["time/step_s"] = time_delta / max(self.steps_since_last_log, 1)
        out["throughput/tflops"] = self.num_flop_per_token * tps / 1e12
        if self.peak_flops:
            out["throughput/mfu_pct"] = 100 * self.num_flop_per_token * tps / self.peak_flops
        time_data = sum(self.data_loading_times)
        out["time/data_loading_pct"] = 100 * time_data / time_delta if time_delta else 0.0
        pieces = [f"step {step:6d}",
                  f"loss {out.get('loss/per_sample', 0):.4f}/{out.get('loss/per_token', 0):.4f}",
                  f"acc {out.get('acc', 0):.4f}", f"gnorm {out.get('grad_norm', 0):.3f}",
                  f"lr {out.get('lr', 0):.2e}"]
        if self.device.type == "cuda":
            peak = dist_max(torch.cuda.max_memory_allocated(self.device))
            out["memory/peak_gib"] = peak / _GIB
            out["memory/peak_pct"] = 100 * peak / self.total_memory
            pieces.append(f"mem {out['memory/peak_gib']:.1f}GiB({out['memory/peak_pct']:.0f}%)")
        pieces.append(f"tps {tps:,.0f}")
        pieces.append(f"tflops {out['throughput/tflops']:.1f}")
        if "throughput/mfu_pct" in out:
            pieces.append(f"mfu {out['throughput/mfu_pct']:.2f}%")
        pieces.append(f"data {out['time/data_loading_pct']:.1f}%")
        if self.rank == 0:
            logger.info("  ".join(pieces))
        self.logger_backend.log({k: v for k, v in out.items() if k != "step"}, step)
        self.history.append(out)
        self.ntokens_since_last_log = 0
        self.steps_since_last_log = 0
        self.data_loading_times.clear()
        self.time_last_log = time.perf_counter()
        return out

    def log_dev(self, step: int, metrics: Dict[str, float]) -> None:
        """One line of dev-set metrics (the JAX log_dev, metrics.py:275-281),
        also kept in ``dev_history``."""
        self.logger_backend.log({f"dev/{k}": v for k, v in metrics.items()}, step)
        if self.rank == 0:
            parts = "  ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            logger.info(f"[dev] step {step:6d}  {parts}")
        self.dev_history.append({"step": step, **metrics})

    def close(self) -> None:
        self.logger_backend.close()
