# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/utils/logging.py (framework-free: numpy and the standard
# library), with its imports pointed at the port.
#
# Rank-aware logging for the TPU framework.
#
# Capability parity: reference touchnet/utils/logging.py:15-63 (per-rank
# formatter, rank-0 file handler, ANSI color palette). Re-designed for JAX
# process indexing instead of CUDA LOCAL_RANK.

import logging
import os
import sys
from dataclasses import dataclass

logger = logging.getLogger("touchnet_tpu_torch")


def _process_index() -> int:
    # Cheap: avoid importing jax at logging-init time; JAX sets these envs in
    # multi-process mode, and single-process runs default to 0.
    for key in ("JAX_PROCESS_INDEX", "PROCESS_INDEX", "RANK"):
        if key in os.environ:
            try:
                return int(os.environ[key])
            except ValueError:
                pass
    return 0


def init_logger(log_file: str = None, level: int = logging.INFO) -> None:
    """Configure the package logger: stdout on every process, file on rank 0."""
    rank = _process_index()
    fmt = logging.Formatter(
        fmt=f"[rank{rank}] %(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    logger.setLevel(level)
    logger.handlers.clear()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None and rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False


@dataclass(frozen=True)
class Color:
    black: str = "\033[30m"
    red: str = "\033[31m"
    green: str = "\033[32m"
    yellow: str = "\033[33m"
    blue: str = "\033[34m"
    magenta: str = "\033[35m"
    cyan: str = "\033[36m"
    white: str = "\033[37m"
    reset: str = "\033[39m"


@dataclass(frozen=True)
class NoColor:
    black: str = ""
    red: str = ""
    green: str = ""
    yellow: str = ""
    blue: str = ""
    magenta: str = ""
    cyan: str = ""
    white: str = ""
    reset: str = ""
