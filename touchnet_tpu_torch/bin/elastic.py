# Copyright (c) 2026 touchnet_tpu authors.
# Restart wrapper around the launcher: run the train command, restart it
# from the last checkpoint when it fails.
#
# Port of touchnet_tpu/bin/elastic.py (run_elastic :25, main), the wrapper
# that examples/text/pretrain/allenai_c4/run.sh:102 puts round stage 2.
# There the child is the JAX train binary; here it is torchrun, which starts
# one touchnet_tpu_torch.bin.train process per card:
#
#     python -m touchnet_tpu_torch.bin.elastic --max-restarts 3 -- \
#         torchrun --standalone --nproc_per_node 8 \
#         -m touchnet_tpu_torch.bin.train --training_enable_ckpt true ...
#
# A failure (a non-zero exit, the StepWatchdog's abort with exit 124
# included) restarts the command after a backoff, up to --max-restarts
# times; the trainer resumes from its newest checkpoint
# (training_ckpt_load_step -1). SIGTERM and SIGINT are forwarded to the
# child as SIGTERM (torchrun passes it to every rank, which saves at the
# step boundary and exits) and end the loop: no restart after them.

import argparse
import signal
import subprocess
import sys
import time

from touchnet_tpu_torch.utils.logging import logger


def run_elastic(cmd, max_restarts: int = 3, backoff_s: float = 5.0) -> int:
    """Run ``cmd`` until it exits 0, a signal stops it, or the restarts are
    spent. Returns the last exit code."""
    attempt = 0
    child = None
    interrupted = False

    def forward(signum, frame):
        nonlocal interrupted
        # an operator's stop: forward it and do not restart afterwards
        interrupted = True
        if child is not None and child.poll() is None:
            child.send_signal(signal.SIGTERM)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread
            pass
    try:
        while True:
            if attempt:
                logger.warning(f"elastic: restart {attempt}/{max_restarts} in {backoff_s:.0f}s "
                               "(resumes from the last checkpoint)")
                time.sleep(backoff_s)
            if interrupted:
                return 1
            child = subprocess.Popen(cmd)
            rc = child.wait()
            if rc == 0:
                return 0
            if interrupted:
                logger.warning(f"elastic: stopped by signal (child rc={rc})")
                return rc
            logger.error(f"elastic: train exited rc={rc}")
            if attempt >= max_restarts:
                logger.error("elastic: restart budget exhausted")
                return rc
            attempt += 1
    finally:
        for sig, h in prev.items():
            if h is not None:
                signal.signal(sig, h)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="restart-with-resume wrapper around torchrun ... -m "
                    "touchnet_tpu_torch.bin.train")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--backoff-seconds", type=float, default=5.0)
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the full launch command")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (append: -- torchrun ... -m touchnet_tpu_torch.bin.train "
                     "...)")
    sys.exit(run_elastic(cmd, args.max_restarts, args.backoff_seconds))


if __name__ == "__main__":
    main()
