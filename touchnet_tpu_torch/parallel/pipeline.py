# Copyright (c) 2026 touchnet_tpu authors.
# Pipeline parallelism: the stage split, the schedules and their runner
# over the "pp" ranks.
#
# Port of touchnet_tpu/parallel/pipeline.py: SUPPORTED_SCHEDULES (:54),
# stage_layer_counts (:90), parse_split_points (:307), virtual_stages_of
# (:340) and validate_pp_composition (:359), with pipeline_apply (:104)
# rebuilt for one process a rank. JAX runs one SPMD program whose lockstep
# tick loop is differentiated as a whole (shard_map, ppermute, scan); here
# each pp rank builds only the layers of its stages and runs its own list of
# actions, each the forward (F) or the backward (B) of one microbatch
# through one of its chunks:
#   GPipe            every forward, then every backward;
#   1F1B             stage s runs min(S-1-s, M) warm-up forwards, then one
#                    forward and one backward in turn, then the remaining
#                    backwards;
#   Interleaved1F1B  the same over V chunks a rank (rank s holds the
#                    semantic stages {v*S + s}, JAX's strided assignment):
#                    the forwards go round by round (chunk v takes the M
#                    microbatches of round v, stage S-1 hands each to stage
#                    0 for the next round, JAX's ring), the backwards in the
#                    reverse rounds, after 2(S-1-s) + (V-1)M warm-up
#                    forwards.
# A backward is torch.autograd.backward on the stage's output with the
# gradient the next stage sent (the last stage: its microbatch's loss). In
# exact arithmetic every schedule computes the step that one process
# computes; the order changes only the memory held (the stage inputs and
# outputs of the microbatches in flight).
#
# The actions of every rank are laid on one timeline (timeline below): a
# tick runs at most one action a rank, an action runs at the first tick
# after its input was made, and what a tick makes is exchanged at its end,
# each rank posting the sends and receives of that tick in one batch
# (utils/distributed.start_p2p, the ring attention's transport: through
# host buffers over gloo, on the device under NCCL). Every rank derives the
# same timeline, so each receive has its send at the same tick, and a rank
# waits only for what it receives: no deadlock, and the message order
# between two ranks is the same on both sides (NCCL matches by order).
#
# Differences from JAX by design: a stage with fewer layers, or none (L 3
# at S*V 4 gives [1, 1, 1, 0]), holds only what it has and passes its
# input on: no padded identity slots; the remat modes apply per layer
# (JAX rematerialises each tick's whole stage); the data flags' checks are
# ValueErrors naming them where JAX asserts, and the schedules that JAX
# refuses (ZBVZeroBubble, a CSV schedule, a split other than the ceil
# blocks) raise ValueErrors naming their flags.

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from touchnet_tpu_torch.utils.distributed import start_p2p

SUPPORTED_SCHEDULES = ("1F1B", "GPipe", "Interleaved1F1B")

FORWARD, BACKWARD = "F", "B"


def stage_layer_counts(num_layers: int, pp: int, virtual: int = 1):
    """Per-semantic-stage layer counts under the contiguous ceil-block
    split: K = ceil(L / (S*V)), stage t holds layers [t*K, min((t+1)*K, L))."""
    n = pp * virtual
    K = -(-num_layers // n)
    counts = [max(0, min(num_layers - t * K, K)) for t in range(n)]
    return counts, K


def stage_layers(num_layers: int, pp: int, virtual: int, rank: int) -> List[List[int]]:
    """The global layer indices of pp rank ``rank``'s chunks: chunk v is the
    semantic stage v*pp + rank, layers [t*K, t*K + counts[t])."""
    counts, K = stage_layer_counts(num_layers, pp, virtual)
    return [list(range(t * K, t * K + counts[t]))
            for t in (v * pp + rank for v in range(virtual))]


def parse_split_points(split_points: Optional[str], num_layers: int, pp: int,
                       virtual: int = 1) -> None:
    """training_pipeline_parallel_split_points: accepted only when it names
    the ceil-block split (JAX's rule, :307-337; every stage runs its layers
    in turn, so the largest stage, >= ceil(L/n) layers, sets the step time,
    and that split reaches it); any other raises a ValueError naming the
    flag with the arithmetic."""
    if not split_points:
        return
    n = pp * virtual
    _, K = stage_layer_counts(num_layers, pp, virtual)
    pts = [int(p) for p in str(split_points).split(",") if str(p).strip()]
    expected = [min(K * i, num_layers) for i in range(1, n)]
    if pts != expected:
        raise ValueError(
            f"training_pipeline_parallel_split_points={pts}: the largest stage (>= ceil(L/n) "
            f"layers) sets the step time and the ceil-block split {expected} ({num_layers} "
            f"layers, pp={pp} x {virtual} virtual stages) reaches it, so any other split is "
            "equivalent or slower; use that split or omit the flag")


def virtual_stages_of(split_points: Optional[str], num_layers: int, pp: int,
                      schedule: str) -> int:
    """Chunks a pp rank holds: 1, or for Interleaved1F1B the count of the
    split points' stages over pp (2 without split points). A stage count
    that pp does not divide raises naming the flag."""
    if schedule != "Interleaved1F1B":
        return 1
    if split_points:
        n_stages = len([p for p in str(split_points).split(",") if str(p).strip()]) + 1
        if n_stages % pp != 0:
            raise ValueError(f"training_pipeline_parallel_split_points: {n_stages} pipeline "
                             f"stages do not divide training_pipeline_parallel_degree={pp}")
        return max(1, n_stages // pp)
    return 2


def validate_pp_composition(job_config) -> None:
    """The schedule flags: a CSV schedule and a schedule outside
    SUPPORTED_SCHEDULES raise a ValueError naming the flag (JAX :359-378:
    they split the weight backward from the activation backward)."""
    if job_config.training_pipeline_parallel_schedule_csv:
        raise ValueError(
            f"training_pipeline_parallel_schedule_csv="
            f"{job_config.training_pipeline_parallel_schedule_csv!r}: CSV schedules split the "
            f"weight backward from the activation backward; use one of {SUPPORTED_SCHEDULES}")
    if job_config.training_pipeline_parallel_schedule not in SUPPORTED_SCHEDULES:
        raise ValueError(
            f"training_pipeline_parallel_schedule="
            f"{job_config.training_pipeline_parallel_schedule!r}: supported "
            f"{SUPPORTED_SCHEDULES}")


def check_microbatches(rows: int, microbatches: int, pp: int, virtual: int,
                       what: str = "dataset_batchsize") -> None:
    """The rows of a rank's batch (``what``) split into ``microbatches``;
    Interleaved1F1B (virtual > 1) needs microbatches >= pp (JAX :132-139).
    A ValueError names both flags."""
    if microbatches < 1:
        raise ValueError(f"training_pipeline_parallel_microbatches={microbatches}: must be >= 1")
    if rows % microbatches:
        raise ValueError(f"{what}={rows} rows a data-parallel rank do not split into "
                         f"training_pipeline_parallel_microbatches={microbatches}")
    if virtual > 1 and microbatches < pp:
        raise ValueError(f"training_pipeline_parallel_microbatches={microbatches}: "
                         f"Interleaved1F1B needs at least training_pipeline_parallel_degree="
                         f"{pp} microbatches")


# -- the schedules ----------------------------------------------------------------

Action = Tuple[str, int, int]  # (F or B, chunk v, microbatch m)


def stage_order(schedule: str, pp: int, microbatches: int, virtual: int, stage: int,
                train: bool = True) -> List[Action]:
    """Pp rank ``stage``'s actions in order. Without ``train``, the
    forwards alone, round by round (the dev pass)."""
    S, M, V = pp, microbatches, virtual
    fwd = [(v, m) for v in range(V) for m in range(M)]
    if not train:
        return [(FORWARD, v, m) for v, m in fwd]
    bwd = [(V - 1 - v, m) for v in range(V) for m in range(M)]
    if schedule == "GPipe":
        return [(FORWARD, v, m) for v, m in fwd] + [(BACKWARD, v, m) for v, m in bwd]
    if schedule == "Interleaved1F1B":
        warm = 2 * (S - 1 - stage) + (V - 1) * M
    else:
        warm = S - 1 - stage
    warm = min(warm, len(fwd))
    order = [(FORWARD, v, m) for v, m in fwd[:warm]]
    for i in range(len(fwd) - warm):
        order += [(FORWARD, *fwd[warm + i]), (BACKWARD, *bwd[i])]
    order += [(BACKWARD, v, m) for v, m in bwd[len(fwd) - warm:]]
    return order


def _source(action: Action, stage: int, S: int, V: int) -> Optional[Tuple[str, int, int, int]]:
    """What ``action`` of rank ``stage`` waits for from another rank:
    (kind, producing rank, its chunk, microbatch), or None."""
    kind, v, m = action
    t, n = v * S + stage, S * V
    if kind == FORWARD:
        return None if t == 0 else (FORWARD, (t - 1) % S, (t - 1) // S, m)
    return None if t == n - 1 else (BACKWARD, (t + 1) % S, (t + 1) // S, m)


def timeline(schedule: str, pp: int, microbatches: int, virtual: int,
             train: bool = True) -> List[Dict[int, Action]]:
    """Every rank's actions on one clock: tick k maps rank -> its action.
    An action runs at the first tick after the one that made its input.
    Raises a RuntimeError if the orders cannot all run (a cycle)."""
    S, V = pp, virtual
    orders = [stage_order(schedule, S, microbatches, V, s, train) for s in range(S)]
    done: Dict[Tuple, int] = {}  # (kind, rank, v, m) -> tick
    pos = [0] * S
    ticks = []
    while any(p < len(o) for p, o in zip(pos, orders)):
        k = len(ticks)
        now = {}
        for s in range(S):
            if pos[s] == len(orders[s]):
                continue
            act = orders[s][pos[s]]
            src = _source(act, s, S, V)
            if src is None or done.get(src, k) < k:
                now[s] = act
        if not now:
            raise RuntimeError(f"pipeline schedule {schedule} (pp {S}, microbatches "
                               f"{microbatches}, virtual {V}) cannot proceed")
        for s, act in now.items():
            done[(act[0], s, act[1], act[2])] = k
            pos[s] += 1
        ticks.append(now)
    return ticks


def _tag(kind: str, t: int, m: int, n: int, M: int) -> int:
    """The message of stage t's input (F) or output gradient (B) of
    microbatch m: one tag each."""
    return ((0 if kind == FORWARD else 1) * n + t) * M + m


class Pipeline:
    """One pp rank's part of a step: ``run(forward_fn, shape, dtype)``
    drives the schedule. forward_fn(v, m, x) runs chunk v on microbatch m
    (x: the stage input received, None on semantic stage 0) and returns the
    stage output, or on the last semantic stage the microbatch's loss (a
    scalar to differentiate; None without ``train``). ``shape`` and
    ``dtype`` are those of a stage's input and output (every microbatch's
    the same)."""

    def __init__(self, schedule: str, pp: int, microbatches: int, virtual: int, stage: int,
                 group, device: torch.device):
        self.schedule, self.S, self.M, self.V = schedule, pp, microbatches, virtual
        self.stage, self.group, self.device = stage, group, device
        # NCCL's first call on a group must involve all its ranks; a tick's
        # point-to-point involves two
        dist.barrier(group=group)

    def peer(self, rank: int) -> int:
        """Pp rank ``rank``'s global rank (this rank's dp, cp and tp)."""
        return dist.get_global_rank(self.group, rank)

    def _plan(self, train: bool):
        """Per tick: this rank's action, its sends (key, peer rank, tag) and
        receives (key, peer rank, tag); keys are (F, t, m), the input of
        stage t, and (B, t, m), the gradient of stage t's output."""
        S, V, M, s = self.S, self.V, self.M, self.stage
        n = S * V
        plan = []
        for now in timeline(self.schedule, S, M, V, train):
            act, sends, recvs = now.get(s), [], []
            for r, (kind, v, m) in now.items():
                t = v * S + r
                # the consumer of what rank r made at this tick
                if kind == FORWARD and t + 1 < n:
                    key, dst = (FORWARD, t + 1, m), (t + 1) % S
                elif kind == BACKWARD and train and t > 0:
                    key, dst = (BACKWARD, t - 1, m), (t - 1) % S
                else:
                    continue
                tag = _tag(key[0], key[1], m, n, M)
                if r == s:
                    sends.append((key, dst, tag))
                elif dst == s:
                    recvs.append((key, r, tag))
            plan.append((act, sends, recvs))
        return plan

    def run(self, forward_fn: Callable, shape, dtype, train: bool = True) -> None:
        S, s, n = self.S, self.stage, self.S * self.V
        inbox: Dict[Tuple, torch.Tensor] = {}
        saved: Dict[Tuple[int, int], Tuple] = {}
        pending = []
        for act, sends, recvs in self._plan(train):
            made = None
            if act is not None:
                kind, v, m = act
                t = v * S + s
                if kind == FORWARD:
                    x = None if t == 0 else inbox.pop((FORWARD, t, m))
                    if x is not None and train:
                        x.requires_grad_(True)
                    y = forward_fn(v, m, x)
                    if train:
                        saved[(v, m)] = (x, y)
                    made = y if t + 1 < n else None
                else:
                    x, y = saved.pop((v, m))
                    if t == n - 1:
                        torch.autograd.backward(y)
                    else:
                        torch.autograd.backward(y, inbox.pop((BACKWARD, t, m)))
                    made = x.grad if x is not None else None
            if not sends and not recvs:
                continue
            wait = start_p2p([(made, self.peer(dst), tag) for _, dst, tag in sends],
                             [(shape, dtype, self.device, self.peer(src), tag)
                              for _, src, tag in recvs], self.group)
            if recvs:
                for (key, _, _), got in zip(recvs, wait()):
                    inbox[key] = got
            else:
                pending.append(wait)  # a send alone: waited for at the end
        for wait in pending:
            wait()
        if inbox or saved:
            raise RuntimeError(f"pipeline: {len(inbox)} messages and {len(saved)} stages "
                               "left at the end of the step")
