# Multi-process helpers of the port's CPU tests: spawn N processes, each a
# rank of a gloo process group with its own FileStore rendezvous under the
# test's tmp_path (never a fixed port: test files run side by side), run a
# function in each and collect what rank 0 (or each rank) returns. The
# workers import torch and the port only: no JAX, so a spawned process
# starts in ~2 s. Functions run in the workers must live in this module or
# another importable one.

import os
import pickle
import signal
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, out, fn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = fn(rank, *args)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 300.0) -> list:
    """fn(rank, *args) in `world` spawned gloo ranks; returns the ranks'
    results in rank order (pickled through files)."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    n = len(list(tmp.glob("rdzv_*")))
    store, out = tmp / f"rdzv_{n}", tmp / f"result_{n}"
    ctx = mp.start_processes(_entry, args=(world, str(store), str(out), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} on {world} ranks: no end in {timeout} s")
    except Exception as e:
        errs = sorted(tmp.glob(f"result_{n}.*.err"))
        raise RuntimeError("\n".join(p.read_text() for p in errs) or str(e)) from e
    return [pickle.load(open(f"{out}.{r}", "rb")) for r in range(world)]


# -- workers ---------------------------------------------------------------------


def train_main(rank, argv, state=False, stop_at=None):
    """bin.train.main on the CPU; returns the logged history, the dev lines
    and the last step, and with ``state`` every param, moment and the
    count, whole. With ``stop_at``, rank 0 alone gets SIGTERM in that step
    (every rank must save and stop after it)."""
    from touchnet_tpu_torch.bin import train as ttrain

    if stop_at is not None and rank == 0:
        real = ttrain.Trainer.train_step

        def step(self, *a):
            out = real(self, *a)
            if self.step == stop_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        ttrain.Trainer.train_step = step
    trainer = ttrain.main(argv, device=torch.device("cpu"))
    out = {"history": [{k: v for k, v in h.items() if not k.startswith("time")}
                       for h in trainer.metrics_processor.history],
           "dev": trainer.metrics_processor.dev_history, "step": trainer.step}
    if state:
        out["state"] = full_state(trainer)
    return out


def full_state(trainer) -> dict:
    """Every param and moment as a whole numpy array (DTensors gathered),
    and the count."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().cpu().numpy().copy()

    st = {k: whole(v) for k, v in trainer._model_state().items()}
    st.update({k: whole(v) for k, v in trainer._opt_state().items()})
    return st


def assert_states_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def vocab_ce(rank, h, w, labels, slen, ns):
    """The port's fused_linear_cross_entropy on this rank's vocab shard
    (tp = the world, f32): (loss_ps, loss_pt, acc), dh, this shard's dw,
    and the mesh coordinates of the world's DeviceMesh."""
    from touchnet_tpu_torch.parallel.loss_parallel import fused_linear_cross_entropy

    tp = dist.get_world_size()
    vl = w.shape[0] // tp
    ht = torch.tensor(h, requires_grad=True)
    wl = torch.tensor(w[rank * vl:(rank + 1) * vl], requires_grad=True)
    out = fused_linear_cross_entropy(
        ht, wl, torch.from_numpy(labels), torch.from_numpy(slen), ns,
        compute_dtype=torch.float32, tp_group=dist.group.WORLD, vocab_start=rank * vl)
    out[0].backward()
    return [float(x) for x in out], ht.grad.numpy(), wl.grad.numpy()


def mesh_coords(rank, shape):
    """This rank's coordinates in ParallelDims.build_mesh's DeviceMesh, its
    dp rank, and utils/distributed's reductions of rank + 1 over the world
    (after a barrier) and over the mesh's tp group."""
    from touchnet_tpu_torch.parallel.dims import ParallelDims
    from touchnet_tpu_torch.utils import distributed as d

    pp, dpr, dps, cp, tp = shape
    pd = ParallelDims(dp_replicate=dpr, dp_shard=dps, cp=cp, tp=tp, pp=pp)
    mesh = pd.build_mesh("cpu")
    d.barrier()
    x = rank + 1
    world = (d.dist_max(x), d.dist_min(x), d.dist_sum(x), d.dist_mean(x))
    tp_sum = d.dist_sum(x, mesh["tp"].get_group())
    return tuple(mesh.get_coordinate()), pd.dp_rank(), world, tp_sum
