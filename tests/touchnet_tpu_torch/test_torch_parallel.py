# The port's data- and tensor-parallel layer against the JAX package on the
# CPU, without the trainer:
#   - ParallelDims: every rank's mesh coordinates and dp rank equal JAX's
#     (the row-major reshape of its devices) over several layouts, also in
#     a real DeviceMesh of 4 gloo ranks; its validation raises naming the
#     flags;
#   - the vocab-parallel pack loss (parallel/loss_parallel.py) at tp 2 and
#     4, each rank a gloo process with its vocab shard of the head, against
#     JAX's fused_linear_cross_entropy on a tp mesh: the three values, dh on
#     every rank and the gathered dw, f32, rtol 1e-5 (the summation order of
#     two frameworks' matmuls and logsumexps); an argmax tie across the
#     shard boundary goes to the smallest global index. The same combine
#     over a stacked shard axis in one process (as the card's check runs
#     it) gives the same values and gradients;
#   - the plan's refusals: tp not dividing num_key_value_heads, cp and pp;
#     a dp_only TrainSpec (qwen2_audio, kimi_audio) at tp, cp or pp > 1.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dist_workers import mesh_coords, spawn, vocab_ce

from touchnet_tpu.parallel.dims import ParallelDims as JParallelDims
from touchnet_tpu.parallel.dims import _device_coords
from touchnet_tpu.parallel.loss_parallel import fused_linear_cross_entropy as jflce
from touchnet_tpu_torch.ops import fused_ce
from touchnet_tpu_torch.parallel import loss_parallel as lp
from touchnet_tpu_torch.parallel.dims import MESH_AXES, ParallelDims

LAYOUTS = [  # (pp, dp_replicate, dp_shard, cp, tp)
    (1, 1, 8, 1, 1), (1, 2, 4, 1, 1), (1, 2, 2, 1, 2), (1, 1, 2, 1, 4),
    (2, 1, 2, 2, 1), (1, 4, 1, 1, 2), (2, 2, 1, 1, 2),
]


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: "x".join(map(str, s)))
def test_mesh_coords_and_dp_rank_match_jax(shape):
    pp, dpr, dps, cp, tp = shape
    world = pp * dpr * dps * cp * tp
    ours = ParallelDims(dp_replicate=dpr, dp_shard=dps, cp=cp, tp=tp, pp=pp, world_size=world)
    theirs = JParallelDims(dp_replicate=dpr, dp_shard=dps, cp=cp, tp=tp, pp=pp,
                           world_size=world)
    mesh = theirs.build_mesh(jax.devices()[:world])
    assert tuple(mesh.axis_names) == MESH_AXES
    for r in range(world):
        c = dict(zip(MESH_AXES, _device_coords(mesh, jax.devices()[r])))
        assert ours.coords(r) == c, r
        assert ours.dp_rank(r) == c["dp_replicate"] * theirs.dp_shard + c["dp_shard"]
    assert ours.dp_degree == theirs.dp_degree


def test_device_mesh_of_four_ranks(tmp_path):
    """build_mesh over 4 gloo ranks: each rank's DeviceMesh coordinates are
    ParallelDims.coords (JAX's), the dp rank its loader stream; the
    dist_* reductions of rank + 1 over the world and over a tp group."""
    shape = (1, 2, 1, 1, 2)
    pd = ParallelDims(dp_replicate=2, dp_shard=1, tp=2, world_size=4)
    got = spawn(mesh_coords, 4, tmp_path, shape)
    for r, (coords, dp_rank, world, tp_sum) in enumerate(got):
        assert dict(zip(MESH_AXES, coords)) == pd.coords(r)
        assert dp_rank == pd.dp_rank(r) == r // 2
        assert world == (4.0, 1.0, 10.0, 2.5)
        assert tp_sum == (1 + 2 if r < 2 else 3 + 4)


@pytest.mark.parametrize("kw,flag", [
    (dict(dp_shard=2), "training_data_parallel_shard_degree=2"),
    (dict(tp=3), "training_tensor_parallel_degree=3"),
    (dict(dp_replicate=0), "training_data_parallel_replicate_degree=0"),
])
def test_dims_validation_names_the_flags(kw, flag):
    with pytest.raises(ValueError, match=flag):
        ParallelDims(world_size=4, **kw) if "tp" in kw else ParallelDims(world_size=1, **kw)


def test_dims_autofill():
    pd = ParallelDims(dp_replicate=2, tp=2, world_size=8)
    assert pd.dp_shard == 2 and pd.dp_degree == 4 and pd.non_data_parallel_size == 2


B, T, E, V = 2, 24, 16, 64


def _ce_inputs(seed, tp):
    """Rows with a padding tail; rows 0 and 1 of batch 0 hold the row max
    twice, at the last id of shard 0 and the first of shard 1, with the
    label on one of them."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, E)).astype(np.float32)
    w = (rng.normal(size=(V, E)) * 0.1).astype(np.float32)
    vl = V // tp
    w[vl - 1] = w[vl] = 3.0 * h[0, 0] / np.linalg.norm(h[0, 0])
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, 0] = vl - 1
    labels[:, -4:] = -100
    slen = np.full((B, T), 6, np.int32)
    return h, w, labels, slen, 8.0


def _jax_ce(h, w, labels, slen, ns, tp):
    mesh = JParallelDims(dp_shard=1, tp=tp, world_size=tp).build_mesh(jax.devices()[:tp])

    def f(hh, ww):
        out = jflce(hh, ww, jnp.asarray(labels), jnp.asarray(slen), jnp.asarray(ns),
                    mesh=mesh, compute_dtype=jnp.float32)
        return out[0], out

    with mesh:
        (_, vals), (dh, dw) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(h), jnp.asarray(w))
    return [float(v) for v in vals], np.asarray(dh), np.asarray(dw)


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_ce_matches_jax_mesh(tmp_path, tp):
    h, w, labels, slen, ns = _ce_inputs(tp, tp)
    want, want_dh, want_dw = _jax_ce(h, w, labels, slen, ns, tp)
    got = spawn(vocab_ce, tp, tmp_path, h, w, labels, slen, ns)
    for vals, dh, _ in got:
        np.testing.assert_allclose(vals, want, rtol=1e-5)
        np.testing.assert_allclose(dh, want_dh, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([g[2] for g in got]), want_dw, rtol=1e-5,
                               atol=1e-7)
    # the tie at (0, 0): the label is the smaller id, so it counts as a hit
    single = lp.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
        torch.from_numpy(slen), ns, compute_dtype=torch.float32)
    assert float(single[2]) == pytest.approx(want[2], rel=1e-6)
    logits = h[0, 0] @ w.T
    assert logits[V // tp - 1] == logits[V // tp] == logits.max()


def _stacked_reduce(t, op):
    """combine_vocab_shards' reduction over a leading shard axis."""
    if op == "sum":
        return t.sum(0, keepdim=True).expand_as(t)
    red = t.amax(0, keepdim=True) if op == "max" else t.amin(0, keepdim=True)
    return red.expand_as(t)


@pytest.mark.parametrize("tp", [2, 4])
def test_stacked_combine_equals_whole_vocab(tp):
    """K3's plain version on each shard, combined over a stacked shard axis
    in one process: lse, label logit, argmax (ties across the boundary to
    the smaller id), dh and dw equal the whole-vocab rows at f32."""
    h, w, labels, _, _ = _ce_inputs(5, tp)
    n = B * T
    h2, lab = torch.from_numpy(h.reshape(n, E)), torch.from_numpy(labels.reshape(n))
    vl = V // tp
    wt = torch.from_numpy(w)
    hs = h2.clone().requires_grad_()
    ws = wt.clone().requires_grad_()
    stats = [fused_ce.fused_ce_rows(hs, ws[s * vl:(s + 1) * vl], lab - s * vl)
             for s in range(tp)]
    lse, tl, m2, ai = (torch.stack(x) for x in zip(*stats))
    starts = torch.arange(tp, dtype=torch.int32)[:, None] * vl
    lse, tl, ai = lp.combine_vocab_shards(lse, tl, m2, ai, starts, _stacked_reduce)
    hw = h2.clone().requires_grad_()
    ww = wt.clone().requires_grad_()
    lse1, tl1, _, ai1 = fused_ce.fused_ce_rows(hw, ww, lab)
    torch.testing.assert_close(lse[0], lse1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tl[0], tl1, rtol=0, atol=0)
    assert torch.equal(ai[0], ai1) and int(ai1[0]) == vl - 1
    r = torch.from_numpy(np.random.default_rng(6).normal(size=(2, n)).astype(np.float32))
    ((lse[0] * r[0]).sum() + (tl[0] * r[1]).sum()).backward()
    ((lse1 * r[0]).sum() + (tl1 * r[1]).sum()).backward()
    torch.testing.assert_close(hs.grad, hw.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ws.grad, ww.grad, rtol=1e-5, atol=1e-6)


class _FakeMesh:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n

    def get_group(self):
        return None


def test_tp_must_divide_kv_heads():
    """Each rank's K1/K2 take whole heads: tp 4 over tiny_llama's 2 kv
    heads raises naming the flag (JAX's GSPMD would split inside a head)."""
    import os

    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
    from touchnet_tpu_torch.models.llama.modeling_llama import init_params
    from touchnet_tpu_torch.parallel.sharding import apply_tp

    cfg = LlamaConfig.from_json_file(os.path.join(os.path.dirname(__file__), "..", "assets",
                                                  "config", "tiny_llama.json"))
    model = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="training_tensor_parallel_degree=4 does not divide "
                                         "num_key_value_heads=2"):
        apply_tp(model, _FakeMesh(4))


DP_ONLY_FLAGS = ("training_tensor_parallel_degree", "training_context_parallel_degree",
                 "training_pipeline_parallel_degree")


@pytest.mark.parametrize("flag", DP_ONLY_FLAGS)
@pytest.mark.parametrize("model", ["qwen2_audio", "kimi_audio"])
def test_dp_only_specs_refuse_model_parallel_degrees(model, flag):
    """qwen2_audio's and kimi_audio's TrainSpecs are dp_only (FSDP, HSDP
    and DDP only): tp, cp or pp at 2 raises naming the flag, as the JAX
    trainer asserts (touchnet_tpu/bin/train.py:353-358); degree 1 of each,
    and llama and touch_audio at 2, pass the check."""
    from touchnet_tpu_torch.bin import TrainConfig
    from touchnet_tpu_torch.bin.train import check_dp_only
    from touchnet_tpu_torch.utils.train_spec import get_train_spec

    spec = get_train_spec(model)
    assert spec.dp_only
    with pytest.raises(ValueError, match=f"{flag}=2: {model}'s TrainSpec is dp_only"):
        check_dp_only(spec, TrainConfig(**{flag: 2}))
    check_dp_only(spec, TrainConfig())
    for other in ("llama", "touch_audio"):
        check_dp_only(get_train_spec(other), TrainConfig(**{flag: 2}))
