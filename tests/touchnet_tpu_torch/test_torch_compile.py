# --training_compile on the CPU (inductor's C++ backend), tiny Llama
# (tests/assets/config/tiny_llama.json, 2 layers), f32, liger on (K3's op):
#   - the custom ops of K1's forward, K2 and K3's two directions pass
#     torch.library.opcheck through their CPU (plain) bodies: schema, fake
#     implementation, autograd registration, AOT dispatch with dynamic
#     shapes;
#   - under none, op_small and full, the compiled Trainer's step against the
#     JAX Trainer's jitted step (training_compile true) on the same weights
#     and batch, loss and grad norm rtol 1e-5 (as test_torch_train's
#     assembled JAX step), and against the port's eager step at rtol 1e-5
#     (inductor orders some sums otherwise: not bit-equal);
#   - the remat under compile: the K1 op calls of a forward and backward
#     and the projections the backward recomputes, compiled as eager;
#   - graphs: the llama block and the loss compile with no graph break,
#     4 steps whose num_sentence differs recompile no frame, and the dev
#     pass runs the compiled graphs (the same entries);
#   - under symbolic sizes a compiled block takes no host scalar tensor;
#   - the NCCL flight recorder's environment (training_trace_buf_size).
# Each mode's Trainers are built once (a module fixture) and shared by its
# tests: a compile costs ~10-20 s here.

import gc
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_services import _trainer
from test_torch_train import CFG, _CountRecompute, _flags, build_corpus

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.models import whisper_encoder
from touchnet_tpu_torch.models.llama import modeling_llama as tmodel
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.ops import attention as attn
from touchnet_tpu_torch.ops import fused_ce
from touchnet_tpu_torch.parallel.sharding import configure_compile
from touchnet_tpu_torch.utils import distributed as tdist

MODES = ("none", "op_small", "full")
KEYS = ("loss/per_sample", "grad_norm")


def _op_cases():
    g = torch.Generator().manual_seed(0)
    B, T, H, Hkv, D = 2, 16, 4, 2, 64
    q, k, v = (torch.randn(B, T, h, D, generator=g, requires_grad=True)
               for h in (H, Hkv, Hkv))
    seg = torch.tensor([[1] * 8 + [2] * 8, [1] * 12 + [0] * 4], dtype=torch.int32)
    out, lse = attn.packed_attention_reference(q.detach(), k.detach(), v.detach(), seg, True,
                                               0.125)
    dout = torch.randn(out.shape, generator=g)
    N, E, V = 12, 32, 50
    h = torch.randn(N, E, generator=g, requires_grad=True)
    w = torch.randn(V, E, generator=g, requires_grad=True)
    labels = torch.randint(0, V, (N,), generator=g)
    labels[3] = -100
    rows = fused_ce._rows_reference(h.detach(), w.detach(), labels)
    return {
        "k1_fwd": (attn.FLASH_FWD_OP, (q, k, v, seg, seg, True, 0.125, 3, 0)),
        "k2": (attn.FLASH_BWD_OP, (q.detach(), k.detach(), v.detach(), seg, seg, out, lse,
                                   dout, True, 0.125, 0, 0)),
        "k3_fwd": (fused_ce.CE_FWD_OP, (h, w, labels)),
        "k3_bwd": (fused_ce.CE_BWD_OP, (h.detach(), w.detach(), labels, rows[0],
                                        torch.randn(N, generator=g), torch.randn(N, generator=g))),
    }


@pytest.mark.parametrize("name", ["k1_fwd", "k2", "k3_fwd", "k3_bwd"])
def test_opcheck(name):
    op, args = _op_cases()[name]
    got = torch.library.opcheck(op, args)
    assert set(got.values()) == {"SUCCESS"}, got


def _jax_step(argv, batch):
    """The JAX Trainer's jitted step on ``batch`` (one device, dp 1, as the
    port's one process): (its params, its metrics)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "device_count", lambda *a: 1)
        gc_on = gc.isenabled()
        jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                              argv + ["--training_compile", "true"]))
        try:
            params = jax.tree.map(np.asarray, jt.params)  # the step donates its inputs
            db, jns = jt._put_batch(batch)
            _, _, met = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
            return params, {k: float(met[k]) for k in KEYS}
        finally:
            jt.close()
            if gc_on:  # the JAX trainer turns automatic GC off for good
                gc.enable()


def _counts(trainer, batch, remat):
    """K1 op calls of a forward and backward of the trainer's model on
    ``batch`` (the plain K1 counted where the op body calls it, which no
    trace skips), and the projection matmuls its backward recomputes."""
    calls = []
    real = attn.packed_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    attn.packed_attention_reference = counted
    try:
        logits = tmodel.forward(
            trainer.model, input_ids=torch.from_numpy(batch["input_ids"]),
            segment_ids=torch.from_numpy(batch["attention_mask"]),
            position_ids=torch.from_numpy(batch["position_ids"]),
            config=trainer.model_config, compute_dtype=torch.float32, remat_mode=remat)
        with _CountRecompute(trainer.model) as mode:
            logits.square().mean().backward()
    finally:
        attn.packed_attention_reference = real
    trainer.model.zero_grad()
    return len(calls), mode.dots


@pytest.fixture(scope="module", params=MODES)
def runs(request, tmp_path_factory):
    """One mode: the JAX Trainer's step, the port's eager and compiled steps
    on the JAX weights and the loader's first batch, their remat counts;
    for op_small also 4 more compiled steps and a dev pass, with the run's
    summary."""
    remat = request.param
    tmp = tmp_path_factory.mktemp(f"compile_{remat}")
    listfile = build_corpus(tmp)
    out = {"remat": remat}
    argv = _flags(tmp / "jax", listfile, 10, training_activation_checkpoint_mode=remat,
                  datalist_dev_path=listfile)
    eager = _trainer(argv)
    batch = next(iter(eager.dataloader))
    jparams, out["jax"] = _jax_step(argv, batch)
    state = params_from_jax_numpy(jparams, LlamaConfig.from_json_file(CFG))
    for name, compile_ in (("eager", "false"), ("compiled", "true")):
        trainer = eager if name == "eager" else _trainer(
            _flags(tmp / name, listfile, 10, training_activation_checkpoint_mode=remat,
                   training_compile=compile_, datalist_dev_path=listfile))
        trainer.model.load_state_dict(state)
        device_batch, ns = trainer._put_batch(batch)
        met = trainer.train_step(device_batch, ns)
        out[name] = {k: float(met[k]) for k in KEYS}
        out[f"{name} counts"] = _counts(trainer, batch, remat)
        if name == "compiled":
            out["first summary"] = trainer._compile_summary()
        if name == "compiled" and remat == "op_small":
            sentences = [ns]
            for _, b in zip(range(4), trainer.dataloader):
                device_batch, ns = trainer._put_batch(b)
                trainer.train_step(device_batch, ns)
                sentences.append(ns)
            trainer.dev()
            out["sentences"] = sentences
            out["dev"] = trainer.metrics_processor.dev_history
            out["summary"] = trainer._compile_summary()
        trainer.close()
    return out


def test_compiled_step_matches_jax_and_eager(runs):
    for k in KEYS:
        np.testing.assert_allclose(runs["compiled"][k], runs["jax"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(runs["compiled"][k], runs["eager"][k], rtol=1e-5, err_msg=k)
    assert runs["compiled"]["grad_norm"] > 1.0  # the clip engaged


def test_remat_counts_compiled_equal_eager(runs):
    """The compiled graphs save what the eager checkpoint saves: the same
    K1 op calls (a forward's 2 and the recomputes) and the same recomputed
    projections, named by their weights."""
    L = LlamaConfig.from_json_file(CFG).num_hidden_layers
    flash, dots = runs["compiled counts"]
    assert (flash, dots) == runs["eager counts"]
    want = {"none": (L, {}), "op_small": (L, {"dot_gate": L, "dot_up": L})}
    if runs["remat"] in want:
        assert (flash, dots) == want[runs["remat"]]
    else:  # full: K1 and q, k, v, o, gate, up once more a layer
        assert flash == 2 * L and dots == {n: L for n in tmodel.LlamaDecoderLayer.DOTS[:6]}


def test_graphs_and_recompiles(runs):
    """No graph break in the block or the loss, one graph each after a
    step; on the op_small run, over steps whose num_sentence differs no
    frame recompiles for it (a device tensor), and the dev pass runs the
    same graphs (grad enabled, no new entry)."""
    first = runs["first summary"]
    assert first["graph_breaks"] == 0 and first["recompiles"] == 0, first
    assert first["cache_entries"] == {"LlamaDecoderLayer": 1, "fused_loss": 1, "loss": 0}
    if runs["remat"] != "op_small":
        return
    s = runs["summary"]
    assert len(set(runs["sentences"])) > 1, runs["sentences"]
    assert s["graph_breaks"] == 0 and s["graph_break_reasons"] == {}
    assert s["cache_entries"] == {"LlamaDecoderLayer": 1, "fused_loss": 1, "loss": 0}, s
    assert s["recompiles"] == 0 and s["seconds"] > 0
    assert len(runs["dev"]) == 1 and np.isfinite(runs["dev"][0]["loss_per_sample"])


@pytest.mark.parametrize("family", ["llama", "whisper"])
def test_compiled_blocks_take_no_host_scalar(family):
    """Under the trainer's settings (configure_compile), with every size
    symbolic (harsher than the trainer's symbolic rows and lengths) a
    compiled block's inputs are the activations, the weights and sizes: no Python float (a norm's eps, a scale) becomes a
    0-d host tensor, for which inductor would write a CPU kernel on the
    card. Recorded by a backend that keeps each graph's example inputs."""
    configure_compile()
    graphs = []

    def record(gm, example_inputs):
        graphs.append(example_inputs)
        return gm.forward

    if family == "llama":
        cfg = LlamaConfig.from_json_file(CFG)
        model = tmodel.init_params(cfg, torch.Generator().manual_seed(0), requires_grad=True,
                                   train=True)
        layers = model.model.layers
    else:
        cfg = whisper_encoder.WhisperEncoderConfig(
            d_model=64, encoder_attention_heads=1, encoder_ffn_dim=128, encoder_layers=2,
            num_mel_bins=16)
        model = whisper_encoder.init_params(cfg, torch.Generator().manual_seed(0))
        model.requires_grad_(True).train()
        layers = model.layers
    for layer in layers:  # as apply_compile, recording, every dim symbolic
        layer.compiled_block = torch.compile(type(layer).checkpointed_block, backend=record,
                                             fullgraph=True, dynamic=True)
        layer.dynamic_rows = True
    for rows in (3, 5):
        if family == "llama":
            out = tmodel.forward(model, input_ids=torch.ones((rows, 24), dtype=torch.int32),
                                 config=cfg, compute_dtype=torch.float32, remat_mode="full")
        else:
            out = whisper_encoder.forward(model, torch.randn(rows, 16, 80), cfg,
                                          compute_dtype=torch.float32, remat_mode="full")
        out.square().mean().backward()
    (inputs,) = graphs  # one graph, symbolic in the rows
    scalars = [x for x in inputs if isinstance(x, torch.Tensor) and x.dim() == 0]
    assert not scalars and any(isinstance(x, torch.SymInt) for x in inputs), inputs


@pytest.mark.parametrize("backend,size,user,want", [
    ("nccl", 2000, {}, {"TORCH_NCCL_TRACE_BUFFER_SIZE": "2000",
                        "TORCH_NCCL_DUMP_ON_TIMEOUT": "1"}),
    ("nccl", 2000, {"TORCH_FR_BUFFER_SIZE": "7"}, {"TORCH_NCCL_DUMP_ON_TIMEOUT": "1"}),
    ("nccl", 0, {}, {}),
    ("gloo", 2000, {}, {}),
])
def test_flight_recorder_env(tmp_path, backend, size, user, want):
    """A nonzero training_trace_buf_size sizes NCCL's flight recorder and
    dumps it on a timeout into <dump>/comm_trace/; a variable the user set
    (under either of its names) is left alone; 0 and gloo set nothing."""
    env = dict(user)
    done = tdist.flight_recorder_env(size, str(tmp_path), backend, environ=env)
    prefix = str(tmp_path / "comm_trace" / "nccl_trace_rank_")
    if want:
        want = {**want, "TORCH_NCCL_DEBUG_INFO_TEMP_FILE": prefix}
    assert done == want and env == {**user, **want}
    assert (tmp_path / "comm_trace").is_dir() == bool(want)
    state = tdist.flight_recorder_state(env)
    assert state["buffer_size"] == (int(user.get("TORCH_FR_BUFFER_SIZE", size)) if want else 0)
    assert state["dump_prefix"] == (prefix if want else None)
    assert not tdist.dump_flight_recorder(str(tmp_path / "x.pkl"))  # no NCCL group here
    json.dumps(state)
