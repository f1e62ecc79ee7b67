# The port's trainer over gloo ranks on the CPU (bin.train.main in spawned
# processes, torchrun's environment, a FileStore rendezvous each) against
# the JAX Trainer at the same dp degree, which fixes the global batch (the
# cp layouts at their own layout): the JAX run takes as many of the pytest
# process's virtual devices as its world (jax.device_count patched, as
# test_torch_checkpoint does for 1), both start from the JAX init (a step_0
# seed checkpoint for the port), 3 steps on the tiny Llama in f32 with
# liger (the fused K3 loss):
#   - per-step loss_per_sample rtol 1e-5, grad_norm rtol 1e-4 (the two
#     frameworks' summation orders; the norm sums ~1e5 squares), and the
#     per-token loss and accuracy of the global batch rtol 1e-5, for
#     dp_shard 2, dp_replicate 2 (DDP), HSDP 2 x 2, dp_shard 2 x tp 2
#     with loss parallel (the vocab-parallel K3 combine, q/k/v heads split),
#     and context parallelism: cp 2 with each rotate method (allgather, and
#     alltoall, the ring) and dp_shard 2 x cp 2 (allgather; FSDP2 over the
#     flattened dp_shard x cp mesh), each rank on its half of every row;
#   - touch_audio at tp 2: V = 1025 is not divisible, so embed and head
#     stay whole, the projector's input width 161 too; its losses equal the
#     same run at world 1 (no JAX run: its own test holds world 1 to JAX);
#   - a 4-rank run (dp_shard 2 x tp 2) stopped by SIGTERM after step 2 and
#     resumed gives the uninterrupted run's later losses and final params,
#     moments and count bit for bit, and convert_ckpt_to_hf on the 4-rank
#     checkpoint equals the export of the same parameters written by one
#     process; a resume at another world size raises;
#   - one rank under FSDP2 (as on one card) against one process: bit-equal
#     in f32 and in bf16;
#   - at world 1 a degree that does not fit (tp, cp, pp) raises from
#     ParallelDims naming it (pp's layouts: test_torch_pipeline.py).

import gc
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from dist_workers import spawn, train_main
from test_torch_train import CFG, _flags, build_corpus
from torch.distributed.checkpoint import FileSystemWriter

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy

STEPS = 3
LAYOUTS = {
    "dp_shard2": (2, dict(training_data_parallel_shard_degree=2)),
    "ddp2": (2, dict(training_data_parallel_replicate_degree=2,
                     training_data_parallel_shard_degree=1)),
    "hsdp2x2": (4, dict(training_data_parallel_replicate_degree=2,
                        training_data_parallel_shard_degree=2)),
    "dp_shard2_tp2": (4, dict(training_data_parallel_shard_degree=2,
                              training_tensor_parallel_degree=2,
                              training_enable_loss_parallel="true")),
    "cp2_allgather": (2, dict(training_data_parallel_shard_degree=1,
                              training_context_parallel_degree=2,
                              training_context_parallel_rotate_method="allgather")),
    "cp2_alltoall": (2, dict(training_data_parallel_shard_degree=1,
                             training_context_parallel_degree=2,
                             training_context_parallel_rotate_method="alltoall")),
    "dp_shard2_cp2": (4, dict(training_data_parallel_shard_degree=2,
                              training_context_parallel_degree=2)),
}
# the JAX run each layout is held to: dp_shard at the layout's dp degree, or
# the cp layout itself
JAX_RUNS = {"dp2": (2, dict(training_data_parallel_shard_degree=2)),
            "dp4": (4, dict(training_data_parallel_shard_degree=4)),
            **{name: LAYOUTS[name] for name in ("cp2_allgather", "cp2_alltoall",
                                                "dp_shard2_cp2")}}
HELD_TO = {"dp_shard2": "dp2", "ddp2": "dp2", "hsdp2x2": "dp4", "dp_shard2_tp2": "dp2",
           "cp2_allgather": "cp2_allgather", "cp2_alltoall": "cp2_alltoall",
           "dp_shard2_cp2": "dp_shard2_cp2"}


def _jax_reference(tmp_path, listfile, world, flags):
    """The JAX Trainer with ``flags`` over ``world`` of the CPU devices: its
    params at init (as the port's state dict) and its logged metrics."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "device_count", lambda *a: world)
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                          _flags(tmp_path / "jax", listfile, STEPS, **flags)))
    try:
        init = params_from_jax_numpy(jax.tree.map(np.asarray, jt.params),
                                     LlamaConfig.from_json_file(CFG))
        logs = []
        jt.metrics_processor.log = lambda step, host: logs.append(dict(host))
        jt.train()
    finally:
        jt.close()
        mp.undo()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
    return init, logs[:STEPS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    listfile = build_corpus(tmp)
    return listfile, {name: _jax_reference(tmp / name, listfile, world, flags)
                      for name, (world, flags) in JAX_RUNS.items()}


def _seeded(exp, init):
    """A step_0 seed checkpoint of ``init`` under exp, as convert_hf_to_ckpt
    writes one."""
    dcp.save({k: v.clone() for k, v in init.items()},
             storage_writer=FileSystemWriter(str(exp / "checkpoint" / "step_0" / "model")),
             no_dist=True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_jax_trainer(tmp_path, reference, tp_run, layout):
    listfile, refs = reference
    world, flags = LAYOUTS[layout]
    init, want = refs[HELD_TO[layout]]
    if layout == "dp_shard2_tp2":
        ranks = tp_run[1]  # its first 3 steps
    else:
        _seeded(tmp_path / "exp", init)
        argv = _flags(tmp_path, listfile, STEPS, training_enable_ckpt="true",
                      training_ckpt_interval=100, **flags)
        ranks = spawn(train_main, world, tmp_path, argv)
    for r, got in enumerate(ranks):
        for step, (g, j) in enumerate(zip(got["history"][:STEPS], want), 1):
            for key, rtol in (("loss/per_sample", 1e-5), ("grad_norm", 1e-4),
                              ("loss/per_token", 1e-5), ("acc", 1e-5)):
                np.testing.assert_allclose(g[key], j[key], rtol=rtol,
                                           err_msg=f"{layout} rank {r} step {step} {key}")
        assert len(got["history"]) >= STEPS, r

@pytest.fixture(scope="module")
def tp_run(reference, tmp_path_factory):
    """The dp_shard 2 x tp 2 run from the JAX init, 4 steps with saves at
    1 and 4 (straight), and its directory."""
    listfile, refs = reference
    tmp = tmp_path_factory.mktemp("tp_run")
    _seeded(tmp / "exp", refs["dp2"][0])
    argv = _flags(tmp, listfile, 4, training_enable_ckpt="true", training_ckpt_interval=100,
                  **LAYOUTS["dp_shard2_tp2"][1])
    return tmp, spawn(train_main, 4, tmp, argv, True)


def test_four_rank_resume_and_export_are_exact(tmp_path, reference, tp_run):
    """4 ranks stopped by SIGTERM on rank 0 in step 2 (every rank saves
    step 2 and stops), then resumed: steps 3-4 give the straight run's
    losses, final params, moments and count bit for bit. The 4-rank
    checkpoint through convert_ckpt_to_hf equals the export of the same
    parameters saved by one process; a resume at world 1 raises."""
    from touchnet_tpu_torch.bin import convert_ckpt_to_hf
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors

    listfile, refs = reference
    straight_dir, straight = tp_run
    _seeded(tmp_path / "exp", refs["dp2"][0])
    argv = _flags(tmp_path, listfile, 4, training_enable_ckpt="true", training_ckpt_interval=100,
                  **LAYOUTS["dp_shard2_tp2"][1])
    first = spawn(train_main, 4, tmp_path, argv, False, 2)
    assert [r["step"] for r in first] == [2] * 4
    ckpt = tmp_path / "exp" / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["step_0", "step_1", "step_2"]
    second = spawn(train_main, 4, tmp_path, argv, True)
    want = [h["loss/per_sample"] for h in straight[0]["history"]]
    for r in range(4):
        got = [h["loss/per_sample"] for h in first[r]["history"] + second[r]["history"]]
        assert got == want, r
        for k, v in straight[0]["state"].items():
            np.testing.assert_array_equal(second[r]["state"][k], v, err_msg=k)

    # the export of the 4-rank step_4, and of the same tensors from one process
    cfg = str(CFG)
    single = tmp_path / "single"
    model = {k: torch.from_numpy(v) for k, v in straight[0]["state"].items()
             if not k.startswith(("mu.", "nu.")) and k != "count"}
    dcp.save(model, storage_writer=FileSystemWriter(str(single / "checkpoint" / "step_4" / "model")),
             no_dist=True)
    outs = []
    for exp in (tmp_path / "exp", single):
        convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", "-1", "--config", cfg,
                                 "--model_type", "causal_lm"])
        outs.append(read_safetensors(str(exp / "checkpoint_hf" / "step-4" / "model.safetensors")))
    assert outs[0].keys() == outs[1].keys() and len(outs[0]) == len(model)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k

    # the loader states are per dp rank of 2: world 1 refuses them
    with pytest.raises(AssertionError, match="dataloader resharding is not supported"):
        ttrain.main(_flags(tmp_path, listfile, 4, training_enable_ckpt="true"),
                    device=torch.device("cpu"))


@pytest.mark.parametrize("flag", ["training_context_parallel_degree",
                                  "training_pipeline_parallel_degree",
                                  "training_tensor_parallel_degree"])
def test_unported_degrees_raise(tmp_path, flag):
    """cp 2, pp 2 and tp 2 at world 1 (no torchrun) raise from
    ParallelDims naming their flags."""
    with pytest.raises(ValueError, match=f"{flag}=2"):
        ttrain.main(_flags(tmp_path, "unused.list", 2, **{flag: 2}), device=torch.device("cpu"))


def test_touch_audio_tp2_keeps_odd_dimensions_whole(tmp_path):
    """Touch-Audio with V = 1025 at tp 2 (dp 1): embed, head (no vocab
    shard: 1025 is odd) and the projector (input 161) stay whole, the
    attention and MLP split; 3 steps give the world-1 run's losses (rtol
    1e-5: the split sums the projections in another order) and grad norms
    (rtol 1e-4)."""
    import json

    from test_torch_touch_audio import CFG as AUDIO_CFG
    from test_torch_touch_audio import _flags as audio_flags
    from test_torch_touch_audio import _shards

    raw = json.loads(open(AUDIO_CFG).read())
    raw["text_config"]["vocab_size"] = 1025
    cfg = tmp_path / "touch_audio_v1025.json"
    cfg.write_text(json.dumps(raw))
    listfile = _shards(tmp_path, count=16)
    kw = dict(training_model_config_path=cfg, tokenizer_bestrq_vocab_size=1024,
              training_enable_loss_parallel="true")
    one = ttrain.main(audio_flags(tmp_path / "one", listfile, 3, **kw),
                      device=torch.device("cpu"))
    want = one.metrics_processor.history
    got = spawn(train_main, 2, tmp_path, audio_flags(
        tmp_path / "tp2", listfile, 3, training_tensor_parallel_degree=2, **kw))
    log = (tmp_path / "tp2" / "exp" / "touchnet_train.log").read_text()
    assert "replicated where tp does not divide" in log and "vocab 1025" in log \
        and "projector (input 161)" in log
    for r in got:
        assert len(r["history"]) == 3
        for g, w in zip(r["history"], want):
            np.testing.assert_allclose(g["loss/per_sample"], w["loss/per_sample"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_world_one_under_fsdp_equals_one_process(tmp_path, dtype):
    """One rank under torchrun's environment (FSDP2 over a mesh of 1, as
    on one card) against the trainer without a process group: the losses,
    grad norms and accuracies of 3 steps are bit-equal, in f32 and under
    bf16 compute. Under bf16 FSDP2 gathers the layers' weights in bf16,
    which gives the values of the single-device casts (its cast of the
    layers' floating inputs would round the f32 rope frequencies, so it is
    off), and the root unit's (embedding, final norm) in the reduce dtype,
    f32, so the embedding's gradient, the sum of its rows over repeated ids
    and of the tied head's part, adds up in f32 as in one process (in bf16
    parameters it read 1.5e-5 apart by step 2)."""
    listfile = build_corpus(tmp_path)
    kw = dict(training_mixed_precision_param=dtype)
    argv = _flags(tmp_path / "one", listfile, STEPS, **kw)
    want = ttrain.main(argv, device=torch.device("cpu")).metrics_processor.history
    (got,) = spawn(train_main, 1, tmp_path, _flags(tmp_path / "fsdp", listfile, STEPS, **kw))
    log = (tmp_path / "fsdp" / "exp" / "touchnet_train.log").read_text()
    assert "FSDP2 over dp_replicate 1 x dp_shard 1" in log
    for key in ("loss/per_sample", "grad_norm", "loss/per_token", "acc"):
        g, w = [h[key] for h in got["history"]], [h[key] for h in want]
        assert len(g) == STEPS and g == w, key
