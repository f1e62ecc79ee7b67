# Pipeline parallelism of the port (touchnet_tpu_torch/parallel/pipeline.py,
# models/llama/pipeline_llama.py, models/touch_audio/pipeline_touch_audio.py
# and the trainer's pp path) against the JAX package on the CPU:
#   - the copied split and schedule functions against JAX's on a grid of
#     (L, S, V, split points): the same counts, the same accepted and
#     refused inputs; the port's schedules on a grid of (S, M, V) run to
#     their end, each action once; each refusal (ZBVZeroBubble, a CSV
#     schedule, a non-ceil split, rows that the microbatches do not divide,
#     Interleaved1F1B with M < S) names its flag, in the functions and in
#     the trainer;
#   - bin.train.main over gloo ranks (dist_workers.spawn, all of a world's
#     layouts in one spawn) against the JAX Trainer at the same layout from
#     the same init (a step_0 seed checkpoint), 3 steps in f32:
#     loss_per_sample, per-token loss and accuracy rtol 1e-5, grad_norm rtol
#     1e-4 (test_torch_parallel_train's tolerances), for pp 2 under 1F1B
#     (with its dev lines) and GPipe, Interleaved1F1B at V 2 and M 2 on
#     tiny_llama_4l, a tied-embedding copy, touch_audio (input 161, V 1025);
#     pp 2 x tp 2 and pp 2 x cp 2 with each rotate method against JAX's pp 2
#     run (tp and cp split the same global step), pp 2 x dp_shard 2 against
#     JAX at dp 2 (the same global batch); the layouts that JAX does not run
#     alike (Interleaved at M 4, a 3-layer copy split [2, 1] and
#     [1, 1, 1, 0]) against the port's one-process run from the same init,
#     rtol 1e-6 on the losses (1e-5 on the norms);
#   - a pp 2 run resumed from its step-1 checkpoint gives steps 2-3 and the
#     final params, moments and count bit for bit; convert_ckpt_to_hf on the
#     pp 2 checkpoint equals the export of the same tensors saved by one
#     process;
#   - MULTICHIP_r05's 8-device goldens (__graft_entry__.dryrun_multichip):
#     the step-1 loss at pp 2 x dp_shard 2 x tp 2 and pp 2 x dp_shard 2 x cp
#     2 (alltoall) on 8 ranks, from init_params(_tiny_config(), key 0) on
#     _packed_batch(4, 256, 256), equals 4.9008 within 5e-5 (the print's
#     rounding).

import gc
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from dist_workers import golden_steps, spawn, train_runs
from test_torch_parallel_train import _seeded
from test_torch_train import CFG, _flags, build_corpus
from torch.distributed.checkpoint import FileSystemWriter

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.parallel import pipeline as jpipe
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.parallel import pipeline as tpipe

STEPS = 3
CFG4 = os.path.join(os.path.dirname(CFG), "tiny_llama_4l.json")
PP = dict(training_pipeline_parallel_degree=2, training_data_parallel_shard_degree=1,
          dataset_batchsize=2)
INTERLEAVED = dict(PP, training_pipeline_parallel_schedule="Interleaved1F1B",
                   training_model_config_path=CFG4)
SEEDED = dict(training_enable_ckpt="true", training_ckpt_interval=100)
JAX_TOL = (("loss/per_sample", 1e-5), ("grad_norm", 1e-4), ("loss/per_token", 1e-5),
           ("acc", 1e-5))
PORT_TOL = (("loss/per_sample", 1e-6), ("grad_norm", 1e-5), ("loss/per_token", 1e-6),
            ("acc", 1e-6))
LINE = ("step", "loss/per_sample", "loss/per_token", "acc", "grad_norm", "lr")


def _lines(history):
    """A history's values (not its timings)."""
    return [{k: h[k] for k in LINE} for h in history]


# -- the split and schedule functions ------------------------------------------------

GRID = [(L, S, V) for L in (2, 3, 4, 5, 8) for S in (2, 4) for V in (1, 2) if L >= 2]


@pytest.mark.parametrize("L,S,V", GRID)
def test_split_functions_match_jax(L, S, V):
    """stage_layer_counts, parse_split_points and virtual_stages_of equal
    JAX's: the same counts; every split point list of the grid accepted or
    refused alike (the port's ValueError names the flag)."""
    assert tpipe.stage_layer_counts(L, S, V) == jpipe.stage_layer_counts(L, S, V)
    counts, K = tpipe.stage_layer_counts(L, S, V)
    layers = [i for s in range(S) for chunk in tpipe.stage_layers(L, S, V, s) for i in chunk]
    assert sorted(layers) == list(range(L))
    ceil = ",".join(str(min(K * i, L)) for i in range(1, S * V))
    for pts in (None, "", ceil, "1", ",".join(str(i) for i in range(1, S * V)), "0,9"):
        try:
            jpipe.parse_split_points(pts, L, S, V)
            refused = False
        except NotImplementedError:
            refused = True
        if refused:
            with pytest.raises(ValueError, match="training_pipeline_parallel_split_points"):
                tpipe.parse_split_points(pts, L, S, V)
        else:
            tpipe.parse_split_points(pts, L, S, V)
        for sched in ("1F1B", "Interleaved1F1B"):
            try:
                want = jpipe.virtual_stages_of(pts, L, S, sched)
            except NotImplementedError:
                with pytest.raises(ValueError, match="training_pipeline_parallel"):
                    tpipe.virtual_stages_of(pts, L, S, sched)
                continue
            assert tpipe.virtual_stages_of(pts, L, S, sched) == want


@pytest.mark.parametrize("schedule", tpipe.SUPPORTED_SCHEDULES)
def test_schedules_run_every_action_once(schedule):
    """For S 2-4 and M from 1 (S under Interleaved1F1B) to 2S+2, with and
    without the backwards: the timeline ends, each rank runs each of its
    (kind, chunk, microbatch) once, a forward after its input's stage, a
    backward after the next stage's; 1F1B holds at most S - s forwards in
    flight on stage s."""
    for S in (2, 3, 4):
        for V in ((2, 3) if schedule == "Interleaved1F1B" else (1,)):
            for M in range(S if V > 1 else 1, 2 * S + 3):
                for train in (True, False):
                    when = {}
                    for k, now in enumerate(tpipe.timeline(schedule, S, M, V, train)):
                        for s, (kind, v, m) in now.items():
                            assert (kind, v * S + s, m) not in when
                            when[(kind, v * S + s, m)] = k
                    n = S * V
                    assert len(when) == n * M * (2 if train else 1)
                    for (kind, t, m), k in when.items():
                        if kind == "F" and t:
                            assert when[("F", t - 1, m)] < k
                        if kind == "B":
                            assert when[("F", t, m)] < k
                            if t < n - 1:
                                assert when[("B", t + 1, m)] < k
                    if schedule == "1F1B" and train:
                        for s in range(S):
                            order = tpipe.stage_order(schedule, S, M, 1, s)
                            live = peak = 0
                            for kind, _, _ in order:
                                live += 1 if kind == "F" else -1
                                peak = max(peak, live)
                            assert peak <= min(S - s, M)


@pytest.mark.parametrize("case", ["ZBVZeroBubble", "csv", "split", "rows", "interleaved_m"])
def test_refusals_name_their_flags(case):
    """JAX refuses each (NotImplementedError or an assert); the port raises
    a ValueError naming the flag."""
    if case in ("ZBVZeroBubble", "csv"):
        over = ({"training_pipeline_parallel_schedule": "ZBVZeroBubble"} if case != "csv"
                else {"training_pipeline_parallel_schedule_csv": "sched.csv"})
        flag = ("training_pipeline_parallel_schedule" if case != "csv"
                else "training_pipeline_parallel_schedule_csv")
        with pytest.raises(NotImplementedError):
            jpipe.validate_pp_composition(None, JTrainConfig(**over))
        with pytest.raises(ValueError, match=flag):
            tpipe.validate_pp_composition(TrainConfig(**over))
    elif case == "split":
        with pytest.raises(NotImplementedError):
            jpipe.parse_split_points("1", 4, 2)
        with pytest.raises(ValueError, match="training_pipeline_parallel_split_points"):
            tpipe.parse_split_points("1", 4, 2)
    elif case == "rows":
        with pytest.raises(ValueError, match="dataset_batchsize=3 .*"
                                             "training_pipeline_parallel_microbatches=2"):
            tpipe.check_microbatches(3, 2, 2, 1)
    else:
        with pytest.raises(ValueError, match="training_pipeline_parallel_microbatches=2"):
            tpipe.check_microbatches(4, 2, 4, 2)
        tpipe.check_microbatches(4, 2, 4, 1)  # 1F1B takes M < S


# -- the JAX references ------------------------------------------------------------------


def _jax_trainer(argv, world, to_port):
    """The JAX Trainer on ``argv`` over ``world`` of the CPU devices
    (jax.device_count patched, as test_torch_parallel_train does): its init
    as the port's state dict, its training lines and its dev lines."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "device_count", lambda *a: world)
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], argv))
    try:
        init = to_port(jax.tree.map(np.asarray, jt.params))
        logs, dev = [], []
        jt.metrics_processor.log = lambda step, host: logs.append(dict(host))
        jt.metrics_processor.log_dev = lambda step, m: dev.append({"step": step, **m})
        jt.train()
    finally:
        jt.close()
        mp.undo()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
    return init, logs[:STEPS], dev


def _variant(tmp, name, base=CFG, **over):
    """A copy of a tiny config with ``over`` set."""
    raw = json.loads(open(base).read())
    raw.update(over)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _audio_config(tmp):
    from test_torch_touch_audio import CFG as AUDIO_CFG

    raw = json.loads(open(AUDIO_CFG).read())
    raw["text_config"]["vocab_size"] = 1025
    path = tmp / "touch_audio_v1025.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _audio_flags(tmp, listfile, config, **over):
    from test_torch_touch_audio import _flags as audio_flags

    return audio_flags(tmp, listfile, STEPS, training_model_config_path=config,
                       tokenizer_bestrq_vocab_size=1024, audio_speed_perturb="false",
                       **over)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the config copies, and the JAX Trainer runs the layouts
    are held to: name -> (init, lines, dev lines)."""
    from test_torch_touch_audio import _shards

    from touchnet_tpu_torch.models.touch_audio import convert as audio_convert
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )

    tmp = tmp_path_factory.mktemp("pp")
    listfile = build_corpus(tmp)
    cfgs = {"tied": _variant(tmp, "tied", tie_word_embeddings=True),
            "three": _variant(tmp, "three", num_hidden_layers=3),
            "audio": _audio_config(tmp)}
    audio_list = _shards(tmp / "audio", count=16)

    def llama(path):
        cfg = LlamaConfig.from_json_file(path)
        return lambda p: params_from_jax_numpy(p, cfg)

    devlist = tmp / "dev.list"  # one shard: a dev pass of a few batches
    devlist.write_text(open(listfile).readline())
    dev = dict(datalist_dev_path=devlist, **SEEDED)
    runs = {
        "pp2": (2, _flags(tmp / "j_pp2", listfile, STEPS, **PP, **dev), llama(CFG)),
        "interleaved": (2, _flags(tmp / "j_il", listfile, STEPS, **INTERLEAVED), llama(CFG4)),
        "tied": (2, _flags(tmp / "j_tied", listfile, STEPS, **dict(
            PP, training_model_config_path=cfgs["tied"])), llama(cfgs["tied"])),
        "dp2": (2, _flags(tmp / "j_dp2", listfile, STEPS, dataset_batchsize=2,
                          training_data_parallel_shard_degree=2), llama(CFG)),
        "audio": (2, _audio_flags(tmp / "j_audio", audio_list, cfgs["audio"], **PP),
                  lambda p: audio_convert.params_from_jax_numpy(
                      p, TouchAudioConfig.from_json_file(cfgs["audio"]))),
    }
    refs = {name: _jax_trainer(argv, world, to_port)
            for name, (world, argv, to_port) in runs.items()}
    return tmp, listfile, audio_list, cfgs, refs, devlist


def _check(got, want, tol, what):
    assert len(got) >= STEPS, what
    for step, (g, j) in enumerate(zip(got[:STEPS], want), 1):
        for key, rtol in tol:
            np.testing.assert_allclose(g[key], j[key], rtol=rtol, err_msg=f"{what} step {step} {key}")


# -- two ranks: pp 2 ---------------------------------------------------------------------

# name -> (the JAX reference whose init seeds it, or None: the port's own init;
# what it is held to: a JAX reference, or "one:<name>" the one-process run)
TWO_RANK = {
    "1F1B": ("pp2", "pp2"),
    "GPipe": ("pp2", "pp2"),
    "interleaved_m2": ("interleaved", "interleaved"),
    "interleaved_m4": ("interleaved", "one:interleaved_m4"),
    "three_1F1B": (None, "one:three"),
    "three_interleaved": (None, "one:three"),
    "tied": ("tied", "tied"),
    "touch_audio": ("audio", "audio"),
}


@pytest.fixture(scope="module")
def two_ranks(setup):
    """Every 2-rank layout in one spawn: the layouts of TWO_RANK, a run
    resumed from 1F1B's step-1 checkpoint, and two refusals in the
    trainer; and the one-process runs the port-held layouts are held to."""
    tmp, listfile, audio_list, cfgs, refs, devlist = setup
    argvs = {
        "1F1B": _flags(tmp / "1F1B", listfile, STEPS, datalist_dev_path=devlist, **PP, **SEEDED),
        "GPipe": _flags(tmp / "GPipe", listfile, STEPS, training_pipeline_parallel_schedule="GPipe",
                        **PP, **SEEDED),
        "interleaved_m2": _flags(tmp / "interleaved_m2", listfile, STEPS, **INTERLEAVED,
                                 **SEEDED),
        "interleaved_m4": _flags(tmp / "interleaved_m4", listfile, STEPS, **dict(
            INTERLEAVED, dataset_batchsize=4, training_pipeline_parallel_microbatches=4),
            **SEEDED),
        "three_1F1B": _flags(tmp / "three_1F1B", listfile, STEPS, **dict(
            PP, training_model_config_path=cfgs["three"])),
        "three_interleaved": _flags(tmp / "three_interleaved", listfile, STEPS, **dict(
            INTERLEAVED, training_model_config_path=cfgs["three"])),
        "tied": _flags(tmp / "tied", listfile, STEPS, **dict(
            PP, training_model_config_path=cfgs["tied"]), **SEEDED),
        "touch_audio": _audio_flags(tmp / "touch_audio", audio_list, cfgs["audio"], **PP,
                                    **SEEDED),
    }
    for name, (seed, _) in TWO_RANK.items():
        if seed is not None:
            _seeded(tmp / name / "exp", refs[seed][0])
    resumed = tmp / "resumed"
    runs = [{"argv": argv, "state": name == "1F1B"} for name, argv in argvs.items()]
    runs.append({"argv": _flags(resumed, listfile, STEPS, training_ckpt_load_step=1, **PP,
                                **SEEDED),
                 "copy": [str(tmp / "1F1B" / "exp" / "checkpoint" / "step_1"),
                          str(resumed / "exp" / "checkpoint" / "step_1")],
                 "state": True})
    runs.append({"argv": _flags(tmp / "zbv", listfile, STEPS, **PP,
                                training_pipeline_parallel_schedule="ZBVZeroBubble"),
                 "error": True})
    runs.append({"argv": _flags(tmp / "rows", listfile, STEPS, **dict(
        PP, dataset_batchsize=3)), "error": True})
    got = spawn(train_runs, 2, tmp / "spawn2", runs, timeout=600)
    # the same full-logits loss as the last stage's (no K3)
    plain = dict(training_enable_liger_kernel="false")
    ones = {
        "interleaved_m4": _one(tmp / "one_il4", refs["interleaved"][0], _flags(
            tmp / "one_il4", listfile, STEPS, training_model_config_path=CFG4,
            dataset_batchsize=4, **plain, **SEEDED)),
        "three": _one(tmp / "one_three", None, _flags(
            tmp / "one_three", listfile, STEPS, dataset_batchsize=2,
            training_model_config_path=cfgs["three"], **plain)),
    }
    n = len(argvs)
    results = {name: [r[i] for r in got] for i, name in enumerate(argvs)}
    results["resumed"] = [r[n] for r in got]
    results["errors"] = [r[n + 1:] for r in got]
    return results, ones, tmp


def _one(folder, init, argv):
    """The port's one-process run (no process group) of ``argv``, from
    ``init`` when given: its training lines."""
    if init is not None:
        _seeded(folder / "exp", init)
    return ttrain.main(argv, device=torch.device("cpu")).metrics_processor.history


@pytest.mark.parametrize("layout", list(TWO_RANK))
def test_two_rank_layout(setup, two_ranks, layout):
    """pp 2 layouts on two ranks against the JAX Trainer at the same layout
    (JAX_TOL) or the port's one-process run (PORT_TOL); both ranks log the
    same lines."""
    refs = setup[4]
    results, ones, _ = two_ranks
    _, held = TWO_RANK[layout]
    want, tol = ((ones[held[4:]], PORT_TOL) if held.startswith("one:")
                 else (refs[held][1], JAX_TOL))
    ranks = results[layout]
    assert _lines(ranks[0]["history"]) == _lines(ranks[1]["history"])
    for r, got in enumerate(ranks):
        _check(got["history"], want, tol, f"{layout} rank {r}")


def test_dev_lines_match_jax_trainer(setup, two_ranks):
    """1F1B's dev passes (the pipeline's forwards alone) after the saves at
    steps 1 and 3 equal the JAX Trainer's dev lines at pp 2 (rtol 1e-5)."""
    want = setup[4]["pp2"][2]
    results = two_ranks[0]
    assert [d["step"] for d in want] == [1, 3]
    for r, got in enumerate(results["1F1B"]):
        assert [d["step"] for d in got["dev"]] == [1, 3]
        for g, j in zip(got["dev"], want):
            for key in ("loss_per_sample", "loss_per_token", "acc"):
                np.testing.assert_allclose(g[key], j[key], rtol=1e-5,
                                           err_msg=f"rank {r} dev step {g['step']} {key}")


def test_resume_is_bit_equal(two_ranks):
    """A run resumed from 1F1B's step-1 checkpoint (each rank reads its
    stage's layers and the held tensors) gives steps 2-3 and each rank's
    final params, moments and count bit for bit."""
    results = two_ranks[0]
    for r in range(2):
        straight, again = results["1F1B"][r], results["resumed"][r]
        assert [h["step"] for h in again["history"]] == [2, 3]
        assert _lines(again["history"]) == _lines(straight["history"][1:])
        assert straight["state"].keys() == again["state"].keys()
        for k, v in straight["state"].items():
            np.testing.assert_array_equal(again["state"][k], v, err_msg=f"rank {r} {k}")


def test_stages_hold_their_layers_and_the_export_is_one_process(two_ranks):
    """Stage 0 holds layer 0, stage 1 layer 1, both the embedding, the
    final norm and the head (equal on both ranks after every step: their
    gradients are summed over pp); convert_ckpt_to_hf on the pp 2
    checkpoint of step 3 equals the export of the same tensors saved by
    one process."""
    from touchnet_tpu_torch.bin import convert_ckpt_to_hf
    from touchnet_tpu_torch.utils.safetensors_io import read_safetensors

    results, _, tmp = two_ranks
    states = [r["state"] for r in results["1F1B"]]
    held = ("model.embed_tokens.weight", "model.norm.weight", "lm_head.weight")
    for r, st in enumerate(states):
        layers = {k.split(".")[2] for k in st if k.startswith("model.layers.")}
        assert layers == {str(r)}, r
        for k in held:
            assert k in st and f"mu.{k}" in st, k
    for k in held + tuple(f"{m}.{k}" for m in ("mu", "nu") for k in held):
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
    model = {k: torch.from_numpy(v) for st in states for k, v in st.items()
             if not k.startswith(("mu.", "nu.")) and k != "count"}
    single = tmp / "single"
    dcp.save(model, storage_writer=FileSystemWriter(
        str(single / "checkpoint" / "step_3" / "model")), no_dist=True)
    outs = []
    for exp in (tmp / "1F1B" / "exp", single):
        convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", "-1", "--config", CFG,
                                 "--model_type", "causal_lm"])
        outs.append(read_safetensors(str(exp / "checkpoint_hf" / "step-3" / "model.safetensors")))
    assert outs[0].keys() == outs[1].keys() and len(outs[0]) == len(model)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_trainer_refusals_name_their_flags(two_ranks):
    """At pp 2 on two ranks the trainer raises before it builds a model:
    ZBVZeroBubble names the schedule flag, 3 rows a dp rank name
    dataset_batchsize and the microbatch flag."""
    for zbv, rows in two_ranks[0]["errors"]:
        assert "training_pipeline_parallel_schedule='ZBVZeroBubble'" in zbv
        assert "dataset_batchsize=3" in rows and "training_pipeline_parallel_microbatches=2" in rows


# -- four ranks: pp 2 with dp_shard, tp and cp --------------------------------------------

# layout -> (its flags beside PP, the JAX Trainer run it is held to)
FOUR_RANK = {
    "pp2_dp_shard2": (dict(training_data_parallel_shard_degree=2), "dp2"),
    "pp2_tp2": (dict(training_tensor_parallel_degree=2), "pp2"),
    "pp2_cp2_allgather": (dict(training_context_parallel_degree=2,
                               training_context_parallel_rotate_method="allgather"), "pp2"),
    "pp2_cp2_alltoall": (dict(training_context_parallel_degree=2,
                              training_context_parallel_rotate_method="alltoall"), "pp2"),
}


@pytest.fixture(scope="module")
def four_ranks(setup):
    tmp, listfile, _, _, refs, _ = setup
    runs = []
    for name, (over, held) in FOUR_RANK.items():
        _seeded(tmp / name / "exp", refs[held][0])
        runs.append({"argv": _flags(tmp / name, listfile, STEPS, **dict(PP, **over), **SEEDED)})
    got = spawn(train_runs, 4, tmp / "spawn4", runs, timeout=600)
    return {name: [r[i] for r in got] for i, name in enumerate(FOUR_RANK)}


@pytest.mark.parametrize("layout", list(FOUR_RANK))
def test_four_rank_layout_matches_jax_trainer(setup, four_ranks, layout):
    """pp 2 composed with dp_shard 2 (FSDP2 over each stage's dp ranks;
    JAX at dp 2 holds the same global batch), tp 2 (the TP plan on each
    stage's layers) and cp 2 (each rotate method, over each stage's cp
    group; both against JAX at pp 2: the same global step) against the JAX
    Trainer (JAX_TOL); every rank logs the same lines."""
    want = setup[4][FOUR_RANK[layout][1]][1]
    ranks = four_ranks[layout]
    for r, got in enumerate(ranks):
        assert _lines(got["history"]) == _lines(ranks[0]["history"]), r
        _check(got["history"], want, JAX_TOL, f"{layout} rank {r}")


# -- eight ranks: MULTICHIP_r05's goldens ----------------------------------------------

GOLDEN = 4.9008  # MULTICHIP_r05.json: "dryrun_multichip PP OK ... loss=4.9008"
GOLDEN_LAYOUTS = {
    "pp2_dp_shard2_tp2": dict(training_tensor_parallel_degree=2),
    "pp2_dp_shard2_cp2": dict(training_context_parallel_degree=2,
                              training_context_parallel_rotate_method="alltoall"),
}


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    """__graft_entry__'s pp layouts on 8 ranks: the port's step-1 loss from
    the JAX init of _tiny_config() on _packed_batch(2 * dp, 256, 256) with
    num_sentence 2 * 2 * dp, in f32."""
    import __graft_entry__ as graft

    from touchnet_tpu.models.llama.modeling_llama import init_params as jinit

    tmp = tmp_path_factory.mktemp("golden")
    jcfg = graft._tiny_config()
    cfg = tmp / "tiny.json"
    cfg.write_text(json.dumps({**jcfg.__dict__, "attn_implementation": "eager"}))
    init = params_from_jax_numpy(jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0))),
                                 LlamaConfig.from_json_file(str(cfg)))
    listfile = build_corpus(tmp, vocab=256)
    dp = 2
    batch = graft._packed_batch(2 * dp, 256, jcfg.vocab_size)
    runs = []
    for name, over in GOLDEN_LAYOUTS.items():
        _seeded(tmp / name / "exp", init)
        runs.append(_flags(tmp / name, listfile, 1, training_model_config_path=cfg,
                           tokenizer_raw_vocab_size=256, dataset_text_seqlen=256,
                           training_pipeline_parallel_degree=2, dataset_batchsize=2,
                           training_data_parallel_shard_degree=dp, **SEEDED, **over))
    got = spawn(golden_steps, 8, tmp / "spawn8", runs, batch, 2.0 * 2 * dp, timeout=600)
    return {name: [r[i] for r in got] for i, name in enumerate(GOLDEN_LAYOUTS)}


@pytest.mark.parametrize("layout", list(GOLDEN_LAYOUTS))
def test_eight_rank_golden(goldens, layout):
    """pp 2 x dp_shard 2 x tp 2 and pp 2 x dp_shard 2 x cp 2 (alltoall) on
    8 ranks: the step-1 loss equals MULTICHIP_r05's 4.9008 within 5e-5 on
    every rank."""
    for r, loss in enumerate(goldens[layout]):
        assert abs(loss - GOLDEN) <= 5e-5, (r, loss)
