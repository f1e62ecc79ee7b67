# --training_compile with tp, cp and pp over gloo on the CPU: one spawned
# world of 2 runs tp 2, cp 2 (alltoall, the ring) and pp 2 (1F1B) one after
# another, each eager and compiled, in the same two processes
# (dist_workers.train_runs, as test_torch_pipeline.py shares its spawns).
# Each layout compiled is held to the same layout eager at rtol 1e-5 in f32
# (inductor orders some sums otherwise), over 2 steps of the tiny Llama
# under op_small. The graphs: the tp block is one graph (its collectives,
# autograd Functions over the tp group, trace); under cp the ring's
# point-to-point is the graph's boundary (ContextParallel.attend runs
# eagerly): the block breaks there, into a graph before the attention and
# one after it; under pp the stages' blocks compile whole and the
# schedule's sends stay outside them.

import json

import numpy as np
import pytest
from dist_workers import spawn, train_runs
from test_torch_train import _flags, build_corpus

LAYOUTS = {
    "tp": dict(training_tensor_parallel_degree=2),
    "cp": dict(training_context_parallel_degree=2,
               training_context_parallel_rotate_method="alltoall"),
    "pp": dict(training_pipeline_parallel_degree=2, training_pipeline_parallel_schedule="1F1B",
               dataset_batchsize=2),
}
STEPS = 2


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compile_parallel")
    listfile = build_corpus(tmp)
    runs, exps = [], []
    for name, kw in LAYOUTS.items():
        for compiled in ("false", "true"):
            exp = tmp / f"{name}_{compiled}"
            exps.append(exp)
            runs.append({"argv": _flags(exp, listfile, STEPS, training_compile=compiled,
                                        training_activation_checkpoint_mode="op_small", **kw)})
    out = spawn(train_runs, 2, tmp, runs, timeout=900)
    got = {}
    for i, name in enumerate(LAYOUTS):
        summaries = [json.loads((exps[2 * i + 1] / "exp" / f"train_summary_rank{r}.json")
                                .read_text())["compile"] for r in range(2)]
        got[name] = (out[0][2 * i], out[0][2 * i + 1], summaries)
    return got


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_compiled_layout_matches_eager(layouts, name):
    eager, compiled, summaries = layouts[name]
    assert len(eager["history"]) == len(compiled["history"]) == STEPS
    for key in ("loss/per_sample", "grad_norm", "loss/per_token"):
        np.testing.assert_allclose([h[key] for h in compiled["history"]],
                                   [h[key] for h in eager["history"]], rtol=1e-5, err_msg=key)
    for s in summaries:
        assert s["enabled"] and s["recompiles"] == 0, s
        if name == "pp":
            assert s["graph_breaks"] == 0, s["graph_break_reasons"]
            continue
        # every break is a call dynamo leaves to eager code: the cp attention
        # (ContextParallel.attend), the tp collectives (sharding's
        # _sum_forward, _sum_backward); each is met in the block's frame and
        # in the checkpoint's body before it (dynamo then runs the
        # checkpoint eagerly around the block's graphs)
        eager = ("ContextParallel.attend",) if name == "cp" else ("_sum_forward", "_sum_backward")
        for reason in s["graph_break_reasons"]:
            assert "skip" in reason.lower() or "disable" in reason, reason
        assert s["graph_breaks"] > 0, s
