# The trainer's dev evaluation and run-time services on the CPU, tiny Llama:
#   - dev(): the JAX trainer's dev() and the port's on one dev list, the
#     port holding the JAX trainer's params (params_from_jax_numpy): every
#     metric at rtol 1e-5 (f32; only the two frameworks' summation orders
#     differ); a [dev] line after each save of a run;
#   - profiling (a trace per cycle, naming the step's ops), memory snapshots
#     (raise on the CPU: no CUDA memory to record), after
#     tests/touchnet_tpu/utils/test_profiling.py;
#   - determinism: the same seed gives the same losses bit for bit, and
#     --training_deterministic turns on PyTorch's deterministic algorithms;
#   - the step watchdog: a dump of the threads' stacks when a step hangs,
#     and with --training_abort_on_timeout the process ends with code 124;
#   - --training_gc_freq: automatic GC off during training, a generation-1
#     collection every gc_freq steps, the collector restored by close();
#   - the flags the trainer accepts and never reads (bin/train.py
#     UNREAD_FLAGS): each set away from its default writes one warning
#     naming it to the run's log, none at the defaults, and the layout
#     flags of a parallel degree stay silent at degree 1 (inert in the JAX
#     trainer on one device too); the losses equal the default run's bit
#     for bit in every case.

import gc
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_train import CFG, _flags, build_corpus

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.utils import distributed
from touchnet_tpu_torch.utils.distributed import StepWatchdog
from touchnet_tpu_torch.utils.profiling import (
    maybe_enable_memory_snapshot,
    maybe_enable_profiling,
)

REPO = os.path.join(os.path.dirname(__file__), "..", "..")


def _trainer(argv):
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    return ttrain.Trainer(tok, data, job, device=torch.device("cpu"))


def test_dev_matches_jax(tmp_path, monkeypatch):
    """The JAX trainer on one device (dp 1, as the port) and the port's, on
    the JAX trainer's params: dev() gives the same averages."""
    listfile = build_corpus(tmp_path)
    (tmp_path / "dev").mkdir()
    devlist = build_corpus(tmp_path / "dev", num_shards=2, samples=40)
    argv = _flags(tmp_path, listfile, 4, datalist_dev_path=devlist,
                  training_activation_checkpoint_mode="none")
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    gc_on = gc.isenabled()
    jtrainer = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], argv))
    want = []
    monkeypatch.setattr(jtrainer.metrics_processor, "log_dev",
                        lambda step, m: want.append(dict(m)))
    jtrainer.dev()
    jtrainer.close()
    if gc_on:  # the JAX trainer turns automatic GC off for good
        gc.enable()

    trainer = _trainer(argv)
    trainer.model.load_state_dict(params_from_jax_numpy(
        jax.tree.map(np.asarray, jtrainer.params), LlamaConfig.from_json_file(CFG)))
    trainer.dev()
    trainer.close()
    (got,) = trainer.metrics_processor.dev_history
    assert got.pop("step") == 0 and len(want) == 1
    assert got.keys() == want[0].keys() == {"loss_per_sample", "loss_per_token", "acc"}
    for k, v in want[0].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert 0 < got["acc"] < 1 and got["loss_per_token"] > 1


def test_dev_after_every_save(tmp_path):
    listfile = build_corpus(tmp_path)
    trainer = ttrain.main(_flags(tmp_path, listfile, 5, datalist_dev_path=listfile,
                                 training_enable_ckpt="true", training_ckpt_interval=2),
                          device=torch.device("cpu"))
    dev = trainer.metrics_processor.dev_history
    assert [d["step"] for d in dev] == [1, 2, 4, 5]
    assert all(np.isfinite(d["loss_per_sample"]) for d in dev)
    assert dev[-1]["loss_per_sample"] < dev[0]["loss_per_sample"]
    assert "[dev] step      5" in (tmp_path / "exp" / "touchnet_train.log").read_text()


def test_profiler_writes_trace(tmp_path):
    cfg = TrainConfig(training_enable_profiling=True, training_trace_dump_folder=str(tmp_path),
                      training_profiling_freq=2, training_profiling_keep_first_k=1)
    with maybe_enable_profiling(cfg) as prof:
        assert prof is not None
        for step in range(1, 7):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
            prof.step(step)
    # the trace of step 2 only: keep_first_k = 1
    assert os.listdir(tmp_path / "profile_traces") == ["iteration_2"]
    assert "aten::mm" in (tmp_path / "profile_traces" / "iteration_2" / "trace.json").read_text()


def test_trainer_profiles_and_snapshot_raises_on_cpu(tmp_path):
    listfile = build_corpus(tmp_path)
    ttrain.main(_flags(tmp_path, listfile, 5, training_enable_profiling="true",
                       training_profiling_freq=2, training_profiling_keep_first_k=2),
                device=torch.device("cpu"))
    traces = tmp_path / "exp" / "profile_traces"
    assert sorted(os.listdir(traces)) == ["iteration_2", "iteration_4"]
    assert "flash_attention_fwd" in (traces / "iteration_2" / "trace.json").read_text()
    with pytest.raises(ValueError, match="CUDA allocator"):
        ttrain.main(_flags(tmp_path / "snap", listfile, 2,
                           training_enable_memory_snapshot="true"),
                    device=torch.device("cpu"))


def test_disabled_yields_none(tmp_path):
    cfg = TrainConfig(training_trace_dump_folder=str(tmp_path))
    with maybe_enable_profiling(cfg) as p, maybe_enable_memory_snapshot(cfg) as m:
        assert p is None and m is None


def test_same_seed_same_losses(tmp_path):
    listfile = build_corpus(tmp_path)
    runs = [[h["loss/per_sample"] for h in ttrain.main(
        _flags(tmp_path / tag, listfile, 3, training_seed=7),
        device=torch.device("cpu")).metrics_processor.history] for tag in "ab"]
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_deterministic_flag(tmp_path, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    listfile = build_corpus(tmp_path)
    try:
        trainer = _trainer(_flags(tmp_path, listfile, 2, training_deterministic="true"))
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        trainer.train()  # every op of the step has a deterministic algorithm
        trainer.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert trainer.step == 2


def test_watchdog_dumps_stacks(tmp_path):
    wd = StepWatchdog(0.2, str(tmp_path), abort=False)
    wd.arm()
    time.sleep(1.0)
    wd.disarm()
    wd.close()
    assert wd.fired == 1  # one report per armed step
    (dump,) = os.listdir(tmp_path / "comm_trace")
    assert "test_watchdog_dumps_stacks" in (tmp_path / "comm_trace" / dump).read_text()


def test_abort_on_timeout_ends_a_hung_run(tmp_path):
    """A run whose third step hangs, in a process of its own: with
    --training_abort_on_timeout it ends with code 124 and a stack dump."""
    listfile = build_corpus(tmp_path)
    argv = _flags(tmp_path, listfile, 6, training_abort_on_timeout="true",
                  training_train_timeout_seconds=1)
    script = textwrap.dedent(f"""
        import time, torch
        from touchnet_tpu_torch.bin import train
        step = train.Trainer.train_step
        def hung(self, *a):
            if self.step == 3:
                time.sleep(60)
            return step(self, *a)
        train.Trainer.train_step = hung
        train.main({argv!r}, device=torch.device("cpu"))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 124, res.stderr[-2000:]
    assert "training_abort_on_timeout" in res.stdout
    (dump,) = os.listdir(tmp_path / "exp" / "comm_trace")
    assert "hung" in (tmp_path / "exp" / "comm_trace" / dump).read_text()


def test_gc_freq(tmp_path, monkeypatch):
    gc.enable()  # a JAX trainer of an earlier test leaves it off
    listfile = build_corpus(tmp_path)
    collected = []
    monkeypatch.setattr(distributed.gc, "collect", lambda gen=2: collected.append(gen))
    trainer = _trainer(_flags(tmp_path, listfile, 5, training_gc_freq=2))
    step_fn, enabled = trainer.train_step, []

    def step(*a):
        enabled.append(gc.isenabled())
        return step_fn(*a)

    trainer.train_step = step
    trainer.train()
    assert enabled == [False] * 5
    assert collected == [1, 1, 1]  # at init, then before steps 3 and 5
    trainer.close()
    assert gc.isenabled()


# (flags, the flags warned as unread, whether the step runs compiled).
# training_compile and training_trace_buf_size are read: compile compiles
# the step (its losses within rtol 1e-5 of the eager ones: inductor orders
# some sums otherwise), and a trace buffer sizes NCCL's flight recorder,
# which a run without a process group never starts (losses bit-equal, no
# comm_trace folder); compiled autograd stays a warned no-op, as in JAX.
UNREAD_CASES = {
    "defaults": ({}, (), False),
    "compile": ({"training_compile": "true"}, (), True),
    "compiled_autograd": ({"training_enable_compiled_autograd": "true"},
                          ("training_enable_compiled_autograd",), False),
    "trace_buf_size": ({"training_trace_buf_size": 100}, (), False),
    "all three": ({"training_compile": "true", "training_enable_compiled_autograd": "true",
                   "training_trace_buf_size": 100}, ("training_enable_compiled_autograd",),
                  True),
    "layout flags at degree 1": ({
        "training_context_parallel_rotate_method": "alltoall",
        "training_fsdp_reshard_after_forward": "always",
        "training_pipeline_parallel_schedule": "GPipe",
        "training_pipeline_parallel_microbatches": 4,
        "training_pipeline_parallel_split_points": "layers.1",
        "training_enable_loss_parallel": "true",
        "training_enable_async_tensor_parallel": "true"}, (), False),
}


@pytest.fixture(scope="module")
def default_losses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unread")
    listfile = build_corpus(tmp)
    trainer = ttrain.main(_flags(tmp, listfile, 2), device=torch.device("cpu"))
    return listfile, [h["loss/per_sample"] for h in trainer.metrics_processor.history]


@pytest.mark.parametrize("case", list(UNREAD_CASES))
def test_unread_flags_warn_once_and_change_nothing(tmp_path, default_losses, case):
    listfile, want = default_losses
    flags, warned, compiled = UNREAD_CASES[case]
    trainer = ttrain.main(_flags(tmp_path, listfile, 2, **flags), device=torch.device("cpu"))
    losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    assert len(losses) == 2
    if compiled:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
    else:
        assert losses == want
    assert trainer.compiled == compiled
    summary = json.loads((tmp_path / "exp" / "train_summary_rank0.json").read_text())
    assert summary["compile"]["enabled"] == compiled
    if compiled:
        assert summary["compile"]["graph_breaks"] == 0 and summary["compile"]["seconds"] > 0
    assert summary["flight_recorder"]["buffer_size"] == 0  # no NCCL group here
    assert not (tmp_path / "exp" / "comm_trace").exists()
    log = (tmp_path / "exp" / "touchnet_train.log").read_text().splitlines()
    assert any("training_compile:" in ln for ln in log) == compiled
    for name in ttrain.UNREAD_FLAGS:
        lines = [ln for ln in log if " WARNING " in ln and f"{name}=" in ln]
        assert len(lines) == (name in warned), (name, lines)
        if lines:
            assert ttrain.UNREAD_FLAGS[name] in lines[0] and "changes nothing" in lines[0]
    for name in ("training_compile", "training_trace_buf_size"):
        assert not [ln for ln in log if " WARNING " in ln and f"{name}=" in ln]
    assert not [ln for ln in log if " WARNING " in ln and "parallel" in ln]
