# The port's checkpoints (touchnet_tpu_torch/utils/checkpoint.py) on the CPU:
#   - the CheckpointManager cases of tests/touchnet_tpu/utils/test_checkpoint.py
#     on the port: cadence and keep-k, resume and exclude, a named or missing
#     step, the step-0 seed, weights-only at a dtype, async, keys by name,
#     shape and dtype validation (raising, naming the key, loading nothing),
#     excluding the model, and an async save that the next in-place update
#     does not corrupt; the step directories equal those the JAX manager
#     leaves under the same flags;
#   - the trainer: N steps straight against k steps, a save, a new Trainer
#     and N - k more, in f32 on the tiny config: params, AdamW moments and
#     count, the loader state and every logged loss bit for bit; the same
#     at device-prefetch depths 1 and 4; SIGTERM saves at the step boundary
#     and a rerun resumes there; the weights-only export at the end.

import gc
import os
import signal

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from test_torch_train import _flags, build_corpus
from torch.distributed.checkpoint import FileSystemReader

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.utils.checkpoint import CheckpointManager, export_weights_only


def make_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = {"w": torch.randn((8, 8), generator=g), "b": torch.zeros(8)}
    opt = {"mu.w": torch.randn((8, 8), generator=g), "mu.b": torch.zeros(8),
           "nu.w": torch.rand((8, 8), generator=g), "nu.b": torch.zeros(8),
           "count": torch.tensor(seed + 3, dtype=torch.int32)}
    return model, opt


class FakeLoader:
    def __init__(self):
        self.state = {"dp_rank_0": {"x": 1}, "world_size": 1}

    def state_dict(self):
        return self.state

    def load_state_dict(self, s):
        self.state = s


def make_cfg(tmp_path, cls=TrainConfig, **over):
    cfg = cls(training_enable_ckpt=True, training_trace_dump_folder=str(tmp_path),
              training_ckpt_interval=2, training_ckpt_keep_latest_k=2)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def step_dirs(folder):
    return sorted(p for p in os.listdir(folder) if p.startswith("step_"))


def assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cadence_and_keep_k(tmp_path):
    model, opt = make_state()
    mgr = CheckpointManager(FakeLoader(), make_cfg(tmp_path))
    assert mgr.save(1, model, opt)          # step-1 fail-fast
    assert not mgr.save(3, model, opt)      # off-interval
    assert mgr.save(2, model, opt)
    assert mgr.save(4, model, opt)
    assert mgr.save(6, model, opt)
    assert mgr.save(7, model, opt, force=True)
    mgr.close()
    assert step_dirs(tmp_path / "checkpoint") == ["step_6", "step_7"]  # keep-latest-2


@pytest.mark.parametrize("async_mode", ["disabled", "async"])
def test_step_dirs_equal_jax(tmp_path, async_mode):
    """Under the same flags and save calls, the port leaves the step
    directories of the JAX (Orbax) manager, each with the same items."""
    model, opt = make_state()
    jparams = {"w": jnp.asarray(model["w"].numpy()), "b": jnp.zeros(8)}
    jopt = optax.adamw(1e-3).init(jparams)
    ours = CheckpointManager(FakeLoader(), make_cfg(tmp_path / "port",
                                                    training_ckpt_async_mode=async_mode))
    theirs = JCheckpointManager(FakeLoader(), make_cfg(tmp_path / "jax", JTrainConfig,
                                                       training_ckpt_async_mode=async_mode))
    for step in range(1, 8):
        assert ours.save(step, model, opt, force=step == 7) == \
            theirs.save(step, jparams, jopt, force=step == 7)
    ours.close()
    theirs.close()
    a, b = tmp_path / "port" / "checkpoint", tmp_path / "jax" / "checkpoint"
    assert step_dirs(a) == step_dirs(b) == ["step_6", "step_7"]
    for d in step_dirs(a):
        items = sorted(p for p in os.listdir(b / d) if not p.startswith("_"))
        assert sorted(os.listdir(a / d)) == items == [
            "dataloader", "model", "optimizer", "train_state"]


def test_resume_and_exclude(tmp_path):
    model, opt = make_state()
    loader = FakeLoader()
    mgr = CheckpointManager(loader, make_cfg(tmp_path))
    loader.state = {"dp_rank_0": {"x": 42}, "world_size": 1}
    trained = {k: v + 1.0 for k, v in model.items()}
    mgr.save(2, trained, opt)
    mgr.close()

    model2, opt2 = make_state(seed=1)
    loader2 = FakeLoader()
    out = CheckpointManager(loader2, make_cfg(tmp_path)).load(model2, opt2)
    assert out == {"step": 2, "loaded": True}
    assert_state_equal(model2, trained)
    assert_state_equal(opt2, opt)
    assert loader2.state["dp_rank_0"]["x"] == 42

    loader3 = FakeLoader()  # the dataloader excluded from loading
    CheckpointManager(loader3, make_cfg(
        tmp_path, training_ckpt_exclude_from_loading="dataloader")).load(*make_state(1))
    assert loader3.state["dp_rank_0"]["x"] == 1


def test_load_specific_and_missing_step(tmp_path):
    model, opt = make_state()
    mgr = CheckpointManager(FakeLoader(), make_cfg(tmp_path))
    mgr.save(2, model, opt)
    mgr.save(4, {k: v * 2 for k, v in model.items()}, opt)
    mgr.close()
    fresh, fresh_opt = make_state(seed=1)
    out = CheckpointManager(FakeLoader(), make_cfg(tmp_path, training_ckpt_load_step=99)
                            ).load(fresh, fresh_opt)
    assert not out["loaded"] and out["step"] == 0  # missing step: fresh start
    assert_state_equal(fresh, make_state(seed=1)[0])
    out = CheckpointManager(FakeLoader(), make_cfg(tmp_path, training_ckpt_load_step=2)
                            ).load(fresh, fresh_opt)
    assert out["step"] == 2
    assert_state_equal(fresh, model)  # the named step, not the latest


def test_seed_checkpoint_step0_loads_model_only(tmp_path):
    """Step 0 is the converter's seed: the model loads, the optimizer,
    loader and step stay."""
    model, opt = make_state()
    CheckpointManager(FakeLoader(), make_cfg(tmp_path)).save(0, model, opt, force=True)
    model2, opt2 = make_state(seed=1)
    loader = FakeLoader()
    loader.state = "untouched"
    out = CheckpointManager(loader, make_cfg(tmp_path)).load(model2, opt2)
    assert out == {"step": 0, "loaded": True}
    assert_state_equal(model2, model)
    assert_state_equal(opt2, make_state(seed=1)[1])
    assert loader.state == "untouched"


def test_partial_step_is_not_loaded(tmp_path):
    """A step whose write did not finish (step_<N>.partial) is never the
    latest."""
    model, opt = make_state()
    mgr = CheckpointManager(FakeLoader(), make_cfg(tmp_path))
    mgr.save(2, model, opt)
    (tmp_path / "checkpoint" / "step_4.partial").mkdir()
    assert mgr.all_steps() == [2]
    assert CheckpointManager(FakeLoader(), make_cfg(tmp_path)).load(*make_state(1))["step"] == 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_weights_only_export(tmp_path, dtype):
    model, _ = make_state()
    export_weights_only(model, str(tmp_path / "weights_only"), dtype=dtype)
    md = FileSystemReader(str(tmp_path / "weights_only")).read_metadata().state_dict_metadata
    assert set(md) == {"w", "b"}  # keys are state_dict names
    assert md["w"].properties.dtype == getattr(torch, dtype)


def test_async_mode(tmp_path):
    model, opt = make_state()
    mgr = CheckpointManager(FakeLoader(),
                            make_cfg(tmp_path, training_ckpt_async_mode="async"))
    assert mgr.save(2, model, opt)
    mgr.wait_until_finished()
    assert os.path.isdir(tmp_path / "checkpoint" / "step_2")
    mgr.close()


def test_keys_by_name(tmp_path):
    """Model keys are state_dict names, optimizer keys mu.<name>,
    nu.<name> and count; a renamed tensor fails loudly, never loads by
    position."""
    model, opt = make_state()
    mgr = CheckpointManager(FakeLoader(), make_cfg(tmp_path))
    mgr.save(2, model, opt)
    root = tmp_path / "checkpoint" / "step_2"
    assert set(FileSystemReader(str(root / "model")).read_metadata().state_dict_metadata) == \
        {"w", "b"}
    assert set(FileSystemReader(str(root / "optimizer")).read_metadata()
               .state_dict_metadata) == {"mu.w", "mu.b", "nu.w", "nu.b", "count"}
    renamed = {"w2": torch.zeros(8, 8), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="missing keys.*w2"):
        CheckpointManager(FakeLoader(), make_cfg(tmp_path)).load(renamed, make_state(1)[1])


@pytest.mark.parametrize("bad,match", [
    ({"w": torch.zeros(4, 4)}, r"model/w: shape \(8, 8\) != expected \(4, 4\)"),
    ({"w": torch.zeros(8, 8, dtype=torch.bfloat16)}, "model/w: dtype torch.float32"),
    ({"mu.b": torch.zeros(9)}, r"optimizer/mu.b: shape"),
])
def test_restore_validates_shapes_and_dtypes(tmp_path, bad, match):
    """A checkpoint that does not fit raises naming the key, and loads
    nothing: every tensor keeps its value."""
    model, opt = make_state()
    CheckpointManager(FakeLoader(), make_cfg(tmp_path)).save(2, model, opt)
    model2, opt2 = make_state(seed=1)
    for k, v in bad.items():
        (opt2 if k.startswith("mu.") else model2)[k] = v
    before = {k: v.clone() for k, v in {**model2, **opt2}.items()}
    with pytest.raises(ValueError, match=match):
        CheckpointManager(FakeLoader(), make_cfg(tmp_path)).load(model2, opt2)
    assert_state_equal({**model2, **opt2}, before)


def test_exclude_model_from_loading(tmp_path):
    model, opt = make_state()
    CheckpointManager(FakeLoader(), make_cfg(tmp_path)).save(
        2, {k: v + 7.0 for k, v in model.items()}, opt)
    out = CheckpointManager(FakeLoader(), make_cfg(
        tmp_path, training_ckpt_exclude_from_loading="model")).load(model, make_state(1)[1])
    assert out["step"] == 2
    assert_state_equal(model, make_state()[0])  # untouched


def test_async_save_not_corrupted_by_in_place_update(tmp_path):
    """An async save, then at once the in-place update the next AdamW step
    makes (after the trainer's fence, maybe_wait_for_staging): the
    checkpoint holds the saved step exactly."""
    model, opt = make_state()
    snapshot = {k: v.clone() for k, v in {**model, **opt}.items()}
    mgr = CheckpointManager(FakeLoader(), make_cfg(tmp_path, training_ckpt_async_mode="async"))
    mgr.save(2, model, opt)
    mgr.maybe_wait_for_staging()
    for t in (*model.values(), *opt.values()):
        t.mul_(0).sub_(123)
    mgr.close()
    model2, opt2 = make_state(seed=1)
    CheckpointManager(FakeLoader(), make_cfg(tmp_path)).load(model2, opt2)
    assert_state_equal({**model2, **opt2}, snapshot)


# -- the trainer -------------------------------------------------------------


def _trainer(argv):
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    return ttrain.Trainer(tok, data, job, device=torch.device("cpu"))


def _run(trainer, stop_at=None):
    """train(); with stop_at, the step that reaches it preempts the run as
    SIGTERM does. Returns the logged losses."""
    if stop_at is not None:
        step_fn = trainer.train_step

        def step(*a):
            out = step_fn(*a)
            if trainer.step == stop_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        trainer.train_step = step
    try:
        trainer.train()
    finally:
        trainer.close()
    return [h["loss/per_sample"] for h in trainer.metrics_processor.history]


def _final_state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in trainer._opt_state().items()},
            trainer.checkpointer.dataloader.state_dict())


@pytest.mark.parametrize("depth", [1, 4])
def test_resume_is_bit_equal_to_straight_run(tmp_path, depth):
    """N = 6 steps straight, against 3 steps, a save, a new Trainer and 3
    more: params, mu, nu, count, the loader state and every logged loss
    equal bit for bit, at device-prefetch depth 1 and 4 (a staged but
    untrained batch is never skipped, and the batcher's look-ahead sample
    is not dropped)."""
    listfile = build_corpus(tmp_path)
    kw = dict(training_enable_ckpt="true", training_ckpt_interval=100,
              dataloader_device_prefetch=depth, training_activation_checkpoint_mode="op_small")
    straight = _trainer(_flags(tmp_path / "a", listfile, 6, **kw))
    want_losses = _run(straight)
    want = _final_state(straight)

    first = _trainer(_flags(tmp_path / "b", listfile, 6, **kw))
    losses = _run(first, stop_at=3)
    assert first.step == 3
    second = _trainer(_flags(tmp_path / "b", listfile, 6, **kw))
    assert second.step == 3 and int(second.count) == 3
    losses += _run(second)
    assert second.step == 6
    assert losses == want_losses and len(losses) == 6
    got = _final_state(second)
    assert_state_equal(got[0], want[0])
    assert_state_equal(got[1], want[1])
    assert got[2] == want[2]


def test_trainer_step_dirs_equal_jax_trainer(tmp_path, monkeypatch):
    """A 5-step run of the port's trainer and of the JAX trainer (one
    device, as the port) under the same checkpoint flags leave the same
    step directories (step 1, every 2nd, the last; keep 2), each with the
    same items."""
    listfile = build_corpus(tmp_path)
    kw = dict(training_enable_ckpt="true", training_ckpt_interval=2,
              training_ckpt_keep_latest_k=2, training_activation_checkpoint_mode="none")
    _run(_trainer(_flags(tmp_path / "port", listfile, 5, **kw)))
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    gc_on = gc.isenabled()
    jtrainer = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                                _flags(tmp_path / "jax", listfile, 5, **kw)))
    try:
        jtrainer.train()
    finally:
        jtrainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
    a, b = tmp_path / "port" / "exp" / "checkpoint", tmp_path / "jax" / "exp" / "checkpoint"
    assert step_dirs(a) == step_dirs(b) == ["step_4", "step_5"]
    for d in step_dirs(a):
        items = sorted(p for p in os.listdir(b / d) if not p.startswith("_"))
        assert sorted(os.listdir(a / d)) == items == [
            "dataloader", "model", "optimizer", "train_state"]


def test_sigterm_preemption_checkpoint_and_resume(tmp_path):
    """SIGTERM mid-run checkpoints at the step boundary and exits cleanly;
    a rerun resumes from the preemption step."""
    listfile = build_corpus(tmp_path)
    argv = _flags(tmp_path, listfile, 8, training_enable_ckpt="true",
                  training_ckpt_interval=100)
    handler = signal.getsignal(signal.SIGTERM)
    t = _trainer(argv)
    _run(t, stop_at=3)
    assert t.step == 3  # stopped early, not at 8
    assert step_dirs(tmp_path / "exp" / "checkpoint") == ["step_1", "step_3"]
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    t2 = _trainer(argv)
    assert t2.step == 3
    _run(t2)
    assert t2.step == 8
    assert step_dirs(tmp_path / "exp" / "checkpoint") == ["step_1", "step_3", "step_8"]


def test_weights_only_export_at_end(tmp_path):
    listfile = build_corpus(tmp_path)
    t = _trainer(_flags(tmp_path, listfile, 2, training_enable_ckpt="true",
                        training_ckpt_model_weights_only="true",
                        training_ckpt_export_dtype="bfloat16"))
    _run(t)
    md = FileSystemReader(str(tmp_path / "exp" / "checkpoint" / "weights_only")
                          ).read_metadata().state_dict_metadata
    assert set(md) == set(t.model.state_dict())
    assert {m.properties.dtype for m in md.values()} == {torch.bfloat16}
