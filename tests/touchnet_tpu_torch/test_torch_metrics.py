# The metrics backends of the port (utils/metrics.py) against the JAX
# package's _build_logger, on the CPU:
#   - TensorBoard: a trainer run with --training_enable_tensorboard true
#     leaves an event file whose scalars (read back with tensorboard's
#     EventAccumulator) are the logged lines' values, dev lines under dev/;
#   - wandb: a stub module in sys.modules receives init, one log per logged
#     line at its step, and finish when the trainer closes;
#   - a missing wandb is a warning, then TensorBoard or nothing, as the JAX
#     _build_logger chooses for the same flags.

import sys
import types

import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.utils import metrics as jmetrics
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.utils import metrics
from test_torch_train import _flags, build_corpus


def test_tensorboard_event_file_holds_the_logged_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    listfile = build_corpus(tmp_path)
    trainer = ttrain.main(_flags(tmp_path, listfile, 3, training_enable_tensorboard="true",
                                 training_enable_ckpt="true", training_ckpt_interval=2,
                                 datalist_dev_path=listfile),
                          device=torch.device("cpu"))
    runs = list((tmp_path / "exp" / "tensorboard").iterdir())
    assert len(runs) == 1
    acc = EventAccumulator(str(runs[0]))
    acc.Reload()
    hist = trainer.metrics_processor.history
    for tag in ("loss/per_sample", "loss/per_token", "acc", "grad_norm", "lr", "throughput/tps"):
        events = acc.Scalars(tag)
        assert [e.step for e in events] == [h["step"] for h in hist], tag
        np.testing.assert_allclose([e.value for e in events], [h[tag] for h in hist],
                                   rtol=1e-6, err_msg=tag)
    dev = acc.Scalars("dev/loss_per_sample")
    assert [e.step for e in dev] == [d["step"] for d in trainer.metrics_processor.dev_history]
    assert [e.step for e in dev] == [1, 2, 3]


class _StubWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        self.run = None

    def init(self, **kw):
        self.calls.append(("init", kw))
        self.run = object()

    def log(self, metrics, step):
        self.calls.append(("log", step, dict(metrics)))

    def finish(self):
        self.calls.append(("finish",))
        self.run = None


def test_wandb_backend_receives_init_log_finish(tmp_path, monkeypatch):
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    listfile = build_corpus(tmp_path)
    trainer = ttrain.main(_flags(tmp_path, listfile, 2, training_enable_wandb="true",
                                 training_enable_tensorboard="true"),
                          device=torch.device("cpu"))
    assert isinstance(trainer.metrics_processor.logger_backend, metrics.WandBLogger)
    kinds = [c[0] for c in stub.calls]
    assert kinds == ["init", "log", "log", "finish"]
    assert stub.calls[0][1]["dir"] == str(tmp_path / "exp")
    for call, h in zip(stub.calls[1:3], trainer.metrics_processor.history):
        assert call[1] == h["step"] and call[2]["loss/per_sample"] == h["loss/per_sample"]


@pytest.mark.parametrize("tensorboard", [False, True])
def test_missing_wandb_warns_and_falls_back_as_jax(tmp_path, monkeypatch, tensorboard):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    warned = []
    monkeypatch.setattr(metrics.logger, "warning", lambda msg, *a, **k: warned.append(msg))
    kw = dict(training_enable_wandb=True, training_enable_tensorboard=tensorboard)
    ours = metrics._build_logger(TrainConfig(**kw), str(tmp_path / "port"))
    theirs = jmetrics._build_logger(JTrainConfig(**kw), str(tmp_path / "jax"))
    assert type(ours).__name__ == type(theirs).__name__ == (
        "TensorBoardLogger" if tensorboard else "BaseLogger")
    assert len(warned) == 1 and "wandb unavailable" in warned[0]
    ours.close()
    theirs.close()
