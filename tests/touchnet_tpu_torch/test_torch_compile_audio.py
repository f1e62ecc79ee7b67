# --training_compile on the CPU for touch_audio and qwen2_audio: the
# compiled Trainer's step against the JAX Trainer's jitted step on the same
# weights and batch, at the tolerances of the eager tests they copy
# (test_torch_touch_audio.py::test_train_step_matches_jax_trainer: the
# first BEST-RQ batch of 8 packed rows, loss, grad norm and accuracy rtol
# 1e-5; test_torch_qwen2_audio_sft.py::test_train_step_matches_jax_trainer:
# a dynamic_batch batch of 8 rows through the whisper tower and the text
# stack, both compiled with symbolic rows and lengths, under the recipe's
# remat full as the recipe-flags test, whose graphs these are, rtol 1e-5).
# The JAX Trainer's
# dp 8 over its 8 CPU devices takes the rows in multiples of 8.

import gc

import jax
import numpy as np
import torch
import test_torch_qwen2_audio_sft as q2
import test_torch_touch_audio as ta
from test_torch_qwen2_audio_sft import env  # noqa: F401  (the module fixture)

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.data import DataConfig

KEYS = ("loss/per_sample", "loss/per_token", "acc", "grad_norm")


def _jax_trainer(argv):
    return JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], argv))


def _compare(trainer, jt, batch, convert):
    """Both steps on ``batch`` from the JAX Trainer's weights."""
    trainer.model.load_state_dict(convert.params_from_jax_numpy(
        jax.tree.map(np.asarray, jt.params), trainer.model_config))
    db, jns = jt._put_batch(batch)
    _, _, jmet = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
    met = trainer.train_step(*trainer._put_batch(batch))
    for key in KEYS:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5, err_msg=key)
    summary = trainer._compile_summary()
    assert summary["enabled"] and summary["graph_breaks"] == 0, summary
    return summary


def test_touch_audio_compiled_step_matches_jax_trainer(tmp_path):
    listfile = ta._shards(tmp_path)
    kw = dict(dataset_batchsize=ta.ROWS, audio_speed_perturb="false")
    trainer = ta._trainer(ta._flags(tmp_path / "port", listfile, 10, training_compile="true",
                                    **kw))
    gc_on = gc.isenabled()
    jt = _jax_trainer(ta._flags(tmp_path / "jax", listfile, 10, **kw))
    try:
        batch = next(iter(trainer.dataloader))
        summary = _compare(trainer, jt, batch, ta.convert)
        assert summary["cache_entries"]["LlamaDecoderLayer"] == 1 and not summary["dynamic"]
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()


def test_qwen2_audio_compiled_step_matches_jax_trainer(env, tmp_path):  # noqa: F811
    argv = q2._flags(env, tmp_path / "port", 4,
                     dataloader_num_workers=1, training_data_parallel_shard_degree=-1,
                     training_compile="true")
    trainer = q2._trainer(argv)
    gc_on = gc.isenabled()
    jt = _jax_trainer([a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in argv])
    try:
        rows = [s for s in q2._samples() if s["key"].startswith("utt")][:8]
        (batch,) = q2.proc.dynamic_batch(
            iter(rows), DataConfig(**q2._data_kw(dataset_batchsize=8, dataset_text_seqlen=400)),
            q2.proc.ManualQwen2AudioFrontend(trainer.tokenizer, q2.MEL), q2.AUDIO_ID)
        summary = _compare(trainer, jt, batch, q2.convert)
        assert summary["dynamic"]
        assert summary["cache_entries"]["LlamaDecoderLayer"] == 1
        assert summary["cache_entries"]["WhisperEncoderLayer"] == 1
    finally:
        jt.close()
        trainer.close()
        if gc_on:
            gc.enable()
