# --training_compile on the CPU for kimi_audio: the compiled Trainer's step
# against the JAX Trainer's jitted step on the same weights, on a
# dynamic_batch batch of 8 rows with its features cropped (the JAX
# Trainer's dp 8 over its 8 CPU devices), as
# test_torch_kimi_audio_sft.py::test_train_steps_match_jax_trainer builds
# it, under the recipe's remat full (the recipe-flags test's graphs). The
# text and mimo layers and the whisper tower run compiled with symbolic
# rows and lengths; the frozen WhisperVQ tokenizer stays eager (no_grad, its
# dense block-causal attention). Loss, per-token loss and accuracy rtol 1e-5
# (that test's); the grad norm, from each side's own gradients, rtol 1e-4
# (test_loss_and_grads_match_jax holds every gradient within 1e-4 relative
# L2 of jax.grad's).

import gc

import jax
import numpy as np
import test_torch_kimi_audio_sft as km
from test_torch_kimi_audio_sft import env  # noqa: F401  (the module fixture)

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import whisper_features


def test_kimi_audio_compiled_step_matches_jax_trainer(env, tmp_path):  # noqa: F811
    argv = km._flags(env, tmp_path / "port", 3,
                     dataloader_num_workers=1, training_data_parallel_shard_degree=-1,
                     training_compile="true")
    trainer = km._trainer(argv)
    gc_on = gc.isenabled()
    jargv = [a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in argv]
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], jargv))
    try:
        trainer.model.load_state_dict(km.convert.params_from_jax_numpy(
            jax.tree.map(np.asarray, jt.params), trainer.model_config))
        samples = [s for s in km._samples(seed=50) if s["key"].startswith("utt")]
        (batch,) = km.proc.dynamic_batch(
            iter(samples[:8]),
            DataConfig(**km._data_kw(dataset_batchsize=8, dataset_text_seqlen=400)),
            lambda w, sr: whisper_features(w, sr, km.MEL), trainer.tokenizer, km.BEGIN,
            km.END, 3000)
        batch = km._cropped(batch)
        db, jns = jt._put_batch(batch)
        _, _, jmet = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
        met = trainer.train_step(*trainer._put_batch(batch))
        for key in ("loss/per_sample", "loss/per_token", "acc"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5,
                                       err_msg=key)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
        summary = trainer._compile_summary()
        assert summary["dynamic"] and summary["graph_breaks"] == 0, summary
        # the text and mimo layers share one graph; the tokenizer's layers none
        assert summary["cache_entries"]["LlamaDecoderLayer"] == 1
        assert summary["cache_entries"]["WhisperEncoderLayer"] == 1
        tokenizer_layers = trainer.model.speech_tokenizer.layers
        assert not any(hasattr(layer, "compiled_block") for layer in tokenizer_layers)
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
