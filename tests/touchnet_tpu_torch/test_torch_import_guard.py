# touchnet_tpu_torch imports torch and never jax: the machines it serves on
# have no JAX. A fresh interpreter imports every module of the package and
# must end with no jax (and no touchnet_tpu) module loaded, without
# building a kernel, and without the host packages that only a flag needs
# (transformers, wandb, tensorboard: imported on first use).

import os
import pkgutil
import subprocess
import sys

import touchnet_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _modules():
    names = [touchnet_tpu_torch.__name__]
    for info in pkgutil.walk_packages(touchnet_tpu_torch.__path__, "touchnet_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_is_found():
    names = set(_modules())
    for want in (
        "touchnet_tpu_torch.models.common",
        "touchnet_tpu_torch.models.llama.configuration_llama",
        "touchnet_tpu_torch.models.llama.modeling_llama",
        "touchnet_tpu_torch.models.llama.convert",
        "touchnet_tpu_torch.models.llama.inference_llama",
        "touchnet_tpu_torch.ops.attention",
        "touchnet_tpu_torch.ops.decode_attention",
        "touchnet_tpu_torch.ops._build",
        "touchnet_tpu_torch.ops.fused_ce",
        "touchnet_tpu_torch.ops.fused_adamw",
        "touchnet_tpu_torch.ops.frontend",
        "touchnet_tpu_torch.loss.cross_entropy",
        "touchnet_tpu_torch.parallel.loss_parallel",
        "touchnet_tpu_torch.data.dataset",
        "touchnet_tpu_torch.data.datapipe",
        "touchnet_tpu_torch.data.functions",
        "touchnet_tpu_torch.data.dataloader",
        "touchnet_tpu_torch.models.llama.processing_llama",
        "touchnet_tpu_torch.tokenizer.tokenizer",
        "touchnet_tpu_torch.bin",
        "touchnet_tpu_torch.bin.make_data",
        "touchnet_tpu_torch.bin.train",
        "touchnet_tpu_torch.bin.convert_hf_to_ckpt",
        "touchnet_tpu_torch.bin.convert_ckpt_to_hf",
        "touchnet_tpu_torch.utils.checkpoint",
        "touchnet_tpu_torch.utils.safetensors_io",
        "touchnet_tpu_torch.utils.cli",
        "touchnet_tpu_torch.utils.logging",
        "touchnet_tpu_torch.utils.metrics",
        "touchnet_tpu_torch.utils.optimizer",
        "touchnet_tpu_torch.utils.train_spec",
        "touchnet_tpu_torch.utils.inference",
        "touchnet_tpu_torch.data.dsp",
        "touchnet_tpu_torch.data.native",
        "touchnet_tpu_torch.models.touch_audio",
        "touchnet_tpu_torch.models.whisper_encoder",
        "touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio",
        "touchnet_tpu_torch.models.qwen2_audio.modeling_qwen2_audio",
        "touchnet_tpu_torch.models.qwen2_audio.convert",
        "touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio",
        "touchnet_tpu_torch.models.qwen2_audio.inference_qwen2_audio",
        "touchnet_tpu_torch.bin.textnorm_zh",
        "touchnet_tpu_torch.bin.error_rate_zh",
        "touchnet_tpu_torch.models.touch_audio.configuration_touch_audio",
        "touchnet_tpu_torch.models.touch_audio.modeling_touch_audio",
        "touchnet_tpu_torch.models.touch_audio.convert",
        "touchnet_tpu_torch.models.touch_audio.processing_touch_audio",
        "touchnet_tpu_torch.models.touch_audio.inference_touch_audio",
        "touchnet_tpu_torch.models.kimi_audio",
        "touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio",
        "touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio",
        "touchnet_tpu_torch.models.kimi_audio.convert",
        "touchnet_tpu_torch.models.kimi_audio.processing_kimi_audio",
        "touchnet_tpu_torch.models.kimi_audio.generate_kimi_audio",
        "touchnet_tpu_torch.models.kimi_audio.inference_kimi_audio",
        "touchnet_tpu_torch.parallel.dims",
        "touchnet_tpu_torch.parallel.sharding",
        "touchnet_tpu_torch.utils.distributed",
        "touchnet_tpu_torch.bin.elastic",
    ):
        assert want in names


def test_package_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "from touchnet_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'touchnet_tpu'))\n"
        "assert not bad, bad\n"
        "lazy = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in ('transformers', 'wandb', 'tensorboard'))\n"
        "assert not lazy, lazy\n"
        "assert _build._lib is None, 'a kernel was built at import'\n"
        "from touchnet_tpu_torch.data import native\n"
        "assert native._lib is None, 'the native frontend was built at import'\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group was started at import'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_train_specs_register_without_jax():
    """The trainer's lookup of every model family (kimi_audio's registration
    imports the loader, the loss and the model) loads no jax, no
    touchnet_tpu and no transformers."""
    code = (
        "import sys\n"
        "from touchnet_tpu_torch.utils.train_spec import get_train_spec\n"
        "for name in ('llama', 'touch_audio', 'qwen2_audio', 'kimi_audio'):\n"
        "    assert get_train_spec(name).name == name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'touchnet_tpu', 'transformers'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
