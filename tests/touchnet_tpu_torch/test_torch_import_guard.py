# touchnet_tpu_torch imports torch and never jax: the machines it serves on
# have no JAX. A fresh interpreter imports every module of the package and
# must end with no jax (and no touchnet_tpu) module loaded, and without
# building a kernel.

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
        "assert _build._lib is None, 'a kernel was built at import'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
