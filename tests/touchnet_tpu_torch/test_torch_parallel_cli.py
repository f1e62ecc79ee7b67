# The port's multi-process entry points outside the trainer, on the CPU:
#   - the three ASR CLIs under torchrun's environment (RANK, WORLD_SIZE;
#     no process group is needed): at world 2, rank 0 writes part_0 and
#     rank 1 part_1, every other utterance each, and their union equals
#     the world-1 part file line for line (the tiny configs and wavs of
#     each CLI's own test);
#   - bin/elastic.py: a failing command is restarted until it succeeds
#     (each restart counted), one that keeps failing stops when the
#     restarts are spent, and SIGTERM to the wrapper reaches the command
#     as SIGTERM and ends the loop without a restart.

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from touchnet_tpu_torch.bin import elastic
from test_torch_inference_kimi_audio import tiny as kimi_tiny  # noqa: F401
from test_torch_inference_qwen2_audio import _argv as qwen2_argv
from test_torch_inference_qwen2_audio import tiny as qwen2_tiny  # noqa: F401
from test_torch_inference_touch_audio import _argv as touch_argv
from test_torch_inference_touch_audio import tiny as touch_tiny  # noqa: F401
from test_torch_audio_frontend import jax_native, jax_native_dir  # noqa: F401
from test_torch_inference_kimi_audio import chip_smoke


def _lines(path):
    return [json.loads(ln) for ln in open(path, encoding="utf8")]


def _subset(jsonl, tmp_path, keep):
    """The jsonl's first ``keep`` lines (its short wavs; the 31 s one of
    the qwen2_audio fixture comes last)."""
    out = tmp_path / "subset.jsonl"
    out.write_text("".join(open(jsonl, encoding="utf8").readlines()[:keep]))
    return str(out)


def _with_list(argv, data_list):
    i = argv.index("--data_list")
    return argv[:i + 1] + [data_list] + argv[i + 2:]


def _split(main, argv_of, tmp_path, monkeypatch):
    """main at world 1, then ranks 0 and 1 of 2: the parts and the whole."""
    whole = main(argv_of(tmp_path / "w1"), device=torch.device("cpu"))
    parts = []
    for rank in (0, 1):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "2")
        parts.append(main(argv_of(tmp_path / "w2"), device=torch.device("cpu")))
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert [os.path.basename(p) for p in parts] == ["part_0", "part_1"]
    assert os.path.basename(whole) == "part_0"
    got = [_lines(p) for p in parts]
    want = _lines(whole)
    assert [r["key"] for r in got[0]] == [r["key"] for r in want[0::2]]
    assert [r["key"] for r in got[1]] == [r["key"] for r in want[1::2]]
    key = lambda r: r["key"]  # noqa: E731
    assert sorted(got[0] + got[1], key=key) == sorted(want, key=key)


def test_touch_audio_cli_rank_split(touch_tiny, tmp_path, monkeypatch):  # noqa: F811
    from touchnet_tpu_torch.models.touch_audio import inference_touch_audio as cli

    _split(cli.main, lambda out: touch_argv(touch_tiny, out), tmp_path, monkeypatch)


def test_qwen2_audio_cli_rank_split(qwen2_tiny, tmp_path, monkeypatch):  # noqa: F811
    from touchnet_tpu_torch.models.qwen2_audio import inference_qwen2_audio as cli

    data = _subset(qwen2_tiny["jsonl"], tmp_path, 3)
    _split(cli.main, lambda out: _with_list(qwen2_argv(qwen2_tiny, out), data), tmp_path,
           monkeypatch)


def test_kimi_audio_cli_rank_split(kimi_tiny, tmp_path, monkeypatch):  # noqa: F811
    from touchnet_tpu_torch.models.kimi_audio import inference_kimi_audio as cli

    data = _subset(kimi_tiny["jsonl"], tmp_path, 2)

    def argv(out):
        return chip_smoke.stage4_argv("kimi_audio", kimi_tiny["hf"], data,
                                      out) + ["--max_length", "4", "--batch_size", "1"]

    _split(cli.main, argv, tmp_path, monkeypatch)


_FLAKY = """import os, sys
n = int(open(sys.argv[1]).read()) if os.path.exists(sys.argv[1]) else 0
open(sys.argv[1], "w").write(str(n + 1))
sys.exit(0 if n + 1 >= int(sys.argv[2]) else 3)
"""


@pytest.mark.parametrize("succeed_on,restarts,rc,runs", [(3, 3, 0, 3), (9, 2, 3, 3)])
def test_elastic_restarts(tmp_path, succeed_on, restarts, rc, runs):
    """A command that fails until its n-th run: restarted until it exits 0,
    or until the restarts are spent (then its exit code)."""
    script = tmp_path / "flaky.py"
    script.write_text(_FLAKY)
    count = tmp_path / "count"
    got = elastic.run_elastic([sys.executable, str(script), str(count), str(succeed_on)],
                              max_restarts=restarts, backoff_s=0.0)
    assert got == rc
    assert int(count.read_text()) == runs


_SLEEPER = """import signal, sys, time
def on_term(signum, frame):
    open(sys.argv[1], "w").write("SIGTERM")
    sys.exit(0)
signal.signal(signal.SIGTERM, on_term)
open(sys.argv[1] + ".up", "w").write("up")
time.sleep(60)
"""


def test_elastic_forwards_sigterm_and_stops(tmp_path):
    """SIGTERM to the wrapper: the command gets SIGTERM (and here exits 0,
    as the trainer does after its save); the wrapper does not restart it."""
    script = tmp_path / "sleeper.py"
    script.write_text(_SLEEPER)
    mark = tmp_path / "mark"
    proc = subprocess.Popen([sys.executable, "-m", "touchnet_tpu_torch.bin.elastic",
                             "--max-restarts", "3", "--backoff-seconds", "0", "--",
                             sys.executable, str(script), str(mark)],
                            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__)))))
    deadline = time.monotonic() + 60
    while not os.path.exists(str(mark) + ".up"):
        assert time.monotonic() < deadline and proc.poll() is None
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0
    assert mark.read_text() == "SIGTERM"
    os.remove(str(mark) + ".up")
    time.sleep(0.5)
    assert not os.path.exists(str(mark) + ".up")  # no second run
