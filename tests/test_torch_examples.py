"""The port's example twins (``examples/torch_*.py``) run as a user runs
them, in a subprocess: ``torch_quickstart.py``, ``torch_train_lm.py`` and
``torch_online_training.py`` with ``--device cpu`` (the plain versions;
the quickstart skips its ``cuda`` backend and says so), and without a
device where there is no card, where each refuses instead of falling
back to the CPU.  ``tests/test_torch_cuda.py`` runs them on the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# example: (CPU arguments, lines its output must hold)
RUNS = {
    "torch_quickstart.py": (
        [], ["[numpy ] dense:(4096, 128):float32", "[torch ] dense:",
             "[cuda  ] skipped: --device cpu",
             "numpy, torch agree with numpy: True"]),
    "torch_train_lm.py": (
        ["--steps", "3", "--batch", "4", "--seq", "32"],
        ["[train] done: 3 steps", "tok/s"]),
    "torch_online_training.py": (
        ["--duration", "4", "--refit-every", "4", "--checkpoint-every", "4"],
        ["[online] staleness p50/p95/p99", "newest committed checkpoint"]),
}


def run(example: str, args: list, tmp_path) -> subprocess.CompletedProcess:
    if example == "torch_online_training.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


@pytest.mark.parametrize("example", list(RUNS))
def test_example_runs_on_the_cpu(example, tmp_path):
    args, lines = RUNS[example]
    out = run(example, args + ["--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in lines:
        assert line in out.stdout, (line, out.stdout[-3000:])


@pytest.mark.parametrize("example", list(RUNS))
def test_example_refuses_without_a_card(example, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    out = run(example, RUNS[example][0], tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-3000:]
