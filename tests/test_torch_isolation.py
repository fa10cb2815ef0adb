"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points never fall back to the CPU silently."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


def test_no_jax_or_reference_imports_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith("repro.")
                  or m.split(".")[0] == "jax"))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


@pytest.fixture
def no_cuda(monkeypatch):
    """Pin "no CUDA device" whatever the host has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_device(no_cuda):
    tmpl = paper_pipeline("II", small_vocab=2048)
    for backend in ("torch", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmpl.compile(backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EtlJob(tmpl, Source.synth("I", rows=10, batch_size=10),
               backend="cuda")
    cfg = dlrm.DLRMConfig(vocab_size=9, d_emb=4, bot_mlp=(8, 4),
                          top_mlp=(8, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dlrm.DLRM(cfg)
    model = dlrm.DLRM(cfg, device="cpu")
    state = ttl.TrainState.create(model, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttl.train_loop(state, None, [], ttl.LoopConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmpl.compile("cuda", device="cuda")


def test_kernel_wrappers_take_plain_path_only_for_cpu_tensors():
    p = paper_pipeline("I", modulus=4096).compile("cuda", device="cpu")
    p.fit(iter(()))
    raw = next(iter(Source.synth("I", rows=64, batch_size=64)))
    before = dict(df.LAUNCHES)
    ((kname, names, fn, args),) = p.dataflow_launches(raw)
    assert kname == "group_dataflow" and all(a.device.type == "cpu"
                                             for a in args)
    got = fn(*args)
    want = df.apply_dataflow_plain(fn.program, args, [])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert df.LAUNCHES == before  # no CUDA launch was counted


def test_unported_options_raise():
    tmpl = paper_pipeline("II", small_vocab=2048)
    src = Source.synth("I", rows=10, batch_size=10)
    for kw in ({"autotune": True}, {"adaptive_credits": True},
               {"embed_cache": object()}):
        with pytest.raises(NotImplementedError):
            EtlJob(tmpl, src, backend="cuda", device="cpu", **kw)
    job = EtlJob(tmpl, src, backend="cuda", device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        job.executor()
    with pytest.raises(NotImplementedError):
        ttl.make_train_step(dlrm.loss_fn, TrainConfig(microbatch=2))


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and when it is copied somewhere without the rest of the repo."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_resolve_device_keeps_explicit_cpu():
    from repro_torch.kernels.backend import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
