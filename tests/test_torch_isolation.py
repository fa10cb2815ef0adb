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
assert {"repro_torch.distributed.sharding",
        "repro_torch.launch.mesh", "repro_torch.launch.cells",
        "repro_torch.launch.dryrun", "repro_torch.distributed.hlo_cost",
        "repro_torch.distributed.hlo_analysis"} <= set(names)
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
    # the online path's modules included (controller, checkpoint, fault,
    # online.{bus,shed,service}, launch.online), the LM side's
    # (multitenant, configs.*, models.{layers,transformer,api},
    # training.grad, launch.{presets,train}) and distribution's
    # (distributed, distributed.sharding, launch.mesh) and the dry run's
    # (launch.{cells,dryrun}, distributed.{hlo_cost,hlo_analysis})
    assert int(out.stdout.strip()) >= 75


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
    """``mesh=`` builds an executor whose place stage keeps this rank's
    rows (one shard of one here); the launcher refuses an enc-dec arch
    (no frames) and the production mesh without a world of its ranks."""
    from repro_torch.launch import train as launch

    class OneRankMesh:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return 1

        def get_local_rank(self, name):
            return 0

    tmpl = paper_pipeline("II", small_vocab=2048)
    src = Source.synth("I", rows=10, batch_size=10)
    job = EtlJob(tmpl, src, backend="cuda", device="cpu", mesh=OneRankMesh())
    job.fit()
    with job.batches() as batches:
        (batch,) = list(batches)
    assert all(v.shape[0] == 10 for v in batch.values())
    with pytest.raises(ValueError, match="frames"):  # no launcher feeds them
        launch.main(["--arch", "whisper_base", "--reduced", "--device",
                     "cpu"])
    with pytest.raises(RuntimeError, match="no process group"):
        launch.main(["--arch", "llama3_2_3b", "--reduced", "--device", "cpu",
                     "--mesh", "pod"])


def test_adafactor_and_moe_run():
    """Once unported: a DLRM steps with Adafactor (one leaf per parameter,
    the weights' factors in the port's [out, in] layout) and the MoE family
    builds."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models.api import build_model
    model = dlrm.DLRM(dlrm.DLRMConfig(vocab_size=9, d_emb=4, bot_mlp=(8, 4),
                                      top_mlp=(8, 1)), device="cpu")
    tc = TrainConfig(optimizer="adafactor")
    state = ttl.TrainState.create(model, tc)
    step = ttl.make_train_step(dlrm.loss_fn, tc)
    batch = {"dense": torch.zeros(2, 16), "label": torch.zeros(2),
             "sparse": torch.zeros(2, 32, dtype=torch.int32)}
    before = [p.detach().clone() for p in model.parameters()]
    state, m = step(state, batch)
    assert state.step == 1 and torch.isfinite(m["loss"])
    assert [sorted(s) for s in state.opt["f"]] == [
        ["vc", "vr"] if p.dim() >= 2 and min(p.shape[-2:]) > 1 else ["v"]
        for p in model.parameters()]
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    moe = build_model(get_reduced("mixtral_8x7b")).init(device="cpu")
    assert len(moe.moe_blocks) == 2 and len(moe.blocks) == 0


def test_knob_controller_options_build_a_controller():
    """``autotune=`` and ``adaptive_credits=True`` (once unported) build
    the knob controller: the throughput search over the executor's knobs
    and, on "cuda", the compile-time ``row_tile`` and ``fuse``; the
    occupancy rule on the credits alone."""
    from repro_torch.etl_runtime.controller import PipelineController
    tmpl = paper_pipeline("II", small_vocab=2048)
    src = Source.synth("I", rows=10, batch_size=10)
    ex = EtlJob(tmpl, src, backend="cuda", device="cpu",
                autotune=True).executor()
    ctl = ex.stats.controller
    assert isinstance(ctl, PipelineController) and ctl.mode == "throughput"
    knobs = {k.name: k for k in ctl.knobs}
    assert set(knobs) == {"row_tile", "fuse", "credits", "prefetch_depth"}
    assert knobs["fuse"].candidates == (False, True)
    tiles = knobs["row_tile"].candidates
    assert ex.pipeline.plan.row_tile in tiles and len(tiles) > 1
    # each candidate runs kernels of its own rows per tile
    assert len({ex.pipeline.with_knobs(row_tile=t).kernel_tiles()
                for t in tiles}) == len(tiles)
    with pytest.warns(DeprecationWarning):
        job = EtlJob(tmpl, src, backend="cuda", device="cpu",
                     adaptive_credits=True)
    ctl = job.executor().stats.controller
    assert ctl.mode == "occupancy" and [k.name for k in ctl.knobs] == \
        ["credits"]
    torch_ex = EtlJob(tmpl, src, backend="torch", device="cpu",
                      autotune=True).executor()
    assert {k.name for k in torch_ex.stats.controller.knobs} == \
        {"credits", "prefetch_depth"}


def test_train_launcher_raises_without_a_device(no_cuda):
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer
    from repro_torch.configs.registry import get_reduced
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "llama3_2_3b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.Transformer(get_reduced("llama3_2_3b"))


def test_online_launcher_raises_without_a_device(no_cuda):
    from repro_torch.launch.online import build_parser, build_service
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_service(build_parser().parse_args([]))


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
