"""The dry run's counters (``repro_torch.distributed.hlo_cost`` /
``hlo_analysis``) against the JAX package's HLO analysers, and the dry run
itself (``repro_torch.launch.dryrun``) on a fake world.

5. ``hlo_cost.analyze`` of a 256x512 @ 512x1024 float32 matmul has
   exactly the reference's ``hlo_cost.analyze`` flops of the compiled
   product, and bytes within 10 % (the reference's own bound against XLA,
   ``tests/test_distributed.py:35-42``); ``flop_counter_total`` agrees.
6. Ten chained 128x128 matmuls count >= 10 x 2 x 128^3 flops, within 1e-3
   of the reference's trip-count-aware figure for its ``lax.scan`` of ten.
7. One all-reduce and one all-gather of fixed shapes, issued on a fake
   world of 4, give the same per-op ``count``, ``bytes`` and
   ``wire_bytes`` as the reference's ``collect_collectives`` on the
   compiled HLO of the same two collectives (``shard_map`` over 4 forced
   host devices, an Auto-axes ``Mesh``, in a subprocess).
8. A miniature of ``tests/test_distributed.py:180-197``: ``mamba2_370m``
   at ``ShapeCfg("train_tiny", 256, 16, "train")`` on a (4, 2) fake world
   runs ``run_cell`` to ``ok``, with ``flops > 0`` and ``n_collectives >
   0``.

Besides: flash attention's chunk loops counted on fake tensors (each body
run once, ``models.loops.uniform``) equal the same call counted on real
tensors; a composite op counts as its parts under ``inference_mode`` and
``no_grad`` as with grad on, and a backward formula's own
(``silu_backward``) too; the dry run refuses to start beside another
process group.
Every fake group is destroyed before its test returns.  Takes ~125 s alone
on an 8-core CPU, ~115 s of it the miniature (48 layers, 4 microbatches,
each op dispatched through the fake mode and the counting mode).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.distributed import hlo_cost as rcost  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed import hlo_analysis, hlo_cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import loops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ref_analyze(fn, *shapes):
    c = jax.jit(fn).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                            for s in shapes]).compile()
    return rcost.analyze(c.as_text())


def test_a_matmul_counts_as_the_reference():
    ref = _ref_analyze(lambda a, b: a @ b, (256, 512), (512, 1024))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(512, 1024)).astype(np.float32))
    got = hlo_cost.analyze(torch.matmul, a, b)
    assert got["flops"] == ref["flops"] == 2 * 256 * 512 * 1024
    assert abs(got["bytes_accessed"] - ref["bytes_accessed"]) \
        / ref["bytes_accessed"] < 0.1
    assert hlo_cost.flop_counter_total(torch.matmul, a, b) == got["flops"]
    assert got["n_collectives"] == 0


def test_composite_ops_count_as_their_parts_in_every_grad_mode():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    want = hlo_cost.analyze(torch.einsum, "ij,jk->ik", a, b)
    assert want["flops"] == 2 * 8 * 16 * 4
    with torch.no_grad():
        assert hlo_cost.analyze(torch.einsum, "ij,jk->ik", a, b) == want
    with torch.inference_mode():  # einsum reaches the mode whole here
        assert hlo_cost.analyze(torch.einsum, "ij,jk->ik", a, b) == want


def test_a_backward_formulas_composite_op_counts_as_its_parts():
    """``silu_backward`` (a SwiGLU block's backward) reaches the mode whole
    with grad on; its parts count: the sigmoid it recomputes a
    transcendental an element, its products and sums a flop each."""
    n = 64
    x = torch.linspace(-2, 2, n, requires_grad=True)
    got = hlo_cost.analyze(
        lambda: torch.nn.functional.silu(x).sum().backward())
    assert got["transcendentals"] == 2 * n  # the forward's and the grad's
    assert got["flops"] >= 4 * n


def test_ten_chained_matmuls_count_every_product():
    def scan(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)
        return y

    ref = _ref_analyze(scan, (128, 128))

    def chain(x):
        for _ in range(10):
            x = x @ x
        return x

    x = torch.eye(128)
    got = hlo_cost.analyze(chain, x)
    assert got["flops"] >= 10 * 2 * 128 ** 3
    assert abs(got["flops"] - ref["flops"]) / ref["flops"] < 1e-3


_REF_COLLECTIVES = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed import hlo_analysis

mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map

def f(x):
    return (jax.lax.psum(x, "x"),
            jax.lax.all_gather(x, "x", axis=0, tiled=True))

g = jax.jit(shard_map(f, mesh=mesh, in_specs=P("x"),
                      out_specs=(P("x"), P("x"))))
c = g.lower(jax.ShapeDtypeStruct((4 * 64, 128), jnp.float32)).compile()
print("STATS", json.dumps(hlo_analysis.collect_collectives(c.as_text())))
"""


def test_collectives_count_as_the_references_hlo():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_REF_COLLECTIVES)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    ref = json.loads(out.stdout.split("STATS", 1)[1])

    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
    try:
        def issue():
            x = torch.ones(64, 128)
            dist.all_reduce(x)
            whole = x.new_empty(4 * 64, 128)
            dist.all_gather_into_tensor(whole, x)

        got = hlo_cost.analyze(issue)["per_op"]
    finally:
        dist.destroy_process_group()
    assert set(got) == set(ref) == {"all-reduce", "all-gather"}
    for op in ref:
        assert got[op]["count"] == ref[op]["count"] == 1, op
        assert got[op]["bytes"] == ref[op]["bytes"], op
        assert got[op]["wire_bytes"] == pytest.approx(
            ref[op]["wire_bytes"], rel=1e-12), op


def test_wire_model_per_op():
    recs = [("all-reduce", 400, 4), ("all-gather", 400, 4),
            ("reduce-scatter", 100, 4), ("all-to-all", 400, 4),
            ("collective-permute", 400, 2)]
    st = hlo_analysis.summarize(recs)
    assert st["per_op"]["all-reduce"]["wire_bytes"] == 600.0
    assert st["per_op"]["all-gather"]["wire_bytes"] == 300.0
    assert st["per_op"]["reduce-scatter"]["wire_bytes"] == 300.0
    assert st["per_op"]["all-to-all"]["wire_bytes"] == 300.0
    assert st["per_op"]["collective-permute"]["wire_bytes"] == 400.0
    assert st["n_collectives"] == 5 and st["collective_bytes"] == 1700
    r = hlo_analysis.roofline_terms(989e12, 3.35e12, 0.0, 50e9, 4)
    assert r["t_compute_s"] == r["t_memory_s"] == r["t_wire_s"] == 1.0
    assert r["dominant"] == "compute"


def test_a_loop_on_fake_tensors_counts_as_every_iteration():
    """flash attention's query- and key-chunk loops: each run once on fake
    tensors, counted once a chunk; the same as every chunk run on real
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S, H, D = 1, 64, 2, 8
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(S)

    def attend(q, k, v, pos):
        return L.flash_attention(q, k, v, pos, pos, causal=True, window=0,
                                 q_chunk=16, k_chunk=8)

    real = hlo_cost.analyze(attend, q, k, v, pos)
    with FakeTensorMode() as fake:
        args = [fake.from_tensor(t) for t in (q, k, v, pos)]
        counted = hlo_cost.analyze(attend, *args)
    for key in ("flops", "transcendentals", "bytes_accessed"):
        assert counted[key] == real[key] > 0, key
    with loops.uniform(8, q) as trips:
        assert trips == 8  # real tensors run every iteration


def test_the_dry_run_refuses_beside_another_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            with dryrun.fake_world((2, 1), "cpu"):
                pass
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_a_miniature_cell_runs_to_ok(tmp_path):
    shape = ShapeCfg("train_tiny", 256, 16, "train")
    rec = dryrun.run_cell("mamba2_370m", shape, mesh_shape=(4, 2),
                          out_dir=str(tmp_path), device="cpu")
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["n_collectives"] > 0
    assert rec["memory"]["per_device_bytes"] >= \
        rec["memory"]["param_bytes"] > 0
    assert (tmp_path / "mamba2_370m__train_tiny__4x2.json").exists()
