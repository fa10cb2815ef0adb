"""Data-parallel distribution of the port against the JAX package's.

- (a) ``param_specs`` / ``cache_specs`` / ``batch_specs`` equal the
  reference's leaf for leaf, for every arch at full width (the reference's
  ``jax.eval_shape`` paths and shapes fed to both; ``AbstractMesh``es).
- (b) ``compressed_psum_mean`` on 4 gloo ranks is bit-equal to the
  reference's under ``jax.vmap(axis_name="d")`` over 4 ranks, for 5
  error-feedback steps (the means and every rank's residuals).
- (c) 3 data-parallel train steps on 4 gloo ranks against the reference's
  ``jit_train_step`` on 4 host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4`` and an Auto-axes
  ``jax.sharding.Mesh``), float32, within the LM float32 bounds: loss rtol
  1e-5, grad norm rtol 1e-4, each parameter leaf within 1e-4 of its norm;
  a failure names each check that failed (a leaf by its JAX path) and its
  worst relative error.  ``llama_fsdp_mb2`` runs a second time on each
  side, bit-equal to its first run.
- (d) ``EtlJob(mesh=)`` gives each of 4 ranks its rows bit-equal; a row
  count 4 does not divide raises.
- (e) elastic restores bit-equal: a one-process port checkpoint and a
  reference one onto 4 FSDP ranks, and the 4 ranks' save back onto one.
- (f) ``launch.train --mesh host`` on 2 ranks gives one process's losses;
  a rank that raises at step 2 ends the world within the timeout.
- (g) ``make_production_mesh`` on 4 ranks raises, naming 256.

The ranks' side is ``tests/torch_dist.py`` (no JAX there).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist as td  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import checkpoint as rckpt  # noqa: E402
from repro.training import grad as rgrad  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import lm_token_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

# ---------------------------------------------------------------------------
# (a) the sharding rules at full width
# ---------------------------------------------------------------------------

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]


def _pstr(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_pstr(p): tuple(s) for p, s in leaves}


@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_specs_equal_the_references_at_full_width(arch):
    cfg = rreg.get_config(arch)
    model = rapi.build_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    leaves = {_pstr(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(shapes)[0]}
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    # a decode cache and a batch of the model's own layouts
    cache = {"blocks": {"k": (cfg.n_layers, 32, 4096, cfg.n_kv_heads, 128),
                        "v": (cfg.n_layers, 32, 4096, cfg.n_kv_heads, 128),
                        "pos": (cfg.n_layers, 4096)},
             "ssm": {"ssm": (cfg.n_layers, 32, 64, 128, 64),
                     "conv": (cfg.n_layers, 32, 3, 4096)}}
    batch = {"tokens": (48, 1024), "labels": (48, 1024),
             "frames": (6, 3000, 80)}
    to_sds = lambda t: jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, np.float32), t,
        is_leaf=lambda x: isinstance(x, tuple))
    for shape, names in MESHES:
        am = AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        for fsdp in (False, True):
            for ne in sorted({0, n_exp}):
                want = _flat_specs(rshd.param_specs(shapes, am, fsdp=fsdp,
                                                    n_experts=ne))
                got = shd.param_specs(leaves, sizes, fsdp=fsdp,
                                      n_experts=ne)
                assert {k: tuple(v) for k, v in got.items()} == want, \
                    (shape, fsdp, ne)
        want = _flat_specs(rshd.cache_specs(to_sds(cache), am))
        got = shd.cache_specs(cache, sizes)
        assert {f"{g}/{k}": tuple(v) for g, sub in got.items()
                for k, v in sub.items()} == want
        want = _flat_specs(rshd.batch_specs(to_sds(batch), am))
        assert {k: tuple(v) for k, v in
                shd.batch_specs(batch, sizes).items()} == want


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    spec = shd.P(None, ("pod", "data"), "model")
    assert shd.placements(spec, Mesh()) == (Shard(1), Shard(1), Shard(2))
    assert shd.placements(shd.P(None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    assert shd.data_dim(spec) == 1 and shd.data_dim(shd.P(None)) is None


# ---------------------------------------------------------------------------
# the 4-rank runs, shared by (b) - (e) and (g)
# ---------------------------------------------------------------------------

def _port_state(seed: int, steps: int):
    """A one-process port state of reduced llama3_2_3b after ``steps``
    AdamW steps (nonzero moments)."""
    cfg = td.lm_cfg("llama3_2_3b")
    model = api.build_model(cfg)
    tc = TrainConfig(fsdp=True)
    state = ttl.TrainState.create(model.init(seed=seed, device="cpu"), tc)
    step = ttl.make_train_step(model.loss, tc)
    for i in range(steps):
        b = td.lm_batch(cfg.vocab_size, 4, 16, 40 + i)
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return state


def _int8_inputs():
    rng = np.random.default_rng(7)
    return [{"a": rng.normal(size=(WORLD, 33, 7)).astype(np.float32)
             * (10.0 ** s),
             "bf16_b": rng.normal(size=(WORLD, 64)).astype(np.float32),
             "zero": np.zeros((WORLD, 5), np.float32)} for s in range(5)]


@pytest.fixture(scope="module")
def misc_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("misc")
    paths = {"int8": str(tmp / "int8.pkl"), "port_ckpt": str(tmp / "port"),
             "ref_ckpt": str(tmp / "ref"), "saved_ckpt": str(tmp / "saved"),
             "etl": {"batch": 8, "bad_batch": 6, "seq": 16, "vocab": 512}}
    td.save(_int8_inputs(), paths["int8"])
    state = _port_state(seed=3, steps=1)
    ckpt.save(state, paths["port_ckpt"], 1)
    rcfg = dataclasses.replace(rreg.get_reduced("llama3_2_3b"),
                               compute_dtype="float32")
    rparams = rapi.build_model(rcfg).init(jax.random.key(11))
    rstate = rtl.TrainState.create(rparams, RTrainConfig(fsdp=True))
    rckpt.save(dataclasses.replace(rstate, step=np.int32(9)),
               paths["ref_ckpt"], 9)
    out = td.spawn(td.misc, WORLD, tmp, paths, timeout=120)
    return paths, out


def test_int8_mean_is_bit_equal_to_the_references(misc_run):
    _, out = misc_run
    fn = jax.vmap(lambda g, e: rgrad.compressed_psum_mean(g, e, "d"),
                  axis_name="d")
    grads = _int8_inputs()
    ef = jax.tree_util.tree_map(np.zeros_like, grads[0])
    for s, g in enumerate(grads):
        g = {k: jax.numpy.asarray(v, jax.numpy.bfloat16 if k == "bf16_b"
                                  else jax.numpy.float32)
             for k, v in g.items()}
        mean, ef = fn(g, ef)
        for r in range(WORLD):
            got_mean, got_ef = out[r]["int8"][s]
            for k in g:
                np.testing.assert_array_equal(
                    got_mean[k], np.asarray(mean[k][r], np.float32),
                    err_msg=f"mean {k} step {s} rank {r}")
                np.testing.assert_array_equal(
                    got_ef[k], np.asarray(ef[k][r]),
                    err_msg=f"residual {k} step {s} rank {r}")


def _one_process_batches(batch: int, seq: int, vocab: int) -> list:
    job = EtlJob(lm_token_pipeline(seq, vocab, batch_size=batch),
                 Source.lm_events(seq, rows=batch * 3, batch_size=batch),
                 backend="torch", device="cpu")
    with job.batches() as batches:
        return [{k: v.numpy() for k, v in b.items()} for b in batches]


def test_etl_job_on_a_mesh_delivers_each_rank_its_rows(misc_run):
    paths, out = misc_run
    e = paths["etl"]
    want = _one_process_batches(e["batch"], e["seq"], e["vocab"])
    per = e["batch"] // WORLD
    for r in range(WORLD):
        got = out[r]["etl"][0]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(g[k], w[k][r * per:
                                                         (r + 1) * per])


def test_etl_job_rows_the_world_does_not_divide_raise(misc_run):
    _, out = misc_run
    for r in range(WORLD):
        assert "6 rows" in out[r]["etl"][1] and "4 data shards" in \
            out[r]["etl"][1]


def _manifest_arrays(d: str, step: int) -> list:
    import json
    root = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as fh:
        index = json.load(fh)["index"]
    return [np.load(os.path.join(root, e["file"])) for e in index]


def _check_shards(arrays, ranks_leaves):
    for i, full in enumerate(arrays[:-1]):  # the step is the last leaf
        for r, leaves in enumerate(ranks_leaves):
            got, dim = leaves[i]
            want = full if dim is None else np.split(full, WORLD, dim)[r]
            np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")


def test_elastic_restore_one_to_four(misc_run):
    paths, out = misc_run
    arrays = _manifest_arrays(paths["port_ckpt"], 1)
    steps = [o["port_1_to_n"][0] for o in out]
    assert steps == [1] * WORLD
    _check_shards(arrays, [o["port_1_to_n"][1] for o in out])
    # FSDP sharded some leaves over the 4 ranks
    assert any(d is not None for _, d in out[0]["port_1_to_n"][1])


def test_elastic_restore_reference_one_to_port_four(misc_run):
    paths, out = misc_run
    arrays = _manifest_arrays(paths["ref_ckpt"], 9)
    assert [o["ref_1_to_n"][0] for o in out] == [9] * WORLD
    _check_shards(arrays, [o["ref_1_to_n"][1] for o in out])


def test_elastic_restore_four_to_one(misc_run):
    paths, _ = misc_run
    assert ckpt.latest_step(paths["saved_ckpt"]) == 1
    state = ckpt.restore(paths["saved_ckpt"], _port_state(seed=8, steps=0))
    want = _port_state(seed=3, steps=1)  # what the 4 ranks restored
    assert state.step == 1
    from repro_torch.models.transformer import state_to_jax_leaves
    for a, b in zip(state_to_jax_leaves(state)[:-1],
                    state_to_jax_leaves(want)[:-1]):
        a = torch.stack(a) if isinstance(a, list) else a
        b = torch.stack(b) if isinstance(b, list) else b
        assert torch.equal(a, b)


def test_production_mesh_raises_on_another_world(misc_run):
    _, out = misc_run
    assert all("256" in o["production"] for o in out)


# ---------------------------------------------------------------------------
# (c) train-step parity against the reference's 4-device jit_train_step
# ---------------------------------------------------------------------------

# name: (arch, TrainConfig kwargs, rows, uneven labels, capacity factor)
CASES = {
    "llama_replicated_mb1": ("llama3_2_3b", dict(microbatch=1), 8, False,
                             None),
    "llama_replicated_mb2": ("llama3_2_3b", dict(microbatch=2), 8, False,
                             None),
    "llama_fsdp_mb1": ("llama3_2_3b", dict(fsdp=True, microbatch=1), 8,
                       False, None),
    "llama_fsdp_mb2": ("llama3_2_3b", dict(fsdp=True, microbatch=2), 8,
                       False, None),
    # -100 labels spread unevenly over the shards
    "llama_fsdp_uneven": ("llama3_2_3b", dict(fsdp=True, microbatch=2), 8,
                          True, None),
    # the token groups: a capacity that binds, one group of 2 rows per
    # rank per microbatch (the rows of rank r's groups are not its
    # contiguous block)
    "mixtral_fsdp_mb2": ("mixtral_8x7b", dict(fsdp=True, microbatch=2), 16,
                         False, 0.5),
    # llama3_405b's preset (FSDP, Adafactor) at float32 state and
    # accumulation, microbatch 2
    "llama405b_adafactor": ("llama3_405b", dict(
        fsdp=True, optimizer="adafactor", microbatch=2), 8, False, None),
    # 6 rows the 4 ranks do not divide: the batch is replicated, and the
    # 96 tokens are 4 token groups on every rank
    "mixtral_fsdp_replicated": ("mixtral_8x7b", dict(fsdp=True), 6, False,
                                0.5),
    # the data axes ("pod", "data") of a (2, 2, 1) mesh, flattened
    "llama_fsdp_pod": ("llama3_2_3b", dict(fsdp=True, microbatch=2), 8,
                       False, None),
    # bfloat16 parameters beside a float32 router (kimi_k2's preset:
    # FSDP, Adafactor; microbatch 2) and float32 A_log / D / dt_bias:
    # each block's float32 parameters an FSDP unit of their own
    "kimi_bf16_fsdp": ("kimi_k2", dict(
        fsdp=True, optimizer="adafactor", microbatch=2), 8, False, None),
    "mamba_bf16_fsdp": ("mamba2_370m", dict(fsdp=True), 8, False, None),
    # 4 layers of 2 heads: the spec shards the layer dim of A_log, D and
    # dt_bias ([4, 2]) over the 4 data ranks; each layer's [2] splits
    # unevenly (two ranks hold one entry, two hold none), under Adafactor
    "mamba_layer_dim_fsdp": ("mamba2_370m", dict(
        fsdp=True, optimizer="adafactor"), 8, False, None),
    # bfloat16 parameters, microbatch 2, on 2 data ranks beside a model
    # axis of 2: the data axes replicate every parameter, whose gradient
    # is summed and rounded once a microbatch (the reference's formula)
    "llama_bf16_mb2_22": ("llama3_2_3b", dict(microbatch=2), 8, False,
                          None),
    # the same under FSDP on 4 data ranks: FSDP2 accumulates each rank's
    # bfloat16 gradients and reduce-scatters once a step
    "llama_bf16_fsdp_mb2": ("llama3_2_3b", dict(fsdp=True, microbatch=2),
                            8, False, None),
}
POD = {"llama_fsdp_pod"}
# a (data, model) mesh of the world's 4 ranks
MESH = {"llama_bf16_mb2_22": (2, 2)}
# the first step's gradients against the reference's per-microbatch
# formula over each rank's float32 parts (torch_dist.rounding_check)
ROUNDING = {"llama_bf16_mb2_22": "replicated",
            "llama_bf16_fsdp_mb2": "fsdp"}
# config fields replaced ("ssm": the SSM config's)
OVER = {"kimi_bf16_fsdp": {"param_dtype": "bfloat16"},
        "mamba_bf16_fsdp": {"param_dtype": "bfloat16"},
        "llama_bf16_mb2_22": {"param_dtype": "bfloat16"},
        "llama_bf16_fsdp_mb2": {"param_dtype": "bfloat16"},
        "mamba_layer_dim_fsdp": {"n_layers": 4, "ssm": {"head_dim": 128}}}
# the LM bounds at bfloat16 parameters: loss 2e-3, grad norm and each
# leaf 5e-2 (float32: 1e-5, 1e-4, 1e-4)
BF16 = {n for n, o in OVER.items() if o.get("param_dtype") == "bfloat16"}
# run twice on each side: every run of the suite shows whether a side
# gives the same bits for the same inputs
REPEAT = "llama_fsdp_mb2"
STEPS, SEQ = 3, 16
# seconds a side may take: alone on an 8-core CPU the port's takes ~20 s
# and the reference's ~60 s (before the three mixed-dtype and layer-dim
# cases, which add to both), but beside five other test workers the
# reference's passed 120 s, which ended the fixture before any comparison
STEP_TIMEOUT = 420

_REFERENCE = """
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import registry as rreg
from repro.configs.base import TrainConfig
from repro.distributed import sharding as shd
from repro.models import api
from repro.training import train_loop as tl

inputs = pickle.load(open(sys.argv[1], "rb"))
out, steps = {}, {}
for name, case in inputs.items():
    devices = np.array(jax.devices())
    mesh = (Mesh(devices.reshape(2, 2, 1), ("pod", "data", "model"))
            if case["pod"] else Mesh(devices.reshape(case["mesh"] or (4, 1)),
                                     ("data", "model")))
    shd.set_active_mesh(mesh)
    cfg = dataclasses.replace(rreg.get_reduced(case["arch"]),
                              compute_dtype="float32")
    if case["capacity_factor"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    over = dict(case["over"])
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    cfg = dataclasses.replace(cfg, **over)
    model = api.build_model(cfg)
    tc = TrainConfig(**case["tcfg"])
    params = jax.tree_util.tree_map(jax.numpy.asarray, case["params"])
    state = tl.TrainState.create(params, tc)
    b0 = case["batches"][0]
    key = name.split(":")[0]  # a repeated case runs its compiled step again
    if key not in steps:
        steps[key] = tl.jit_train_step(
            tl.make_train_step(model.loss, tc), mesh,
            jax.eval_shape(lambda: state),
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b0.items()},
            fsdp=tc.fsdp, n_experts=cfg.moe.n_experts if cfg.moe else 0)[0]
    step = steps[key]
    losses, norms = [], []
    with mesh:
        for b in case["batches"]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    leaves = [np.asarray(x, np.float32) for _, x in flat]
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    out[name] = (losses, norms, leaves, paths)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _ref_cfg(arch: str, over: dict):
    """The reference's reduced config of ``arch`` at float32 compute with
    the fields of ``over`` replaced."""
    cfg = dataclasses.replace(rreg.get_reduced(arch), compute_dtype="float32")
    over = dict(over)
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return dataclasses.replace(cfg, **over)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Both sides of every case, run side by side: the reference in a
    4-device subprocess, the port on 4 gloo ranks; each side runs
    ``REPEAT`` a second time last (as ``REPEAT + ":repeat"``)."""
    tmp = tmp_path_factory.mktemp("steps")
    inputs = {}
    for name, (arch, kw, rows, uneven, cf) in CASES.items():
        rcfg = _ref_cfg(arch, OVER.get(name, {}))
        params = rapi.build_model(rcfg).init(jax.random.key(1))
        kw = dict(kw, lr=3e-3)
        inputs[name] = {
            "arch": arch, "tcfg": kw, "capacity_factor": cf,
            "over": OVER.get(name, {}), "pod": name in POD,
            "mesh": MESH.get(name), "rounding": ROUNDING.get(name),
            "params": jax.tree_util.tree_map(np.asarray, params),
            "batches": [td.lm_batch(rcfg.vocab_size, rows, SEQ, 30 + i,
                                    uneven) for i in range(STEPS)]}
    inputs[REPEAT + ":repeat"] = inputs[REPEAT]
    td.save(inputs, tmp / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = td.spawn(td.train_cases, WORLD, tmp, str(tmp / "inputs.pkl"),
                        timeout=STEP_TIMEOUT)[0]
        _, err = ref.communicate(timeout=STEP_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return td.load(tmp / "ref.pkl"), port


def _worst_rel(got, want) -> float:
    """The largest ``|got - want| / |want|`` over paired values (0 where
    both are 0, inf where only ``want`` is)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want), np.abs(want)
    rel = np.where(scale > 0, err / np.where(scale > 0, scale, 1.0),
                   np.where(err > 0, np.inf, 0.0))
    return float(rel.max())


def _leaf_rel(got, want) -> float:
    """``||got - want|| / ||want||`` (0 where both are 0)."""
    err, scale = np.linalg.norm(got - want), np.linalg.norm(want)
    return float(err / scale) if scale > 0 else (0.0 if err == 0 else
                                                  float("inf"))


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_the_references_on_4_ranks(step_runs, name):
    ref, port = step_runs
    (rl, rn, rleaves, paths), (pl, pn, pleaves) = ref[name], port[name][:3]
    assert len(pleaves) == len(rleaves)
    loss, grad, leaf = (2e-3, 5e-2, 5e-2) if name in BF16 else \
        (1e-5, 1e-4, 1e-4)
    checks = [("loss", _worst_rel(pl, rl), loss),
              ("grad norm", _worst_rel(pn, rn), grad)]
    checks += [(f"leaf {i} {paths[i]}", _leaf_rel(got, want), leaf)
               for i, (got, want) in enumerate(zip(pleaves, rleaves))]
    failed = [f"{what}: worst relative error {err:.3e} > {bound:.0e}"
              for what, err, bound in checks if not err <= bound]
    assert not failed, f"{name}: " + "; ".join(failed)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_a_repeated_case_is_bit_equal_on_each_side(step_runs, side):
    """``REPEAT`` run twice on one side gives the same bits: drift on the
    port's side points at FSDP2 over gloo (``train_loop._fully_shard``,
    the in-place accumulation), on the reference's at its 4-device XLA
    step."""
    ref, port = step_runs
    runs = port if side == "port" else ref
    first, again = runs[REPEAT], runs[REPEAT + ":repeat"]
    moved = [what for what, a, b in (("losses", first[0], again[0]),
                                     ("grad norms", first[1], again[1]))
             if not np.array_equal(a, b)]
    moved += [f"leaf {i}" for i, (a, b) in enumerate(zip(first[2],
                                                         again[2]))
              if not np.array_equal(a, b)]
    assert not moved, f"{side}: {REPEAT} run twice differs in " + \
        ", ".join(moved) + f" (losses {first[0]} then {again[0]})"


@pytest.mark.parametrize("name", sorted(
    n for n in BF16 if n.startswith(("kimi", "mamba"))))
def test_float32_parameters_of_a_bf16_block_are_units_of_their_own(
        step_runs, name):
    """Under FSDP with bfloat16 parameters the MoE router and the SSM's
    ``A_log`` / ``D`` / ``dt_bias`` (float32) are FSDP units of their own
    beside their block's bfloat16 one, in every block."""
    _, port = step_runs
    units = port[name][3]
    f32 = {n for n, dt in units.items() if dt == "torch.float32"}
    holder = "moe.gate" if name.startswith("kimi") else "mixer.scalars"
    assert f32 and all(n.endswith(holder) for n in f32), units
    blocks = {n for n in units if n and not n.endswith(holder)}
    assert {n.rsplit("." + holder, 1)[0] for n in f32} <= blocks
    assert all(units[n] == "torch.bfloat16" for n in blocks | {""}), units


def test_layer_dim_leaves_hold_the_references_share_plus_padding(step_runs):
    """The case whose spec shards ``[4, 2]`` leaves on their layer dim:
    each rank holds at most the reference's 2 entries of each plus the
    padding of its layers' uneven split (4 layers x one entry), and the 4
    ranks hold each leaf once."""
    _, port = step_runs
    per_rank = port["mamba_layer_dim_fsdp"][4]
    for path in ("blocks/mixer/A_log", "blocks/mixer/D",
                 "blocks/mixer/dt_bias"):
        held = [r[path] for r in per_rank]
        assert max(held) <= 2 + 4 and sum(held) == 8, (path, held)


def test_replicated_bf16_gradients_follow_the_per_microbatch_formula(
        step_runs):
    """On 2 data ranks at microbatch 2, each bfloat16 parameter the data
    axes replicate gets the reference's gradient bit for bit: each
    microbatch's float32 parts summed over the ranks and rounded to
    bfloat16, the two accumulated in float32 and halved.  The rule before
    it (the parts summed over both microbatches and ranks, then rounded
    once) gives other bits on these batches."""
    _, port = step_runs
    for r, rep in enumerate(port["llama_bf16_mb2_22"][5]):
        assert rep["leaves"] > 0, (r, rep)
        assert rep["old_rule_differs"], (r, rep)
        assert rep["bit_equal"], (r, rep)


def test_fsdp_bf16_gradients_differ_from_the_formula_within_bf16_bounds(
        step_runs):
    """Under FSDP a sharded bfloat16 parameter's gradient is FSDP2's: each
    rank's bfloat16 gradients accumulated in float32 over the microbatches,
    reduce-scattered once a step and rounded to bfloat16, not the
    reference's per-microbatch rounding of the ranks' sum (ROADMAP.md
    Queue A): the difference is pinned, nonzero and within the bfloat16
    leaf bound (5e-2 of the norm)."""
    _, port = step_runs
    for r, rep in enumerate(port["llama_bf16_fsdp_mb2"][5]):
        errs = rep["rel_err"]
        assert errs and 0 < max(errs.values()) <= 5e-2, (r, errs)


# ---------------------------------------------------------------------------
# (f) the launcher on 2 ranks
# ---------------------------------------------------------------------------

ARGV = ["--arch", "llama3_2_3b", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "8", "--seq", "32", "--mesh", "host"]


def test_launcher_on_two_ranks_gives_one_processs_losses(tmp_path,
                                                         monkeypatch):
    from repro_torch.launch import train as launch
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    real = launch.make_train_step
    losses = []

    def tapped(loss_fn, tc):
        step = real(loss_fn, tc)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run
    monkeypatch.setattr(launch, "make_train_step", tapped)
    assert launch.main(ARGV)["state"].step == 3
    out = td.spawn(td.launcher, 2, tmp_path, ARGV, timeout=120)
    for got, steps in out:
        assert steps == 3
        np.testing.assert_allclose(got, losses, rtol=1e-5)


def test_a_failing_rank_ends_the_world(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails at step 2"):
        td.spawn(td.launcher, 2, tmp_path, ARGV, 2, timeout=120, grace=10)
    assert time.monotonic() - t0 < 120
