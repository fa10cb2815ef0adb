"""Serving on the "model" mesh axis against the JAX package's sharded
serving.

- (a) Every LM family (``llama3_2_3b``, ``internvl2_2b``, ``mixtral_8x7b``
  with a capacity factor of 0.5 that drops tokens, ``mamba2_370m``,
  ``zamba2_2_7b``, ``whisper_base``) at its reduced config, float32
  compute, on the (1, 4) and the (2, 2) mesh of 4 gloo ranks: the
  reference's parameters in a module sharded for serving
  (``tensor_parallel.shard_for_serving``), each rank's rows of a seeded
  batch of 4 prompts of 8 tokens (whisper: and 32 seeded frames), a
  12-slot cache, greedy decode for 3 steps.  The reference runs
  ``prefill`` and ``decode_step`` under ``jax.jit`` on 4 forced host
  devices with an Auto-axes ``Mesh`` of the same shape, its parameters,
  batch and cache placed by ``param_specs`` (``fsdp=False``),
  ``batch_specs`` and ``cache_specs``, fed the port's chosen tokens.  The
  two sides run one after the other.

  - Each rank's prefill and decode logits are within 1e-4 of the largest
    of the reference's logits for its rows.
  - Each rank's cache after the prefill and after the last step is its
    ``cache_specs`` slice of the reference's whole cache: ``pos`` bit-equal,
    every other leaf within 1e-4 of the slice's norm.
  - The greedy tokens equal the reference's argmax wherever its top two
    logits differ by more than that bound.

  The cases cover every branch of ``cache_specs``: the reduced llama's 2
  kv heads split by sequence on (1, 4) (flash-decoding across the model
  ranks) and by head on (2, 2); SSM states by head, conv states by
  channel; the hybrid's ``shared_kv`` and whisper's ``self`` / ``cross``
  by kv head.  Two more cases take the other layouts: whisper with 2 kv
  heads on (1, 4) (``self`` by sequence, ``cross`` by encoder position)
  and llama with an 11-slot cache on (1, 4) (neither splits: every rank
  holds the whole cache); and mamba with 2 groups of B / C and per-head
  ``A_log`` / ``D`` / ``dt_bias`` that differ (seeded noise on the init's
  constants) on (1, 4); mamba on (1, 4) widened so that no SSM projection
  splits, and with 2 heads (x's columns split, the heads do not; both with
  per-head noise).  ``mixtral_8x7b`` on (2, 2) routes each data rank's
  rows as one token group, as the reference's dispatch does (it differs
  from one device by design); with 3 rows, which 2 data ranks do not
  divide, every rank serves all of them (``sharding.row_shards(1)``),
  routed in the reference's 2 groups of the whole batch's tokens.
- (b) A model-sharded train state (``shard_train_step`` on (1, 4)) of the
  SSM, hybrid and enc-dec serves bit-equal to a module sharded for
  serving.
- (c) Without ranks: ``init_cache`` of a module on a model axis of 4 gives
  ``cache_specs``' local shapes (2 kv heads: split by sequence; 4: by
  head); an uneven data shard (``padded_part``) is zero-padded and its
  gather cut back to the whole.
- (d) Weight-gathered serving (``shard_for_serving(fsdp=True)``: the
  parameters also sharded over the data axes, each block gathered whole
  just before it runs): ``llama3_2_3b`` on (2, 2) and on (4, 1),
  ``mixtral_8x7b`` and ``mamba2_370m`` on (2, 2), ``zamba2_2_7b`` at 6
  layers (three applications of its shared block) and ``whisper_base``
  on (4, 1) (the meshes where the data axes spare the stacked leaves'
  layer dim), and ``zamba2_2_7b`` (4 layers) and ``whisper_base`` on
  (2, 2), where they shard it (each layer's parameter on a dim of its
  own), go through (a)'s checks against the reference's serving with
  ``param_specs(fsdp=True)``; each rank holds its
  ``param_specs(fsdp=True)`` share of the parameters; rank 0's gathers
  over the data axes in a decode step carry each data-sharded leaf's
  whole (model-local) bytes once a use (the tied embedding twice, the
  shared block once an application, the encoder never); and
  ``hlo_cost.analyze`` of rank 0's real
  prefill equals the dry run's trace of the same cell on a fake world of
  4 (``launch.cells.plan_cell`` + ``launch.dryrun.trace_plan``): flops,
  collective bytes and count.

Takes ~105 s alone on an 8-core CPU.  The ranks' side is
``tests/torch_dist.py`` (``serve_cases``; no JAX there).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist as td  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.models.hybrid import n_shared_applications  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ROWS, PROMPT, MAX_LEN, STEPS = 4, 8, 12, 3
TOL = 1e-4
FAMILIES = ["llama3_2_3b", "internvl2_2b", "mixtral_8x7b", "mamba2_370m",
            "zamba2_2_7b", "whisper_base"]
# the capacity factor mixtral_fsdp_mb2 trains with: it drops tokens
OVER = {"mixtral_8x7b": {"moe": {"capacity_factor": 0.5}}}
# name: (arch, mesh, config fields replaced, max_len)
CASES = {f"{a}_{m[0]}{m[1]}": (a, m, OVER.get(a, {}), MAX_LEN)
         for a in FAMILIES for m in ((1, 4), (2, 2))}
CASES["whisper_kv2_14"] = ("whisper_base", (1, 4), {"n_kv_heads": 2},
                           MAX_LEN)
CASES["llama_len11_14"] = ("llama3_2_3b", (1, 4), {}, 11)
# 2 groups of B / C (each rank's heads read their own) and per-head
# parameters that differ (``_per_head``)
CASES["mamba_groups2_14"] = ("mamba2_370m", (1, 4), {"ssm": {"n_groups": 2}},
                             MAX_LEN)
PER_HEAD = {"mamba_groups2_14"}
# weight-gathered serving (``shard_for_serving(fsdp=True)``)
CASES["llama_fsdp_22"] = ("llama3_2_3b", (2, 2), {}, MAX_LEN)
CASES["llama_fsdp_41"] = ("llama3_2_3b", (4, 1), {}, MAX_LEN)
CASES["mixtral_fsdp_22"] = ("mixtral_8x7b", (2, 2), OVER["mixtral_8x7b"],
                            MAX_LEN)
# the SSM, hybrid and enc-dec families where the data axes spare their
# stacked leaves' layer dim: 3 mamba layers on (2, 2), 6 zamba layers
# (three applications of the shared block) and whisper on (4, 1)
CASES["mamba_fsdp_22"] = ("mamba2_370m", (2, 2), {}, MAX_LEN)
CASES["zamba_fsdp_41"] = ("zamba2_2_7b", (4, 1), {"n_layers": 6}, MAX_LEN)
CASES["whisper_fsdp_41"] = ("whisper_base", (4, 1), {}, MAX_LEN)
# ... and where they shard it: each layer's parameter then on a dim of
# its own (4 zamba layers, whisper's 2 a stack, on 2 data ranks)
CASES["zamba_fsdp_22"] = ("zamba2_2_7b", (2, 2), {}, MAX_LEN)
CASES["whisper_fsdp_22"] = ("whisper_base", (2, 2), {}, MAX_LEN)
FSDP = ("llama_fsdp_22", "llama_fsdp_41", "mixtral_fsdp_22",
        "mamba_fsdp_22", "zamba_fsdp_41", "whisper_fsdp_41",
        "zamba_fsdp_22", "whisper_fsdp_22")
# the SSM where the model axis of 4 splits no projection (d_inner 390 in
# 13 heads of 30, 18 state entries), or x's columns but not its 2 heads
CASES["mamba_whole_14"] = ("mamba2_370m", (1, 4), {"d_model": 130, "ssm": {
    "expand": 3, "head_dim": 30, "d_state": 18}}, MAX_LEN)
CASES["mamba_x_split_14"] = ("mamba2_370m", (1, 4), {"ssm": {"head_dim": 128}},
                             MAX_LEN)
PER_HEAD |= {"mamba_whole_14", "mamba_x_split_14"}
# 3 rows on 2 data ranks: each holds the whole batch (``batch_specs``
# replicates it), whose 24 prompt tokens route as the reference's 2 token
# groups of 12 (a capacity that binds)
CASES["mixtral_rows3_22"] = ("mixtral_8x7b", (2, 2), OVER["mixtral_8x7b"],
                             MAX_LEN)
CASE_ROWS = {"mixtral_rows3_22": 3}
# the families whose serving on a model axis was refused before
TRAINED = ("mamba2_370m", "zamba2_2_7b", "whisper_base")

_REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import registry as rreg
from repro.distributed import sharding as shd
from repro.models import api

inputs = pickle.load(open(sys.argv[1], "rb"))
tree_map = jax.tree_util.tree_map
out = {}
for name, case in inputs.items():
    mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                ("data", "model"))
    shd.set_active_mesh(mesh)
    cfg = dataclasses.replace(rreg.get_reduced(case["arch"]),
                              compute_dtype="float32")
    over = dict(case["over"])
    for sub in ("moe", "ssm"):
        if sub in over:
            over[sub] = dataclasses.replace(getattr(cfg, sub), **over[sub])
    cfg = dataclasses.replace(cfg, **over)
    model = api.build_model(cfg)
    placed = lambda specs: tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    params = tree_map(jnp.asarray, case["params"])
    p_sh = placed(shd.param_specs(params, mesh, fsdp=case["fsdp"],
                                  n_experts=cfg.moe.n_experts if cfg.moe
                                  else 0))
    b_sh = placed(shd.batch_specs(case["batch"], mesh))
    max_len = case["max_len"]
    pre = lambda p, b: model.prefill(p, b, max_len)
    c_sh = placed(shd.cache_specs(
        jax.eval_shape(pre, params, case["batch"])[1], mesh))
    prefill = jax.jit(pre, in_shardings=(p_sh, b_sh),
                      out_shardings=(None, c_sh))
    step = jax.jit(model.decode_step,
                   in_shardings=(p_sh, c_sh, b_sh["tokens"], None),
                   out_shardings=(None, c_sh))
    S = case["batch"]["tokens"].shape[1]
    with mesh:
        params = jax.device_put(params, p_sh)
        lg, cache = prefill(params, case["batch"])
        logits = [np.asarray(lg[:, -1])]
        caches = [tree_map(np.asarray, cache)]
        for i in range(case["forced"].shape[1]):
            lg, cache = step(params, cache, case["forced"][:, i:i + 1],
                             jnp.int32(S + i))
            logits.append(np.asarray(lg[:, -1]))
        caches.append(tree_map(np.asarray, cache))
    out[name] = {"logits": logits, "caches": caches}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _ref_cfg(arch, over):
    cfg = dataclasses.replace(rreg.get_reduced(arch), compute_dtype="float32")
    over = dict(over)
    for sub in ("moe", "ssm"):
        if sub in over:
            over[sub] = dataclasses.replace(getattr(cfg, sub), **over[sub])
    return dataclasses.replace(cfg, **over)


def _per_head(params, seed: int):
    """``params`` with seeded noise on the SSM's per-head ``A_log``, ``D``
    and ``dt_bias`` (the init makes them the same for every head, so a
    rank reading another rank's heads would go unseen)."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        key = getattr(path[-1], "key", None)
        if key in ("A_log", "D", "dt_bias"):
            return x + rng.normal(0, 0.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(one, params)


def _batch(cfg, rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(rows, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32)
    return out


def _inputs() -> dict:
    cases = {}
    for i, (name, (arch, mesh, over, max_len)) in enumerate(CASES.items()):
        cfg = _ref_cfg(arch, over)
        params = rapi.build_model(cfg).init(jax.random.key(1))
        if name in PER_HEAD:
            params = _per_head(params, 70 + i)
        cases[name] = {"arch": arch, "mesh": mesh, "over": over,
                       "max_len": max_len, "steps": STEPS,
                       "fsdp": name in FSDP,
                       "params": jax.tree_util.tree_map(np.asarray, params),
                       "batch": _batch(cfg, CASE_ROWS.get(name, ROWS),
                                       60 + i)}
    trained = {a: _batch(_ref_cfg(a, {}), 2, 90) for a in TRAINED}
    return {"cases": cases, "trained": trained}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, then the reference fed the port's greedy tokens
    (one after the other, never side by side)."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    inputs = _inputs()
    td.save(inputs, tmp / "inputs.pkl")
    port = td.spawn(td.serve_cases, WORLD, tmp, str(tmp / "inputs.pkl"),
                    timeout=400)
    ref_in = {}
    for name, case in inputs["cases"].items():
        forced = np.zeros((CASE_ROWS.get(name, ROWS), STEPS), np.int32)
        for out in port:
            first, n = out[name]["rows"]
            forced[first:first + n] = out[name]["tokens"]
        ref_in[name] = dict(case, forced=forced)
    td.save(ref_in, tmp / "ref_in.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "ref_in.pkl"), str(tmp / "ref.pkl")],
        env=env, capture_output=True, text=True, timeout=400)
    assert ref.returncode == 0, ref.stderr[-3000:]
    return {"port": port, "ref": td.load(tmp / "ref.pkl"), "inputs": inputs}


# ---------------------------------------------------------------------------
# (a) against the reference's sharded serving
# ---------------------------------------------------------------------------

def _logit_errors(runs, name):
    """Per rank and step: ``(max |port - reference|, the reference's
    largest |logit|)`` over the rank's rows."""
    ref = runs["ref"][name]["logits"]
    out = []
    for r, port in enumerate(runs["port"]):
        first, n = port[name]["rows"]
        for i, (got, want) in enumerate(zip(port[name]["logits"], ref)):
            want = want[first:first + n]
            out.append((r, i, float(np.abs(got - want).max()),
                        float(np.abs(want).max())))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_the_references_sharded_serving(runs, name):
    bad = [f"rank {r} step {i}: {err:.3e} > {TOL} x {scale:.3e}"
           for r, i, err, scale in _logit_errors(runs, name)
           if not err <= TOL * scale]
    assert not bad, "; ".join(bad)


def _cache_slice(whole, spec, sizes: dict, coords: dict):
    """The part of ``whole`` that ``spec`` assigns to the device at
    ``coords`` (``{axis: index}``)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in names:
            n = whole.shape[d] // sizes[a]
            whole = np.take(whole, range(coords[a] * n,
                                         (coords[a] + 1) * n), axis=d)
    return whole


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_cache_is_its_cache_specs_slice(runs, name):
    arch, mesh, _, _ = CASES[name]
    sizes = dict(zip(("data", "model"), mesh))
    bad = []
    for which in (0, 1):  # after the prefill, after the last step
        whole = runs["ref"][name]["caches"][which]
        specs = dict(_leaves(shd.cache_specs(whole, sizes)))
        for r, port in enumerate(runs["port"]):
            coords = {"data": r // mesh[1], "model": r % mesh[1]}
            got = dict(_leaves(port[name]["caches"][which]))
            for path, full in _leaves(whole):
                want = _cache_slice(full, specs[path], sizes, coords)
                mine = got[path]
                if mine.shape != want.shape or mine.dtype != want.dtype:
                    bad.append(f"{path} rank {r}: {mine.shape} {mine.dtype}"
                               f" vs {want.shape} {want.dtype}")
                elif np.issubdtype(want.dtype, np.integer):
                    if not np.array_equal(mine, want):
                        bad.append(f"{path} rank {r}: positions differ")
                else:
                    err = np.linalg.norm(mine - want)
                    if not err <= TOL * np.linalg.norm(want):
                        bad.append(f"{path} rank {r} ({which}): {err:.3e}")
    assert not bad, "; ".join(bad)


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_match_where_the_top_two_differ(runs, name):
    ref = runs["ref"][name]["logits"]
    checked = 0
    for r, port in enumerate(runs["port"]):
        first, n = port[name]["rows"]
        for i in range(STEPS):  # the token fed to step i came from i's logits
            want = ref[i][first:first + n]
            top2 = np.sort(want, -1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > TOL * np.abs(want).max()
            got = port[name]["tokens"][:, i]
            assert np.array_equal(got[sure], want.argmax(-1)[sure]), (r, i)
            checked += int(sure.sum())
    assert checked > 0


def test_sequence_split_cases_split_by_sequence(runs):
    """The (1, 4) llama cache is split by sequence, whisper_kv2's cross
    cache by encoder position, and llama_len11's whole on every rank."""
    port = runs["port"][0]
    assert port["llama3_2_3b_14"]["caches"][0]["blocks"]["k"].shape == \
        (2, ROWS, MAX_LEN // 4, 2, 32)
    assert port["whisper_kv2_14"]["caches"][0]["cross"]["k"].shape[2] == \
        _ref_cfg("whisper_base", {}).enc_seq // 4
    assert port["llama_len11_14"]["caches"][0]["blocks"]["k"].shape == \
        (2, ROWS, 11, 2, 32)


# ---------------------------------------------------------------------------
# (b) a model-sharded train state serves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRAINED)
def test_a_model_sharded_train_state_serves(runs, arch):
    for r, port in enumerate(runs["port"]):
        (tl, tt, tc), (sl, st, sc) = port["trained"][arch]
        assert all(np.isfinite(x).all() for x in tl), r
        for a, b in zip(tl, sl):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
        np.testing.assert_array_equal(tt, st)
        for (pa, a), (pb, b) in zip(_leaves(tc[1]), _leaves(sc[1])):
            assert pa == pb
            np.testing.assert_array_equal(a, b, err_msg=f"{pa} rank {r}")


# ---------------------------------------------------------------------------
# (c) no ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 3, 4])
def test_an_uneven_data_shard_is_padded_and_its_gather_drops_the_pad(size):
    """``padded_part``: the ranks' slices of a dim of 5 over ``size``
    ranks are zero-padded to equal lengths, lie in rank order, and
    concatenated (the gather) then cut to 5 (``gathered``) give the
    whole back."""
    from repro_torch.distributed import tensor_parallel as tp
    x = torch.arange(15, dtype=torch.float32).reshape(3, 5) + 1
    parts = [tp.padded_part(x, 1, tp.ModelAxis(None, r, size))
             for r in range(size)]
    n = -(-5 // size)
    assert all(p.shape == (3, n) for p in parts)
    whole = torch.cat(parts, 1)
    assert torch.equal(whole.narrow(1, 0, 5), x)
    assert not whole[:, 5:].any()


@pytest.mark.parametrize("kv", [2, 4])
def test_init_cache_on_a_model_axis_of_4(kv):
    from repro_torch.models import transformer
    cfg = dataclasses.replace(td.lm_cfg("llama3_2_3b"), n_kv_heads=kv)
    ax = tp.ModelAxis(None, 1, 4)
    cache = transformer.init_cache(cfg, 2, 12, device="cpu", ax=ax)["blocks"]
    # 2 kv heads do not split 4 ways: the sequence does
    want = (2, 2, 3, 2, 32) if kv == 2 else (2, 2, 12, 1, 32)
    assert tuple(cache["k"].shape) == tuple(cache["v"].shape) == want
    assert tuple(cache["pos"].shape) == (2, 12)
    assert (cache["pos"] == -1).all() and not cache["k"].any()
    whole = {"blocks": {k: (2, 2, 12, kv, 32) for k in ("k", "v")}}
    spec = shd.cache_specs(whole, {"model": 4})["blocks"]["k"]
    assert spec == rshd.cache_specs(
        jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                               whole, is_leaf=lambda x: isinstance(x, tuple)),
        jax.sharding.AbstractMesh((4,), ("model",)))["blocks"]["k"]


# ---------------------------------------------------------------------------
# (d) weight-gathered serving
# ---------------------------------------------------------------------------

def _ref_leaves(name, fsdp: bool, axes=("data", "model")) -> list:
    """``[(path, spec, shape, itemsize)]`` of the case's reference
    parameters placed by ``param_specs(fsdp=fsdp)`` on an abstract mesh of
    the case's shape."""
    arch, mesh, over, _ = CASES[name]
    cfg = _ref_cfg(arch, over)
    params = jax.eval_shape(lambda: rapi.build_model(cfg).init(
        jax.random.key(1)))
    specs = rshd.param_specs(params, jax.sharding.AbstractMesh(mesh, axes),
                             fsdp=fsdp,
                             n_experts=cfg.moe.n_experts if cfg.moe else 0)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [("/".join(k.key for k in path), spec, leaf.shape,
             leaf.dtype.itemsize)
            for (path, leaf), spec in zip(flat, spec_leaves)]


def _share(shape, spec, sizes: dict, axes) -> int:
    """Elements of ``shape`` a device holds, ``spec``'s dims divided by
    the sizes of its axes among ``axes``."""
    n = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in axes:
                n[d] //= sizes[a]
    return int(np.prod(n))


@pytest.mark.parametrize("name", FSDP)
def test_weight_gathered_ranks_hold_their_param_specs_share(runs, name):
    mesh = CASES[name][1]
    sizes = dict(zip(("data", "model"), mesh))
    want = sum(_share(shape, spec, sizes, ("data", "model")) * size
               for _, spec, shape, size in _ref_leaves(name, True))
    whole = sum(int(np.prod(shape)) * size
                for _, _, shape, size in _ref_leaves(name, False))
    assert want < whole / mesh[1]  # the data axes cut something
    for r, port in enumerate(runs["port"]):
        assert port[name]["param_bytes"] == want, r


def _gathers_a_decode_step(path: str, cfg) -> int:
    """How many times a decode step gathers the leaf at ``path``: the
    tied embedding twice (the lookup and the head), the hybrid's shared
    block once an application, the enc-dec's encoder never (prefill
    leaves its output in the cross cache), every other leaf once."""
    if path == "embed" and cfg.tie_embeddings:
        return 2
    if path.startswith("shared_attn/"):
        return n_shared_applications(cfg)
    return 0 if path.startswith(("enc_blocks/", "enc_norm/")) else 1


@pytest.mark.parametrize("name", FSDP)
def test_a_decode_step_gathers_each_data_shard_once(runs, name):
    """Each data-sharded leaf's whole (model-local) bytes as many times as
    a decode step runs it (``_gathers_a_decode_step``)."""
    arch, mesh, over, _ = CASES[name]
    sizes = dict(zip(("data", "model"), mesh))
    cfg = _ref_cfg(arch, over)
    want = 0
    for path, spec, shape, size in _ref_leaves(name, True):
        if shd.data_dim(spec) is None:
            continue
        leaf = _share(shape, spec, sizes, ("model",)) * size
        want += leaf * _gathers_a_decode_step(path, cfg)
    assert want > 0
    assert runs["port"][0][name]["analyzed"]["gathered_a_step"] == want


@pytest.mark.parametrize("name", FSDP)
def test_the_real_prefill_counts_as_its_fake_trace(runs, name):
    """``hlo_cost.analyze`` of rank 0's prefill (its rows, a cache of the
    prompt's length) against the dry run's trace of the same cell."""
    arch, mesh, over, _ = CASES[name]
    real = runs["port"][0][name]["analyzed"]
    rows = ROWS // mesh[0]
    shape = ShapeCfg("serve_fsdp", PROMPT, ROWS, "prefill")
    with dryrun.fake_world(mesh, "cpu") as m:
        plan = cells.plan_cell(arch, shape, m, cfg=td.tp_cfg(arch, over),
                               serve_fsdp=True)
        traced = dryrun.trace_plan(plan)
    assert not torch.distributed.is_initialized()
    cfg = td.tp_cfg(arch, over)
    frames = rows * cfg.enc_seq * cfg.d_model * 4 \
        if cfg.family == "encdec" else 0
    assert traced["memory"]["batch_bytes"] == 2 * rows * PROMPT * 4 + frames
    assert traced["cost"]["flops"] == real["flops"] > 0
    coll = traced["collectives"]
    assert coll["collective_bytes"] == real["collective_bytes"] > 0
    assert coll["n_collectives"] == real["n_collectives"]
