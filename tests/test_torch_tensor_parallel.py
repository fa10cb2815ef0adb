"""The "model" mesh axis of the port against the JAX package's.

- (a) 3 train steps on 4 gloo ranks against the reference's
  ``jit_train_step`` on 4 host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``, an Auto-axes
  ``jax.sharding.Mesh`` of the same ``(data, model)`` shape), float32
  compute, within the data-parallel bounds: loss rtol 1e-5, grad norm rtol
  1e-4, each parameter leaf within 1e-4 of its norm.  Cases: tensor
  parallelism with FSDP (2, 2) and without (1, 4); sequence parallelism
  with Adafactor (llama3_405b); expert parallelism (mixtral, kimi_k2 with
  its shared expert and leading dense layer); experts split within
  (``"model_in_expert"``: 6 experts on 4); q not head-aligned (6 heads on
  4); the VLM's prefix; DLRM's row-sharded tables on (2, 2) with and
  without FSDP and on (1, 4).
- (b) each rank's local shape of every leaf equals the reference spec's
  shard, on those meshes and (from the rule alone) at ``{"data": 16,
  "model": 16}``.
- (c) checkpoints across mesh shapes: a (2, 2) save restored onto (1, 4)
  and onto one process, a reference file onto (2, 2), and that world's
  save read back by the reference, bit-equal; ``params_from_jax`` into a
  model-sharded FSDP state.
- (d) the model ranks of one data coordinate receive the same rows;
  ``launch.train --mesh pod`` on 4 ranks raises the mesh's error naming
  256 ranks, for the SSM too.

The SSM, hybrid and enc-dec families and DLRM's lookahead path on the
model axis are ``tests/test_torch_tensor_parallel_families.py``; serving
on it, ``tests/test_torch_serve_model_axis.py``.

The ranks' side is ``tests/torch_dist.py`` (no JAX there).
"""

import dataclasses
import json
import math
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
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import dlrm as rdlrm  # noqa: E402
from repro.training import checkpoint as rckpt  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import lm_token_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
STEPS, SEQ, ROWS = 3, 16, 8

# name: (arch, mesh, TrainConfig kwargs, config fields replaced)
CASES = {
    "llama_tp22_fsdp": ("llama3_2_3b", (2, 2),
                        dict(fsdp=True, microbatch=2), {}),
    "llama_tp14": ("llama3_2_3b", (1, 4), {}, {}),
    # the preset's seq_parallel, Adafactor and FSDP
    "llama405b_sp22": ("llama3_405b", (2, 2), dict(
        fsdp=True, optimizer="adafactor", microbatch=2), {}),
    "mixtral_ep22_fsdp": ("mixtral_8x7b", (2, 2),
                          dict(fsdp=True, microbatch=2), {}),
    # 6 experts on a model axis of 4: each expert's d_ff is split
    "mixtral_mie14": ("mixtral_8x7b", (1, 4), {}, {"moe": {"n_experts": 6}}),
    # a shared expert and a leading dense layer
    "kimi_ep22_fsdp": ("kimi_k2", (2, 2), dict(fsdp=True), {}),
    # 6 q heads on 4 ranks (48 columns a rank), 2 kv heads
    "llama_tp4_odd_heads": ("llama3_2_3b", (1, 4), {},
                            dict(n_heads=6, n_kv_heads=2, head_dim=32)),
    # patch embeddings before the text
    "internvl_tp22": ("internvl2_2b", (2, 2), {}, {}),
    "dlrm_22": ("dlrm", (2, 2), {}, {}),
    "dlrm_22_fsdp": ("dlrm", (2, 2), dict(fsdp=True), {}),
    "dlrm_14": ("dlrm", (1, 4), {}, {}),
}
CKPT_CASE = "llama_tp22_fsdp"

_REFERENCE = """
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import registry as rreg
from repro.configs.base import TrainConfig
from repro.distributed import sharding as shd
from repro.models import api, dlrm
from repro.training import train_loop as tl

inputs = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, case in inputs["cases"].items():
    mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                ("data", "model"))
    shd.set_active_mesh(mesh)
    tc = TrainConfig(**case["tcfg"])
    n_exp = 0
    if case["arch"] == "dlrm":
        cfg = dlrm.DLRMConfig(**case["dlrm"])
        loss = lambda p, b, cfg=cfg: dlrm.loss_fn(p, b, cfg)
    else:
        cfg = dataclasses.replace(rreg.get_reduced(case["arch"]),
                                  compute_dtype="float32")
        over = dict(case["over"])
        if "moe" in over:
            over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
        cfg = dataclasses.replace(cfg, **over)
        loss = api.build_model(cfg).loss
        n_exp = cfg.moe.n_experts if cfg.moe else 0
    params = jax.tree_util.tree_map(jax.numpy.asarray, case["params"])
    state = tl.TrainState.create(params, tc)
    b0 = case["batches"][0]
    step, _ = tl.jit_train_step(
        tl.make_train_step(loss, tc), mesh, jax.eval_shape(lambda: state),
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b0.items()},
        fsdp=tc.fsdp, n_experts=n_exp)
    losses, norms = [], []
    with mesh:
        for b in case["batches"]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.params)]
    out[name] = (losses, norms, leaves)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _ref_cfg(arch, over):
    cfg = dataclasses.replace(rreg.get_reduced(arch), compute_dtype="float32")
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


def _inputs() -> dict:
    cases = {}
    for i, (name, (arch, mesh, kw, over)) in enumerate(CASES.items()):
        case = {"arch": arch, "mesh": mesh, "over": over,
                "tcfg": dict(kw, lr=3e-3), "dlrm": td.DLRM_SMALL}
        if arch == "dlrm":
            cfg = rdlrm.DLRMConfig(**td.DLRM_SMALL)
            params = rdlrm.init(jax.random.key(1), cfg)
            case["batches"] = [td.dlrm_batch(ROWS, 30 + s)
                               for s in range(STEPS)]
        else:
            cfg = _ref_cfg(arch, over)
            params = rapi.build_model(cfg).init(jax.random.key(1))
            case["batches"] = [td.lm_batch(cfg.vocab_size, ROWS, SEQ,
                                           30 + s) for s in range(STEPS)]
            if cfg.family == "vlm":
                rng = np.random.default_rng(50 + i)
                for b in case["batches"]:
                    b["patch_embeds"] = rng.normal(size=(
                        ROWS, cfg.n_patches, cfg.d_model)).astype(np.float32)
        case["params"] = jax.tree_util.tree_map(np.asarray, params)
        cases[name] = case
    return {"cases": cases, "ckpt": CKPT_CASE}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case side by side, then the rank-side checks
    that read the checkpoint the (2, 2) case saved."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    td.save(inputs, tmp / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = td.spawn(td.tp_cases, WORLD, tmp, str(tmp / "inputs.pkl"),
                        str(tmp / "port_ckpt"), timeout=400)
        _, err = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    # a reference checkpoint for (c)
    rcfg = _ref_cfg("llama3_2_3b", {})
    rstate = rtl.TrainState.create(
        rapi.build_model(rcfg).init(jax.random.key(11)),
        RTrainConfig(fsdp=True))
    rstate = dataclasses.replace(rstate, step=np.int32(9))
    rckpt.save(rstate, str(tmp / "ref_ckpt"), 9)
    paths = {"port_ckpt": str(tmp / "port_ckpt"),
             "ref_ckpt": str(tmp / "ref_ckpt"),
             "saved_ckpt": str(tmp / "saved_ckpt"),
             "tcfg": inputs["cases"][CKPT_CASE]["tcfg"],
             "ref_params": jax.tree_util.tree_map(np.asarray, rstate.params),
             "etl": {"batch": 8, "seq": 16, "vocab": 512}}
    misc = td.spawn(td.tp_misc, WORLD, tmp, paths, timeout=300)
    return {"ref": td.load(tmp / "ref.pkl"), "port": port, "misc": misc,
            "paths": paths, "rstate": rstate, "inputs": inputs}


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


def test_sequence_parallel_entries_reduce_scatter_their_backward(runs):
    """``llama405b_sp22``'s model-axis traffic each step equals the count
    its shapes give (every collective moves a whole-sequence activation
    ``W = b S D`` float32 values, ``b`` a microbatch's rows a data rank,
    except the norms' weight gradients and the loss' statistics).  Per
    microbatch, with L blocks and ``E = 2 L + 1`` sequence-sharded entries
    (each block's attention and MLP, the head):

    - reduce-scatters: each entry's backward once (``tp.enter``), each
      block's two outputs, and the attention's again where remat
      recomputes the block (the recompute stops at the MLP's last saved
      input, before its output);
    - all-gathers: each entry's forward, the block's two again under
      remat, the two outputs' backward, the residual's scatter backward;
    - all-reduces: the embedding's vocabulary-parallel sum (the only one
      of ``W`` bytes: no entry's backward all-reduces the sequence), the
      2 L + 1 norms' weights (``D``) and the loss' three statistics
      (``b S`` each)."""
    arch, mesh, tcfg, _ = CASES["llama405b_sp22"]
    cfg = rreg.get_reduced(arch)
    n = tcfg["microbatch"]
    layers, d = cfg.n_layers, cfg.d_model
    b = ROWS // mesh[0] // n
    w = b * SEQ * d * 4
    entries = 2 * layers + 1
    want = {"reduce_scatter": entries + 2 * layers + layers,
            "all_gather": entries + 2 * layers + 2 * layers + 1,
            "all_reduce": 1 + entries + 3}
    bytes_ = {"reduce_scatter": want["reduce_scatter"] * w,
              "all_gather": want["all_gather"] * w,
              "all_reduce": w + entries * d * 4 + 3 * b * SEQ * 4}
    for r in range(WORLD):
        for step in runs["port"][r]["llama405b_sp22"][4]["traffic"]:
            got = {k: step[k] for k in want}
            assert got == {k: [n * bytes_[k], n * want[k]] for k in want}, \
                (r, got)


# ---------------------------------------------------------------------------
# (b) local shapes against the reference's specs
# ---------------------------------------------------------------------------

def _ref_specs(arch, over, sizes: dict, fsdp: bool,
               published: bool = False) -> tuple:
    """``(AbstractMesh of sizes, [(path, shape struct, spec)])`` of the
    reference's ``param_specs`` (``published``: the arch's published
    config, else its reduced one)."""
    if arch == "dlrm":
        cfg = rdlrm.DLRMConfig(**td.DLRM_SMALL)
        shapes = jax.eval_shape(lambda: rdlrm.init(jax.random.key(0), cfg))
        n_exp = 0
    else:
        cfg = rreg.get_config(arch) if published else _ref_cfg(arch, over)
        shapes = jax.eval_shape(
            lambda: rapi.build_model(cfg).init(jax.random.key(0)))
        n_exp = cfg.moe.n_experts if cfg.moe else 0
    am = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    specs = rshd.param_specs(shapes, am, fsdp=fsdp, n_experts=n_exp)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return am, [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in p), x, s)
                for (p, x), s in zip(flat, spec_leaves)]


def _ref_shard_shapes(arch, over, sizes: dict, fsdp: bool,
                      published: bool = False) -> dict:
    """``{path: shard shape}`` of the reference's ``param_specs`` on an
    ``AbstractMesh`` of ``sizes``."""
    am, leaves = _ref_specs(arch, over, sizes, fsdp, published)
    return {path: NamedSharding(am, s).shard_shape(x.shape)
            for path, x, s in leaves}


def _ref_data_dims(arch, sizes: dict, fsdp: bool) -> dict:
    """``{path: the dim the reference shards over "data", or None}`` at
    the arch's published config."""
    _, leaves = _ref_specs(arch, {}, sizes, fsdp, published=True)
    return {path: next((d for d, e in enumerate(s) if e == "data"), None)
            for path, _, s in leaves}


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_leaves_are_the_reference_specs_shards(runs, name):
    arch, mesh, kw, over = CASES[name]
    want = _ref_shard_shapes(arch, over, dict(zip(("data", "model"), mesh)),
                             kw.get("fsdp", False))
    for r in range(WORLD):
        got = runs["port"][r][name][3]
        assert got == want, r
    # a parameter whose spec names "model" is held whole on no rank
    whole = _ref_shard_shapes(arch, over, {"data": 1, "model": 1}, False)
    split = [k for k in want if want[k] != whole[k]]
    assert split


# the SSM, hybrid and enc-dec at their published configs (built on the meta
# device), the others reduced
PUBLISHED = ("mamba2_370m", "zamba2_2_7b", "whisper_base")


def _published_on_meta(arch, monkeypatch):
    """``arch``'s published config, built on the meta device (its
    initialisers draw from a CPU generator: meta has none)."""
    from repro_torch.configs import registry as treg
    real = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: real(
        device="cpu") if str(device) == "meta" else real(device=device))
    cfg = treg.get_config(arch)
    return cfg, api.build_model(cfg).init(device="meta")


@pytest.mark.parametrize("arch", ["llama3_2_3b", "llama3_405b",
                                  "mixtral_8x7b", "kimi_k2", "internvl2_2b",
                                  "dlrm", *PUBLISHED])
@pytest.mark.parametrize("fsdp", [False, True])
def test_local_shapes_at_the_production_sizes(arch, fsdp, monkeypatch):
    """Each leaf's local shape is the reference spec's shard; where FSDP
    shards a stacked leaf's layer dim (``mamba2_370m`` at data 16:
    ``blocks/mixer/A_log`` ``[48, 32]``), each layer's parameter is
    sharded on a dim of its own, and a rank holds the reference's
    elements of the leaf (plus the padding of an uneven split, none
    here)."""
    sizes = {"data": 16, "model": 16}
    want = _ref_shard_shapes(arch, {}, sizes, fsdp,
                             published=arch in PUBLISHED)
    layer_dim = set()
    if arch == "dlrm":
        from repro_torch.models import dlrm
        model = dlrm.DLRM(dlrm.DLRMConfig(**td.DLRM_SMALL), device="cpu")
        n_exp = 0
    elif arch in PUBLISHED:
        cfg, model = _published_on_meta(arch, monkeypatch)
        n_exp = 0
        layer_dim = {k for k, v in _ref_data_dims(arch, sizes, fsdp).items()
                     if v == 0 and k.startswith(("blocks", "enc_blocks",
                                                 "dec_blocks"))}
        assert bool(layer_dim) == (fsdp and arch == "mamba2_370m"), \
            layer_dim
    else:
        cfg = td.lm_cfg(arch)
        model = api.build_model(cfg).init(device="cpu")
        n_exp = cfg.moe.n_experts if cfg.moe else 0
    dims = ttl._shard_dims(model, sizes, fsdp=fsdp, n_experts=n_exp)
    names = {id(p): n for n, p in model.named_parameters()}
    got, slot = {}, {}
    for path, ts, tr in td.jax_order(model):
        md, dd = dims[names[id(ts[0])]]
        shape = list(ts[0].shape)
        for d, n in ((md, sizes["model"]), (dd, sizes["data"])):
            if d is not None:
                shape[d] = -(-shape[d] // n)  # padded where it is uneven
        if path in layer_dim:  # one entry of the split dim, every layer
            slot[path] = len(ts) * math.prod(shape) // shape[dd]
        shape = shape[::-1] if tr else shape
        if td.stacked(model, path):
            shape = [len(ts)] + shape
        got[path] = tuple(shape)
    padded = set()
    for path in layer_dim:
        held, ref = math.prod(got.pop(path)), math.prod(want.pop(path))
        assert ref <= held < ref + slot[path], (path, held, ref)
        padded |= {path} if held > ref else set()
    if layer_dim:  # [48, 32]: 2 of each layer's 32 a rank, as the reference
        assert "blocks/mixer/A_log" in layer_dim - padded, padded
    assert got == want


# ---------------------------------------------------------------------------
# (c) checkpoints across mesh shapes
# ---------------------------------------------------------------------------

def _manifest_arrays(d: str, step: int) -> list:
    root = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as fh:
        index = json.load(fh)["index"]
    return [np.load(os.path.join(root, e["file"])) for e in index]


def _check_local(arrays, ranks_leaves, mesh):
    dp, mp = mesh
    for i, full in enumerate(arrays[:-1]):  # the step is the last leaf
        for r, leaves in enumerate(ranks_leaves):
            got, md, dd = leaves[i]
            want = full
            if md is not None:
                want = np.split(want, mp, md)[r % mp]
            if dd is not None:
                want = np.split(want, dp, dd)[r // mp]
            np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")


def test_a_22_checkpoint_holds_the_runs_whole_leaves(runs):
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    leaves = runs["port"][0][CKPT_CASE][2]
    for got, want in zip(arrays, leaves):  # the parameters come first
        np.testing.assert_array_equal(got, want)


def test_a_22_checkpoint_restores_onto_14(runs):
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    out = [m["port_22_to_14"] for m in runs["misc"]]
    assert [s for s, _ in out] == [STEPS] * WORLD
    _check_local(arrays, [leaves for _, leaves in out], (1, 4))
    assert any(md is not None for _, md, _ in out[0][1])


def test_a_22_checkpoint_restores_onto_one_process(runs):
    cfg = td.lm_cfg("llama3_2_3b")
    model = api.build_model(cfg)
    tc = TrainConfig(**runs["paths"]["tcfg"])
    state = ttl.TrainState.create(model.init(seed=7, device="cpu"), tc)
    state = ckpt.restore(runs["paths"]["port_ckpt"], state)
    assert state.step == STEPS
    from repro_torch.models.transformer import state_to_jax_leaves
    arrays = _manifest_arrays(runs["paths"]["port_ckpt"], STEPS)
    for got, want in zip(state_to_jax_leaves(state)[:-1], arrays):
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_fills_a_model_sharded_state(runs):
    want = jax.tree_util.tree_leaves(runs["rstate"].params)
    for m in runs["misc"]:
        got = m["params_from_jax_14"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_a_reference_checkpoint_restores_onto_22(runs):
    arrays = _manifest_arrays(runs["paths"]["ref_ckpt"], 9)
    out = [m["ref_to_22"] for m in runs["misc"]]
    assert [s for s, _ in out] == [9] * WORLD
    _check_local(arrays, [leaves for _, leaves in out], (2, 2))
    assert any(md is not None and dd is not None
               for _, md, dd in out[0][1])


def test_the_reference_reads_a_22_save(runs):
    got = rckpt.restore(runs["paths"]["saved_ckpt"], runs["rstate"], step=9)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(runs["rstate"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# (d) rows, the production mesh
# ---------------------------------------------------------------------------

def test_model_ranks_of_one_data_coordinate_receive_the_same_rows(runs):
    e = runs["paths"]["etl"]
    job = EtlJob(lm_token_pipeline(e["seq"], e["vocab"],
                                   batch_size=e["batch"]),
                 Source.lm_events(e["seq"], rows=e["batch"] * 3,
                                  batch_size=e["batch"]),
                 backend="torch", device="cpu")
    with job.batches() as batches:
        want = [{k: v.numpy() for k, v in b.items()} for b in batches]
    per = e["batch"] // 2
    for r, m in enumerate(runs["misc"]):
        d = r // 2  # rank r is (r // 2, r % 2) of the (2, 2) mesh
        assert len(m["etl"]) == len(want) == 3
        for g, w in zip(m["etl"], want):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(g[k],
                                              w[k][d * per:(d + 1) * per])


def test_launcher_pod_mesh_on_four_ranks_raises(runs):
    for m in runs["misc"]:
        msg = m["pod_llama3_2_3b"]
        assert "256" in msg and "the world has 4" in msg


def test_launcher_pod_mesh_raises_for_the_ssm_too(runs):
    for m in runs["misc"]:
        msg = m["pod_mamba2_370m"]
        assert "256" in msg and "the world has 4" in msg
