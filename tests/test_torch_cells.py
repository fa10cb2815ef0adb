"""The cell tooling (``repro_torch.launch.cells``) against the JAX
package's cells, at production sizes, without devices.

The port's side builds each plan on one rank of a fake world
(``launch.dryrun.fake_world``: a fake default process group of 256 or 512
ranks, destroyed after each mesh) under the plan's ``FakeTensorMode``;
nothing is traced.  The reference's side is ``jax.eval_shape`` of its
model, train state and decode cache, placed by its ``param_specs`` /
``cache_specs`` on a ``jax.sharding.AbstractMesh`` of the same shape: a
leaf's bytes a device are its shape with each dim its spec names divided
by those axes' sizes.

1. ``iter_cells`` equals the reference's: arch, shape and skip reason.
2. For all 40 (arch, shape) pairs on 16 x 16, the plan's ``model_flops``
   and weight-gathered serving decision equal the reference's (its
   ``plan_cell`` computes both inline, ``launch/cells.py:79-118``: the
   test applies those lines to its config; the decision also shows in its
   serving specs, which name the data axes exactly where it is taken).
3. For every arch on 16 x 16 and 2 x 16 x 16, the rank's parameter bytes
   (train, with the preset's FSDP, and serve) and optimizer bytes (train,
   the preset's optimizer) equal the reference's bytes a device, leaf for
   leaf by JAX path, and in total.
4. For each decode cell, the rank's cache bytes equal the reference's.

Takes ~70 s alone on an 8-core CPU (the plans on both fake worlds).
"""

import math

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import ALL_SHAPES as R_SHAPES  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.launch import cells as rcells  # noqa: E402
from repro.launch.presets import train_preset as r_preset  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training.train_loop import TrainState as RState  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

MESHES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16)}
SHAPES = {s.name: s for s in ALL_SHAPES}


def _names(mesh_shape):
    return ("pod", "data", "model")[-len(mesh_shape):]


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in keys)


def _device_bytes(tree, specs, sizes: dict) -> dict:
    """``{path: bytes a device}`` of the abstract ``tree`` placed by
    ``specs``."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            shape[d] //= math.prod(sizes[a] for a in names)
        out[_path(path)] = math.prod(shape) * leaf.dtype.itemsize
    return out


def _names_data(specs, daxes) -> bool:
    """Whether any spec of ``specs`` shards a dim over a data axis."""
    for spec in jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            if any(a in daxes for a in names):
                return True
    return False


def _ref_serve_fsdp(cfg, sizes: dict) -> bool:
    """The reference's ``plan_cell`` lines 113-115 on its config."""
    msize = sizes.get("model", 1)
    pbytes = cfg.param_count() * (2 if cfg.param_dtype == "bfloat16" else 4)
    return pbytes / msize > 12e9


def _ref_model_flops(cfg, shape) -> float:
    """The reference's ``plan_cell`` model flops (lines 88-153)."""
    nactive = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * nactive * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * nactive * shape.global_batch * shape.seq_len
    return 2.0 * nactive * shape.global_batch


def _reference(mesh_shape) -> dict:
    """Per arch: ``{"train_params", "opt", "serve_params": {path:
    bytes}, "cache": {shape name: bytes}, "serve_fsdp": bool,
    "serve_spec_names_data": bool}``."""
    names = _names(mesh_shape)
    mesh = jax.sharding.AbstractMesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    daxes = [a for a in ("pod", "data") if a in sizes]
    out = {}
    for arch in ARCH_IDS:
        cfg = rreg.get_config(arch)
        model = rapi.build_model(cfg)
        tcfg = r_preset(arch)
        ne = cfg.moe.n_experts if cfg.moe else 0
        state = jax.eval_shape(
            lambda: RState.create(model.init(jax.random.key(0)), tcfg))
        gathered = _ref_serve_fsdp(cfg, sizes)
        serve_specs = rshd.param_specs(state.params, mesh, fsdp=gathered,
                                       n_experts=ne)
        rec = {
            "train_params": _device_bytes(
                state.params, rshd.param_specs(state.params, mesh,
                                               fsdp=tcfg.fsdp, n_experts=ne),
                sizes),
            "opt": _device_bytes(
                state.opt, rshd.param_specs(state.opt, mesh, fsdp=tcfg.fsdp,
                                            n_experts=ne), sizes),
            "serve_params": _device_bytes(state.params, serve_specs, sizes),
            "serve_fsdp": gathered,
            "serve_spec_names_data": _names_data(serve_specs, daxes),
            "cache": {}}
        for shape in R_SHAPES:
            if shape.kind != "decode":
                continue
            cache = jax.eval_shape(lambda: model.init_cache(
                shape.global_batch, shape.seq_len))
            rec["cache"][shape.name] = sum(_device_bytes(
                cache, rshd.cache_specs(cache, mesh), sizes).values())
        out[arch] = rec
    return out


def _port_leaves(module) -> dict:
    """``{JAX path: bytes this rank holds}`` of a module's parameters."""
    return {path: cells.tensor_bytes(leaf)
            for path, leaf in transformer.jax_leaves(module.jax_tree())}


def _port_opt(plan) -> dict:
    """``{reference opt path: bytes this rank holds}``: AdamW's ``m`` /
    ``v`` by parameter, Adafactor's factors by JAX leaf."""
    paths = [p for p, _ in transformer.jax_leaves(plan.module.jax_tree())]
    opt, out = plan.opt, {}
    if "f" in opt:
        for path, st in zip(paths, opt["f"]):
            for k, t in st.items():
                out[f"f/{path}/{k}"] = cells.tensor_bytes(t)
        return out
    for path, leaf in zip(paths, plan.module.param_leaves()):
        idx = leaf if isinstance(leaf, list) else [leaf]
        for k in ("m", "v"):
            out[f"{k}/{path}"] = sum(cells.tensor_bytes(opt[k][i])
                                     for i in idx)
    return out


def _port(mesh_shape, shapes) -> dict:
    """Per (arch, shape name): the plan's numbers, built on a fake world
    of ``mesh_shape``."""
    out = {}
    with dryrun.fake_world(mesh_shape, "cpu") as mesh:
        for arch in ARCH_IDS:
            for name in shapes:
                plan = cells.plan_cell(arch, SHAPES[name], mesh)
                rec = {"model_flops": plan.model_flops,
                       "serve_fsdp": plan.serve_fsdp,
                       "params": _port_leaves(plan.module)}
                if plan.kind == "train":
                    rec["opt"] = _port_opt(plan)
                if plan.kind == "decode":
                    with plan.fake_mode:
                        rec["cache"] = cells.tensor_bytes(
                            plan.make_args()[0])
                out[arch, name] = rec
    return out


@pytest.fixture(scope="module")
def sides():
    return {mesh: {"ref": _reference(shape),
                   "port": _port(shape, list(SHAPES) if mesh == "pod16x16"
                                 else ["train_4k", "decode_32k",
                                       "long_500k"])}
            for mesh, shape in MESHES.items()}


def test_iter_cells_equals_the_references():
    mine = [(a, s.name, skip) for a, s, skip in cells.iter_cells()]
    theirs = [(a, s.name, skip) for a, s, skip in rcells.iter_cells()]
    assert mine == theirs
    assert cells.LONG_CONTEXT_OK == rcells.LONG_CONTEXT_OK
    assert sum(skip is None for *_, skip in mine) == 33


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_and_serve_fsdp_equal_the_references(sides, shape):
    port, ref = sides["pod16x16"]["port"], sides["pod16x16"]["ref"]
    sizes = dict(zip(("data", "model"), MESHES["pod16x16"]))
    for arch in ARCH_IDS:
        rcfg = rreg.get_config(arch)
        rshape = {s.name: s for s in R_SHAPES}[shape]
        got = port[arch, shape]
        assert got["model_flops"] == _ref_model_flops(rcfg, rshape), arch
        if SHAPES[shape].kind == "train":
            assert got["serve_fsdp"] is False
            continue
        want = _ref_serve_fsdp(rcfg, sizes)
        assert got["serve_fsdp"] == want == \
            ref[arch]["serve_spec_names_data"], arch
    if shape != "train_4k":
        assert {a for a in ARCH_IDS if port[a, shape]["serve_fsdp"]} == \
            {"llama3_405b", "kimi_k2"}


def _compare(mine: dict, theirs: dict, what: str) -> list:
    bad = [f"{what} {p}: {mine[p]} vs {theirs[p]}"
           for p in sorted(set(mine) & set(theirs)) if mine[p] != theirs[p]]
    if sum(mine.values()) != sum(theirs.values()):
        bad.append(f"{what} total: {sum(mine.values())} vs "
                   f"{sum(theirs.values())}")
    return bad


# the Adafactor presets' optimizer state a rank, the reference's bytes
ADAFACTOR_BYTES = {("pod16x16", "llama3_405b"): 4_913_464,
                   ("pod16x16", "kimi_k2"): 80_282_768,
                   ("pod2x16x16", "llama3_405b"): 2_456_984,
                   ("pod2x16x16", "kimi_k2"): 40_141_504}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_parameter_and_optimizer_bytes_equal_the_references(sides, mesh):
    """Parameters (train and serve) and the optimizer state (AdamW's
    moments; Adafactor's factors, laid out by their own spec) leaf for
    leaf and in total."""
    port, ref = sides[mesh]["port"], sides[mesh]["ref"]
    bad = []
    for arch in ARCH_IDS:
        r = ref[arch]
        train, serve = port[arch, "train_4k"], port[arch, "decode_32k"]
        assert set(train["params"]) == set(r["train_params"]), arch
        assert set(train["opt"]) == set(r["opt"]), arch
        bad += _compare(train["params"], r["train_params"],
                        f"{arch} train params")
        bad += _compare(serve["params"], r["serve_params"],
                        f"{arch} serve params")
        bad += _compare(train["opt"], r["opt"], f"{arch} opt")
        want = ADAFACTOR_BYTES.get((mesh, arch))
        if want is not None and not (sum(train["opt"].values()) == want
                                     == sum(r["opt"].values())):
            bad.append(f"{arch} Adafactor state: {want} B a rank wanted")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_cache_bytes_equal_the_references(sides, mesh):
    port, ref = sides[mesh]["port"], sides[mesh]["ref"]
    for arch in ARCH_IDS:
        for name in ("decode_32k", "long_500k"):
            assert port[arch, name]["cache"] == ref[arch]["cache"][name], \
                (arch, name)
