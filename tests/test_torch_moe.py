"""The port's MoE family against the JAX package's, at the reduced
``mixtral_8x7b`` (4 experts, top-2, no dense layer) and ``kimi_k2`` (8
experts, top-2, one shared expert, one leading dense layer), from the same
parameters (the JAX init exported through ``models/api.params_from_jax``)
on the same seeded numpy inputs; then Adafactor training, checkpoints
across the packages and the launcher on the CPU.

Tolerances (those of ``tests/test_torch_lm.py``, ROADMAP Queue C):
- routing (``top_e``, ``pos_in_e``, ``keep``, ``slot``): bit-equal, drops
  and ties included;
- float32 compute: ``moe_apply`` and the logits within rtol 1e-4 (absolute
  floor 1e-4 x the largest magnitude), the loss and the load-balance loss
  within rtol 1e-5, each gradient leaf within a relative norm error of
  1e-4;
- bfloat16 compute: outputs within 3e-2 x the largest magnitude, the loss
  within rtol 2e-3, each gradient leaf within a relative norm error of
  5e-2;
- one Adafactor step at ``microbatch=2``: loss rtol 1e-5, grad norm 1e-4,
  parameters 1e-4 in norm.
"""

import dataclasses
import inspect
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

MOE = ["mixtral_8x7b", "kimi_k2"]


def _cfgs(arch: str, **kw):
    rcfg, tcfg = rreg.get_reduced(arch), treg.get_reduced(arch)
    moe_kw = {k: kw.pop(k) for k in ("capacity_factor",) if k in kw}
    if moe_kw:
        rcfg = dataclasses.replace(
            rcfg, moe=dataclasses.replace(rcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(tcfg, **kw)


def _pair(arch: str, seed: int = 0, edit=None, **kw):
    """(ref cfg, ref params, port cfg, port model) with equal parameters;
    ``edit(params)`` may change the numpy tree first."""
    rcfg, tcfg = _cfgs(arch, **kw)
    params = jax.tree_util.tree_map(
        np.array, rtr.init(jax.random.key(seed), rcfg))
    if edit is not None:
        edit(params)
    model = ttr.Transformer(tcfg, device="cpu")
    api.params_from_jax(model, params)
    return rcfg, jax.tree_util.tree_map(jnp.asarray, params), tcfg, model


def _batch(vocab: int, padded: int, rows: int = 2, seq: int = 16,
           seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    lab = rng.integers(-2, 2 * padded, (rows, seq)).astype(np.int32)
    lab[0, :3] = -100
    return {"tokens": tok, "labels": lab}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _assert_grads(model, ref_grads, rel: float):
    ref = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, ref_grads))
    mine = [(p, ttr.stacked([t.grad for t in leaf])
             if isinstance(leaf, list) else leaf.grad)
            for p, leaf in ttr.jax_leaves(model.jax_tree())]
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, g), (_, want) in zip(mine, ref):
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(g.float().numpy() - want)
        assert err <= rel * max(np.linalg.norm(want), 1e-30), (path, err)


def _layer0(params) -> dict:
    return jax.tree_util.tree_map(lambda a: a[0], params["moe_blocks"]["moe"])


def _ref_routing(p, xf, cfg, cap) -> tuple:
    """The reference's routing, run from its own source: the lines of
    ``repro.models.moe._dispatch_ffn`` up to the dispatch, returning
    ``(top_e, pos_in_e, keep, slot)``."""
    src = textwrap.dedent(inspect.getsource(rmoe._dispatch_ffn))
    head = src[:src.index("    disp = ")]
    ns = dict(vars(rmoe))
    exec(head + "    return top_e, pos_in_e, keep, slot\n", ns)
    return ns["_dispatch_ffn"](p, xf, cfg, cap)


def _x(n: int, d: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing, bit for bit
# ---------------------------------------------------------------------------

def _tie(params):
    """Router columns 1 and 2 equal in every MoE layer: every token's
    probabilities tie there."""
    r = params["moe_blocks"]["moe"]["router"]
    r[..., 2] = r[..., 1]


@pytest.mark.parametrize("case", ["plain", "drops", "tie"])
@pytest.mark.parametrize("arch", MOE)
def test_routing_is_bit_equal(arch, case):
    kw = {"capacity_factor": 0.5} if case == "drops" else {}
    rcfg, params, tcfg, model = _pair(
        arch, edit=_tie if case == "tie" else None, **kw)
    xf = _x(48, tcfg.d_model)
    cap = moe.capacity(48, tcfg)
    assert cap == int(max(1, np.ceil(48 * tcfg.moe.top_k / tcfg.moe.n_experts
                                     * tcfg.moe.capacity_factor))) + 7 & ~7
    want = _ref_routing(_layer0(params), jnp.asarray(xf), rcfg, cap)
    got = moe.route(model.moe_blocks[0].moe, torch.tensor(xf), tcfg, cap)
    for name, w in zip(("top_e", "pos_in_e", "keep", "slot"), want):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)
    if case == "drops":
        assert not got["keep"].numpy().all()
    if case == "tie":
        top = got["top_e"].numpy()
        both = (top == 1).any(-1) & (top == 2).any(-1)
        assert both.any()
        # where both tied experts are chosen, the lower index comes first
        first = np.argmax((top == 1) | (top == 2), axis=-1)
        assert (top[both, first[both]] == 1).all()


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    w, e = moe.top_k(probs, 2)
    assert e.tolist() == [[1, 2], [0, 1]]
    rw, re_ = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


# ---------------------------------------------------------------------------
# values and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_and_aux_loss_match(arch, compute):
    rcfg, params, tcfg, model = _pair(arch, compute_dtype=compute)
    x = _x(2 * 24, tcfg.d_model, seed=3).reshape(2, 24, -1)
    dt = getattr(torch, compute)
    p = _layer0(params)
    want = np.asarray(rmoe.moe_apply(
        p, jnp.asarray(x).astype(compute), rcfg), np.float32)
    layer = model.moe_blocks[0].moe
    with torch.no_grad():
        got = moe.moe_apply(layer, torch.tensor(x).to(dt), tcfg).float()
        aux = moe.aux_load_balance_loss(layer, torch.tensor(x), tcfg)
    scale = np.abs(want).max()
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)
    else:
        assert np.abs(got.numpy() - want).max() <= 3e-2 * scale
    raux = rmoe.aux_load_balance_loss(p, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_logits_loss_and_grads_match(arch, compute):
    rcfg, params, tcfg, model = _pair(arch, compute_dtype=compute)
    b = _batch(tcfg.vocab_size, tcfg.padded_vocab)
    loss, grads = jax.value_and_grad(
        lambda p: rtr.loss_fn(p, _jb(b), rcfg))(params)
    want = np.asarray(rtr.forward(params, _jb(b)["tokens"], rcfg), np.float32)
    tl = model.loss_fn(_tb(b))
    tl.backward()
    with torch.no_grad():
        got = model(_tb(b)["tokens"]).float().numpy()
    scale = np.abs(want).max()
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(float(tl.detach()), float(loss), rtol=1e-5)
        _assert_grads(model, grads, 1e-4)
    else:
        assert np.abs(got - want).max() <= 3e-2 * scale
        np.testing.assert_allclose(float(tl.detach()), float(loss),
                                   rtol=2e-3)
        _assert_grads(model, grads, 5e-2)


def test_moe_layout_and_param_count():
    """``moe_blocks`` after ``blocks`` (kimi_k2: one dense layer), the
    router float32 under bfloat16 parameters, ``param_count`` the matrix
    parameters, and the JAX leaves' shapes."""
    rcfg, params, tcfg, model = _pair("kimi_k2")
    assert len(model.blocks) == 1 and len(model.moe_blocks) == 2
    mats = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    # param_count (both packages') counts a router in the dense layer too
    e = tcfg.moe
    assert mats + e.first_dense_layers * tcfg.d_model * e.n_experts == \
        tcfg.param_count()
    want = [(p, np.shape(a)) for p, a in ttr.jax_leaves(params)]
    got = [(p, tuple(ttr.stacked(x).shape))
           for p, x in ttr.jax_leaves(model.jax_tree())]
    assert got == want
    bf = ttr.Transformer(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                         device="cpu")
    assert bf.moe_blocks[0].moe.router.dtype == torch.float32
    assert bf.moe_blocks[0].moe.experts["w1"].dtype == torch.bfloat16


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_give_equal_gradients(remat):
    grads = {}
    for r in ("full", remat):
        _, _, _, model = _pair("kimi_k2", compute_dtype="float32", remat=r)
        model.loss_fn(_tb(_batch(512, 512, rows=2, seed=9))).backward()
        grads[r] = [p.grad for p in model.parameters()]
    for a, b in zip(grads["full"], grads[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# training, checkpoints, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_adafactor_step_at_microbatch_2_matches_reference(arch):
    rcfg, params, tcfg, model = _pair(arch, seed=1, compute_dtype="float32")
    kw = dict(optimizer="adafactor", lr=3e-3, microbatch=2)
    rt, t = RTrainConfig(**kw), TrainConfig(**kw)
    rstate = rtl.TrainState.create(params, rt)
    rstep = jax.jit(rtl.make_train_step(
        lambda p, bb: rtr.loss_fn(p, bb, rcfg), rt))
    state = ttl.TrainState.create(model, t)
    step = ttl.make_train_step(ttr.loss_fn, t)
    for i in range(2):
        b = _batch(tcfg.vocab_size, tcfg.padded_vocab, rows=4, seed=20 + i)
        rstate, rm = rstep(rstate, _jb(b))
        state, m = step(state, _tb(b))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"loss step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    want = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, rstate.params))
    for (path, leaf), (_, w) in zip(ttr.jax_leaves(model.jax_tree()), want):
        got = ttr.stacked(leaf).numpy()
        err = np.linalg.norm(got - w)
        assert err <= 1e-4 * np.linalg.norm(w), (path, err)
    # the state's leaves: the reference's shapes and order
    mine = ttr.state_to_jax_leaves(state)[len(want):-1]
    theirs = jax.tree_util.tree_leaves(rstate.opt)
    assert [tuple(x.shape) for x in mine] == [x.shape for x in theirs]


def _trained_port(state_dtype: str, steps: int = 2):
    _, _, tcfg, model = _pair("kimi_k2", compute_dtype="float32")
    t = TrainConfig(optimizer="adafactor", opt_state_dtype=state_dtype,
                    lr=1e-3, microbatch=2)
    state = ttl.TrainState.create(model, t)
    step = ttl.make_train_step(ttr.loss_fn, t)
    for i in range(steps):
        state, _ = step(state, _tb(_batch(tcfg.vocab_size, tcfg.padded_vocab,
                                          rows=4, seed=30 + i)))
    return state


def _bits(x) -> np.ndarray:
    """A leaf's values (bfloat16 as its bits) on the host."""
    if isinstance(x, (list, torch.Tensor)):
        x = ttr.stacked(x) if isinstance(x, list) else x
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_port_equals_ref(port, ref):
    mine = ttr.state_to_jax_leaves(port)
    theirs = jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def _ref_state(seed: int, state_dtype: str):
    rcfg, _ = _cfgs("kimi_k2", compute_dtype="float32")
    rt = RTrainConfig(optimizer="adafactor", opt_state_dtype=state_dtype,
                      lr=1e-3)
    return rtl.TrainState.create(rtr.init(jax.random.key(seed), rcfg), rt)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Float32 state restores in the reference bit for bit.  The
    reference's restore cannot read a bfloat16 leaf (its own either:
    ``jax.device_put`` refuses numpy's 2-byte void records), so for the
    preset's bfloat16 state the port's files are held against the
    reference's own save of the same values, byte for byte."""
    port = _trained_port("float32")
    ck.save(port, str(tmp_path / "f32"), port.step)
    shapes = jax.eval_shape(lambda: _ref_state(0, "float32"))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = rck.restore(str(tmp_path / "f32"), zeros)
    assert int(ref.step) == 2
    _assert_port_equals_ref(port, ref)

    port = _trained_port("bfloat16")
    ck.save(port, str(tmp_path / "bf16"), port.step)
    rtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(_ref_state(0, "bfloat16")),
        [jnp.asarray(_bits(x)).view(jnp.bfloat16) if _bits(x).dtype ==
         np.int16 else jnp.asarray(_bits(x))
         for x in ttr.state_to_jax_leaves(port)])
    rck.save(rtree, str(tmp_path / "ref"), 2)
    files = sorted(p.name for p in (tmp_path / "ref" / "step_00000002")
                   .glob("leaf_*.npy"))
    man = {}
    for which in ("bf16", "ref"):
        d = tmp_path / which / "step_00000002"
        man[which] = [(e["shape"], e["dtype"]) for e in json.loads(
            (d / "manifest.json").read_text())["index"]]
    assert man["bf16"] == man["ref"]
    assert ("bfloat16" in {dt for _, dt in man["ref"]})
    for f in files:
        a = np.load(tmp_path / "bf16" / "step_00000002" / f)
        b = np.load(tmp_path / "ref" / "step_00000002" / f)
        assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, state_dtype):
    ref = _ref_state(2, state_dtype)
    rng = np.random.default_rng(5)
    ref = rtl.TrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(size=x.shape)).astype(x.dtype),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    rck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _trained_port(state_dtype, steps=1))
    assert port.step == 7
    _assert_port_equals_ref(port, ref)


@pytest.mark.parametrize("arch,micro", [("mixtral_8x7b", 4), ("kimi_k2", 16),
                                        ("llama3_405b", 8),
                                        ("qwen3_32b", 8)])
def test_launcher_trains_the_preset_on_the_cpu(arch, micro, monkeypatch):
    """The presets that need MoE, Adafactor or fsdp train through the
    launcher at their reduced configs: the preset's microbatching, finite
    losses, the state of the preset's optimizer."""
    from repro_torch.launch import train as launch
    seen = []
    real = launch.make_train_step

    def tapped(loss_fn, tc):
        assert tc.microbatch == micro and tc.fsdp
        step = real(loss_fn, tc)

        def run(state, batch):
            state, m = step(state, batch)
            seen.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(launch, "make_train_step", tapped)
    out = launch.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--steps", "2", "--batch", "16", "--seq", "16"])
    state = out["state"]
    assert state.step == 2 and len(seen) == 2 and np.isfinite(seen).all()
    adafactor = launch.train_preset(arch).optimizer == "adafactor"
    assert ("f" in state.opt) == adafactor
    assert bool(len(state.model.moe_blocks)) == (arch in MOE)
