"""The port's hybrid family (``models/hybrid.py``, Zamba2) against the JAX
package's, at the reduced ``zamba2_2_7b`` (4 Mamba2 layers, d 128, one
shared attention block of 4 heads applied after every 2, window 16, SSD
chunk 32), from the same parameters on the same seeded numpy inputs: the
parameter tree (the unstacked ``shared_attn`` subtree), logits, loss and
gradients (``shared_attn``'s summed over its applications), remat,
prefill's states and rings, decode across the ring's wrap, an Adafactor
step (the unstacked leaf factors unstacked), checkpoints both ways, the
launcher and ``launch.serve``.

Tolerances (ROADMAP's LM tolerances): float32 compute: logits and states
within rtol 1e-4 (absolute floor 1e-4 x the largest magnitude), the loss
within rtol 1e-5, each gradient leaf within a relative norm error of 1e-4;
bfloat16 compute: logits, convolution states and rings 3e-2 x the
largest, the loss rtol 2e-3, gradients 5e-2 in norm.  At bfloat16 the
float32 SSD state is held in relative norm at 5e-2, as the gradients: it
sums the bfloat16 rounding of every layer below it (measured 0.020 in
norm, up to 0.04 of the largest element in the deepest layer; 0.006 in
layer 0, as in the SSM's tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_pair as lp  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.models import hybrid as rhybrid  # noqa: E402
from repro.serving import decode as rdecode  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ARCH = "zamba2_2_7b"


def _grads_close(module, want_g, rel: float) -> None:
    ref = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, want_g))
    mine = [(p, ttr.stacked([t.grad for t in leaf]) if isinstance(leaf, list)
             else leaf.grad) for p, leaf in ttr.jax_leaves(module.jax_tree())]
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, g), (_, w) in zip(mine, ref):
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(g.float().numpy() - w)
        assert err <= rel * max(np.linalg.norm(w), 1e-30), (path, err)


def _state_close(rcache, tcache, compute: str) -> None:
    """``lp.cache_close``; at bfloat16 the SSD state in relative norm."""
    if compute == "float32":
        lp.cache_close(rcache, tcache, compute)
        return
    lp.cache_close({k: v for k, v in rcache.items() if k != "ssm"},
                   {k: v for k, v in tcache.items() if k != "ssm"}, compute)
    w, g = np.asarray(rcache["ssm"]), tcache["ssm"].numpy()
    assert g.shape == w.shape and tcache["ssm"].dtype == torch.float32
    assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_layout_dtypes_and_param_count():
    """The JAX tree's paths, shapes and dtypes against the reference's
    ``jax.eval_shape(init)`` (``shared_attn/*`` unstacked, after
    ``lm_head``), one ``Block`` shared by every application, and the
    matrices against ``param_count`` (the shared block counted once)."""
    rcfg, tcfg = lp.cfgs(ARCH, param_dtype="bfloat16")
    want = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: rhybrid.init(jax.random.key(0), rcfg)))
    mod = hybrid.Hybrid(tcfg, device="cpu")
    got = ttr.jax_leaves(mod.jax_tree())
    assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                   for path, _ in want]
    assert got[-1][0].startswith("shared_attn/")
    for (path, leaf), (_, w) in zip(got, want):
        t = ttr.stacked(leaf)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, path
    assert hybrid.n_shared_applications(tcfg) == 2
    mats = sum(p.numel() for n, p in mod.named_parameters()
               if p.dim() == 2 and "conv" not in n) \
        - 2 * (tcfg.padded_vocab - tcfg.vocab_size) * tcfg.d_model
    assert mats == tcfg.param_count()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_logits_loss_and_grads_match(compute):
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32),
         "labels": rng.integers(-2, 2 * cfg.padded_vocab,
                                (2, 64)).astype(np.int32)}
    b["labels"][0, :3] = -100
    want_logits = jax.jit(rm.forward)(params, lp.jb(b))
    want_loss, want_g = jax.jit(jax.value_and_grad(rm.loss))(params,
                                                             lp.jb(b))
    with torch.no_grad():
        got_logits = tm.forward(mod, lp.tb(b))
    lp.logits_close(want_logits, got_logits, compute)
    loss = tm.loss(mod, lp.tb(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5 if compute == "float32" else 2e-3)
    _grads_close(mod, want_g, 1e-4 if compute == "float32" else 5e-2)
    # the shared block's gradient sums its applications: nonzero, and
    # more than the last application's alone
    assert float(mod.shared_attn.attn["wq"].grad.abs().sum()) > 0


def test_remat_gives_equal_gradients():
    grads = {}
    for remat in ("full", "none"):
        _, _, tm, mod = lp.pair(ARCH, compute_dtype="float32", remat=remat)
        b = {"tokens": torch.tensor(lp.tokens(512, 2, 32, seed=9)),
             "labels": torch.tensor(lp.tokens(512, 2, 32, seed=10))}
        tm.loss(mod, b).backward()
        grads[remat] = [p.grad.clone() for p in mod.parameters()]
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt", [16, 64])
def test_prefill_states_and_decode_match(prompt, compute):
    """A prompt that fills the 16-slot ring (16) and one past it (64: the
    ring holds its last 16 positions), then 4 decode steps, every one
    writing over a slot the ring wrapped to: logits at each step, every
    state leaf after prefill and after the last step."""
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    rdecode_step = jax.jit(rm.decode_step)
    tok = lp.tokens(tm.cfg.vocab_size, 2, prompt + 4, seed=11)
    max_len = prompt + 8
    lg, rc = jax.jit(rm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tok[:, :prompt])}, max_len)
    tlg, tc = tm.prefill(mod, {"tokens": torch.tensor(tok[:, :prompt])},
                         max_len)
    lp.logits_close(lg, tlg, compute)
    _state_close(rc, tc, compute)
    assert tc["shared_kv"]["pos"].shape == (2, 16)
    assert int(tc["shared_kv"]["pos"][0, 0]) == prompt - 16
    for pos in range(prompt, prompt + 4):
        lg, rc = rdecode_step(params, rc, jnp.asarray(tok[:, pos:pos + 1]),
                              jnp.int32(pos))
        tlg, tc = tm.decode_step(mod, tc, torch.tensor(tok[:, pos:pos + 1]),
                                 pos)
        lp.logits_close(lg, tlg, compute)
    _state_close(rc, tc, compute)
    assert int(tc["shared_kv"]["pos"][1, 3]) == prompt + 3


def test_state_bytes_follow_the_formula():
    """The SSM state is constant in length; each application's ring holds
    ``min(window, max_len)`` slots."""
    _, tcfg = lp.cfgs(ARCH)
    from repro_torch.models import ssm
    d_inner, H, G, N, P = ssm.dims(tcfg)
    B, k, n_app = 2, tcfg.ssm.d_conv - 1, hybrid.n_shared_applications(tcfg)
    for max_len in (8, 16, 4096):
        cache = hybrid.init_cache(tcfg, B, max_len, device="meta")
        got = sum(t.numel() * t.element_size() for t in
                  [*cache["conv"].values(), cache["ssm"],
                   *cache["shared_kv"].values()])
        kv_len = min(tcfg.sliding_window, max_len)
        want = tcfg.n_layers * B * (k * (d_inner + 2 * G * N) * 2
                                    + H * N * P * 4) \
            + n_app * (2 * B * kv_len * tcfg.n_kv_heads * tcfg.hd * 2
                       + kv_len * 4)
        assert got == want, max_len


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def _batch(i: int, rows: int = 4) -> dict:
    return {"tokens": lp.tokens(512, rows, 32, seed=20 + i),
            "labels": lp.tokens(512, rows, 32, seed=30 + i)}


@pytest.mark.parametrize("optimizer,micro", [("adamw", 4), ("adafactor", 2)])
def test_train_step_matches_reference(optimizer, micro):
    """Two microbatched steps against the reference's ``make_train_step``
    (jitted) from equal parameters: each step's loss (rtol 1e-5; the second
    is taken at the first's updated parameters) and gradient norm (1e-4);
    the optimizer state in the reference's leaves and shapes (Adafactor's
    unstacked ``shared_attn`` matrices factored as 2-D leaves).  Adafactor's
    parameters after the steps are held per leaf in norm (1e-4).  AdamW's
    are not: its per-element update is ``m / sqrt(v)``, so where an
    element's gradient changes sign between the steps a 1e-7 difference in
    the gradient moves the update by up to ``lr`` (one embedding element
    ends 0.0039 apart, measured)."""
    rm, params, tm, mod = lp.pair(ARCH, seed=1, compute_dtype="float32")
    kw = dict(optimizer=optimizer, lr=3e-3, microbatch=micro)
    rt, t = RTrainConfig(**kw), TrainConfig(**kw)
    rstate = rtl.TrainState.create(params, rt)
    rstep = jax.jit(rtl.make_train_step(rm.loss, rt))
    state = ttl.TrainState.create(mod, t)
    step = ttl.make_train_step(tm.loss, t)
    for i in range(2):
        b = _batch(i, rows=8)
        rstate, rmet = rstep(rstate, lp.jb(b))
        state, m = step(state, lp.tb(b))
        np.testing.assert_allclose(float(m["loss"]), float(rmet["loss"]),
                                   rtol=1e-5, err_msg=f"loss step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-4)
    want = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, rstate.params))
    mine = ttr.state_to_jax_leaves(state)[len(want):-1]
    theirs = jax.tree_util.tree_leaves(rstate.opt)
    assert [tuple(ttr.stacked(x).shape) for x in mine] == \
        [x.shape for x in theirs]
    if optimizer == "adamw":
        return
    for (path, leaf), (_, w) in zip(ttr.jax_leaves(mod.jax_tree()), want):
        err = np.linalg.norm(ttr.stacked(leaf).numpy() - w)
        assert err <= 1e-4 * np.linalg.norm(w), (path, err)
    i = [p for p, _ in want].index("shared_attn/attn/wq")
    st = state.opt["f"][i]
    assert sorted(st) == ["vc", "vr"] and st["vr"].dim() == 1


def _trained_port(optimizer: str, steps: int = 2):
    _, _, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    t = TrainConfig(optimizer=optimizer, lr=1e-3, microbatch=2)
    state = ttl.TrainState.create(mod, t)
    step = ttl.make_train_step(tm.loss, t)
    for i in range(steps):
        state, _ = step(state, lp.tb(_batch(i)))
    return state


def _ref_state(optimizer: str, seed: int = 0):
    rcfg, _ = lp.cfgs(ARCH, compute_dtype="float32")
    return rtl.TrainState.create(rhybrid.init(jax.random.key(seed), rcfg),
                                 RTrainConfig(optimizer=optimizer, lr=1e-3))


def _assert_port_equals_ref(port, ref):
    mine, theirs = ttr.state_to_jax_leaves(port), \
        jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(ttr.stacked(a).numpy()
                                      if isinstance(a, list) else a.numpy(),
                                      np.asarray(b), err_msg=f"leaf {i}")


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, optimizer):
    port = _trained_port(optimizer)
    ck.save(port, str(tmp_path), port.step)
    shapes = jax.eval_shape(lambda: _ref_state(optimizer))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = rck.restore(str(tmp_path), zeros)
    assert int(ref.step) == 2
    _assert_port_equals_ref(port, ref)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, optimizer):
    ref = _ref_state(optimizer, seed=2)
    rng = np.random.default_rng(5)
    ref = rtl.TrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(size=x.shape)).astype(x.dtype),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    rck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _trained_port(optimizer, steps=1))
    assert port.step == 7
    _assert_port_equals_ref(port, ref)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launcher_trains_the_preset_on_the_cpu(monkeypatch):
    """``zamba2_2_7b``'s preset (AdamW, microbatch 4) through the ETL-fed
    launcher: finite losses, the hybrid's state."""
    from repro_torch.launch import train as launch
    seen = []
    real = launch.make_train_step

    def tapped(loss_fn, tc):
        assert tc.microbatch == 4 and tc.optimizer == "adamw"
        step = real(loss_fn, tc)

        def run(state, batch):
            state, m = step(state, batch)
            seen.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(launch, "make_train_step", tapped)
    out = launch.main(["--device", "cpu", "--reduced", "--arch", ARCH,
                       "--steps", "2", "--batch", "8", "--seq", "32"])
    state = out["state"]
    assert state.step == 2 and len(seen) == 2 and np.isfinite(seen).all()
    assert isinstance(state.model, hybrid.Hybrid)


def test_serve_launcher_tokens_equal_the_reference(monkeypatch):
    """``launch.serve.main`` (greedy, float32 compute, the prompt 64
    tokens so the decode steps run past the ring's wrap): its tokens equal
    the reference's ``generate`` on the launcher's prompts and on the
    launcher's module's parameters."""
    from repro_torch.launch import serve
    rcfg, tcfg = lp.cfgs(ARCH, compute_dtype="float32")
    monkeypatch.setattr(serve, "get_reduced", lambda arch: tcfg)
    out = serve.main(["--device", "cpu", "--reduced", "--arch", ARCH,
                      "--batch", "2", "--prompt-len", "64", "--max-new",
                      "6"])
    params = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(ttr.stacked(leaf).numpy()),
        out["module"].jax_tree(), is_leaf=lambda x: isinstance(x, list))
    rmodel = lp.rapi.build_model(rcfg)
    want, _ = rdecode.generate(rmodel, params,
                               jnp.asarray(out["prompts"].numpy()),
                               max_new=6, max_len=70)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
