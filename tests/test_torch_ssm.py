"""The port's Mamba2 SSM family (``models/ssm.py``) against the JAX
package's, at the reduced ``mamba2_370m`` (3 layers, d 128, 4 heads of 32,
state 16, chunk 32), from the same parameters on the same seeded numpy
inputs: the causal convolution, the chunked SSD (also against the
step-by-step recurrence it replaces), the mixer against a loop of its
one-token decode, the model's logits, loss and gradients, prefill states
and decode; then checkpoints across the packages and the launcher.

Tolerances (ROADMAP's LM tolerances): float32 compute: outputs and states
within rtol 1e-4 (absolute floor 1e-4 x the largest magnitude), the loss
within rtol 1e-5, each gradient leaf within a relative norm error of 1e-4;
bfloat16 compute: 3e-2 x the largest, the loss rtol 2e-3, gradients 5e-2.
Layer functions in float32: rtol 1e-5 (absolute floor 1e-5 x the
largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_pair as lp  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ARCH = "mamba2_370m"


def _close(want, got, rtol: float = 1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    u, w, b = _rand(2, 9, 6, seed=1), _rand(4, 6, seed=2), _rand(6, seed=3)
    st = _rand(2, 3, 6, seed=4) if with_state else None
    want_y, want_s = rssm._causal_conv(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
        state=None if st is None else jnp.asarray(st))
    got_y, got_s = ssm._causal_conv(
        torch.tensor(u), torch.tensor(w), torch.tensor(b),
        state=None if st is None else torch.tensor(st))
    _close(want_y, got_y)
    _close(want_s, got_s)


def _ssd_inputs(B=2, S=64, H=4, P=8, N=6, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)) - 1)).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bh = rng.normal(size=(B, S, H, N)).astype(np.float32)
    Ch = rng.normal(size=(B, S, H, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return xh, dt, A, Bh, Ch, s0


@pytest.mark.parametrize("chunk,init", [(16, False), (16, True), (64, True),
                                        (128, False)])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, init):
    """The chunked scan against the reference's, and both against the
    recurrence S_t = S_{t-1} exp(dt_t A) + dt_t B_t x_t^T, y_t = C_t S_t
    run one token at a time in float64."""
    xh, dt, A, Bh, Ch, s0 = _ssd_inputs()
    s0 = s0 if init else None
    want_y, want_s = rssm._ssd_chunked(
        *map(jnp.asarray, (xh, dt, A, Bh, Ch)), chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    got_y, got_s = ssm._ssd_chunked(
        *map(torch.tensor, (xh, dt, A, Bh, Ch)), chunk,
        init_state=None if s0 is None else torch.tensor(s0))
    _close(want_y, got_y, 1e-4)
    _close(want_s, got_s, 1e-4)
    B, S, H, P = xh.shape
    s = np.zeros((B, H, Bh.shape[-1], P)) if s0 is None else s0.astype(
        np.float64)
    ys = []
    for t in range(S):
        s = s * np.exp(dt[:, t] * A)[..., None, None] + \
            dt[:, t, :, None, None] * Bh[:, t, :, :, None] * \
            xh[:, t, :, None, :]
        ys.append(np.einsum("bhn,bhnp->bhp", Ch[:, t], s))
    _close(np.stack(ys, 1), got_y, 1e-4)
    _close(s, got_s, 1e-4)


def test_ssd_gradients_stay_finite_where_decay_sums_overflow():
    """A chunk whose decay sum passes 88 (dt 0.8 over 128 tokens): the
    reference's ``where`` after ``exp`` gives NaN gradients there (its
    backward multiplies the masked inf by 0); the port masks before the
    exp, so its values equal the reference's and its gradients stay
    finite."""
    xh, _, _, Bh, Ch, _ = _ssd_inputs(B=1, S=128, H=2)
    A = -np.ones(2, np.float32)
    dt = np.full((1, 128, 2), 0.8, np.float32)

    def ref(d):
        y, s = rssm._ssd_chunked(jnp.asarray(xh), d, jnp.asarray(A),
                                 jnp.asarray(Bh), jnp.asarray(Ch), 128)
        return y.sum() + s.sum(), (y, s)

    (_, (want_y, want_s)), g = jax.value_and_grad(ref, has_aux=True)(
        jnp.asarray(dt))
    assert not np.isfinite(np.asarray(g)).all()
    t = torch.tensor(dt, requires_grad=True)
    got_y, got_s = ssm._ssd_chunked(torch.tensor(xh), t, torch.tensor(A),
                                    torch.tensor(Bh), torch.tensor(Ch), 128)
    (got_y.sum() + got_s.sum()).backward()
    assert torch.isfinite(t.grad).all()
    _close(want_y, got_y, 1e-4)
    _close(want_s, got_s, 1e-4)


def test_ssd_rejects_a_ragged_chunk():
    xh, dt, A, Bh, Ch, _ = _ssd_inputs(S=40)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm._ssd_chunked(*map(torch.tensor, (xh, dt, A, Bh, Ch)), 16)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mixer_apply_and_decode_match(compute):
    """``mixer_apply`` with its returned states, and ``mixer_decode`` from
    them, against the reference's on layer 0's parameters."""
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    cfg, rcfg = tm.cfg, rm.cfg
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mixer"])
    dt = getattr(torch, compute)
    x = _rand(2, 32, cfg.d_model, seed=5)
    x1 = _rand(2, 1, cfg.d_model, seed=6)
    want, (rconv, rst) = rssm.mixer_apply(
        p0, jnp.asarray(x).astype(rcfg.cdtype()), rcfg, return_state=True)
    got, (tconv, tst) = ssm.mixer_apply(
        mod.blocks[0].mixer, torch.tensor(x).to(dt), cfg, return_state=True)
    lp.logits_close(want.astype(jnp.float32), got, compute)
    for k in ("x", "b", "c"):
        lp.logits_close(rconv[k].astype(jnp.float32), tconv[k], compute)
    lp.logits_close(rst, tst, compute)
    want, (rconv, rst) = rssm.mixer_decode(
        p0, jnp.asarray(x1).astype(rcfg.cdtype()), rcfg, rconv, rst)
    got, (tconv, tst) = ssm.mixer_decode(
        mod.blocks[0].mixer, torch.tensor(x1).to(dt), cfg, tconv, tst)
    lp.logits_close(want.astype(jnp.float32), got, compute)
    lp.logits_close(rst, tst, compute)


def test_mixer_apply_equals_a_loop_of_decodes():
    """Float32: the chunked mixer over 32 tokens equals 32 one-token
    decodes from empty states, output and final states."""
    _, _, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    cfg, p = tm.cfg, mod.blocks[1].mixer
    x = torch.tensor(_rand(2, 32, cfg.d_model, seed=7))
    with torch.no_grad():
        want, (conv, st) = ssm.mixer_apply(p, x, cfg, return_state=True)
        cache = ssm.init_cache(cfg, 2, 0, device="cpu")
        c = {k: v[0] for k, v in cache["conv"].items()}
        s, outs = cache["ssm"][0], []
        for t in range(32):
            y, (c, s) = ssm.mixer_decode(p, x[:, t:t + 1], cfg, c, s)
            outs.append(y)
    _close(want.numpy(), torch.cat(outs, 1), 1e-4)
    _close(st.numpy(), s, 1e-4)
    for k in c:
        _close(conv[k].numpy(), c[k], 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_layout_dtypes_and_param_count():
    """The JAX tree's paths, shapes and dtypes (``A_log`` / ``D`` /
    ``dt_bias`` float32 under bfloat16 parameters), and the matrix
    parameters against ``param_count``."""
    rm, params, tm, mod = lp.pair(ARCH, param_dtype="bfloat16")
    want = jax.tree_util.tree_leaves_with_path(params)
    got = ttr.jax_leaves(mod.jax_tree())
    assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                   for path, _ in want]
    for (path, leaf), (_, w) in zip(got, want):
        t = ttr.stacked(leaf)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, path
    assert mod.blocks[0].mixer["A_log"].dtype == torch.float32
    cfg = tm.cfg
    mats = sum(p.numel() for n, p in mod.named_parameters()
               if p.dim() == 2 and "conv" not in n) \
        - (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    norm_w = cfg.n_layers * 2 * cfg.d_model  # each layer's norm_w (d_inner)
    assert mats + norm_w == cfg.param_count()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_logits_loss_and_grads_match(compute):
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32),
         "labels": rng.integers(-2, 2 * cfg.padded_vocab,
                                (2, 64)).astype(np.int32)}
    b["labels"][0, :3] = -100
    want_logits = rm.forward(params, lp.jb(b))
    want_loss, want_g = jax.value_and_grad(rm.loss)(params, lp.jb(b))
    with torch.no_grad():
        got_logits = tm.forward(mod, lp.tb(b))
    lp.logits_close(want_logits, got_logits, compute)
    loss = tm.loss(mod, lp.tb(b))
    loss.backward()
    rtol = 1e-5 if compute == "float32" else 2e-3
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=rtol)
    rel = 1e-4 if compute == "float32" else 5e-2
    ref = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, want_g))
    mine = [(p, ttr.stacked([t.grad for t in leaf]) if isinstance(leaf, list)
             else leaf.grad) for p, leaf in ttr.jax_leaves(mod.jax_tree())]
    for (path, g), (_, w) in zip(mine, ref):
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(g.float().numpy() - w)
        assert err <= rel * max(np.linalg.norm(w), 1e-30), (path, err)


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
def test_prefill_states_and_decode_match(compute):
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    tok = lp.tokens(tm.cfg.vocab_size, 2, 67, seed=11)
    lg, rc = rm.prefill(params, {"tokens": jnp.asarray(tok[:, :64])}, 80)
    tlg, tc = tm.prefill(mod, {"tokens": torch.tensor(tok[:, :64])}, 80)
    lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)
    for pos in range(64, 67):
        lg, rc = rm.decode_step(params, rc, jnp.asarray(tok[:, pos:pos + 1]),
                                jnp.int32(pos))
        tlg, tc = tm.decode_step(mod, tc, torch.tensor(tok[:, pos:pos + 1]),
                                 pos)
        lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)


def test_state_size_is_constant_in_length():
    _, tcfg = lp.cfgs(ARCH)
    sizes = set()
    for max_len in (16, 4096):
        cache = ssm.init_cache(tcfg, 2, max_len, device="meta")
        sizes.add(sum(t.numel() * t.element_size() for t in
                      [*cache["conv"].values(), cache["ssm"]]))
    d_inner, H, G, N, P = ssm.dims(tcfg)
    k = tcfg.ssm.d_conv - 1
    assert sizes == {tcfg.n_layers * 2 * (k * (d_inner + 2 * G * N) * 2
                                          + H * N * P * 4)}


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def _trained_port(param_dtype: str, steps: int = 2):
    _, _, tm, mod = lp.pair(ARCH, param_dtype=param_dtype,
                            compute_dtype="float32")
    t = TrainConfig(lr=1e-3, microbatch=2)
    state = ttl.TrainState.create(mod, t)
    step = ttl.make_train_step(tm.loss, t)
    for i in range(steps):
        b = {"tokens": torch.tensor(lp.tokens(512, 4, 32, seed=20 + i)),
             "labels": torch.tensor(lp.tokens(512, 4, 32, seed=30 + i))}
        state, _ = step(state, b)
    return state


def _bits(x):
    a = ttr.stacked(x) if isinstance(x, list) else x
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy()
    return a.numpy()


def _ref_bits(x):
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _ref_state(param_dtype: str, seed: int = 0):
    rcfg, _ = lp.cfgs(ARCH, param_dtype=param_dtype, compute_dtype="float32")
    return rtl.TrainState.create(rssm.init(jax.random.key(seed), rcfg),
                                 RTrainConfig(lr=1e-3))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    port = _trained_port("float32")
    ck.save(port, str(tmp_path), port.step)
    shapes = jax.eval_shape(lambda: _ref_state("float32"))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = rck.restore(str(tmp_path), zeros)
    assert int(ref.step) == 2
    mine, theirs = ttr.state_to_jax_leaves(port), \
        jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(_bits(a), _ref_bits(b),
                                      err_msg=f"leaf {i}")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, param_dtype):
    """The reference's TrainState (its leaf order and dtypes: under
    bfloat16 parameters ``A_log`` / ``D`` / ``dt_bias`` and every moment
    stay float32) restores into the port bit for bit.  The reference's own
    ``restore`` cannot read a bfloat16 leaf, so the port reads it."""
    ref = _ref_state(param_dtype, seed=2)
    rng = np.random.default_rng(5)
    ref = rtl.TrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(size=x.shape)).astype(x.dtype),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    rck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _trained_port(param_dtype, steps=1))
    assert port.step == 7
    mine, theirs = ttr.state_to_jax_leaves(port), \
        jax.tree_util.tree_leaves(ref)
    assert [str(ttr.stacked(a).dtype).removeprefix("torch.") for a in mine] \
        == [np.asarray(b).dtype.name for b in theirs]
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(_bits(a), _ref_bits(b),
                                      err_msg=f"leaf {i}")


def test_launcher_trains_the_preset_on_the_cpu(monkeypatch):
    """``mamba2_370m``'s preset (AdamW, microbatch 4) through the ETL-fed
    launcher: finite losses, the SSM's state."""
    from repro_torch.launch import train as launch
    seen = []
    real = launch.make_train_step

    def tapped(loss_fn, tc):
        assert tc.microbatch == 4
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
    assert isinstance(state.model, ssm.SSM)
