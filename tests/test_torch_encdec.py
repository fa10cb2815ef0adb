"""The port's enc-dec family (``models/encdec.py``, Whisper) against the JAX
package's, at the reduced ``whisper_base`` (2 + 2 layers, d 64, 4 heads,
32 encoder frames), from the same parameters on the same seeded numpy
inputs: cross-attention (``mha(kv_x=)``), the two sinusoid functions, the
encoder, logits, loss and gradients, prefill's cross and self caches and
decode, a train step, checkpoints both ways, and both launchers refusing
the family (neither can feed its frames, in either package).

Tolerances (ROADMAP's LM tolerances): float32 compute: logits, encoder
outputs and caches within rtol 1e-4 (absolute floor 1e-4 x the largest
magnitude), the loss within rtol 1e-5, each gradient leaf within a
relative norm error of 1e-4; bfloat16 compute: 3e-2 x the largest, the
loss rtol 2e-3, gradients 5e-2.  Layer functions in float32: rtol 1e-5.
``sinusoidal_positions`` (numpy in both packages) is bit-equal;
``sinusoidal_at`` runs float32 ``pow`` / ``sin`` / ``cos``, whose XLA and
PyTorch CPU versions differ in the last bit on ~7 % of entries, so it is
held within 2**-23 absolute (one float32 ulp at 1; its values lie in
[-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_pair as lp  # noqa: E402
from repro.configs.base import ShapeCfg as RShapeCfg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.models import encdec as rencdec  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import ShapeCfg, TrainConfig  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ARCH = "whisper_base"


def _batch(rm, tm, seq: int = 24, rows: int = 2, seed: int = 1) -> tuple:
    """``random_batch`` of both packages (the same arrays)."""
    rb = lp.rapi.random_batch(rm.cfg, RShapeCfg("t", seq, rows, "train"),
                              seed=seed)
    tb = api.random_batch(tm.cfg, ShapeCfg("t", seq, rows, "train"),
                          seed=seed, device="cpu")
    return rb, tb


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_kv", [4, 2])
def test_cross_attention_matches(n_kv):
    """``mha(kv_x=)`` with 5 queries over 11 keys (no mask, no RoPE even
    where the spec has one), GQA where ``n_kv < n_heads``."""
    rng = np.random.default_rng(3)
    spec = dict(d_model=32, n_heads=4, n_kv_heads=n_kv, head_dim=8,
                rope_style="full", causal=True)
    p = {"wq": rng.normal(size=(32, 32)), "wk": rng.normal(size=(32, 8 * n_kv)),
         "wv": rng.normal(size=(32, 8 * n_kv)), "wo": rng.normal(size=(32, 32))}
    p = {k: (v / 6).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    src = rng.normal(size=(2, 11, 32)).astype(np.float32)
    want, _ = RL.mha({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), RL.AttnSpec(**spec),
                     kv_x=jnp.asarray(src))
    got = L.mha({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                L.AttnSpec(**spec), kv_x=torch.tensor(src))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_sinusoids_match():
    for n, d in ((1, 8), (33, 64), (1500, 512)):
        np.testing.assert_array_equal(L.sinusoidal_positions(n, d).numpy(),
                                      np.asarray(RL.sinusoidal_positions(n,
                                                                         d)))
    pos = np.array([0, 1, 7, 63, 447, 1499, 4000], np.int32)
    want = np.asarray(RL.sinusoidal_at(jnp.asarray(pos), 512))
    got = L.sinusoidal_at(torch.tensor(pos), 512)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -23)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_layout_dtypes_and_param_count():
    """The JAX tree (``enc_norm`` unstacked, the layer groups stacked; no
    ``lm_head``: the embedding is the head) and ``param_count``."""
    rcfg, tcfg = lp.cfgs(ARCH, param_dtype="bfloat16")
    want = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: rencdec.init(jax.random.key(0), rcfg)))
    mod = encdec.EncDec(tcfg, device="cpu")
    got = ttr.jax_leaves(mod.jax_tree())
    assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                   for path, _ in want]
    for (path, leaf), (_, w) in zip(got, want):
        t = ttr.stacked(leaf)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, path
    mats = sum(p.numel() for p in mod.parameters() if p.dim() == 2) \
        - (tcfg.padded_vocab - tcfg.vocab_size) * tcfg.d_model
    assert mats == tcfg.param_count()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encode_logits_loss_and_grads_match(compute):
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    rb, tb = _batch(rm, tm)
    rb["labels"] = rb["labels"].at[0, :3].set(-100)
    tb["labels"][0, :3] = -100
    want_enc = jax.jit(lambda p, f: rencdec.encode(p, f, rm.cfg))(
        params, rb["frames"])
    with torch.no_grad():
        lp.logits_close(want_enc.astype(jnp.float32), mod.encode(
            tb["frames"]), compute)
        lp.logits_close(jax.jit(rm.forward)(params, rb), tm.forward(mod, tb),
                        compute)
    want_loss, want_g = jax.jit(jax.value_and_grad(rm.loss))(params, rb)
    loss = tm.loss(mod, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5 if compute == "float32" else 2e-3)
    rel = 1e-4 if compute == "float32" else 5e-2
    ref = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, want_g))
    mine = [(p, ttr.stacked([t.grad for t in leaf]) if isinstance(leaf, list)
             else leaf.grad) for p, leaf in ttr.jax_leaves(mod.jax_tree())]
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, g), (_, w) in zip(mine, ref):
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(g.float().numpy() - w)
        assert err <= rel * max(np.linalg.norm(w), 1e-30), (path, err)


def test_remat_gives_equal_gradients():
    grads = {}
    for remat in ("full", "none"):
        rm, _, tm, mod = lp.pair(ARCH, compute_dtype="float32", remat=remat)
        _, tb = _batch(rm, tm, seed=2)
        tm.loss(mod, tb).backward()
        grads[remat] = [p.grad.clone() for p in mod.parameters()]
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_caches_and_decode_match(compute):
    """Prefill of 12 prompt tokens into a 20-slot self cache (the cross
    K / V of every decoder layer from the 32 encoder frames), then 4
    decode steps: logits at each, every cache leaf after prefill and after
    the last step."""
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    rb, tb = _batch(rm, tm, seq=16, seed=3)
    S, max_len = 12, 20
    rpre = {"frames": rb["frames"], "tokens": rb["tokens"][:, :S]}
    tpre = {"frames": tb["frames"], "tokens": tb["tokens"][:, :S]}
    lg, rc = jax.jit(rm.prefill, static_argnums=2)(params, rpre, max_len)
    tlg, tc = tm.prefill(mod, tpre, max_len)
    lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)
    tok = np.asarray(rb["tokens"])
    rdecode_step = jax.jit(rm.decode_step)
    for pos in range(S, S + 4):
        lg, rc = rdecode_step(params, rc, jnp.asarray(tok[:, pos:pos + 1]),
                              jnp.int32(pos))
        tlg, tc = tm.decode_step(mod, tc, torch.tensor(tok[:, pos:pos + 1]),
                                 pos)
        lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)


def test_prefill_decode_matches_forward():
    """Float32: prefill(12) and 4 decode steps fed the same tokens give
    the teacher-forced forward's logits at positions 11 .. 15 (1e-4 x the
    largest, the reference's bound), and the caches' bytes follow their
    formulas."""
    rm, _, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    _, tb = _batch(rm, tm, seq=16, seed=4)
    cfg = tm.cfg
    with torch.no_grad():
        want = tm.forward(mod, tb)[:, 11:16]
    lg, cache = tm.prefill(mod, {"frames": tb["frames"],
                                 "tokens": tb["tokens"][:, :12]}, 16)
    got = [lg[:, 0]]
    for pos in range(12, 16):
        lg, cache = tm.decode_step(mod, cache, tb["tokens"][:, pos:pos + 1],
                                   pos)
        got.append(lg[:, 0])
    got = torch.stack(got, 1)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    B, Lr, kv, hd = 2, cfg.n_layers, cfg.n_kv_heads, cfg.hd
    nbytes = {g: sum(t.numel() * t.element_size() for t in cache[g].values())
              for g in ("self", "cross")}
    assert nbytes == {"self": 2 * Lr * B * 16 * kv * hd * 4 + Lr * 16 * 4,
                      "cross": 2 * Lr * B * cfg.enc_seq * kv * hd * 4}


def test_train_step_matches_reference():
    """The preset's optimizer (AdamW, microbatch 1), two steps against the
    reference's jitted ``make_train_step``: losses, gradient norms and
    every parameter leaf after (1e-4 in norm)."""
    rm, params, tm, mod = lp.pair(ARCH, seed=1, compute_dtype="float32")
    kw = dict(lr=3e-3, microbatch=1)
    rstate = rtl.TrainState.create(params, RTrainConfig(**kw))
    rstep = jax.jit(rtl.make_train_step(rm.loss, RTrainConfig(**kw)))
    state = ttl.TrainState.create(mod, TrainConfig(**kw))
    step = ttl.make_train_step(tm.loss, TrainConfig(**kw))
    for i in range(2):
        rb, tb = _batch(rm, tm, rows=4, seed=10 + i)
        rstate, rmet = rstep(rstate, rb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(rmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-4)
    want = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, rstate.params))
    for (path, leaf), (_, w) in zip(ttr.jax_leaves(mod.jax_tree()), want):
        err = np.linalg.norm(ttr.stacked(leaf).numpy() - w)
        assert err <= 1e-4 * np.linalg.norm(w), (path, err)


# ---------------------------------------------------------------------------
# checkpoints and the launchers
# ---------------------------------------------------------------------------

def _trained_port(steps: int = 2):
    rm, _, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    t = TrainConfig(lr=1e-3)
    state = ttl.TrainState.create(mod, t)
    step = ttl.make_train_step(tm.loss, t)
    for i in range(steps):
        state, _ = step(state, _batch(rm, tm, rows=2, seed=20 + i)[1])
    return state


def _ref_state(seed: int = 0):
    rcfg, _ = lp.cfgs(ARCH, compute_dtype="float32")
    return rtl.TrainState.create(rencdec.init(jax.random.key(seed), rcfg),
                                 RTrainConfig(lr=1e-3))


def _assert_port_equals_ref(port, ref):
    mine, theirs = ttr.state_to_jax_leaves(port), \
        jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(ttr.stacked(a).numpy(), np.asarray(b),
                                      err_msg=f"leaf {i}")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    port = _trained_port()
    ck.save(port, str(tmp_path), port.step)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jax.eval_shape(_ref_state))
    ref = rck.restore(str(tmp_path), zeros)
    assert int(ref.step) == 2
    _assert_port_equals_ref(port, ref)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_state(seed=2)
    rng = np.random.default_rng(5)
    ref = rtl.TrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(size=x.shape)).astype(x.dtype),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    rck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _trained_port(steps=1))
    assert port.step == 7
    _assert_port_equals_ref(port, ref)


@pytest.mark.parametrize("which", ["train", "serve"])
def test_launchers_refuse_the_family(which, monkeypatch):
    """Neither launcher can feed frames.  The reference's fail deep inside
    (serve: ``KeyError: 'frames'`` in prefill; train: a pytree mismatch
    between the batch and ``input_specs``); the port's raise a
    ``ValueError`` naming the frames before any ETL job starts."""
    import importlib

    from repro.distributed import sharding as rshd
    ref = importlib.import_module(f"repro.launch.{which}")
    port = importlib.import_module(f"repro_torch.launch.{which}")
    # the reference's launcher sets its process-wide mesh: restored after,
    # so later tests in this process run the reference without one
    monkeypatch.setattr(rshd, "_ACTIVE_MESH", rshd.get_active_mesh())
    argv = ["--arch", ARCH, "--reduced", "--batch", "2"]
    argv += ["--steps", "1", "--seq", "16"] if which == "train" else \
        ["--prompt-len", "8", "--max-new", "2"]
    with pytest.raises((KeyError, ValueError)):
        ref.main(argv)
    jobs = []
    monkeypatch.setattr(port, "EtlJob", lambda *a, **k: jobs.append(a))
    with pytest.raises(ValueError, match="frames"):
        port.main(argv + ["--device", "cpu"])
    assert jobs == []
