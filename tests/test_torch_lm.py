"""The port's dense-transformer LM side against the JAX package's: configs,
layers, the model, microbatching, the train step, checkpoints and the
ETL-fed launcher, from the same parameters (the JAX init exported through
numpy, ``models/api.params_from_jax``) on the same seeded numpy batches.

Tolerances (stated once, used below):
- float32 compute: logits within rtol 1e-4 (absolute floor 1e-4 x the
  largest logit), the loss within rtol 1e-5, each gradient leaf within a
  relative norm error of 1e-4 (measured: ~1e-6 on every config);
- bfloat16 compute: logits within 3e-2 x the largest logit, the loss within
  rtol 2e-3, each gradient leaf within a relative norm error of 5e-2
  (measured: 0.8-1.2 %, 0.01-0.03 % and 1.3-1.8 %: the two frameworks round
  the same bf16 products in different orders);
- layer functions (flash attention, cross-entropy) in float32: rtol 1e-5.

Labels follow the reference's one-hot semantics: a label outside ``[0, V)``
contributes ``lse`` and raises nothing (``lm_token_pipeline`` passes labels
through unhashed, so most are out of range).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import ShapeCfg as RShapeCfg  # noqa: E402
from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as rL  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import grad as rgrad  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ShapeCfg, TrainConfig  # noqa: E402
from repro_torch.launch import presets  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import grad  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["llama3_2_3b", "qwen3_32b", "chatglm3_6b", "llama3_405b"]


def _cfgs(arch: str, **kw):
    return (dataclasses.replace(rreg.get_reduced(arch), **kw),
            dataclasses.replace(treg.get_reduced(arch), **kw))


def _pair(arch: str, seed: int = 0, **kw):
    """(ref cfg, ref params, port cfg, port model) with equal parameters."""
    rcfg, tcfg = _cfgs(arch, **kw)
    params = rtr.init(jax.random.key(seed), rcfg)
    model = ttr.Transformer(tcfg, device="cpu")
    api.params_from_jax(model, jax.tree_util.tree_map(np.asarray, params))
    return rcfg, params, tcfg, model


def _batch(vocab: int, padded: int, rows: int = 2, seq: int = 16,
           seed: int = 0) -> dict:
    """Tokens in range; labels mostly out of range, some negative, some
    ignored (-100), as ``lm_token_pipeline`` delivers them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    lab = rng.integers(-2, 2 * padded, (rows, seq)).astype(np.int32)
    lab[0, :3] = -100
    return {"tokens": tok, "labels": lab}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _port_grads(model) -> list:
    """``[(path, grad)]`` in the JAX flatten order, blocks stacked."""
    return [(p, ttr.stacked([t.grad for t in leaf]) if isinstance(leaf, list)
             else leaf.grad) for p, leaf in ttr.jax_leaves(model.jax_tree())]


def _assert_grads(model, ref_grads, rel: float):
    ref = ttr.jax_leaves(jax.tree_util.tree_map(np.asarray, ref_grads))
    mine = _port_grads(model)
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, g), (_, want) in zip(mine, ref):
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(g.float().numpy() - want)
        assert err <= rel * max(np.linalg.norm(want), 1e-30), (path, err)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_configs_are_copies(arch):
    for get in ("get_config", "get_reduced"):
        want = getattr(rreg, get)(arch)
        got = getattr(treg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.padded_vocab == want.padded_vocab
    assert treg.canonical(arch.replace("_", "-")) == rreg.canonical(
        arch.replace("_", "-"))
    assert presets.train_preset(arch) == TrainConfig(
        **dataclasses.asdict(__import__(
            "repro.launch.presets", fromlist=["x"]).train_preset(arch)))


def test_dtypes_are_torch_dtypes():
    cfg = treg.get_config("llama3_405b")
    assert cfg.pdtype() is torch.bfloat16 and cfg.cdtype() is torch.bfloat16
    assert treg.get_reduced("llama3_405b").pdtype() is torch.float32


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_params_from_jax_layout():
    rcfg, params, tcfg, model = _pair("llama3_2_3b")
    mats = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    assert mats == tcfg.param_count()  # tied, padded_vocab == vocab here
    np.testing.assert_array_equal(model.blocks[1].attn["wq"].detach().numpy(),
                                  np.asarray(params["blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  np.asarray(params["embed"]))
    assert model.embed.shape[0] == tcfg.padded_vocab


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
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


def test_untied_head_and_gelu_layernorm_match():
    """The layers no dense preset uses together: an untied ``lm_head``,
    ``layernorm`` and the gelu MLP."""
    rcfg, params, tcfg, model = _pair("llama3_2_3b", compute_dtype="float32",
                                      tie_embeddings=False, norm="layernorm",
                                      mlp="gelu")
    b = _batch(tcfg.vocab_size, tcfg.padded_vocab, seed=3)
    loss, grads = jax.value_and_grad(
        lambda p: rtr.loss_fn(p, _jb(b), rcfg))(params)
    tl = model.loss_fn(_tb(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(loss), rtol=1e-5)
    _assert_grads(model, grads, 1e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_sliding_window_attention_matches(window):
    rcfg, params, tcfg, model = _pair("llama3_2_3b", compute_dtype="float32",
                                      sliding_window=window)
    b = _batch(tcfg.vocab_size, tcfg.padded_vocab, seed=4)
    want = np.asarray(rtr.forward(params, _jb(b)["tokens"], rcfg))
    with torch.no_grad():
        got = model(_tb(b)["tokens"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6), (False, 0)])
def test_flash_attention_matches_reference(causal, window):
    rng = np.random.default_rng(7)
    B, S, H, D = 2, 32, 4, 8
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(rL.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=causal, window=window, q_chunk=8,
        k_chunk=8))
    got = L.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            torch.tensor(pos), torch.tensor(pos),
                            causal=causal, window=window, q_chunk=8,
                            k_chunk=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_long_sequences_take_the_flash_path(monkeypatch):
    """Past ``FLASH_THRESHOLD`` both packages switch to the chunked path
    (threshold lowered in both, so a small sequence takes it); the chunked
    attention equals the dense one."""
    rcfg, params, tcfg, model = _pair("qwen3_32b", compute_dtype="float32")
    b = _batch(tcfg.vocab_size, tcfg.padded_vocab, seq=32, seed=5)
    with torch.no_grad():
        dense = model(_tb(b)["tokens"]).numpy()
    monkeypatch.setattr(rL, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 8)
    calls = []
    orig = L.flash_attention
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(
                            *a, **{**k, "q_chunk": 8, "k_chunk": 8}))
    want = np.asarray(rtr.forward(params, _jb(b)["tokens"], rcfg))
    with torch.no_grad():
        got = model(_tb(b)["tokens"]).numpy()
    assert calls
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, dense, rtol=1e-4,
                               atol=1e-4 * np.abs(dense).max())


@pytest.mark.parametrize("valid", [0, 40, 64])
def test_cross_entropy_matches_reference(valid):
    """Padded vocabularies (logits past ``valid_vocab`` masked) and labels
    out of range in every way: >= V, negative, in [valid_vocab, V), and the
    ignored -100."""
    rng = np.random.default_rng(valid)
    V = 64
    logits = rng.normal(size=(3, 10, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (3, 10)).astype(np.int32)
    labels[0, :4] = [V, 5 * V, -1, -100]
    labels[1, :2] = [V - 1, 41]
    f = lambda lg: rL.cross_entropy(lg, jnp.asarray(labels),  # noqa: E731
                                    valid_vocab=valid)
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    got = L.cross_entropy(t, torch.tensor(labels), valid_vocab=valid)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


def test_cross_entropy_all_labels_out_of_range_is_lse():
    logits = torch.randn(4, 9, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([9, 100, -3, 2 ** 22], dtype=torch.int32)
    got = L.cross_entropy(logits, labels)
    assert torch.allclose(got, torch.logsumexp(logits, -1).mean())


def test_random_batch_and_input_specs_match():
    rcfg, tcfg = _cfgs("llama3_2_3b")
    rshape, shape = RShapeCfg("t", 16, 4, "train"), ShapeCfg("t", 16, 4,
                                                             "train")
    want = rapi.random_batch(rcfg, rshape, seed=3)
    got = api.random_batch(tcfg, shape, seed=3, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    specs = api.input_specs(tcfg, shape)
    for k, s in rapi.input_specs(rcfg, rshape).items():
        assert specs[k][0] == s.shape and specs[k][1] == torch.int32


# ---------------------------------------------------------------------------
# microbatching and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro,accum", [(2, "float32"), (4, "float32"),
                                           (2, "bfloat16")])
def test_microbatched_value_and_grad_matches_reference(n_micro, accum):
    rcfg, params, tcfg, model = _pair("llama3_2_3b", compute_dtype="float32")
    b = _batch(tcfg.vocab_size, tcfg.padded_vocab, rows=8, seed=6)
    rfn = rgrad.microbatched_value_and_grad(
        lambda p, bb: rtr.loss_fn(p, bb, rcfg), n_micro, accum_dtype=accum)
    loss, grads = rfn(params, _jb(b))
    fn = grad.microbatched_value_and_grad(ttr.loss_fn, n_micro,
                                          accum_dtype=accum)
    tl, tg = fn(model, _tb(b))
    assert all(p.grad is None for p in model.parameters())
    assert all(g.dtype == getattr(torch, accum) for g in tg)
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    for p, g in zip(model.parameters(), tg):
        p.grad = g.float()
    _assert_grads(model, grads, 1e-4 if accum == "float32" else 1e-2)


def test_microbatches_accumulate_in_place_into_grad():
    """At the parameters' dtype each chunk's backward adds into one set of
    gradient buffers (no accumulator beside them), and the result equals
    the whole batch's gradient."""
    _, _, _, model = _pair("llama3_2_3b", compute_dtype="float32")
    raw = _batch(512, 512, rows=4, seed=8)
    raw["labels"][0, :3] = 7  # no ignored label: equal counts per chunk
    b = _tb(raw)
    seen = []
    orig = ttr.Transformer.loss_fn

    def loss_fn(m, batch):
        seen.append([p.grad.data_ptr() if p.grad is not None else None
                     for p in m.parameters()])
        return orig(m, batch)

    l2, g2 = grad.microbatched_value_and_grad(loss_fn, 2)(model, b)
    assert all(x is None for x in seen[0])  # the first chunk allocates
    assert seen[1] == [g.data_ptr() for g in g2]  # the second adds into it
    l1, g1 = grad.microbatched_value_and_grad(ttr.loss_fn, 1)(model, b)
    torch.testing.assert_close(l2, l1, rtol=1e-5, atol=0)
    for a, c in zip(g2, g1):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)


def test_adamw_step_at_microbatch_2_matches_reference():
    rcfg, params, tcfg, model = _pair("llama3_2_3b", seed=1,
                                      compute_dtype="float32")
    rt = RTrainConfig(lr=3e-3, microbatch=2)
    t = TrainConfig(lr=3e-3, microbatch=2)
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


def test_dlrm_step_unchanged_at_microbatch_0_and_1():
    """``microbatch`` 0 and 1 are one gradient over the whole batch: the
    DLRM step gives bit-identical parameters either way."""
    from repro_torch.models import dlrm
    cfg = dlrm.DLRMConfig(vocab_size=33, d_emb=4, bot_mlp=(8, 4),
                          top_mlp=(8, 1))
    rng = np.random.default_rng(0)
    batch = {"dense": torch.tensor(rng.normal(size=(16, 16)),
                                   dtype=torch.float32),
             "sparse": torch.tensor(rng.integers(0, 33, (16, 32)),
                                    dtype=torch.int32),
             "label": torch.tensor(rng.integers(0, 2, 16),
                                   dtype=torch.float32)}
    out = []
    for mb in (0, 1):
        model = dlrm.DLRM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        tc = TrainConfig(lr=1e-2, microbatch=mb)
        state = ttl.TrainState.create(model, tc)
        step = ttl.make_train_step(dlrm.loss_fn, tc)
        for _ in range(2):
            state, m = step(state, batch)
        out.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_remat_policies_give_equal_gradients():
    grads = {}
    for remat in ("full", "dots", "none"):
        _, _, _, model = _pair("chatglm3_6b", compute_dtype="float32",
                               remat=remat)
        model.loss_fn(_tb(_batch(512, 512, rows=2, seed=9))).backward()
        grads[remat] = [p.grad for p in model.parameters()]
    for remat in ("dots", "none"):
        for a, b in zip(grads["full"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_ef_init_matches_reference():
    """Float32 zeros shaped like the parameters, in the same tree, whatever
    the parameters' dtype."""
    tree = {"w": np.ones((3, 4), np.float32), "b": [np.ones((5,), np.int8)],
            "h": np.ones((2,), np.float16)}
    want = rgrad.ef_init(jax.tree_util.tree_map(jnp.asarray, tree))
    got = grad.ef_init({"w": torch.ones(3, 4), "b": [torch.ones(5,
                                                                dtype=torch.int8)],
                        "h": torch.ones(2, dtype=torch.bfloat16)})
    assert got.keys() == want.keys() and isinstance(got["b"], list)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, _, _, model = _pair("llama3_2_3b")
    ef = grad.ef_init(list(model.parameters()))
    assert [tuple(e.shape) for e in ef] == \
        [tuple(p.shape) for p in model.parameters()]
    assert all(e.dtype == torch.float32 and not e.any() for e in ef)


def test_int8_quantization_matches_reference():
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32) * 3
    rq, rs = rgrad.quantize_int8(jnp.asarray(x))
    q, s = grad.quantize_int8(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    err = (grad.dequantize_int8(q, s) - torch.tensor(x)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6
    np.testing.assert_array_equal(grad.split_microbatches(
        {"x": torch.zeros(8, 3)}, 4)["x"].shape, (4, 2, 3))


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _trained_port(steps: int = 2):
    _, _, tcfg, model = _pair("qwen3_32b", compute_dtype="float32")
    t = TrainConfig(lr=1e-3, microbatch=2)
    state = ttl.TrainState.create(model, t)
    step = ttl.make_train_step(ttr.loss_fn, t)
    for i in range(steps):
        state, _ = step(state, _tb(_batch(tcfg.vocab_size, tcfg.padded_vocab,
                                          rows=4, seed=30 + i)))
    return state


def _assert_port_equals_ref(port, ref):
    mine = ttr.state_to_jax_leaves(port)
    theirs = jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        a = ttr.stacked(a).numpy() if isinstance(a, list) else a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    port = _trained_port()
    ck.save(port, str(tmp_path), port.step)
    rcfg, _ = _cfgs("qwen3_32b", compute_dtype="float32")
    shapes = jax.eval_shape(lambda: rtl.TrainState.create(
        rtr.init(jax.random.key(0), rcfg), RTrainConfig(lr=1e-3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = rck.restore(str(tmp_path), zeros)
    assert int(ref.step) == 2
    _assert_port_equals_ref(port, ref)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rcfg, _ = _cfgs("qwen3_32b", compute_dtype="float32")
    ref = rtl.TrainState.create(rtr.init(jax.random.key(2), rcfg),
                                RTrainConfig(lr=1e-3))
    rng = np.random.default_rng(5)
    ref = rtl.TrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(x.dtype)),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    rck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _trained_port(1))
    assert port.step == 7
    _assert_port_equals_ref(port, ref)


# ---------------------------------------------------------------------------
# the launcher and what is not ported
# ---------------------------------------------------------------------------

def test_launcher_completes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", "llama3_2_3b", "--steps", "10", "--batch",
         "4", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
         "5"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] step=10 " in out.stdout and "tok/s" in out.stdout
    assert "stage transform" in out.stdout
    assert ck.latest_step(str(tmp_path)) == 10


def test_launcher_feeds_the_pipelines_batches(monkeypatch):
    """In process: the delivered batches are ``lm_token_pipeline``'s on the
    source's raw batches (the cuda backend's plain versions here), labels
    out of range included, and each step's loss is finite."""
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source
    from repro_torch.launch import train as launch
    seen = []
    real = launch.make_train_step

    def tapped(loss_fn, tcfg):
        assert tcfg.microbatch == 2  # the llama3_2_3b preset
        step = real(loss_fn, tcfg)

        def run(state, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(launch, "make_train_step", tapped)
    losses = []
    out = launch.main(["--device", "cpu", "--reduced", "--arch",
                       "llama3_2_3b", "--steps", "3", "--batch", "4",
                       "--seq", "16"])
    assert out["state"].step == 3 and len(seen) == 3
    assert len(losses) == 3 and all(np.isfinite(losses))
    plain = lm_token_pipeline(16, 512, batch_size=4).compile("numpy")
    raws = list(Source.lm_events(16, rows=4 * 7, batch_size=4))
    for got, raw in zip(seen, raws):
        want = plain(raw)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert (seen[0]["labels"] >= 512).any()


@pytest.mark.parametrize("argv,what", [
    (["--arch", "llama3_2_3b", "--reduced", "--mesh", "pod"],
     "no process group"),
    (["--arch", "llama3_405b", "--reduced", "--mesh", "multipod"],
     "no process group"),
    (["--arch", "mixtral_8x7b", "--reduced", "--mesh", "pod"],
     "no process group"),
    (["--arch", "zamba2_2_7b", "--reduced", "--mesh", "pod"],
     "no process group")])
def test_launcher_raises_for_what_is_not_ported(argv, what):
    """``--mesh pod`` / ``multipod`` build the production mesh, whose 256 /
    512 ranks one process without a world does not have, whatever the
    family (on 4 ranks the mesh's ``ValueError``, and a family the model
    axis does not cover raises in ``shard_train_step``:
    ``tests/test_torch_tensor_parallel.py``; ``--mesh host`` is data
    parallel: ``tests/test_torch_distributed.py``); the Adafactor, fsdp and
    MoE presets train (``tests/test_torch_moe.py``), and so do the VLM, the
    SSM and the hybrid (``tests/test_torch_vlm.py``,
    ``tests/test_torch_ssm.py``, ``tests/test_torch_hybrid.py``)."""
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError, match=what):
        launch.main(argv + ["--device", "cpu", "--steps", "1"])


def test_int8_gradient_compression_raises_naming_item_3(monkeypatch):
    """Every preset, and ``grad_compression="int8_ef"``, is accepted: the
    launcher trains with it, which (as the reference's) no train step
    reads."""
    from repro_torch.launch import train as launch
    for arch in treg.ARCH_IDS:
        assert isinstance(presets.train_preset(arch), TrainConfig)
    int8 = dataclasses.replace(presets.train_preset("llama3_2_3b"),
                               grad_compression="int8_ef")
    monkeypatch.setattr(launch, "train_preset", lambda arch: int8)
    out = launch.main(["--arch", "llama3_2_3b", "--reduced", "--device",
                       "cpu", "--steps", "1", "--batch", "2", "--seq", "16"])
    assert out["state"].step == 1


@pytest.mark.parametrize("arch,item", [("zamba2_2_7b", "hybrid"),
                                       ("whisper_base", "enc-dec")])
def test_other_families_raise_naming_their_item(arch, item):
    """The families that once raised here (hybrid and enc-dec, ROADMAP
    Queue A items of those names) now build through ``build_model`` into
    their own module's class, while ``Transformer`` refuses their configs
    as not a transformer's."""
    cfg = treg.get_reduced(arch)
    module = api.build_model(cfg).init(device="cpu")
    assert type(module).__module__ == \
        f"repro_torch.models.{item.replace('-', '')}"
    assert "tokens" in api.input_specs(cfg, ShapeCfg("t", 8, 1, "train"))
    with pytest.raises(ValueError, match="is not a transformer's"):
        ttr.Transformer(cfg, device="cpu")


@pytest.mark.parametrize("seq", [64, 1024])
def test_lm_token_pipeline_lowers_and_packs_as_the_reference(seq):
    """The launcher's ETL: the port's cuda plan lowers tokens and labels as
    the reference's pallas plan does (grouped at seq 64; at seq 1024 one
    fused output each: the grouped tile is over budget), and both deliver
    the same batches (labels unhashed, mostly >= the vocabulary)."""
    from repro.core.pipeline import lm_token_pipeline as rpipe
    from repro.data.source import Source as RSource
    from repro_torch.core.pipeline import lm_token_pipeline
    ref = rpipe(seq, 128256, batch_size=4).compile("pallas")
    port = lm_token_pipeline(seq, 128256, batch_size=4).compile(
        "cuda", device="cpu")
    paths = {k: v["path"] for k, v in port.lowering_report().items()}
    assert paths == {k: v["path"] for k, v in ref.lowering_report().items()}
    assert set(paths.values()) == ({"grouped"} if seq == 64 else {"fused"})
    raw = next(iter(RSource.lm_events(seq, rows=4, batch_size=4)))
    want, got = ref(raw), port(raw)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["labels"] >= 128256).any()
