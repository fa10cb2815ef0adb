"""The port's VLM prefix (``internvl2_2b``) against the JAX package's: the
logits, loss and gradients with ``patch_embeds`` prepended to the text,
the loss over the text positions only, ``input_specs`` and
``random_batch`` for every arch of the ported families at every shape
cell, text-only serving (the reference's ``prefill`` takes no patches)
and the launcher, which feeds text alone as the reference's does.

Tolerances (ROADMAP's LM tolerances): float32 compute: logits within rtol
1e-4 (absolute floor 1e-4 x the largest), the loss rtol 1e-5, gradient
leaves 1e-4 in relative norm; bfloat16 compute: 3e-2 x the largest, the
loss rtol 2e-3, gradients 5e-2.  ``random_batch`` is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_pair as lp  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import ALL_SHAPES as RSHAPES  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ALL_SHAPES, ShapeCfg  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCH = "internvl2_2b"
SHAPE = ShapeCfg("t", 40, 2, "train")


def _batch(tcfg, rcfg, seed=3):
    from repro.configs.base import ShapeCfg as RShapeCfg
    want = rapi.random_batch(rcfg, RShapeCfg("t", 40, 2, "train"), seed=seed)
    got = api.random_batch(tcfg, SHAPE, seed=seed, device="cpu")
    return want, got


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefix_logits_loss_and_grads_match(compute):
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype=compute)
    want_b, got_b = _batch(tm.cfg, rm.cfg)
    assert got_b["patch_embeds"].shape == (2, 8, tm.cfg.d_model)
    want_logits = rm.forward(params, want_b)
    want_loss, want_g = jax.value_and_grad(rm.loss)(params, want_b)
    with torch.no_grad():
        got_logits = tm.forward(mod, got_b)
    assert got_logits.shape == (2, 40, tm.cfg.padded_vocab)
    lp.logits_close(want_logits, got_logits, compute)
    loss = tm.loss(mod, got_b)
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


def test_loss_counts_text_positions_only():
    _, _, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    _, b = _batch(tm.cfg, lp.cfgs(ARCH)[0])
    P = b["patch_embeds"].shape[1]
    with torch.no_grad():
        logits = mod(b["tokens"], b["patch_embeds"])
        want = L.cross_entropy(logits[:, P:], b["labels"],
                               valid_vocab=tm.cfg.vocab_size)
        got = mod.loss_fn(b)
        text_only = mod.loss_fn({k: b[k] for k in ("tokens", "labels")})
    assert torch.equal(got, want)
    assert not torch.equal(got, text_only)  # the prefix moves the text


def test_prefix_is_cast_to_the_compute_dtype():
    """A float32 prefix joins bfloat16 text embeddings in bfloat16."""
    _, tcfg = lp.cfgs(ARCH)
    mod = api.build_model(tcfg).init(device="cpu")
    b = api.random_batch(tcfg, SHAPE, device="cpu")
    with torch.no_grad():
        x = mod.hidden_states(b["tokens"], b["patch_embeds"])
    assert x.dtype == torch.bfloat16 and x.shape[1] == 40


def test_input_specs_match_for_every_arch_and_shape():
    """Every arch of the ported families at its full config, every shape
    cell: the reference's names, shapes and dtypes (a VLM trains on
    ``n_patches`` patch embeddings and ``max(S - n_patches, 1)`` text
    tokens; its prefill and decode take tokens alone)."""
    for arch in lp.PORTED:
        rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
        for rs, s in zip(RSHAPES, ALL_SHAPES):
            want = rapi.input_specs(rcfg, rs)
            got = api.input_specs(tcfg, s)
            assert list(got) == list(want), (arch, s.name)
            for k, spec in want.items():
                assert got[k][0] == spec.shape, (arch, s.name, k)
                assert str(got[k][1]).removeprefix("torch.") == \
                    spec.dtype.name, (arch, s.name, k)


@pytest.mark.parametrize("arch", lp.PORTED)
def test_random_batch_matches_at_every_shape(arch):
    """``random_batch`` at the reduced config for each shape cell's kind
    and geometry: the same seed gives the same arrays (patch embeddings
    drawn first, as float32 normals)."""
    rcfg, tcfg = lp.cfgs(arch)
    for rs, s in zip(RSHAPES, ALL_SHAPES):
        want = rapi.random_batch(rcfg, rs, seed=4)
        got = api.random_batch(tcfg, s, seed=4, device="cpu")
        assert list(got) == list(want), (arch, s.name)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{arch} {s.name} {k}")


def test_text_only_serving_matches_the_reference():
    """The VLM serves its text: prefill's logits and cache and a decode
    step against the reference's (which ignores ``patch_embeds``)."""
    rm, params, tm, mod = lp.pair(ARCH, compute_dtype="float32")
    tok = lp.tokens(tm.cfg.vocab_size, 2, 13, seed=6)
    lg, rc = rm.prefill(params, {"tokens": jnp.asarray(tok[:, :12])}, 16)
    tlg, tc = tm.prefill(mod, {"tokens": torch.tensor(tok[:, :12])}, 16)
    lp.logits_close(lg, tlg, "float32")
    lp.cache_close(rc, tc, "float32")
    lg, _ = rm.decode_step(params, rc, jnp.asarray(tok[:, 12:]),
                           jnp.int32(12))
    tlg, _ = tm.decode_step(mod, tc, torch.tensor(tok[:, 12:]), 12)
    lp.logits_close(lg, tlg, "float32")


def test_launcher_trains_the_vlm_on_text(monkeypatch):
    """The launcher feeds tokens and labels alone (the reference's
    launcher does too): the VLM trains text-only at its preset's
    microbatch 2."""
    from repro_torch.launch import train as launch
    seen = []
    real = launch.make_train_step

    def tapped(loss_fn, tc):
        assert tc.microbatch == 2
        step = real(loss_fn, tc)

        def run(state, batch):
            assert sorted(batch) == ["labels", "tokens"]
            state, m = step(state, batch)
            seen.append(float(m["loss"]))
            return state, m
        return run

    monkeypatch.setattr(launch, "make_train_step", tapped)
    out = launch.main(["--device", "cpu", "--reduced", "--arch", ARCH,
                       "--steps", "2", "--batch", "4", "--seq", "16"])
    assert out["state"].step == 2 and np.isfinite(seen).all()
    assert out["state"].model.cfg.family == "vlm"
