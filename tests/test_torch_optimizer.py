"""The port's optimizers against the JAX package's ``opt_update``: AdamW and
Adafactor over 3 steps, from the same parameters, state and seeded
gradients, on a tree with a stacked ``[2, 16, 24]`` leaf, stacked norm
leaves ``[1, 16]`` (unfactored) and ``[2, 16]`` (factored across its
layers), a 1-D leaf and an embed-like ``[64, 16]``.  The port holds a
stacked leaf as per-layer tensors, grouped by ``opt_init(leaves=)``.

The reference's ``opt_update`` runs eagerly: under ``jax.jit`` XLA
contracts some products into fused multiply-adds (1.6 % of one moment
update's elements round differently), which the port, written term by
term, does not.

Tolerances: a tensor stored in float32 within rtol 1e-5 (with an absolute
floor of 1e-6 x the tensor's largest magnitude: moments near zero come from
cancellation); a tensor stored in bfloat16 within one unit in the last
place.  The state's shapes equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TrainConfig as RTrainConfig  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

SHAPES = {"bias": (16,), "embed": (64, 16), "one": {"n1": (1, 16)},
          "stk": {"n2": (2, 16), "w": (2, 16, 24)}}
STACKED = {"one/n1", "stk/n2", "stk/w"}


def _paths(tree, prefix=""):
    out = []
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        out += (_paths(tree[k], p) if isinstance(tree[k], dict)
                else [(p, tree[k])])
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _port_layout(arrays: dict, dtype):
    """(per-layer tensors, leaves grouping) in the JAX flatten order."""
    params, leaves = [], []
    for path, _ in _paths(SHAPES):
        a = arrays[path]
        if path in STACKED:
            leaves.append(list(range(len(params), len(params) + a.shape[0])))
            params += [torch.tensor(x).to(dtype) for x in a]
        else:
            leaves.append(len(params))
            params.append(torch.tensor(a).to(dtype))
    return params, leaves


def flat_get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _stack(ts, leaf):
    if isinstance(leaf, list):
        return torch.stack([ts[i] for i in leaf])
    return ts[leaf]


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> integers in the values' order."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _assert_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    if got.dtype == torch.bfloat16:
        assert want.dtype == jnp.bfloat16, what
        g = _ordered(got.view(torch.int16).numpy().view(np.uint16))
        w = _ordered(want.view(np.uint16))
        ulps = np.abs(g - w).max(initial=0)
        assert ulps <= 1, (what, ulps)
        return
    assert got.dtype == torch.float32 and want.dtype == np.float32, what
    floor = 1e-6 * max(np.abs(want).max(initial=0), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=floor,
                               err_msg=what)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_steps_match_the_reference(optimizer, param_dtype,
                                         state_dtype):
    rng = np.random.default_rng(0)
    pdt = getattr(torch, param_dtype)
    kw = dict(optimizer=optimizer, opt_state_dtype=state_dtype, lr=1e-2,
              weight_decay=0.1)
    rt, tc = RTrainConfig(**kw), TrainConfig(**kw)
    flat = {p: rng.normal(size=s).astype(np.float32) for p, s in
            _paths(SHAPES)}
    rparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(param_dtype), _nest(flat))
    rstate = ropt.opt_init(rparams, rt)
    params, leaves = _port_layout(flat, pdt)
    state = topt.opt_init(params, tc, leaves=leaves)
    for step in range(3):
        # step 1's gradients are small: the clip scale is 1 there
        scale = 1e-3 if step == 1 else 1.0
        gflat = {p: (rng.normal(size=s) * scale).astype(np.float32)
                 for p, s in _paths(SHAPES)}
        rgrads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(param_dtype), _nest(gflat))
        grads, _ = _port_layout(gflat, pdt)
        # eagerly: under jit XLA contracts some products into FMAs
        rparams, rstate, rnorm = ropt.opt_update(rgrads, rstate, rparams,
                                                 jnp.int32(step), rt)
        norm = topt.opt_update(params, grads, state, step, tc)
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-5)
        for i, (path, _) in enumerate(_paths(SHAPES)):
            leaf = leaves[i]
            w = flat_get(rparams, path)
            _assert_close(_stack(params, leaf), w, f"step {step} {path}")
            if optimizer == "adamw":
                for k in ("m", "v"):
                    _assert_close(_stack(state[k], leaf),
                                  flat_get(rstate[k], path),
                                  f"step {step} {k} {path}")
            else:
                want = flat_get(rstate["f"], path)
                assert sorted(state["f"][i]) == sorted(want), path
                for k, v in state["f"][i].items():
                    _assert_close(v, want[k], f"step {step} {k} {path}")


def test_adafactor_state_shapes_follow_the_stacked_leaves():
    """[1, 16] is unfactored (one layer), [2, 16] factored across its two
    layers ([2] and [16]), [2, 16, 24] factored per layer."""
    flat = {p: np.zeros(s, np.float32) for p, s in _paths(SHAPES)}
    params, leaves = _port_layout(flat, torch.float32)
    st = topt.opt_init(params, TrainConfig(optimizer="adafactor"),
                       leaves=leaves)
    shapes = {p: {k: tuple(v.shape) for k, v in s.items()}
              for (p, _), s in zip(_paths(SHAPES), st["f"])}
    assert shapes == {"bias": {"v": (16,)},
                      "embed": {"vr": (64,), "vc": (16,)},
                      "one/n1": {"v": (1, 16)},
                      "stk/n2": {"vr": (2,), "vc": (16,)},
                      "stk/w": {"vr": (2, 16), "vc": (2, 24)}}
    ref = ropt.adafactor_init(_nest({p: jnp.asarray(a)
                                     for p, a in flat.items()}),
                              RTrainConfig(optimizer="adafactor"))
    for path, want in shapes.items():
        got = {k: tuple(v.shape) for k, v in flat_get(ref["f"],
                                                       path).items()}
        assert got == want, path


def test_clipped_gradient_is_rounded_to_its_dtype():
    """The clip's product is rounded to the gradient's dtype before the
    update, as the reference's ``clip_by_global_norm`` does."""
    g = torch.tensor([1.0 + 2 ** -9, 3.0], dtype=torch.bfloat16)
    scale = torch.tensor(0.9)
    want = (g.float() * scale).to(torch.bfloat16).float()
    assert torch.equal(topt._clipped(g, scale), want)
    assert not torch.equal(want, g.float() * scale)
