"""AdamW and Adafactor with global-norm clipping, written out (the JAX
package's ``training/optimizer.py``: adamw_update, adafactor_update and
opt_update).

Dtype policy (the reference's): moments and second-moment factors are
stored in ``opt_state_dtype``; every update runs in float32 whatever the
storage dtype, and each result is cast once to the dtype it is stored in.
The clipped gradient is rounded back to the gradient's dtype before the
update, as ``clip_by_global_norm`` does.

The update runs one tensor at a time, so the full-width models need only
that tensor's float32 temporaries beside params, grads and state (for
AdamW in float32 the moments update in place).

Adafactor's state is keyed by the model's JAX leaves, not by parameter: a
stacked ``blocks/*`` leaf ``[L, ...]`` is one leaf whose per-layer tensors
are separate parameters here.  Its factors have the stacked shapes
(``vr`` ``[L, rows]``, ``vc`` ``[L, cols]``), a stacked vector ``[L, d]``
with ``L >= 2`` is factored across its layers, and the update clipping's
RMS is taken over the whole stacked leaf.  ``opt_init(..., leaves=)``
takes the grouping (``Transformer.param_leaves``); without it every
parameter is its own leaf (a DLRM's).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig

AF_EPS = 1e-30     # Adafactor's epsilon
AF_CLIP = 1.0      # Adafactor's update clipping threshold (RMS)


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, in float32 (a norm
    reduction per tensor, so no gradient-sized square is materialized)."""
    norms = [torch.linalg.vector_norm(g.to(torch.float32)) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def _clipped(g, scale) -> torch.Tensor:
    """``g`` times the clip scale, rounded to ``g``'s dtype, as float32
    (a 16-bit ``g``'s float32 product is freed before the last cast)."""
    if scale is None:
        return g.to(torch.float32)
    c = (g.to(torch.float32) * scale).to(g.dtype)
    return c.to(torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, tcfg: TrainConfig) -> dict:
    dt = getattr(torch, tcfg.opt_state_dtype)
    return {"m": [torch.zeros_like(p, dtype=dt) for p in params],
            "v": [torch.zeros_like(p, dtype=dt) for p in params]}


def _f32_pow_complement(base: float, exp: float) -> float:
    """``1 - base ** exp`` in float32, as the reference computes its bias
    corrections and Adafactor's ``beta2`` (the step count is float32)."""
    return float(np.float32(1.0) - np.float32(base) ** np.float32(exp))


def _adamw(params, grads, state, step, scale, tcfg):
    # the reference's expressions, term by term (no fused multiply-adds),
    # with at most two parameter-sized float32 temporaries alive
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    c1 = _f32_pow_complement(b1, step + 1)
    c2 = _f32_pow_complement(b2, step + 1)
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = _clipped(g, scale)
        # float32 moments: in place when stored in float32, else a copy
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m32.mul_(b1).add_(g * (1 - b1))             # b1 m + (1 - b1) g
        v32.mul_(b2).add_((g * (1 - b2)).mul_(g))   # b2 v + (1 - b2) g g
        del g
        den = torch.div(v32, c2).sqrt_().add_(eps)  # sqrt(v / c2) + eps
        upd = torch.div(m32, c1).div_(den)          # (m / c1) / den
        del den
        upd.add_(p * tcfg.weight_decay).mul_(tcfg.lr)
        p.sub_(upd)  # in float32, rounded once to p's dtype
        del upd
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
        del m32, v32


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; memory ~ O(rows + cols) per matrix)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def leaf_shape(leaf, params) -> tuple:
    """The JAX shape of a leaf: a parameter index, or a list of per-layer
    indices (the stacked ``[L, ...]`` leaf)."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(params[leaf[0]].shape)
    return tuple(params[leaf].shape)


def adafactor_init(params, tcfg: TrainConfig, leaves=None) -> dict:
    """``{"f": [state per leaf], "leaves": leaves}``: ``{"vr", "vc"}`` for a
    factored leaf, ``{"v"}`` otherwise, in the leaf's stacked shape."""
    dt = getattr(torch, tcfg.opt_state_dtype)
    if leaves is None:
        leaves = list(range(len(params)))
    dev = params[0].device if params else None
    f = []
    for leaf in leaves:
        s = leaf_shape(leaf, params)
        if _factored(s):
            f.append({"vr": torch.zeros(s[:-1], dtype=dt, device=dev),
                      "vc": torch.zeros(s[:-2] + s[-1:], dtype=dt,
                                        device=dev)})
        else:
            f.append({"v": torch.zeros(s, dtype=dt, device=dev)})
    return {"f": f, "leaves": list(leaves)}


def _af_stats(g, st, b2, omb2) -> dict:
    """This step's float32 second-moment statistics of one part."""
    g2 = g.square().add_(AF_EPS)
    if "vr" in st:
        return {"vr": st["vr"].to(torch.float32) * b2 + omb2 * g2.mean(-1),
                "vc": st["vc"].to(torch.float32) * b2 + omb2 * g2.mean(-2)}
    return {"v": st["v"].to(torch.float32) * b2 + omb2 * g2}


def _af_u(g, stats) -> torch.Tensor:
    """The unclipped update ``g / sqrt(second moment)`` in float32."""
    if "vr" in stats:
        vr, vc = stats["vr"], stats["vc"]
        r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=AF_EPS)
        u = r[..., :, None] * vc[..., None, :]
    else:
        u = stats["v"].clone()
    return u.clamp_(min=AF_EPS).rsqrt_().mul_(g)


def _adafactor(params, grads, state, step, scale, tcfg):
    b2 = _f32_pow_complement(step + 1, -0.8)  # the paper's schedule
    omb2 = float(np.float32(1.0) - np.float32(b2))
    lr, wd = tcfg.lr, tcfg.weight_decay
    for leaf, st in zip(state["leaves"], state["f"]):
        # the parts of the leaf whose statistics are their own: (param,
        # grad, state views, per-layer params to write back)
        if not isinstance(leaf, list):
            units = [(params[leaf], grads[leaf], st, None)]
        elif "vr" in st and params[leaf[0]].dim() == 1:
            # a stacked vector [L >= 2, d]: its factors span the layers
            ps = [params[i] for i in leaf]
            units = [(torch.stack(ps), torch.stack([grads[i] for i in leaf]),
                      st, ps)]
        else:
            units = [(params[j], grads[j], {k: v[i] for k, v in st.items()},
                      None) for i, j in enumerate(leaf)]
        # pass 1: the statistics and sum(u^2) over the whole leaf
        stats, total, n = [], None, 0
        for _, g, sv, _ in units:
            g = _clipped(g, scale)
            s = _af_stats(g, sv, b2, omb2)
            stats.append(s)
            sq = _af_u(g, s).square_().sum()
            total = sq if total is None else total + sq
            n += g.numel()
            del g
        rms_u = torch.sqrt(total / n + AF_EPS)
        den = torch.clamp(rms_u / AF_CLIP, min=1.0)
        # pass 2: recompute u, clip it, apply it, store the statistics
        for (p, g, sv, back), s in zip(units, stats):
            u = _af_u(_clipped(g, scale), s).div_(den)
            u.mul_(lr).neg_().add_(p)      # p - lr u
            u.sub_(p * (lr * wd))          # - lr wd p
            if back is None:
                p.copy_(u)
            else:
                for i, q in enumerate(back):
                    q.copy_(u[i])
            del u
            for k, v in s.items():
                sv[k].copy_(v)
        del units, stats


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def opt_init(params, tcfg: TrainConfig, leaves=None) -> dict:
    """The optimizer state of ``params`` (a list); ``leaves`` groups them
    into the JAX leaves Adafactor keys its state by (AdamW's is per
    parameter)."""
    if tcfg.optimizer == "adamw":
        return adamw_init(params, tcfg)
    if tcfg.optimizer == "adafactor":
        return adafactor_init(params, tcfg, leaves)
    raise ValueError(tcfg.optimizer)


@torch.no_grad()
def opt_update(params, grads, state: dict, step: int,
               tcfg: TrainConfig) -> torch.Tensor:
    """Clip ``grads`` to ``max_grad_norm`` (global norm), then one
    optimizer step in place on ``params`` and ``state``.  Returns the
    pre-clip global norm."""
    gnorm = global_norm(grads)
    scale = None
    if tcfg.max_grad_norm:
        scale = torch.clamp(tcfg.max_grad_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    if tcfg.optimizer == "adamw":
        _adamw(params, grads, state, step, scale, tcfg)
    elif tcfg.optimizer == "adafactor":
        _adafactor(params, grads, state, step, scale, tcfg)
    else:
        raise ValueError(tcfg.optimizer)
    return gnorm
