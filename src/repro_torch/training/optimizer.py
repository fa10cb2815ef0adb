"""AdamW with global-norm clipping, written out (the JAX package's
arithmetic: ``training/optimizer.py`` adamw_update + opt_update).

The update runs in place on the parameters and moments, one tensor at a
time, so the full-width DLRM (1.75 B parameters, mostly embedding tables)
needs one parameter-sized temporary beside params, grads, m and v.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, in float32 (a norm
    reduction per tensor, so no gradient-sized square is materialized)."""
    norms = [torch.linalg.vector_norm(g.to(torch.float32)) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def adamw_init(params, tcfg: TrainConfig) -> dict:
    dt = getattr(torch, tcfg.opt_state_dtype)
    return {"m": [torch.zeros_like(p, dtype=dt) for p in params],
            "v": [torch.zeros_like(p, dtype=dt) for p in params]}


@torch.no_grad()
def opt_update(params, grads, state: dict, step: int,
               tcfg: TrainConfig) -> torch.Tensor:
    """Clip ``grads`` to ``max_grad_norm`` (global norm), then one AdamW
    step in place.  Returns the pre-clip global norm."""
    if tcfg.optimizer != "adamw":
        raise NotImplementedError(f"optimizer {tcfg.optimizer!r} is not "
                                  "ported yet (ROADMAP Queue A item 2)")
    gnorm = global_norm(grads)
    scale = None
    if tcfg.max_grad_norm:
        scale = torch.clamp(tcfg.max_grad_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    t = float(step + 1)
    c1 = 1.0 - math.pow(b1, t)
    c2 = 1.0 - math.pow(b2, t)
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        # step = (m / c1) / (sqrt(v / c2) + eps), built in one temporary
        upd = torch.div(v, c2).sqrt_().add_(eps)
        upd.reciprocal_().mul_(m).div_(c1)
        upd.add_(p, alpha=tcfg.weight_decay)
        p.add_(upd, alpha=-tcfg.lr)
        del upd
    return gnorm
