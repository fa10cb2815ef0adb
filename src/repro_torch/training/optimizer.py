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

Sharded parameters (FSDP's DTensors, each rank a ``Shard(d)`` of a 1-D
data mesh) update term by term on the local shard.  AdamW's moments are
sharded as the parameter.  Adafactor's state tensors (``vr``, ``vc``, or
``v``) are laid out as the reference's ``param_specs`` lays out its
optimizer state: whole over the model axis, and with FSDP sharded over the
data axes on their own largest dim the data degree divides
(``state_spec``), not on their parameter's.  The update works on the part
of each that the rank's shard of the parameter spans (``_FactorLayout``):
a stored tensor is all-gathered over the data group first where its shard
is not that part, and the new values are gathered back over the groups
that cut the part before the rank keeps its own shard of them.  What spans
the parameter's shards is one all-reduce each over the data group: the
global norm's sums of squares, a factored row or column mean over the
sharded dim, ``vr``'s mean when its own dim is sharded, and a leaf's
``sum(u^2)`` for the update clipping's RMS.  A parameter sharded over the
model axis (a plain local tensor tagged ``tp_shard``, under or without
FSDP) is one more such shard, its sums taken over the model group as well.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp

AF_EPS = 1e-30     # Adafactor's epsilon
AF_CLIP = 1.0      # Adafactor's update clipping threshold (RMS)


def _local(t):
    """``(local tensor, shard dim or None, process group or None)`` of a
    parameter, gradient or state tensor."""
    if isinstance(t, DTensor):
        (pl,) = t.placements
        if isinstance(pl, Shard):
            return t.to_local(), pl.dim, t.device_mesh.get_group()
        return t.to_local(), None, None
    return t, None, None


def _all_sum(x, group):
    """``x`` summed over ``group`` (in place; ``x`` when there is none)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def global_norm(grads, params=None) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, in float32 (a norm
    reduction per tensor, so no gradient-sized square is materialized).  A
    sharded gradient's square is summed over its shards: over the data
    group for an FSDP shard, over the model group for a model shard of its
    parameter in ``params`` (``tp.shard_of``), over both for a leaf that
    is both (one all-reduce a group for all such leaves); a replicated
    leaf counts once."""
    norms, kinds, groups = [], [], [None, None]
    for i, g in enumerate(grads):
        loc, dim, dgrp = _local(g)
        mdim, ax = tp.shard_of(params[i]) if params is not None \
            else (None, None)
        norms.append(torch.linalg.vector_norm(loc.to(torch.float32)))
        kinds.append((dim is not None, mdim is not None))
        if dim is not None:
            groups[0] = dgrp
        if mdim is not None:
            groups[1] = ax.group
    for kind in ((True, False), (False, True), (True, True)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        if not idx:
            continue
        sq = torch.stack([norms[i] for i in idx]).square()
        for on, grp in zip(kind, groups):
            if on:
                sq = _all_sum(sq, grp)
        for j, i in enumerate(idx):
            norms[i] = sq[j].sqrt()
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
        p, g, m, v = (_local(t)[0] for t in (p, g, m, v))
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


def _leaf_shard(leaf, params):
    """``(dim, mesh)`` of a leaf's shard in its stacked shape (a stacked
    leaf's layer dim is never sharded), or ``(None, None)``."""
    p = params[leaf[0] if isinstance(leaf, list) else leaf]
    _, dim, _ = _local(p)
    if dim is None:
        return None, None
    return dim + isinstance(leaf, list), p.device_mesh


def _kept(key: str, k: int) -> list:
    """The dims of a ``k``-dim leaf that its state tensor ``key`` keeps."""
    return {"v": list(range(k)), "vr": list(range(k - 1)),
            "vc": list(range(k - 2)) + [k - 1]}[key]


def state_spec(shape, data_degree: int, fsdp: bool):
    """The reference's ``param_specs`` on an Adafactor state tensor of
    ``shape`` (its default rule: no path rule names a ``vr``, ``vc`` or
    ``v``): with ``fsdp``, its largest dim the data degree divides over the
    data axes; otherwise whole."""
    return shd.param_spec("", shape, {"data": data_degree}, fsdp=fsdp)


def _state_zeros(shape, dt, dev, dim, mesh):
    """Zeros of a state tensor: a DTensor sharded on ``dim`` of ``mesh``
    where ``dim`` is given, else a plain tensor."""
    if dim is None:
        return torch.zeros(shape, dtype=dt, device=dev)
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=dt, device_mesh=mesh, placements=[Shard(dim)])


def adafactor_init(params, tcfg: TrainConfig, leaves=None) -> dict:
    """``{"f": [state per leaf], "leaves": leaves}``: ``{"vr", "vc"}`` for a
    factored leaf, ``{"v"}`` otherwise, in the leaf's stacked shape with
    its model dim whole, each laid out by ``state_spec`` over the data mesh
    of the FSDP-sharded parameters (a DTensor there), or whole."""
    dt = getattr(torch, tcfg.opt_state_dtype)
    if leaves is None:
        leaves = list(range(len(params)))
    dev = _local(params[0])[0].device if params else None
    mesh = next((p.device_mesh for p in params if isinstance(p, DTensor)),
                None)
    ranks = 1 if mesh is None else mesh.size()
    f = []
    for leaf in leaves:
        first = params[leaf[0] if isinstance(leaf, list) else leaf]
        s = list(leaf_shape(leaf, params))
        md, ax = tp.shard_of(first)
        if md is not None:  # the whole leaf
            s[md + isinstance(leaf, list)] *= ax.size
        st = {}
        for key in ("vr", "vc") if _factored(s) else ("v",):
            shape = [s[i] for i in _kept(key, len(s))]
            dim = None if ranks == 1 else shd.data_dim(
                state_spec(shape, ranks, tcfg.fsdp))
            st[key] = _state_zeros(shape, dt, dev, dim, mesh)
        f.append(st)
    return {"f": f, "leaves": list(leaves)}


def _span(size: int, rank: int, ranks: int) -> tuple:
    """``(start, length)`` of rank's chunk of ``size`` entries split over
    ``ranks`` as ``torch.chunk`` and FSDP2's ``Shard`` split them (the last
    chunks short or empty)."""
    c = -(-size // ranks)
    lo = min(rank * c, size)
    return lo, min(size, lo + c) - lo


_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _gather_chunks(x, dim: int, group, ranks: int, size: int):
    """The ``size`` entries along ``dim`` of which the ranks of ``group``
    hold their ``_span`` chunks (``x``: this rank's), gathered whole (each
    chunk zero-padded to an equal length for the collective)."""
    c = -(-size // ranks)
    x = x.movedim(dim, 0)
    if x.shape[0] < c:
        x = torch.cat([x, x.new_zeros((c - x.shape[0],) + x.shape[1:])])
    out = x.new_empty((ranks * c,) + tuple(x.shape[1:]))
    _gather_single(out, x.contiguous(), group=group)
    return out[:size].movedim(0, dim)


class _FactorLayout:
    """A leaf's Adafactor state tensors against the part of each that this
    rank's shard of the parameter spans: the leaf's data-sharded dim
    ``(dim, group, rank, ranks)`` and model-sharded dim ``(dim,
    ModelAxis)``, in stacked coordinates (None where whole)."""

    def __init__(self, leaf, params):
        first = params[leaf[0] if isinstance(leaf, list) else leaf]
        self.k = len(leaf_shape(leaf, params))
        d, mesh = _leaf_shard(leaf, params)
        self.data = None if d is None else (
            d, mesh.get_group(), mesh.get_local_rank(), mesh.size())
        md, ax = tp.shard_of(first)
        self.model = None if md is None else (
            md + isinstance(leaf, list), ax)

    def _dims(self, key: str) -> tuple:
        """The dims of state tensor ``key`` that the parameter's data and
        model shards cut (None where it does not keep the cut dim)."""
        kept = _kept(key, self.k)
        return tuple(None if cut is None or cut[0] not in kept
                     else kept.index(cut[0])
                     for cut in (self.data, self.model))

    def local(self, key: str, stored):
        """The part of the stored state tensor ``key`` that the
        parameter's shard spans: the stored local tensor itself where the
        two agree (its new values are then written in place)."""
        x, fd, grp = _local(stored)
        dd, md = self._dims(key)
        if fd is not None and fd != dd:
            x = _gather_chunks(x, fd, grp, stored.device_mesh.size(),
                               stored.shape[fd])
        if dd is not None and fd != dd:
            _, _, rank, ranks = self.data
            x = x.narrow(dd, *_span(x.shape[dd], rank, ranks))
        if md is not None:
            x = tp.part(x, md, self.model[1])
        return x

    def store(self, key: str, part, stored) -> None:
        """Write ``part``, the new values of ``local(key, stored)``, into
        this rank's shard of ``stored``."""
        loc, fd, _ = _local(stored)
        dd, md = self._dims(key)
        if fd == dd and md is None:  # ``part`` is ``loc``, written in place
            return
        if md is not None:
            ax = self.model[1]
            part = _gather_chunks(part, md, ax.group, ax.size,
                                  part.shape[md] * ax.size)
        if dd is not None and fd != dd:
            _, grp, _, ranks = self.data
            part = _gather_chunks(part, dd, grp, ranks, stored.shape[dd])
        if fd is not None and fd != dd:
            mesh = stored.device_mesh
            part = part.narrow(fd, *_span(stored.shape[fd],
                                          mesh.get_local_rank(),
                                          mesh.size()))
        loc.copy_(part)


def _mean(x, dim, shard):
    """``x.mean(dim)``; over a dim sharded across a group (``shard`` =
    ``(group, the dim's whole size)``; None: whole), the all-reduced sum
    over that size (an uneven shard's padding holds nothing)."""
    if shard is None:
        return x.mean(dim)
    group, size = shard
    return _all_sum(x.sum(dim), group) / size


def _af_stats(g, st, b2, omb2, shards=None) -> dict:
    """This step's float32 second-moment statistics of one part (``g``
    sharded on each dim of ``shards``, ``{dim: (group, whole size)}``,
    across its group)."""
    shards = shards or {}
    g2 = g.square().add_(AF_EPS)
    if "vr" in st:
        k = g.dim()
        return {"vr": st["vr"].to(torch.float32) * b2
                + omb2 * _mean(g2, -1, shards.get(k - 1)),
                "vc": st["vc"].to(torch.float32) * b2
                + omb2 * _mean(g2, -2, shards.get(k - 2))}
    return {"v": st["v"].to(torch.float32) * b2 + omb2 * g2}


def _af_u(g, stats, shards=None) -> torch.Tensor:
    """The unclipped update ``g / sqrt(second moment)`` in float32."""
    shards = shards or {}
    if "vr" in stats:
        vr, vc = stats["vr"], stats["vc"]
        row_mean = _mean(vr, -1, shards.get(g.dim() - 2)).unsqueeze(-1)
        r = vr / torch.clamp(row_mean, min=AF_EPS)
        u = r[..., :, None] * vc[..., None, :]
    else:
        u = stats["v"].clone()
    return u.clamp_(min=AF_EPS).rsqrt_().mul_(g)


def _adafactor(params, grads, state, step, scale, tcfg):
    b2 = _f32_pow_complement(step + 1, -0.8)  # the paper's schedule
    omb2 = float(np.float32(1.0) - np.float32(b2))
    lr, wd = tcfg.lr, tcfg.weight_decay
    loc = lambda t: _local(t)[0]
    for leaf, st in zip(state["leaves"], state["f"]):
        # the parts of the leaf whose statistics are their own: (param,
        # grad, state views, per-layer params to write back), and the dims
        # of a part its shards cut, each with its group (data, model)
        d, _ = _leaf_shard(leaf, params)
        first = params[leaf[0] if isinstance(leaf, list) else leaf]
        md, ax = tp.shard_of(first)
        shape = list(leaf_shape(leaf, params))  # data dims whole
        if md is not None:
            shape[md + isinstance(leaf, list)] *= ax.size
        shards = {} if d is None else {d: (_local(first)[2], shape[d])}
        if md is not None:
            k = md + isinstance(leaf, list)
            shards[k] = (ax.group, shape[k])
        layout, stored = _FactorLayout(leaf, params), st
        st = {k: layout.local(k, v) for k, v in stored.items()}
        if not isinstance(leaf, list):
            units = [(loc(params[leaf]), loc(grads[leaf]), st, None)]
        elif "vr" in st and first.dim() == 1:
            # a stacked vector [L >= 2, d]: its factors span the layers
            ps = [loc(params[i]) for i in leaf]
            units = [(torch.stack(ps),
                      torch.stack([loc(grads[i]) for i in leaf]), st, ps)]
        else:
            units = [(loc(params[j]), loc(grads[j]),
                      {k: v[i] for k, v in st.items()}, None)
                     for i, j in enumerate(leaf)]
            shards = {k - 1: grp for k, grp in shards.items()}
        # pass 1: the statistics and sum(u^2) over the whole leaf
        stats, total = [], None
        for _, g, sv, _ in units:
            g = _clipped(g, scale)
            s = _af_stats(g, sv, b2, omb2, shards)
            stats.append(s)
            sq = _af_u(g, s, shards).square_().sum()
            total = sq if total is None else total + sq
            del g
        for grp, _ in shards.values():
            total = _all_sum(total, grp)
        n = int(np.prod(shape))
        rms_u = torch.sqrt(total / n + AF_EPS)
        den = torch.clamp(rms_u / AF_CLIP, min=1.0)
        # pass 2: recompute u, clip it, apply it, store the statistics
        for (p, g, sv, back), s in zip(units, stats):
            u = _af_u(_clipped(g, scale), s, shards).div_(den)
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
        for k, v in stored.items():
            layout.store(k, st[k], v)


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
    gnorm = global_norm(grads, params)
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
