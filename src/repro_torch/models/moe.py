"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``):
token-choice top-k routing, capacity-bounded, sort-based dispatch (no
N x E one-hot tensors).

Dispatch
--------
1. router logits (float32, off TF32) -> softmax -> top-k experts per token,
   ties to the lower expert index, weights renormalized;
2. position-within-expert from a stable argsort over the expert ids;
3. tokens scattered into a dense (E, C, D) expert batch (capacity C,
   overflow sent to a dump slot and dropped);
4. the experts' SwiGLU as batched matmuls over the stacked expert weights;
5. weighted scatter-add back to token order (+ shared experts, Kimi style).

Token groups (the reference's ``_n_token_groups``): with an active mesh of
data degree dp (``distributed/sharding.set_active_mesh``), the N tokens of
the global (micro)batch are G = dp contiguous groups when dp divides N, each
with its own capacity, else one.  A rank whose activations are its row
shard of the batch (``sharding.row_shards``, set by the data-parallel train
step) holds exactly its own group when the rows were placed by
``etl_runtime/transfer.put_packed``; a rank holding a replicated batch runs
all G.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L


def moe_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device=None) -> dict:
    """``router`` ``[d, E]`` in float32 whatever ``dtype``; ``experts``
    ``w1`` / ``w3`` ``[E, d, f]`` and ``w2`` ``[E, f, d]``; ``shared``, a
    SwiGLU MLP of width ``n_shared_experts * f``, when there are shared
    experts."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    kw = dict(generator=generator, device=device)
    p = {"router": L.truncated_normal((d, e.n_experts), torch.float32, sc_in,
                                      **kw),
         "experts": {
             "w1": L.truncated_normal((e.n_experts, d, f), dtype, sc_in, **kw),
             "w3": L.truncated_normal((e.n_experts, d, f), dtype, sc_in, **kw),
             "w2": L.truncated_normal((e.n_experts, f, d), dtype, sc_out,
                                      **kw)}}
    if e.n_shared_experts:
        p["shared"] = L.mlp_init(d, e.n_shared_experts * f, "swiglu", dtype,
                                 **kw)
    return p


class Router(nn.Module):
    """The router ``[d, E]`` as a module of its own, whose forward is the
    router logits (``router_logits``).  It is float32 whatever the layer's
    other parameters are, and FSDP2 shards a module's parameters as one
    unit of one dtype: under FSDP the router is a unit beside its block's
    (``training/train_loop._fully_shard``), gathered for its forward."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, xf):
        return router_logits(xf, self.weight)


class MoE(nn.Module):
    """The layer's parameters as a module: ``router`` (held by ``gate``, a
    ``Router``), ``experts`` and (with shared experts) ``shared``,
    indexable as the JAX tree is."""

    def __init__(self, cfg: ModelConfig, dtype, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        tree = moe_init(cfg, dtype, generator=generator, device=device)
        self.gate = Router(tree["router"])
        self.experts = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in tree["experts"].items()})
        if "shared" in tree:
            self.shared = nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in tree["shared"].items()})

    @property
    def router(self) -> torch.Tensor:
        return self.gate.weight

    def __getitem__(self, key):
        return getattr(self, key)

    def tree(self) -> dict:
        """``{"router", "experts": {...}[, "shared": {...}]}``."""
        out = {"router": self.router, "experts": dict(self.experts.items())}
        if hasattr(self, "shared"):
            out["shared"] = dict(self.shared.items())
        return out


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``n_tokens`` tokens (the reference's
    ``moe_apply`` rule), rounded up to a multiple of 8."""
    e = cfg.moe
    cap = int(max(1, math.ceil(n_tokens * e.top_k / e.n_experts
                               * e.capacity_factor)))
    return -(-cap // 8) * 8


def router_logits(xf, router):
    """``xf @ router`` in float32; on the card with TF32 off for the call
    (TF32 would move routing decisions)."""
    xf = xf.to(torch.float32)
    with L.true_float32(xf):
        return xf @ router


def top_k(probs, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties to
    the lower index (a stable descending sort; ``torch.topk`` does not
    promise the tie order on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xf, cfg: ModelConfig, cap: int) -> dict:
    """The dispatch plan of one token group ``xf`` (N, D): ``top_e`` /
    ``top_w`` (N, k), and per routed (token, expert) pair in expert order
    ``se`` (expert), ``st`` (token), ``sw`` (weight), ``pos_in_e``,
    ``keep`` (within capacity) and ``slot`` (``E * cap`` for a dropped
    pair)."""
    e = cfg.moe
    N = xf.shape[0]
    k, E = e.top_k, e.n_experts
    dev = xf.device
    probs = torch.softmax(p.gate(xf), dim=-1)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(N, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # grouping by expert
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # bincount(se, minlength=E), without the host sync CUDA's bincount has
    counts = torch.zeros(E, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N * k, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(pos_in_e, E * cap))
    return {"top_e": top_e, "top_w": top_w, "se": se, "st": st, "sw": sw,
            "pos_in_e": pos_in_e, "keep": keep, "slot": slot}


def dispatch_ffn(p, xf, cfg: ModelConfig, cap: int, xt=None, ax=None):
    """Top-k dispatch, the experts' FFN and the combine for one token
    group ``xf`` (N, D) -> (N, D).

    With the experts sharded over the model axis ``ax`` (this rank's
    ``E / m`` experts, or each expert's ``d_ff / m`` columns), the routing
    is the replicated one of ``xf``, the experts read ``xt`` (``xf``
    through ``tp.copy_in``) and the combine weights pass ``tp.copy_in``
    too, and the result is this rank's partial sum: its experts' slots
    only, or its columns' share of every slot."""
    e = cfg.moe
    N, D = xf.shape
    E = e.n_experts
    r = route(p, xf, cfg, cap)
    slot, keep, st, sw = r["slot"], r["keep"], r["st"], r["sw"]
    ex = p["experts"]
    src, n_exp = xf, E
    if ax is not None:
        src, sw = xt, tp.copy_in(sw, ax)
        n_exp = ex["w1"].shape[0]
        if n_exp < E:  # expert-parallel: this rank's experts' slots
            first = ax.rank * n_exp
            keep = keep & (r["se"] >= first) & (r["se"] < first + n_exp)
            slot = torch.where(keep, slot - first * cap,
                               torch.full_like(slot, n_exp * cap))

    disp = src.new_zeros((n_exp * cap + 1, D)).index_put((slot,), src[st])
    disp = disp[:n_exp * cap].reshape(n_exp, cap, D)

    dt = xf.dtype
    hgate = torch.bmm(disp, ex["w1"].to(dt))
    hlin = torch.bmm(disp, ex["w3"].to(dt))
    eout = torch.bmm(F.silu(hgate) * hlin, ex["w2"].to(dt))

    eflat = eout.reshape(n_exp * cap, D)
    gathered = torch.where(keep[:, None],
                           eflat[torch.clamp(slot, max=n_exp * cap - 1)],
                           torch.zeros((), dtype=dt, device=xf.device))
    return xf.new_zeros((N, D)).index_add(
        0, st, gathered * sw[:, None].to(dt))


def _n_token_groups(N: int) -> int:
    """Dispatch group count of ``N`` global tokens = data-parallel degree
    when it divides N."""
    dp = shd.data_degree(shd.get_active_mesh())
    return dp if dp > 1 and N % dp == 0 else 1


def moe_apply(p, x, cfg: ModelConfig, seq_sharded: bool = False):
    """x: (B, S, D) -> (B, S, D).  On the model axis: the experts sharded
    by expert (``"expert"``: E divisible by m) or within each expert
    (``"model_in_expert"``), shared experts a tensor-parallel MLP, the
    router replicated; ``seq_sharded``: ``x`` is this rank's sequence
    shard (gathered first, the output reduce-scattered)."""
    e = cfg.moe
    ex = p["experts"]
    split = tp.split(ex["w1"].shape[0], e.n_experts) or \
        tp.split(ex["w1"].shape[2], e.d_ff_expert)
    ax = tp.active() if split or seq_sharded else None
    xt = None
    if ax is not None:
        x, xt = tp.enter(x, ax, seq_sharded)
    B, S, D = x.shape
    N = B * S
    # a row shard of the batch is one of the G = dp groups of its N * dp
    # global tokens; a whole batch has _n_token_groups(N)
    G = 1 if shd.get_row_shards() > 1 else _n_token_groups(N)
    xf = x.reshape(N, D)
    cap = capacity(N // G, cfg)
    parts = xt.reshape(G, N // G, D) if split else [None] * G
    out = torch.cat([dispatch_ffn(p, t, cfg, cap, xt=u,
                                  ax=ax if split else None)
                     for t, u in zip(xf.reshape(G, N // G, D), parts)])
    shared = None
    if e.n_shared_experts:
        shared = L.mlp_apply(p["shared"], xf, "swiglu",
                             width=e.n_shared_experts * e.d_ff_expert)
    if ax is None:
        return (out if shared is None else out + shared).reshape(B, S, D)
    out = tp.leave(out.reshape(B, S, D), ax, split, seq_sharded)
    if shared is not None:
        out = out + tp.leave(shared.reshape(B, S, D), ax, False, seq_sharded)
    return out


def aux_load_balance_loss(p, x, cfg: ModelConfig):
    """Switch-style load-balance auxiliary loss (fraction x router prob)."""
    e = cfg.moe
    N = x.shape[0] * x.shape[1]
    xf = x.reshape(N, -1)
    probs = torch.softmax(p.gate(xf), dim=-1)
    top = torch.argmax(probs, dim=-1)
    frac = torch.bincount(top, minlength=e.n_experts) / N
    imp = probs.mean(0)
    return e.n_experts * torch.sum(frac * imp)
