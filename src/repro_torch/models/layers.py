"""Shared neural building blocks: plain functions on tensors (the JAX
package's ``models/layers.py``, op for op).

Conventions
-----------
- Weights are stored as the JAX package stores them: a projection is
  ``[in, out]`` and applies as ``x @ w``, so a parameter tree carries over
  from the JAX package unchanged (``models/api.params_from_jax``).
- Dtype policy: params in ``cfg.param_dtype``, activations in
  ``cfg.compute_dtype``; each weight is cast to the activations' dtype where
  it is used (the reference's ``cast_tree``; no ``torch.autocast``).
  Attention scores, softmax and the loss run in float32, as the reference's
  ``preferred_element_type=float32`` contractions do; probabilities are
  cast back to the compute dtype before they meet ``v``.
- KV caches (``cache_init``) are written in place at the decode position
  (a ring buffer modulo its length for sliding-window models): the caller
  keeps the cache it passed, as the reference's decode donates it.  On the
  model axis a cache is this rank's shard (``_mha_cached``).
- Cross-attention (``mha(..., kv_x=)``) projects K and V from ``kv_x``,
  with no RoPE and no mask.  Sinusoidal positions come in the reference's
  two forms, which differ in their last bits: ``sinusoidal_positions``
  (numpy float64, cast to float32: training and prefill) and
  ``sinusoidal_at`` (float32 arithmetic at given positions: decode).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import loops


def truncated_normal(shape, dtype, scale, *, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """Normal samples truncated to [-2, 2], times ``scale``, drawn in
    float32 from ``generator`` (on its device unless ``device`` is
    given), then cast to ``dtype``."""
    from torch._subclasses.fake_tensor import is_fake
    device = device if device is not None else generator.device
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if not is_fake(t):  # a fake tensor (a dry run's) has no values to draw
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return t.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def layernorm(x, w, b, eps):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def norm_apply(x, p, kind, eps):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"], eps)
    return layernorm(x, p["w"], p["b"], eps)


def norm_init(d, kind, dtype, device=None) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, style, device=None) -> torch.Tensor:
    """style 'full': rotate all dims; 'half': rotate first half (ChatGLM 2d)."""
    rot = head_dim if style == "full" else head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.from_numpy(inv.astype(np.float32)).to(device)  # (rot/2,)


def apply_rope(x, positions, inv_freq, style):
    """x: (..., S, H, hd); positions: broadcastable int (..., S)."""
    hd = x.shape[-1]
    rot = inv_freq.shape[0] * 2
    ang = positions[..., None].to(torch.float32) * inv_freq  # (...,S,rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[..., None, :]  # (...,S,1,rot/2)
    sin = sin[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot == hd:
        return yr.to(x.dtype)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / sliding window)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_style: str = "full"  # "full" | "half" | "none"
    rope_theta: float = 500000.0
    sliding_window: int = 0  # 0 = full causal
    causal: bool = True


def attn_init(spec: AttnSpec, dtype, *, generator: torch.Generator,
              device=None) -> dict:
    d, h, kv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    sc = 1.0 / math.sqrt(d)
    kw = dict(generator=generator, device=device)
    p = {"wq": truncated_normal((d, h * hd), dtype, sc, **kw),
         "wk": truncated_normal((d, kv * hd), dtype, sc, **kw),
         "wv": truncated_normal((d, kv * hd), dtype, sc, **kw),
         "wo": truncated_normal((h * hd, d), dtype, 1.0 / math.sqrt(h * hd),
                                **kw)}
    if spec.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def cache_init(batch, length, n_kv, head_dim, dtype, device=None) -> dict:
    """KV cache with a true-position array (supports ring buffers for SWA).

    ``pos[s]`` is the absolute position stored in slot s (-1 = empty); masks
    are derived from it, so ring wraparound needs no special casing.
    """
    shape = (batch, length, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((length,), -1, dtype=torch.int32,
                              device=device)}


def _mask_from_positions(q_pos, k_pos, causal, window):
    """(Sq, Sk) additive f32 bias. k_pos = -1 marks empty cache slots."""
    ok = k_pos[None, :] >= 0
    if causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if window:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e9))


FLASH_THRESHOLD = 8192  # self-attention seqs beyond this use the chunked path


def _scores(q, k, scale):
    """bqhd,bkhd->bhqk with a float32 result (the reference's
    ``preferred_element_type=float32``)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                        k.to(torch.float32)) * scale


def flash_attention(q, k, v, q_pos, k_pos, *, causal, window,
                    q_chunk=1024, k_chunk=1024):
    """Chunked attention with online softmax: never materializes the (Sq,
    Sk) score matrix; loops over query and key chunks carrying (running
    max, denominator, weighted accumulator) in float32, each query
    chunk's result written into the float32 output.

    q: (B,Sq,H,D); k,v: (B,Sk,H,D) (kv heads already repeated).
    q_pos: (Sq,), k_pos: (Sk,) absolute positions (-1 = empty slot).
    Both loops are ``loops.uniform``: on fake tensors (a dry run) each
    body runs once, standing for every chunk.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    assert Sq % qc == 0 and Sk % kc == 0, (Sq, qc, Sk, kc)
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    with loops.uniform(Sq // qc, q, k, v) as q_trips:
        for i in range(q_trips):
            q_blk = q[:, i * qc:(i + 1) * qc]
            qp = q_pos[i * qc:(i + 1) * qc]
            m = torch.full((B, H, qc), -1e30, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((B, H, qc), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((B, H, qc, D), dtype=torch.float32,
                              device=q.device)
            with loops.uniform(Sk // kc, q, k, v) as k_trips:
                for j in range(k_trips):
                    k_blk = k[:, j * kc:(j + 1) * kc]
                    v_blk = v[:, j * kc:(j + 1) * kc]
                    kp = k_pos[j * kc:(j + 1) * kc]
                    s = _scores(q_blk, k_blk, scale)
                    s = s + _mask_from_positions(qp, kp, causal, window)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "bhqk,bkhd->bhqd",
                        p.to(v_blk.dtype).to(torch.float32),
                        v_blk.to(torch.float32))
                    m = m_new
            out[:, i * qc:(i + 1) * qc] = (
                acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    return out


def mha(p, x, spec: AttnSpec, *, kv_x: Optional[torch.Tensor] = None,
        q_pos: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None, cache_pos: Optional[int] = None,
        ring: bool = False, seq_sharded: bool = False):
    """Multi-head attention with GQA and an optional KV cache.
    x: (B, Sq, D).  kv_x: the cross-attention source (B, Sk, D) or None
    (self-attention, masked as ``spec`` says).

    ``cache`` (from ``cache_init``, or this rank's shard of one on the
    model axis) makes it ``_mha_cached``: self-attention written in place
    at ``cache_pos`` (a host int; modulo the cache's length when ``ring``)
    that attends over the whole cache.  Cross-attention has no RoPE, no
    mask and never the chunked path.

    With the projections sharded over the model axis (or ``seq_sharded``:
    ``x`` is this rank's sequence shard), attention without a cache runs
    ``_mha_model_parallel``.
    """
    B, Sq, _ = x.shape
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if cache is not None:
        if seq_sharded or kv_x is not None or q_pos is not None:
            raise ValueError("a KV cache serves self-attention over whole "
                             "sequences at its own positions")
        return _mha_cached(p, x, spec, cache, cache_pos, ring)
    if seq_sharded or p["wq"].shape[1] != h * hd:
        return _mha_model_parallel(p, x, spec, seq_sharded, kv_x)
    dt = x.dtype
    src = x if kv_x is None else kv_x
    Sk = src.shape[1]
    q = (x @ p["wq"].to(dt)).reshape(B, Sq, h, hd)
    k = (src @ p["wk"].to(dt)).reshape(B, Sk, kv, hd)
    v = (src @ p["wv"].to(dt)).reshape(B, Sk, kv, hd)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"].to(dt), 1e-6)
        k = rmsnorm(k, p["k_norm"].to(dt), 1e-6)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=x.device)
    if spec.rope_style != "none" and kv_x is None:
        inv = rope_freqs(hd, spec.rope_theta, spec.rope_style, x.device)
        pos = torch.broadcast_to(q_pos, (B, Sq))
        q = apply_rope(q, pos, inv, spec.rope_style)
        k = apply_rope(k, pos, inv, spec.rope_style)
    k_pos = torch.arange(Sk, device=x.device)

    # GQA: repeat kv heads to match q heads
    rep = h // kv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    out = _attend(q, k, v, q_pos, k_pos, spec, dt, self_attn=kv_x is None)
    return out @ p["wo"].to(dt)


def cache_slot(cache: dict, cache_pos: int, n: int, ring: bool) -> int:
    """The first of the whole cache's slots that ``n`` tokens from
    position ``cache_pos`` take (modulo its length when ``ring``); the
    reference's ``dynamic_update_slice`` clamps a span that would run past
    the end."""
    length = cache["pos"].shape[-1]
    slot = cache_pos % length if ring else cache_pos
    return max(0, min(slot, length - n))


def write_kv(cache: dict, k, v, slot: int, positions) -> None:
    """Write ``k`` / ``v`` (B, T, heads, hd) into the whole cache's slots
    ``slot .. slot + T`` (they must not wrap) and ``positions`` (T,) into
    its ``pos``.  On a cache split by sequence over the model axis
    (its ``k`` shorter than its ``pos``) this rank keeps the slots in its
    span only; ``pos`` is whole on every rank."""
    T = k.shape[1]
    n = cache["k"].shape[1]
    cache["pos"][slot:slot + T] = positions.to(torch.int32)
    lo = tp.active().rank * n if n != cache["pos"].shape[0] else 0
    a, b = max(slot, lo), min(slot + T, lo + n)
    if a < b:
        cache["k"][:, a - lo:b - lo] = k[:, a - slot:b - slot].to(
            cache["k"].dtype)
        cache["v"][:, a - lo:b - lo] = v[:, a - slot:b - slot].to(
            cache["v"].dtype)


def _attend(q, k, v, q_pos, k_pos, spec: AttnSpec, dt, *, self_attn=True):
    """Attention over per-q-head ``k`` / ``v`` (B, Sk, H, hd) -> (B, Sq,
    H * hd) in ``dt``: the chunked path for long self-attention, else
    whole scores (masked for self-attention)."""
    B, Sq, H, hd = q.shape
    if Sq > 1 and max(Sq, k.shape[1]) > FLASH_THRESHOLD and self_attn:
        # long-context path: chunked online-softmax attention (no S^2 scores)
        out = flash_attention(q, k, v, q_pos, k_pos, causal=spec.causal,
                              window=spec.sliding_window).to(dt)
        return out.reshape(B, Sq, H * hd)
    scores = _scores(q, k, 1.0 / math.sqrt(hd))
    if self_attn:
        scores = scores + _mask_from_positions(q_pos, k_pos, spec.causal,
                                               spec.sliding_window)
    probs = torch.softmax(scores, dim=-1).to(dt)
    del scores
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(B, Sq, H * hd)


def _qk_prep(t, norm_w, pos, spec: AttnSpec):
    """qk-norm (``norm_w``, or none) then RoPE of q or k (B, S, heads,
    hd) at ``pos`` (B, S)."""
    if spec.qk_norm:
        t = rmsnorm(t, norm_w.to(t.dtype), 1e-6)
    if spec.rope_style != "none":
        inv = rope_freqs(spec.head_dim, spec.rope_theta, spec.rope_style,
                         t.device)
        t = apply_rope(t, pos, inv, spec.rope_style)
    return t


def _mha_model_parallel(p, x, spec: AttnSpec, seq_sharded: bool,
                        kv_x: Optional[torch.Tensor] = None):
    """Attention (training: no cache) with ``wq`` / ``wk`` / ``wv``
    column- and ``wo`` row-sharded over the model axis -> this rank's
    output as ``tp.leave`` gives it.  ``kv_x``: the cross-attention source
    (replicated; it enters through ``tp.copy_in`` where the rank's shards
    of ``wk`` / ``wv`` read it), else self-attention.

    Each rank attends with its ``h / m`` q heads when ``m`` divides the
    heads; a k / v projection whose shard is not whole heads (or that is
    whole) is gathered first, and each rank reads the kv heads its q heads
    pair with.  Where q itself is not head-aligned, attention runs
    replicated on the gathered projections and ``wo``'s input is scattered
    back to the rank's rows."""
    ax = tp.active()
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    xr, xt = tp.enter(x, ax, seq_sharded)
    if not tp.split(p["wq"].shape[1], h * hd):  # whole weights: replicated
        return tp.leave(mha(p, xr, spec, kv_x=kv_x), ax, False, seq_sharded)
    if kv_x is None:
        sr, st = xr, xt
    else:  # cross-attention: no RoPE, no mask
        sr, st = kv_x, tp.copy_in(kv_x, ax)
        spec = dataclasses.replace(spec, rope_style="none")
    B, S, _ = xr.shape
    Sk = sr.shape[1]
    dt = xr.dtype
    m, r = ax.size, ax.rank
    k_split = tp.split(p["wk"].shape[1], kv * hd)
    pos = torch.arange(S, device=xr.device)
    bpos = torch.broadcast_to(pos, (B, S))
    k_pos = torch.arange(Sk, device=xr.device)
    bk_pos = torch.broadcast_to(k_pos, (B, Sk))
    q = xt @ p["wq"].to(dt)
    k = (st if k_split else sr) @ p["wk"].to(dt)
    v = (st if k_split else sr) @ p["wv"].to(dt)
    kv_local = k_split and kv % m == 0
    if not kv_local:  # every kv head, the same on each rank
        if k_split:
            k, v = tp.gather(k, -1, ax), tp.gather(v, -1, ax)
        k = _qk_prep(k.reshape(B, Sk, kv, hd), p.get("k_norm"), bk_pos, spec)
        v = v.reshape(B, Sk, kv, hd)
    self_attn = kv_x is None
    if h % m:  # q is not whole heads: attention runs replicated
        q = tp.gather(q, -1, ax).reshape(B, S, h, hd)
        q = _qk_prep(q, p.get("q_norm"), bpos, spec)
        rep = h // kv
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        out = tp.scatter(_attend(q, k, v, pos, k_pos, spec, dt,
                                 self_attn=self_attn), -1, ax)
        return tp.leave(out @ p["wo"].to(dt), ax, True, seq_sharded)
    hl = h // m
    norm = lambda w: None if w is None else tp.copy_in(w, ax)
    q = _qk_prep(q.reshape(B, S, hl, hd), norm(p.get("q_norm")), bpos, spec)
    if kv_local:
        k = _qk_prep(k.reshape(B, Sk, kv // m, hd), norm(p.get("k_norm")),
                     bk_pos, spec)
        v = v.reshape(B, Sk, kv // m, hd)
        first_kv = r * (kv // m)
    else:  # each rank reads the replicated heads its own q heads need
        k, v = tp.copy_in(k, ax), tp.copy_in(v, ax)
        first_kv = 0
    kv_idx = (r * hl + torch.arange(hl, device=xr.device)) // (h // kv) \
        - first_kv
    out = _attend(q, k[:, :, kv_idx], v[:, :, kv_idx], pos, k_pos, spec, dt,
                  self_attn=self_attn)
    return tp.leave(out @ p["wo"].to(dt), ax, True, seq_sharded)


def whole_heads(t, width: int, ax):
    """A projection's output (..., width / m on each rank, or whole) whole
    on every rank (serving: no autograd)."""
    return tp.all_gather(t, -1, ax) if tp.split(t.shape[-1], width) else t


def softmax_split(s, v, dt, ax):
    """``softmax(s) @ v`` -> (B, Sq, H * hd) in ``dt``, where the keys
    (``s``: float32 scores (B, H, Sq, Sk_local); ``v``: (B, Sk_local, H,
    hd), per q head) are this rank's span of the positions
    (flash-decoding): the model ranks' max, sums of exponentials and
    weighted values are all-reduced in float32.  Ranks that hold the same
    keys give the same result (every sum counts them m times)."""
    B, H, Sq, _ = s.shape
    top = tp.all_reduce(s.amax(-1), ax, op=dist.ReduceOp.MAX)
    e = torch.exp(s - top[..., None])
    den = tp.all_reduce(e.sum(-1), ax)  # (B, H, Sq)
    num = tp.all_reduce(torch.einsum("bhqk,bkhd->bqhd", e,
                                     v.to(torch.float32)), ax)
    out = num / den.transpose(1, 2)[..., None]
    return out.to(dt).reshape(B, Sq, H * v.shape[-1])


def _mha_cached(p, x, spec: AttnSpec, cache: dict, cache_pos: int,
                ring: bool):
    """Self-attention with a KV cache (serving): ``x`` (B, Sq, D) at
    positions ``cache_pos ..``, written into ``cache`` at the slot
    ``cache_slot`` gives (a span that does not wrap), then attending over
    the whole cache, masked by its positions.

    On the model axis ``wq`` / ``wk`` / ``wv`` are column- and ``wo``
    row-sharded, and ``cache`` is this rank's shard as
    ``sharding.cache_specs`` lays it out:

    - split by kv head: each rank projects, writes and attends with its
      own q heads and the kv heads they pair with;
    - split by sequence (the kv heads do not split): every rank gathers
      the whole q, k and v of the new tokens, writes the slots in its
      span, and attends over its positions with every q head
      (``softmax_split``); it keeps its heads' rows of the result for
      ``wo``;
    - whole on every rank (neither splits): as by sequence, but each rank
      attends over the whole cache.

    ``wo``'s partial sums are then all-reduced over the model ranks."""
    ax = tp.active()
    B, Sq, _ = x.shape
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = x.dtype
    q_pos = torch.arange(cache_pos, cache_pos + Sq, device=x.device)
    bpos = torch.broadcast_to(q_pos, (B, Sq))
    slot = cache_slot(cache, cache_pos, Sq, ring)
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    by_head = cache["k"].shape[2] != kv
    if not by_head:
        q, k, v = (whole_heads(t, n * hd, ax) for t, n in
                   ((q, h), (k, kv), (v, kv)))
    q = _qk_prep(q.reshape(B, Sq, -1, hd), p.get("q_norm"), bpos, spec)
    k = _qk_prep(k.reshape(B, Sq, -1, hd), p.get("k_norm"), bpos, spec)
    write_kv(cache, k, v.reshape(B, Sq, -1, hd), slot, q_pos)
    kc, vc, k_pos = cache["k"], cache["v"], cache["pos"]
    rep = h // kv
    if rep > 1:
        kc = torch.repeat_interleave(kc, rep, dim=2)
        vc = torch.repeat_interleave(vc, rep, dim=2)
    n = kc.shape[1]
    if not by_head and n != k_pos.shape[0]:  # this rank's span of slots
        s = _scores(q, kc, 1.0 / math.sqrt(hd)) + _mask_from_positions(
            q_pos, k_pos[ax.rank * n:(ax.rank + 1) * n], spec.causal,
            spec.sliding_window)
        out = softmax_split(s, vc, dt, ax)
    else:
        out = _attend(q, kc, vc, q_pos, k_pos, spec, dt)
    if not tp.split(p["wo"].shape[0], h * hd):
        return out @ p["wo"].to(dt)
    if not by_head:
        out = tp.part(out, -1, ax)
    return tp.all_reduce(out @ p["wo"].to(dt), ax)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(d, f, kind, dtype, *, generator: torch.Generator,
             device=None) -> dict:
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    kw = dict(generator=generator, device=device)
    if kind == "swiglu":
        return {"w1": truncated_normal((d, f), dtype, sc_in, **kw),
                "w3": truncated_normal((d, f), dtype, sc_in, **kw),
                "w2": truncated_normal((f, d), dtype, sc_out, **kw)}
    return {"wi": truncated_normal((d, f), dtype, sc_in, **kw),
            "bi": torch.zeros((f,), dtype=dtype, device=device),
            "wo": truncated_normal((f, d), dtype, sc_out, **kw),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def cast_tree(p, dtype):
    """A tensor, or a (nested) dict of them, with every tensor cast to
    ``dtype``."""
    if isinstance(p, Mapping):
        return {k: cast_tree(v, dtype) for k, v in p.items()}
    return p.to(dtype)


def cast_tree_except(p, dtype, keep: tuple) -> dict:
    """Cast a param dict to dtype, leaving ``keep`` keys untouched (float32
    master copies of the SSM's scalar parameters)."""
    return {k: v if k in keep else cast_tree(v, dtype) for k, v in p.items()}


@contextlib.contextmanager
def true_float32(x: torch.Tensor):
    """Float32 matmuls on the card without TF32 for the block (TF32 would
    move routing decisions and the SSM's decays); nothing on the CPU."""
    cuda = torch.backends.cuda.matmul
    if not (x.is_cuda and cuda.allow_tf32):
        yield
        return
    cuda.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32 = True


def mlp_apply(p, x, kind, width: int = 0, seq_sharded: bool = False):
    """The MLP of ``x``.  ``width``: its hidden width, given where the
    weights may be sharded over the model axis (column-parallel ``w1`` /
    ``w3`` / ``wi`` / ``bi``, row-parallel ``w2`` / ``wo``; ``bo`` added
    once, after the reduction); ``seq_sharded``: ``x`` is this rank's
    sequence shard."""
    if width and (seq_sharded or tp.split(
            p["w1" if kind == "swiglu" else "wi"].shape[1], width)):
        return _mlp_model_parallel(p, x, kind, width, seq_sharded)
    dt = x.dtype
    if kind == "swiglu":
        return (F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))) \
            @ p["w2"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh") \
        @ p["wo"].to(dt) + p["bo"].to(dt)


def _mlp_model_parallel(p, x, kind, width: int, seq_sharded: bool):
    ax = tp.active()
    xr, xt = tp.enter(x, ax, seq_sharded)
    if not tp.split(p["w1" if kind == "swiglu" else "wi"].shape[1], width):
        return tp.leave(mlp_apply(p, xr, kind), ax, False, seq_sharded)
    dt = xr.dtype
    if kind == "swiglu":
        y = (F.silu(xt @ p["w1"].to(dt)) * (xt @ p["w3"].to(dt))) \
            @ p["w2"].to(dt)
        return tp.leave(y, ax, True, seq_sharded)
    y = F.gelu(xt @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh") \
        @ p["wo"].to(dt)
    bo = tp.copy_in(p["bo"], ax) if seq_sharded else p["bo"]
    return tp.leave(y, ax, True, seq_sharded) + bo.to(dt)


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def embed_init(vocab, d, dtype, *, generator: torch.Generator, device=None):
    # 1/sqrt(d): keeps tied-head logits O(1) at init
    return truncated_normal((vocab, d), dtype, d ** -0.5, generator=generator,
                            device=device)


def embed_lookup(emb, tokens, compute_dtype, vocab: int = 0):
    """``emb[tokens]`` in ``compute_dtype``.  ``vocab``: the table's whole
    rows, given where they may be sharded over the model axis: each rank
    reads the ids in its rows (0 elsewhere), and the parts are summed."""
    if not vocab or not tp.split(emb.shape[0], vocab):
        return emb[tokens.long()].to(compute_dtype)
    ax = tp.active()
    rows = emb.shape[0]
    ids = tokens.long() - ax.rank * rows
    mine = (ids >= 0) & (ids < rows)
    e = emb[ids.clamp(0, rows - 1)].to(compute_dtype)
    return tp.reduce_out(torch.where(mine[..., None], e, torch.zeros(
        (), dtype=e.dtype, device=e.device)), ax)


def lm_logits(x, emb_or_head, tied):
    if tied:
        return x @ emb_or_head.to(x.dtype).t()
    return x @ emb_or_head.to(x.dtype)


# the global count of unignored labels by which cross_entropy divides this
# rank's sum (the data-parallel train step's ``label_count``)
_LABEL_COUNT = None


@contextlib.contextmanager
def label_count(count):
    """Within: ``cross_entropy`` divides its sum of per-token losses by
    ``count`` (a float32 scalar tensor, the unignored labels of the whole
    data-parallel batch) instead of its own count, so the ranks' losses
    sum to the global mean."""
    global _LABEL_COUNT
    prev, _LABEL_COUNT = _LABEL_COUNT, count
    try:
        yield
    finally:
        _LABEL_COUNT = prev


def cross_entropy(logits, labels, *, ignore_id: int = -100,
                  valid_vocab: int = 0):
    """Token-level CE in f32; mean over non-ignored positions (over all the
    ranks' positions within ``label_count``).

    The reference picks the label's logit with a one-hot contraction, so a
    label outside ``[0, V)`` (V = the logits' width) matches no column: its
    picked logit is 0 and it contributes ``lse``, raising nothing.  Here a
    clamped gather, zeroed where the label is out of range, gives the same
    without a ``[T, V]`` one-hot.  ``valid_vocab``: logits at ids >=
    valid_vocab (padded embedding rows) are masked out of the softmax.
    """
    lf = logits.to(torch.float32)
    V = lf.shape[-1]
    if valid_vocab and valid_vocab < V:
        pad = torch.arange(V, device=lf.device) >= valid_vocab
        lf = lf.masked_fill(pad, -1e9)
    lse = torch.logsumexp(lf, dim=-1)
    lab = labels.long()
    in_range = (lab >= 0) & (lab < V)
    picked = torch.gather(lf, -1, lab.clamp(0, V - 1)[..., None])[..., 0]
    ll = torch.where(in_range, picked, torch.zeros_like(picked))
    return _mean_nll(lse - ll, labels, ignore_id)


def _mean_nll(nll, labels, ignore_id):
    mask = (labels != ignore_id).to(torch.float32)
    count = mask.sum() if _LABEL_COUNT is None else _LABEL_COUNT
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def global_label_count():
    """The count ``label_count`` set (None outside it)."""
    return _LABEL_COUNT


def vocab_parallel_cross_entropy(logits, labels, *, ignore_id: int = -100,
                                 valid_vocab: int = 0):
    """``cross_entropy`` of logits whose vocabulary (last) dim is sharded
    over the model axis: ``logits`` are this rank's columns.  ``lse`` comes
    from the all-reduced max and sum of exponentials, the label's logit
    from the rank that holds it (none for a label outside ``[0, V)``, which
    then contributes ``lse``, as in ``cross_entropy``)."""
    ax = tp.active()
    lf = logits.to(torch.float32)
    cols = lf.shape[-1]
    first = ax.rank * cols
    ids = first + torch.arange(cols, device=lf.device)
    if valid_vocab and valid_vocab < cols * ax.size:
        lf = lf.masked_fill(ids >= valid_vocab, -1e9)
    top = tp.all_reduce(lf.detach().amax(-1), ax, op=dist.ReduceOp.MAX)
    lse = torch.log(tp.reduce_out(torch.exp(lf - top[..., None]).sum(-1),
                                  ax)) + top
    lab = labels.long() - first
    mine = (lab >= 0) & (lab < cols)
    picked = torch.gather(lf, -1, lab.clamp(0, cols - 1)[..., None])[..., 0]
    ll = tp.reduce_out(torch.where(mine, picked, torch.zeros_like(picked)),
                       ax)
    return _mean_nll(lse - ll, labels, ignore_id)


def sinusoidal_positions(n, d) -> torch.Tensor:
    """(n, d) float32 sinusoids of positions 0 .. n-1, computed in numpy
    float64 and cast (training and prefill)."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def sinusoidal_at(positions: torch.Tensor, d) -> torch.Tensor:
    """Sinusoids at integer ``positions`` (S,) -> (S, d), in float32
    arithmetic on their device (decode)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = positions.to(torch.float32)[:, None] / torch.pow(
        torch.tensor(10000.0, device=positions.device), 2 * i / d)
    out = torch.zeros((positions.shape[0], d), dtype=torch.float32,
                      device=positions.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
