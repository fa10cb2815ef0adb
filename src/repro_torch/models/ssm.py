"""Mamba2 (SSD, state-space duality, arXiv:2405.21060): the JAX package's
``models/ssm.py`` in PyTorch.

Training uses the chunked SSD algorithm: quadratic attention-like compute
inside chunks of Q tokens plus a linear recurrent state pass between
chunks.  Decoding is the O(1)-per-token recurrence on the (H, N, P) state:
no KV cache.  Every SSD contraction and decay runs in float32, off TF32 on
the card (``layers.true_float32``).

Head layout: d_inner = expand * d_model split into H heads of P = head_dim;
B / C projections are per group (G groups broadcast over heads).

On a "model" mesh axis of m (``distributed/tensor_parallel.py``) each
projection, convolution and ``norm_w`` / ``out_proj`` holds what the
reference's rules give it: this rank's 1/m of its columns (channels,
rows) where m divides them, else all of them; ``A_log``, ``D`` and
``dt_bias`` are replicated (``_mixer_model_parallel``).  Where the H heads
split, each rank runs the SSD on its H/m heads; where they do not, every
rank runs it on all of them.  The reference's SSM never reads
``seq_parallel`` (its blocks pin the residual to the whole sequence), so
neither does this one.  A model-sharded module serves with this rank's
shard of the decode state (``sharding.cache_specs``): the SSD state of its
heads where they split, the convolutions' states of its channels where
they split.

The model (``SSM``) holds ``embed``, per-layer blocks (``ln`` and
``mixer``), ``final_norm`` and ``lm_head`` when untied, in the JAX
package's tree (``jax_tree`` / ``load_jax_tree``, shared with the
transformer).  ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
parameter dtype, held by a module of their own (``Scalars``, which FSDP2
shards as a unit of its own beside its block's).  The decode state is the
reference's stacked layout: ``conv`` ``{"x", "b", "c"}`` ``[L, B, d_conv -
1, C]`` in the compute dtype and ``ssm`` ``[L, B, H, N, P]`` in float32,
updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, _params

FLOAT32_KEYS = ("A_log", "D", "dt_bias")


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.n_groups, s.d_state, s.head_dim


def mixer_init(cfg: ModelConfig, dtype, *, generator: torch.Generator,
               device=None) -> dict:
    """Per-stream projections (z / x / B / C / dt), as the reference keeps
    them; ``A_log``, ``D`` and ``dt_bias`` in float32."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, G, N, P = dims(cfg)
    sc = 1.0 / math.sqrt(d)
    kw = dict(generator=generator, device=device)

    def tn(shape, scale):
        return L.truncated_normal(shape, dtype, scale, **kw)

    def full(n, value, dt=dtype):
        return torch.full((n,), value, dtype=dt, device=device)

    return {
        "z_proj": tn((d, d_inner), sc),
        "x_proj": tn((d, d_inner), sc),
        "b_proj": tn((d, G * N), sc),
        "c_proj": tn((d, G * N), sc),
        "dt_proj": tn((d, H), sc),
        "conv_wx": tn((s.d_conv, d_inner), 0.5),
        "conv_bx": full(d_inner, 0.0),
        "conv_wb": tn((s.d_conv, G * N), 0.5),
        "conv_bb": full(G * N, 0.0),
        "conv_wc": tn((s.d_conv, G * N), 0.5),
        "conv_bc": full(G * N, 0.0),
        "A_log": full(H, 0.0, torch.float32),  # A = -exp(A_log) = -1
        "D": full(H, 1.0, torch.float32),
        "dt_bias": full(H, -2.0, torch.float32),  # softplus(-2) ~ 0.12
        "norm_w": full(d_inner, 1.0),
        "out_proj": tn((d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


class Scalars(nn.Module):
    """The mixer's float32 per-head parameters ``A_log``, ``D`` and
    ``dt_bias`` as a module of their own, whose forward is what the mixer
    makes of them.  FSDP2 shards a module's parameters as one unit of one
    dtype, so under FSDP with 16-bit parameters these are a unit beside
    their block's (``training/train_loop._fully_shard``), gathered for
    this forward; its outputs are new tensors, never views of the
    gathered parameters, which FSDP2 frees after it."""

    def __init__(self, tree: dict):
        super().__init__()
        for k in FLOAT32_KEYS:
            setattr(self, k, nn.Parameter(tree[k]))

    def forward(self, dtraw, xh, heads=slice(None), ax=None):
        """For the heads ``heads`` (all by default): ``dt`` = softplus(raw
        dt + ``dt_bias``), ``A`` = -exp(``A_log``) and the skip term ``xh *
        D`` (xh: (..., heads, P)), all float32.  On a model axis ``ax`` the
        parameters pass ``tp.copy_in`` first: each rank's gradient is its
        heads' part."""
        def mine(v):
            return (v if ax is None else tp.copy_in(v, ax))[heads]
        dt = F.softplus(dtraw.to(torch.float32) + mine(self.dt_bias))
        return dt, -torch.exp(mine(self.A_log)), xh * mine(self.D)[:, None]


class Mixer(nn.Module):
    """A mixer's parameters, indexable and iterable as the JAX tree's
    ``mixer`` is (``mixer_init``'s keys): the projections, convolutions,
    ``norm_w`` and ``out_proj`` in the parameter dtype, and the float32
    ``A_log``, ``D`` and ``dt_bias`` in ``scalars``."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if k not in FLOAT32_KEYS:
                setattr(self, k, nn.Parameter(v))
        self.scalars = Scalars(tree)

    def __getitem__(self, key):
        return getattr(self.scalars if key in FLOAT32_KEYS else self, key)

    def keys(self):
        return self._keys

    def items(self):
        return [(k, self[k]) for k in self._keys]


def _causal_conv(u, w, b, *, state=None):
    """Depthwise causal conv. u: (B,S,C); w: (K,C). state: (B,K-1,C) or None.

    Returns (y, new_state) where new_state holds the last K-1 inputs (a
    view of the padded input).
    """
    K = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    y = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(K))
    y = y + b
    return F.silu(y), up[:, -(K - 1):, :]


def _ssd_chunked(xh, dt, A, Bh, Ch, chunk, init_state=None):
    """Chunked SSD scan.

    xh: (B,S,H,P) f32; dt: (B,S,H) f32 (post-softplus); A: (H,) f32 (negative);
    Bh, Ch: (B,S,H,N) f32.  Returns (y: (B,S,H,P), final_state: (B,H,N,P)).
    """
    Bsz, S, H, P = xh.shape
    N = Bh.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSD chunk "
                         f"{Q}")
    nc = S // Q

    def r(t):
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = r(xh), r(dt), r(Bh), r(Ch)
    with L.true_float32(xh):
        dA = dtc * A  # (B,nc,Q,H), negative
        cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk
        total = cs[:, :, -1, :]  # (B,nc,H)

        # intra-chunk: y[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
        CB = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
        seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b,c,i,j,h)
        mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                     device=xh.device))
        # masked before the exp: seg above the diagonal is a decay sum that
        # passes 88 on long chunks, and exp's backward at inf is 0 * inf
        # (NaN) even where the mask drops it; below, the values are the
        # reference's, whose where-after-exp gives NaN gradients there
        decay = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                      torch.full((), -torch.inf,
                                                 device=xh.device)))
        scores = CB * decay * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

        # per-chunk local end state: S_c = sum_j exp(total - cs_j) dt_j B_j x_j^T
        w = torch.exp(total[:, :, None, :] - cs) * dtc  # (b,c,j,h)
        S_local = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", w, Bc, xc)

        # inter-chunk recurrence over c: S_prev[c] = S_prev[c-1]*exp(total)
        # + local
        s = (xh.new_zeros((Bsz, H, N, P)) if init_state is None
             else init_state.to(torch.float32))
        prevs = []
        for c in range(nc):
            prevs.append(s)
            s = s * torch.exp(total[:, c])[:, :, None, None] + S_local[:, c]
        S_prevs = torch.stack(prevs, dim=1)  # (B,nc,H,N,P): before chunk

        y_inter = torch.einsum("bcihn,bchnp->bcihp", Cc, S_prevs)
        y_inter = y_inter * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, s


def _projections(p, x, conv_state):
    """z, the three causal convolutions' outputs and new states, and the
    raw dt: what ``mixer_apply`` and ``mixer_decode`` share."""
    cs = conv_state or {}
    z = x @ p["z_proj"]
    xr, ncx = _causal_conv(x @ p["x_proj"], p["conv_wx"], p["conv_bx"],
                           state=cs.get("x"))
    Braw, ncb = _causal_conv(x @ p["b_proj"], p["conv_wb"], p["conv_bb"],
                             state=cs.get("b"))
    Craw, ncc = _causal_conv(x @ p["c_proj"], p["conv_wc"], p["conv_bc"],
                             state=cs.get("c"))
    return z, xr, Braw, Craw, x @ p["dt_proj"], {"x": ncx, "b": ncb,
                                                 "c": ncc}


def _sharded(p, cfg: ModelConfig) -> bool:
    """Whether the mixer's projections are sharded over the model axis."""
    d_inner, _, G, N, _ = dims(cfg)
    return p["x_proj"].shape[1] != d_inner or p["b_proj"].shape[1] != G * N


def mixer_apply(p, x, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                return_state=False):
    """Full-sequence mixer. x: (B,S,D). Returns y [, (conv_state, ssm_state)].
    With the projections sharded over the model axis it runs
    ``_mixer_model_parallel`` (the states are then this rank's heads and
    channels)."""
    d_inner, H, G, N, P = dims(cfg)
    scalars = p.scalars
    p = L.cast_tree_except(p, x.dtype, FLOAT32_KEYS)
    if _sharded(p, cfg):
        return _mixer_model_parallel(p, scalars, x, cfg,
                                     conv_state=conv_state,
                                     ssm_state=ssm_state,
                                     return_state=return_state)
    z, xr, Braw, Craw, dtraw, new_conv = _projections(p, x, conv_state)

    Bsz, S, _ = x.shape
    xh = xr.reshape(Bsz, S, H, P).to(torch.float32)
    Bh = Braw.reshape(Bsz, S, G, N).to(torch.float32)
    Ch = Craw.reshape(Bsz, S, G, N).to(torch.float32)
    rep = H // G
    Bh = torch.repeat_interleave(Bh, rep, dim=2)
    Ch = torch.repeat_interleave(Ch, rep, dim=2)
    dt, A, skip = scalars(dtraw, xh)

    y, final = _ssd_chunked(xh, dt, A, Bh, Ch, cfg.ssm.chunk,
                            init_state=ssm_state)
    y = y + skip
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, final)
    return out


def _rmsnorm_split(x, w, eps, whole: int, ax):
    """``layers.rmsnorm`` of ``x`` whose last dim is this rank's slice of
    ``whole`` channels (``w`` its slice of the weight): the sum of squares
    is summed over the model ranks, forward and backward."""
    xf = x.to(torch.float32)
    # summed forward; each rank's slice reads the sum, so its gradient is
    # summed too (reduce-out, then copy-in)
    ss = tp.copy_in(tp.reduce_out(torch.sum(xf * xf, dim=-1, keepdim=True),
                                  ax), ax)
    y = xf * torch.rsqrt(ss / whole + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def _mixer_model_parallel(p, scalars, x, cfg: ModelConfig, *,
                          conv_state=None, ssm_state=None,
                          return_state=False):
    """The mixer with some of its projections sharded over the model axis
    (x: (B, S, D), replicated) -> the output, replicated [, (conv_state,
    ssm_state)], the states laid out as ``sharding.cache_specs`` splits
    them: each convolution's channels where its projection's columns
    split, the SSD state's heads where the heads split.

    A projection whose columns the spec splits (``param_spec``: where the
    axis divides them) is run on this rank's columns from the input
    through ``tp.copy_in``, its convolution on those channels; one the
    spec leaves whole runs whole on every rank from the replicated input.

    - Heads that split (H / m a rank): each rank runs the SSD on its heads
      (z, x and dt from its columns, its heads' slices of the replicated
      ``A_log``, ``D`` and ``dt_bias`` through ``tp.copy_in``).  B and C
      are read whole by every rank's heads: a split one is gathered
      (``tp.gather_to_shards``: the backward sums the ranks' gradients
      before each keeps its slice), a whole one passes ``tp.copy_in``;
      each rank's heads read their groups.
    - Heads that do not split: every rank runs the SSD on all of them,
      each split projection's output gathered whole first (``tp.gather``).
    - The gated RMSNorm and ``out_proj``: where d_inner splits, each rank
      normalises its channels (the sum of squares summed over the ranks)
      and ``out_proj`` is row-parallel (``tp.reduce_out``); else both run
      whole."""
    d_inner, H, G, N, P = dims(cfg)
    ax = tp.active()
    m, r = ax.size, ax.rank
    heads_split = tp.split(p["dt_proj"].shape[1], H)
    channels_split = tp.split(p["x_proj"].shape[1], d_inner)
    x, xt = tp.enter(x, ax, False)
    cs = conv_state or {}
    new_conv = {}

    def stream(w, whole: int, key=None, conv_w=None, conv_b=None):
        """(x @ w, convolved when ``key`` names its state; split): this
        rank's columns, or all of them."""
        split = tp.split(w.shape[1], whole)
        out = (xt if split else x) @ w
        if key is not None:
            out, new_conv[key] = _causal_conv(out, conv_w, conv_b,
                                              state=cs.get(key))
        return out, split

    z, _ = stream(p["z_proj"], d_inner)
    xs, _ = stream(p["x_proj"], d_inner, "x", p["conv_wx"], p["conv_bx"])
    dtraw, _ = stream(p["dt_proj"], H)
    Bsz, S, _ = x.shape
    if heads_split:
        hl = H // m
        heads = slice(r * hl, (r + 1) * hl)

        def whole(raw, split):  # read by this rank's heads
            return tp.gather_to_shards(raw, -1, ax) if split \
                else tp.copy_in(raw, ax)
    else:  # every rank runs every head
        hl, heads = H, slice(None)

        def whole(raw, split):
            return tp.gather(raw, -1, ax) if split else raw
        xs = whole(xs, channels_split)
    groups = (heads.start or 0) + torch.arange(hl, device=x.device)
    groups = groups // (H // G)

    def per_head(raw):  # these heads' B or C, (B, S, hl, N) f32
        return raw.reshape(Bsz, S, G, N).to(torch.float32)[:, :, groups]

    Bh = per_head(whole(*stream(p["b_proj"], G * N, "b", p["conv_wb"],
                                p["conv_bb"])))
    Ch = per_head(whole(*stream(p["c_proj"], G * N, "c", p["conv_wc"],
                                p["conv_bc"])))
    xh = xs.reshape(Bsz, S, hl, P).to(torch.float32)
    dt, A, skip = scalars(dtraw, xh, heads, ax if heads_split else None)
    y, final = _ssd_chunked(xh, dt, A, Bh, Ch, cfg.ssm.chunk,
                            init_state=ssm_state)
    y = (y + skip).reshape(Bsz, S, hl * P).to(x.dtype)
    out = _gated_out(p, y, z, cfg, ax, heads_split, channels_split)
    return (out, (new_conv, final)) if return_state else out


def _gated_out(p, y, z, cfg: ModelConfig, ax, heads_split: bool,
               channels_split: bool):
    """The gated RMSNorm and ``out_proj`` of the SSD's output ``y`` (this
    rank's heads' channels with ``heads_split``, else all of them), whole
    on every rank.  Where d_inner splits, each rank normalises its
    channels (a whole ``y`` sliced through ``tp.scatter``) and ``out_proj``
    is row-parallel; else both run whole."""
    d_inner = dims(cfg)[0]
    if not channels_split:
        y = L.rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
        return y @ p["out_proj"]
    if not heads_split:
        y = tp.scatter(y, -1, ax)
    y = _rmsnorm_split(y * F.silu(z), p["norm_w"], cfg.norm_eps, d_inner, ax)
    return tp.reduce_out(y @ p["out_proj"], ax)


def mixer_decode(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """One-token recurrence. x: (B,1,D). Returns (y, (conv_state, ssm_state)).
    With projections sharded over the model axis the states are laid out
    as in ``mixer_apply``: where the heads split each rank steps its heads
    (their slices of ``A_log``, ``D`` and ``dt_bias``), else all of them;
    a split projection's output is gathered where the heads it feeds are
    not this rank's alone (B and C always), and the gated norm and
    ``out_proj`` meet the other ranks where d_inner splits."""
    d_inner, H, G, N, P = dims(cfg)
    scalars = p.scalars
    p = L.cast_tree_except(p, x.dtype, FLOAT32_KEYS)
    ax = tp.active() if _sharded(p, cfg) else None
    z, xr, Braw, Craw, dtraw, new_conv = _projections(p, x, conv_state)
    heads_split = channels_split = False
    if ax is not None:
        heads_split = tp.split(p["dt_proj"].shape[1], H)
        channels_split = tp.split(p["x_proj"].shape[1], d_inner)
        Braw, Craw = (tp.all_gather(t, -1, ax) if t.shape[-1] != G * N
                      else t for t in (Braw, Craw))
        if channels_split and not heads_split:
            xr = tp.all_gather(xr, -1, ax)

    Bsz = x.shape[0]
    hl = xr.shape[-1] // P  # the heads this rank steps
    first = ax.rank * hl if heads_split else 0
    heads = slice(first, first + hl)
    groups = (first + torch.arange(hl, device=x.device)) // (H // G)
    xh = xr.reshape(Bsz, hl, P).to(torch.float32)
    Bh = Braw.reshape(Bsz, G, N)[:, groups].to(torch.float32)
    Ch = Craw.reshape(Bsz, G, N)[:, groups].to(torch.float32)
    dt, A, skip = scalars(dtraw[:, 0, :], xh, heads)
    dA = torch.exp(dt * A)  # (B,H)
    # state update: S = S*dA + dt * B x^T
    upd = dt[..., None, None] * Bh[..., :, None] * xh[..., None, :]
    new_state = ssm_state * dA[..., None, None] + upd
    with L.true_float32(xh):
        y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    y = (y + skip).reshape(Bsz, 1, hl * P).to(x.dtype)
    return _gated_out(p, y, z, cfg, ax, heads_split, channels_split), \
        (new_conv, new_state)


# ---------------------------------------------------------------------------
# pure-Mamba2 LM (mamba2-370m)
# ---------------------------------------------------------------------------

class SSMBlock(nn.Module):
    """One residual block: norm, then the mixer."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        dt = cfg.pdtype()
        self.cfg = cfg
        self.ln = _params(L.norm_init(cfg.d_model, cfg.norm, dt, device))
        self.mixer = Mixer(mixer_init(cfg, dt, generator=generator,
                                      device=device))

    def _normed(self, x):
        return L.norm_apply(x, self.ln, self.cfg.norm, self.cfg.norm_eps)

    def forward(self, x):
        return x + mixer_apply(self.mixer, self._normed(x), self.cfg)

    def tree(self) -> dict:
        return {"ln": dict(self.ln.items()),
                "mixer": dict(self.mixer.items())}


class SSM(LM):
    """The Mamba2 LM.  Parameters (JAX names): ``embed`` ``[padded_vocab,
    d]``, ``blocks[i]`` with ``ln`` and ``mixer``, ``final_norm``,
    ``lm_head`` ``[d, padded_vocab]`` when untied."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "the SSM's")
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=dev)
        self.embed = nn.Parameter(L.embed_init(cfg.padded_vocab, cfg.d_model,
                                               dt, **kw))
        self.blocks = nn.ModuleList(SSMBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(L.norm_init(cfg.d_model, cfg.norm, dt, dev))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.truncated_normal(
                (cfg.d_model, cfg.padded_vocab), dt,
                1.0 / math.sqrt(cfg.d_model), **kw))

    def hidden_states(self, tokens):
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for block in self.blocks:
            x = ckpt.checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
        return L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps)

    # ---- serving --------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.embed.device,
                          self.serving_axis())

    @torch.no_grad()
    def prefill(self, tokens, max_len: int) -> tuple:
        """Chunked-SSD prefill; returns (last-token logits, decode-ready
        state; on a model-sharded module this rank's heads and
        channels)."""
        cache = self.init_cache(tokens.shape[0], max_len)
        x = self.embed_tokens(tokens)
        for i, block in enumerate(self.blocks):
            with tp.gathered(block):
                y, (conv, ssm) = mixer_apply(block.mixer, block._normed(x),
                                             self.cfg, return_state=True)
            x = x + y
            _store(cache, i, conv, ssm)
        return self.final_logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos=None) -> tuple:
        """tokens: (B, 1); the recurrence is position-free.  Updates
        ``cache`` in place; returns (logits (B, 1, V), cache)."""
        x = self.embed_tokens(tokens)
        for i, block in enumerate(self.blocks):
            conv = {k: v[i] for k, v in cache["conv"].items()}
            with tp.gathered(block):
                y, (nconv, nssm) = mixer_decode(block.mixer,
                                                block._normed(x), self.cfg,
                                                conv, cache["ssm"][i])
            x = x + y
            _store(cache, i, nconv, nssm)
        return self.final_logits(x), cache


def _store(cache: dict, i: int, conv: dict, ssm) -> None:
    for k, v in conv.items():
        cache["conv"][k][i].copy_(v)
    cache["ssm"][i].copy_(ssm)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, ax=None) -> dict:
    """The O(1) decode state (``max_len`` is unused): the last d_conv - 1
    inputs of each convolution and the SSD state, stacked over layers; with
    a model axis ``ax``, this rank's shard (``tensor_parallel.local_cache``:
    its heads and channels)."""
    dev = resolve_device(device)
    if ax is not None:
        return tp.local_cache(init_cache(cfg, batch, max_len, "meta"), ax,
                              dev)
    d_inner, H, G, N, P = dims(cfg)
    Lr, k = cfg.n_layers, cfg.ssm.d_conv - 1

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {"conv": {"x": zeros((Lr, batch, k, d_inner), cfg.cdtype()),
                     "b": zeros((Lr, batch, k, G * N), cfg.cdtype()),
                     "c": zeros((Lr, batch, k, G * N), cfg.cdtype())},
            "ssm": zeros((Lr, batch, H, N, P), torch.float32)}
