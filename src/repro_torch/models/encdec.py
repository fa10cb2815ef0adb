"""Whisper-style encoder-decoder (arXiv:2212.04356): the JAX package's
``models/encdec.py``.

The audio frontend (mel spectrogram + 2x conv) is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, T_enc, D).
The backbone is the reference's: pre-LN blocks, GELU MLPs, sinusoidal
positions on the encoder and (the reference's deviation from Whisper's
learned ones) on the decoder, bidirectional encoder self-attention, causal
decoder self-attention and cross-attention, the decoder embedding tied to
the output head.

Parameters (JAX names): ``embed`` ``[padded_vocab, d]``, ``enc_blocks[i]``
(``ln1``, ``ln2``, ``attn``, ``mlp``), ``dec_blocks[i]`` (``ln1``,
``ln_x``, ``ln2``, ``attn``, ``xattn``, ``mlp``), ``enc_norm`` (an
unstacked subtree) and ``final_norm``.  On a "model" mesh axis the
attention projections and MLPs split by heads and hidden units (the
cross-attention's ``wk`` / ``wv`` on the encoder's output, which enters
each layer through ``tp.copy_in``), the tied head by vocabulary rows; the
LayerNorms stay replicated (a sharded module serves with this rank's
shard of each cache, ``sharding.cache_specs``).  Serving: ``prefill``
encodes the frames, projects every decoder layer's cross K / V once (``cross``
``[L, B, T_enc, n_kv, hd]``) and writes the prompt into the self-attention
cache (``self``: ``cache_init``'s tensors stacked over the layers) from
position 0; ``decode_step`` writes one position a layer in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, _params, layer_cache


def enc_spec(cfg: ModelConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      rope_style="none", causal=False)


def dec_spec(cfg: ModelConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      rope_style="none", causal=True)


def cross_spec(cfg: ModelConfig) -> L.AttnSpec:
    return dataclasses.replace(dec_spec(cfg), causal=False)


def _norm(cfg, x, p):
    return L.norm_apply(x, p, cfg.norm, cfg.norm_eps)


class EncBlock(nn.Module):
    """Bidirectional self-attention, then the MLP, each residual."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.ln1 = _params(L.norm_init(cfg.d_model, cfg.norm, dt, device))
        self.ln2 = _params(L.norm_init(cfg.d_model, cfg.norm, dt, device))
        self.attn = _params(L.attn_init(enc_spec(cfg), dt, **kw))
        self.mlp = _params(L.mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp, dt,
                                      **kw))

    def forward(self, x):
        cfg = self.cfg
        x = x + L.mha(self.attn, _norm(cfg, x, self.ln1), enc_spec(cfg))
        return x + L.mlp_apply(self.mlp, _norm(cfg, x, self.ln2), cfg.mlp,
                               width=cfg.d_ff)

    def tree(self) -> dict:
        return {k: dict(getattr(self, k).items())
                for k in ("ln1", "ln2", "attn", "mlp")}


class DecBlock(nn.Module):
    """Causal self-attention, cross-attention over the encoder's output,
    then the MLP, each residual."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        for name in ("ln1", "ln_x", "ln2"):
            setattr(self, name, _params(L.norm_init(cfg.d_model, cfg.norm,
                                                    dt, device)))
        self.attn = _params(L.attn_init(dec_spec(cfg), dt, **kw))
        self.xattn = _params(L.attn_init(cross_spec(cfg), dt, **kw))
        self.mlp = _params(L.mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp, dt,
                                      **kw))

    def forward(self, x, enc_out=None, self_cache=None, cross_cache=None,
                pos=None, ax=None):
        """Training: ``enc_out`` (B, T_enc, D).  Serving: ``self_cache``
        written in place at ``pos`` and ``cross_cache`` (``{"k", "v"}``
        projected from the encoder's output; with the model axis ``ax``
        of a sharded module, this rank's shard)."""
        cfg = self.cfg
        x = x + L.mha(self.attn, _norm(cfg, x, self.ln1), dec_spec(cfg),
                      cache=self_cache, cache_pos=pos)
        xn = _norm(cfg, x, self.ln_x)
        if cross_cache is not None:
            x = x + cross_from_cache(cfg, self.xattn, xn, cross_cache, ax)
        else:
            x = x + L.mha(self.xattn, xn, cross_spec(cfg), kv_x=enc_out)
        return x + L.mlp_apply(self.mlp, _norm(cfg, x, self.ln2), cfg.mlp,
                               width=cfg.d_ff)

    def tree(self) -> dict:
        return {k: dict(getattr(self, k).items())
                for k in ("ln1", "ln_x", "ln2", "attn", "xattn", "mlp")}


def cross_from_cache(cfg: ModelConfig, p, x, cc: dict, ax=None):
    """Cross-attention against precomputed encoder K / V: float32 scores
    over sqrt(hd) (the reference divides here; ``mha`` multiplies by the
    reciprocal), probabilities cast back before they meet ``v``.

    On a model axis ``ax`` (a sharded module), ``cc`` is this rank's
    shard: its kv heads, which its own q heads read (``wo``'s partial sums
    all-reduced); or every kv head over its span of the encoder positions
    (or all of them), which every q head reads (``layers.softmax_split``)
    before the rank keeps its heads' rows for ``wo``."""
    spec = cross_spec(cfg)
    B, Sq, _ = x.shape
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    by_span = ax is not None and cc["k"].shape[2] == kv
    if by_span:
        q = L.whole_heads(q, h * hd, ax)
    q = q.reshape(B, Sq, -1, hd)
    k, v = cc["k"], cc["v"]
    rep = h // kv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if by_span:
        out = L.softmax_split(scores, v, dt, ax)
        if not tp.split(p["wo"].shape[0], h * hd):
            return out @ p["wo"].to(dt)
        out = tp.part(out, -1, ax)
    else:
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            B, Sq, -1)
    y = out @ p["wo"].to(dt)
    return y if ax is None else tp.all_reduce(y, ax)


def _positions(n: int, like: torch.Tensor):
    return L.sinusoidal_positions(n, like.shape[-1]).to(like.device,
                                                        like.dtype)


class EncDec(LM):
    LAYER_GROUPS = ("enc_blocks", "dec_blocks")
    UNSTACKED = ("enc_norm",)

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "the enc-dec's")
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=dev)
        self.embed = nn.Parameter(L.embed_init(cfg.padded_vocab, cfg.d_model,
                                               dt, **kw))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, **kw)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = _params(L.norm_init(cfg.d_model, cfg.norm, dt, dev))
        self.final_norm = _params(L.norm_init(cfg.d_model, cfg.norm, dt, dev))
        self.lm_head = None  # the head is the embedding, always

    def _run(self, block, *args):
        if self.cfg.remat == "full" and torch.is_grad_enabled():
            return ckpt.checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def encode(self, frames):
        """frames: (B, T_enc, D) precomputed frame embeddings (the frontend
        stub), cast to the compute dtype, plus sinusoidal positions."""
        x = frames.to(self.cfg.cdtype())
        x = x + _positions(x.shape[1], x)
        for block in self.enc_blocks:
            with tp.gathered(block):
                x = self._run(block, x)
        with tp.gathered(self.enc_norm):
            return _norm(self.cfg, x, self.enc_norm)

    def _decoded(self, enc_out, tokens):
        """The decoder's final-normed hidden states."""
        x = self.embed_tokens(tokens)
        x = x + _positions(tokens.shape[1], x)
        for block in self.dec_blocks:
            x = self._run(block, x, enc_out)
        return _norm(self.cfg, x, self.final_norm)

    def decode_train(self, enc_out, tokens):
        logits, sharded = self.head_logits(self._decoded(enc_out, tokens))
        return tp.gather(logits, -1, tp.active()) if sharded else logits

    def forward(self, frames, tokens):
        return self.decode_train(self.encode(frames), tokens)

    def loss_fn(self, batch: dict):
        return self.loss_of(self._decoded(self.encode(batch["frames"]),
                                          batch["tokens"]), batch["labels"])

    # ---- serving --------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, enc_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, enc_len,
                          self.embed.device, self.serving_axis())

    @torch.no_grad()
    def prefill(self, frames, tokens, max_len: int) -> tuple:
        """Encode the frames, project each decoder layer's cross K / V,
        then run the prompt (B, S) through the decoder from position 0.
        Returns (last-token logits (B, 1, V), cache).  On a model-sharded
        module each rank keeps its shard of the cross K / V: its kv heads,
        or every head over its span of the encoder positions."""
        cfg = self.cfg
        ax = self.serving_axis()
        enc_out = self.encode(frames)
        B, Te, _ = enc_out.shape
        cache = self.init_cache(B, max_len, Te)
        kv, hd = cfg.n_kv_heads, cfg.hd
        cross = cache["cross"]
        span = cross["k"].shape[2]
        first = ax.rank * span if span != Te else 0
        for i, block in enumerate(self.dec_blocks):
            for name in ("k", "v"):
                w = block.xattn["w" + name]
                with tp.gathered(w):
                    # the reference's product promotes to the wider dtype
                    dt = torch.promote_types(enc_out.dtype, w.dtype)
                    t = enc_out.to(dt) @ w.to(dt)
                if cross[name].shape[3] == kv:  # every kv head here
                    t = L.whole_heads(t, kv * hd, ax)[:, first:first + span]
                cross[name][i] = t.reshape(B, span, -1, hd)
        x = self.embed_tokens(tokens)
        x = x + _positions(tokens.shape[1], x)
        for i, block in enumerate(self.dec_blocks):
            with tp.gathered(block):
                x = block(x, self_cache=layer_cache(cache, "self", i),
                          cross_cache=layer_cache(cache, "cross", i), pos=0,
                          ax=ax)
        return self.final_logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos: int) -> tuple:
        """tokens: (B, 1) int at position ``pos`` (a host int).  Writes each
        layer's self K / V into ``cache`` in place; returns (logits (B, 1,
        V), cache)."""
        cfg, pos = self.cfg, int(pos)
        x = self.embed_tokens(tokens)
        at = torch.arange(pos, pos + 1, device=x.device)
        x = x + L.sinusoidal_at(at, cfg.d_model).to(x.dtype)
        for i, block in enumerate(self.dec_blocks):
            with tp.gathered(block):
                x = block(x, self_cache=layer_cache(cache, "self", i),
                          cross_cache=layer_cache(cache, "cross", i),
                          pos=pos, ax=self.serving_axis())
        return self.final_logits(x), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device=None, ax=None) -> dict:
    """``self``: one ``max_len`` KV cache a decoder layer, stacked;
    ``cross``: the encoder's K / V for each decoder layer, zeros until
    ``prefill`` fills them.  All in the compute dtype (``pos`` int32).  With
    a model axis ``ax``, this rank's shard (``tensor_parallel.local_cache``)."""
    dev = resolve_device(device)
    if ax is not None:
        return tp.local_cache(init_cache(cfg, batch, max_len, enc_len,
                                         "meta"), ax, dev)
    one = L.cache_init(batch, max_len, cfg.n_kv_heads, cfg.hd, cfg.cdtype(),
                       device=dev)
    shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    return {"self": {k: v.expand((cfg.n_layers,) + v.shape).clone()
                     for k, v in one.items()},
            "cross": {k: torch.zeros(shape, dtype=cfg.cdtype(), device=dev)
                      for k in ("k", "v")}}
