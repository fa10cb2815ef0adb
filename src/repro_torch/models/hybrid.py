"""Zamba2-style hybrid (arXiv:2411.15242): a Mamba2 backbone and one SHARED
attention block applied after every ``shared_attn_period`` Mamba layers
(the JAX package's ``models/hybrid.py``).

The shared block's parameters are one ``transformer.Block`` reused at each
application point, so autograd sums their gradient over the applications
(the reference broadcasts them into its scan); each application keeps its
own KV cache.  The shared block attends with the config's sliding window
(``cfg.sliding_window``; 0 = full), so its cache is a ring bounded by the
window while the SSM state is O(1).

On a "model" mesh axis the Mamba layers split as ``models/ssm.py`` says
and the shared block as every transformer block does (its gradient still
sums over the applications); the untied head is vocabulary-parallel.  A
model-sharded module serves with this rank's shard of each state: the
SSM's heads and channels, and ``shared_kv`` by kv head, or by sequence
where the kv heads do not split (``sharding.cache_specs``).

In the JAX tree ``shared_attn`` is an unstacked subtree (``LM.UNSTACKED``):
one leaf per tensor of the block, after ``blocks/*`` in sorted order.  The
decode state is the reference's layout: the SSM's ``conv`` / ``ssm``
stacked over the Mamba layers and ``shared_kv`` (``k`` / ``v`` ``[n_app, B,
kv_len, n_kv, hd]`` in the compute dtype, ``pos`` ``[n_app, kv_len]``,
``kv_len = min(window, max_len)``), updated in place at host-int
positions.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import (LM, Block, _params, cache_len,
                                            layer_cache)


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_period


class Hybrid(LM):
    """The hybrid LM.  Parameters (JAX names): ``embed`` ``[padded_vocab,
    d]``, ``blocks[i]`` (``ssm.SSMBlock``: ``ln`` and ``mixer``),
    ``final_norm``, ``lm_head`` ``[d, padded_vocab]`` when untied, and
    ``shared_attn`` (``ln1``, ``ln2``, ``attn``, ``mlp``)."""

    UNSTACKED = ("shared_attn",)

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family != "hybrid" or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "the hybrid's")
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=dev)
        self.embed = nn.Parameter(L.embed_init(cfg.padded_vocab, cfg.d_model,
                                               dt, **kw))
        self.blocks = nn.ModuleList(ssm.SSMBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(L.norm_init(cfg.d_model, cfg.norm, dt, dev))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.truncated_normal(
                (cfg.d_model, cfg.padded_vocab), dt,
                1.0 / math.sqrt(cfg.d_model), **kw))
        self.shared_attn = Block(cfg, **kw)

    def _groups(self):
        """(application index, its Mamba layers' indices)."""
        period = self.cfg.shared_attn_period
        return [(g, range(g * period, (g + 1) * period))
                for g in range(n_shared_applications(self.cfg))]

    def hidden_states(self, tokens):
        """tokens: (B, S) int -> the final-normed hidden states.  Under
        ``remat == "full"`` each Mamba block and each application of the
        shared block is recomputed in the backward on its own."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        remat = cfg.remat == "full" and torch.is_grad_enabled()

        def run(f, x):
            return ckpt.checkpoint(f, x, use_reentrant=False) if remat \
                else f(x)

        for _, layers in self._groups():
            for i in layers:
                x = run(self.blocks[i], x)
            x = run(self.shared_attn, x)
        return L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps)

    # ---- serving --------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.embed.device,
                          self.serving_axis())

    @torch.no_grad()
    def prefill(self, tokens, max_len: int) -> tuple:
        """The chunked SSD with its final states for each Mamba block; each
        application's ring filled from the last ``min(S, kv_len)`` tokens
        of the shared block's input (slot ``position % kv_len``).  Returns
        (last-token logits (B, 1, V), cache)."""
        cfg = self.cfg
        B, S = tokens.shape
        cache = self.init_cache(B, max_len)
        T = min(S, cache_len(cfg, max_len))
        x = self.embed_tokens(tokens)
        for g, layers in self._groups():
            for i in layers:
                block = self.blocks[i]
                with tp.gathered(block):
                    y, (conv, st) = ssm.mixer_apply(
                        block.mixer, block._normed(x), cfg,
                        return_state=True)
                x = x + y
                ssm._store(cache, i, conv, st)
            with tp.gathered(self.shared_attn):
                self.shared_attn.tail_kv(x[:, S - T:], S - T,
                                         layer_cache(cache, "shared_kv", g))
                x = self.shared_attn(x)
        return self.final_logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos: int) -> tuple:
        """tokens: (B, 1) int at position ``pos`` (a host int): the SSM
        recurrence, then the shared block's cached attention (a ring when
        windowed).  Updates ``cache`` in place; returns (logits (B, 1, V),
        cache)."""
        cfg, pos = self.cfg, int(pos)
        x = self.embed_tokens(tokens)
        for g, layers in self._groups():
            for i in layers:
                block = self.blocks[i]
                conv = {k: v[i] for k, v in cache["conv"].items()}
                with tp.gathered(block):
                    y, (nconv, nssm) = ssm.mixer_decode(
                        block.mixer, block._normed(x), cfg, conv,
                        cache["ssm"][i])
                x = x + y
                ssm._store(cache, i, nconv, nssm)
            with tp.gathered(self.shared_attn):
                x = self.shared_attn(x, layer_cache(cache, "shared_kv", g),
                                     pos)
        return self.final_logits(x), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, ax=None) -> dict:
    """The SSM's O(1) state (``ssm.init_cache``) and ``shared_kv``: one KV
    cache of ``min(window, max_len)`` slots per application, stacked; with a
    model axis ``ax``, this rank's shard (``tensor_parallel.local_cache``)."""
    dev = resolve_device(device)
    if ax is not None:
        return tp.local_cache(init_cache(cfg, batch, max_len, "meta"), ax,
                              dev)
    cache = ssm.init_cache(cfg, batch, max_len, device=dev)
    n_app = n_shared_applications(cfg)
    one = L.cache_init(batch, cache_len(cfg, max_len), cfg.n_kv_heads,
                       cfg.hd, cfg.cdtype(), device=dev)
    cache["shared_kv"] = {k: v.expand((n_app,) + v.shape).clone()
                          for k, v in one.items()}
    return cache
