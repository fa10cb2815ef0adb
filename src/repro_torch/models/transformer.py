"""Decoder-only transformer LM: the dense, MoE and VLM-prefix families (the
JAX package's ``models/transformer.py``), trained and served.

The blocks are an ``nn.ModuleList`` of per-layer modules, not one stacked
``[L, ...]`` parameter per leaf: indexing a stacked parameter per layer
would make autograd build a zero-filled gradient of the whole stack for
every layer.  ``jax_tree`` / ``load_jax_tree`` stack and split the layers
where the JAX package's layout (one ``blocks/*`` leaf of ``[L, ...]``) is
wanted: checkpoints and ``models/api.params_from_jax``.  An MoE model
has ``blocks`` for its leading ``first_dense_layers`` (every layer without
MoE) and ``moe_blocks`` for the rest, whose MLP is an ``MoE`` layer
(``models/moe.py``); the JAX tree's ``blocks`` / ``moe_blocks`` leaves.
A VLM prepends ``prefix_embeds`` (stub patch embeddings) to the text, and
its loss counts the text positions only.

Remat (``cfg.remat``): ``"full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), ``"dots"`` saves the blocks' weight matmuls
and recomputes the rest (selective activation checkpointing, as the
reference's ``dots_with_no_batch_dims_saveable``: the experts' batched
products are not saved), ``"none"`` saves all.

Serving: ``init_cache`` allocates one KV cache a layer group in the
reference's stacked layout (``k`` / ``v`` ``[L, B, len, n_kv, hd]`` in the
compute dtype, ``pos`` ``[L, len]``; ``len`` is ``min(max_len,
sliding_window)`` for a sliding-window model, a ring).  ``prefill`` runs
the cache-free forward and fills each layer's cache from K / V recomputed
on that layer's input tail; ``decode_step`` writes one position a layer in
place.  Positions are host ints, so decoding never waits on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def attn_spec(cfg: ModelConfig) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      qk_norm=cfg.qk_norm, rope_style=cfg.rope_style,
                      rope_theta=cfg.rope_theta,
                      sliding_window=cfg.sliding_window, causal=True)


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class Block(nn.Module):
    """One pre-norm block: attention, then the MLP (the MoE layer when
    ``moe_layer``), each residual."""

    def __init__(self, cfg: ModelConfig, *, moe_layer: bool = False,
                 generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype()
        self.cfg = cfg
        self.moe_layer = moe_layer
        self.spec = attn_spec(cfg)
        self.ln1 = _params(L.norm_init(cfg.d_model, cfg.norm, dt, device))
        self.ln2 = _params(L.norm_init(cfg.d_model, cfg.norm, dt, device))
        self.attn = _params(L.attn_init(self.spec, dt, generator=generator,
                                        device=device))
        if moe_layer:
            self.moe = moe_lib.MoE(cfg, dt, generator=generator,
                                   device=device)
        else:
            self.mlp = _params(L.mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp, dt,
                                          generator=generator,
                                          device=device))

    def forward(self, x, cache=None, pos=None, seq_sharded: bool = False):
        """``cache`` / ``pos``: this layer's KV cache, written in place at
        position ``pos`` (decode).  ``seq_sharded``: ``x`` is this rank's
        sequence shard of the residual (sequence parallelism): the norms'
        weights meet the model group in the backward (``tp.copy_in``), and
        attention and the MLP gather their input and reduce-scatter their
        output."""
        cfg = self.cfg
        ln1, ln2 = self.ln1, self.ln2
        if seq_sharded:
            ax = tp.active()
            ln1, ln2 = ({k: tp.copy_in(v, ax) for k, v in n.items()}
                        for n in (ln1, ln2))
        xn = L.norm_apply(x, ln1, cfg.norm, cfg.norm_eps)
        x = x + L.mha(self.attn, xn, self.spec, cache=cache, cache_pos=pos,
                      ring=bool(cfg.sliding_window), seq_sharded=seq_sharded)
        y = L.norm_apply(x, ln2, cfg.norm, cfg.norm_eps)
        if self.moe_layer:
            return x + moe_lib.moe_apply(self.moe, y, cfg,
                                         seq_sharded=seq_sharded)
        return x + L.mlp_apply(self.mlp, y, cfg.mlp, width=cfg.d_ff,
                               seq_sharded=seq_sharded)

    def tail_kv(self, tail_x, start: int, cache: dict) -> None:
        """Fill this layer's ``cache`` with the K / V of the layer inputs
        ``tail_x`` (B, T, D) at the positions ``start .. start + T`` (T <=
        the cache's length), each in slot ``position % length`` (the ring
        layout; every other slot stays empty).  On the model axis the
        cache is this rank's shard (``layers._mha_cached``): its kv heads'
        K / V, or every head's in the slots of its span."""
        cfg, spec = self.cfg, self.spec
        B, T, _ = tail_x.shape
        kv, hd, dt = spec.n_kv_heads, spec.head_dim, tail_x.dtype
        y = L.norm_apply(tail_x, self.ln1, cfg.norm, cfg.norm_eps)
        k = y @ self.attn["wk"].to(dt)
        v = y @ self.attn["wv"].to(dt)
        if cache["k"].shape[2] == kv:  # every kv head on this rank
            k, v = (L.whole_heads(t, kv * hd, tp.active()) for t in (k, v))
        k, v = k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd)
        if spec.qk_norm:
            k = L.rmsnorm(k, self.attn["k_norm"].to(dt), 1e-6)
        tail_pos = torch.arange(start, start + T, device=tail_x.device)
        if spec.rope_style != "none":
            inv = L.rope_freqs(hd, spec.rope_theta, spec.rope_style,
                               tail_x.device)
            k = L.apply_rope(k, torch.broadcast_to(tail_pos, (B, T)), inv,
                             spec.rope_style)
        length = cache["pos"].shape[0]
        first = start % length  # the ring wraps at most once
        n = min(T, length - first)
        L.write_kv(cache, k[:, :n], v[:, :n], first, tail_pos[:n])
        if n < T:
            L.write_kv(cache, k[:, n:], v[:, n:], 0, tail_pos[n:])

    def tree(self) -> dict:
        """This layer's parameters in the JAX block's tree."""
        out = {k: dict(getattr(self, k).items())
               for k in ("ln1", "ln2", "attn")}
        if self.moe_layer:
            out["moe"] = self.moe.tree()
        else:
            out["mlp"] = dict(self.mlp.items())
        return out


_MATMULS = frozenset(getattr(torch.ops.aten, n).default
                     for n in ("mm", "addmm"))


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of 2-D matmuls (the weight
    projections; attention's batched contractions run as ``bmm``) and
    recompute everything else."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_save_weight_matmuls)


class LM(nn.Module):
    """What the LMs share: ``embed``, ``final_norm``, ``lm_head`` when
    untied, per-layer blocks in the groups ``LAYER_GROUPS`` (each block's
    ``tree()`` its JAX subtree), unstacked subtrees ``UNSTACKED`` (a module
    with ``tree()`` or a ``ParameterDict``: one JAX leaf per tensor), and
    the JAX package's parameter layout."""

    LAYER_GROUPS: tuple = ("blocks",)
    UNSTACKED: tuple = ()

    def head(self):
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def final_logits(self, x):
        """The final norm, then the head: whole vocabulary rows (gathered
        where the head is sharded over the model axis)."""
        cfg = self.cfg
        with tp.gathered(self.final_norm, self.head()):
            x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps)
            logits, sharded = self.head_logits(x)
        return tp.all_gather(logits, -1, tp.active()) if sharded else logits

    def serving_axis(self):
        """The model axis this module's parameters are sharded over
        (``tensor_parallel.shard_model``), or None: a sharded module's
        caches are this rank's shards."""
        shards = getattr(self, "model_shards", None)
        return shards[1] if shards else None

    def embed_tokens(self, tokens):
        """``tokens``' embeddings in the compute dtype (vocabulary-parallel
        where the table is sharded; gathered whole over the data axes where
        it is weight-gathered for serving)."""
        cfg = self.cfg
        with tp.gathered(self.embed):
            return L.embed_lookup(self.embed, tokens, cfg.cdtype(),
                                  vocab=cfg.padded_vocab)

    def head_logits(self, x, seq_sharded: bool = False) -> tuple:
        """``(logits, vocab_sharded)`` of the final-normed ``x`` (this
        rank's sequence shard when ``seq_sharded``): this rank's vocabulary
        columns where the head is sharded over the model axis."""
        cfg = self.cfg
        head = self.head()
        rows = head.shape[0 if cfg.tie_embeddings else 1]
        if not seq_sharded and not tp.split(rows, cfg.padded_vocab):
            return L.lm_logits(x, head, cfg.tie_embeddings), False
        xr, xt = tp.enter(x, tp.active(), seq_sharded)
        if rows == cfg.padded_vocab:
            return L.lm_logits(xr, head, cfg.tie_embeddings), False
        return L.lm_logits(xt, head, cfg.tie_embeddings), True

    def loss_of(self, x, labels, seq_sharded: bool = False):
        """The cross-entropy of the head's logits of ``x`` (as
        ``head_logits`` takes it) against ``labels``."""
        logits, sharded = self.head_logits(x, seq_sharded)
        ce = L.vocab_parallel_cross_entropy if sharded else L.cross_entropy
        return ce(logits, labels, valid_vocab=self.cfg.vocab_size)

    def forward(self, tokens):
        """tokens (B, S) -> logits, from ``hidden_states`` (final-normed)."""
        logits, sharded = self.head_logits(self.hidden_states(tokens))
        return tp.gather(logits, -1, tp.active()) if sharded else logits

    def loss_fn(self, batch: dict):
        return self.loss_of(self.hidden_states(batch["tokens"]),
                            batch["labels"])

    def jax_tree(self) -> dict:
        """The parameters in the JAX package's tree: a layer group's
        ``<group>/<path>`` is the list of the layers' tensors for that leaf
        (stack one for the ``[L, ...]`` leaf), every other leaf (an
        ``UNSTACKED`` subtree's too) the parameter itself."""
        tree = {"embed": self.embed,
                "final_norm": dict(self.final_norm.items())}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        for name in self.LAYER_GROUPS:
            layers = getattr(self, name)
            if len(layers):
                tree[name] = _by_layer([b.tree() for b in layers])
        for name in self.UNSTACKED:
            sub = getattr(self, name)
            tree[name] = sub.tree() if hasattr(sub, "tree") \
                else dict(sub.items())
        return tree

    def param_leaves(self) -> list:
        """The JAX leaves as indices into ``list(self.parameters())``: an
        int for a leaf that is one parameter (an unstacked subtree's
        included), a list of per-layer indices for a stacked one (the
        grouping Adafactor keys its state by)."""
        index = {id(p): i for i, p in enumerate(self.parameters())}
        return [[index[id(t)] for t in leaf] if isinstance(leaf, list)
                else index[id(leaf)]
                for _, leaf in jax_leaves(self.jax_tree())]

    @torch.no_grad()
    def load_jax_tree(self, tree: dict) -> "LM":
        """Copy a JAX-layout parameter tree (numpy arrays or tensors; the
        ``blocks`` leaves stacked ``[L, ...]``) into this model, in place and
        on its device.  Shapes must match exactly (``embed`` keeps its
        padded rows)."""
        mine = jax_leaves(self.jax_tree())
        theirs = jax_leaves(tree)
        if [p for p, _ in mine] != [p for p, _ in theirs]:
            raise ValueError(f"parameter paths differ: "
                             f"{[p for p, _ in mine]} vs "
                             f"{[p for p, _ in theirs]}")
        for (path, dst), (_, src) in zip(mine, theirs):
            copy_leaf(dst, src, path)
        return self


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """A layer's KV slots: a ring of the window for a sliding-window
    model."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, ax=None) -> dict:
    """``{"blocks": ..., "moe_blocks": ...}`` (the groups the model has),
    each ``cache_init``'s tensors stacked over the group's layers; with a
    model axis ``ax``, this rank's shard (``tensor_parallel.local_cache``)."""
    dev = resolve_device(device)
    if ax is not None:
        return tp.local_cache(init_cache(cfg, batch, max_len, "meta"), ax,
                              dev)
    length = cache_len(cfg, max_len)
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    cache = {}
    for group, n in (("blocks", n_dense), ("moe_blocks",
                                           cfg.n_layers - n_dense)):
        if n:
            one = L.cache_init(batch, length, cfg.n_kv_heads, cfg.hd,
                               cfg.cdtype(), device=dev)
            cache[group] = {k: v.expand((n,) + v.shape).clone()
                            for k, v in one.items()}
    return cache


def layer_cache(cache: dict, group: str, i: int) -> dict:
    """Layer ``i`` of a group's stacked cache (views: writes go through)."""
    return {k: v[i] for k, v in cache[group].items()}


class Transformer(LM):
    """The decoder-only LM, dense, MoE or VLM.  Parameters (JAX names):
    ``embed`` ``[padded_vocab, d]``, ``final_norm``, ``lm_head`` ``[d,
    padded_vocab]`` when untied, ``blocks[i]`` with ``ln1``, ``ln2``,
    ``attn`` and ``mlp``, and ``moe_blocks[i]`` with ``moe`` in place of
    ``mlp``."""

    LAYER_GROUPS = ("blocks", "moe_blocks")

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family not in TRANSFORMER_FAMILIES or \
                (cfg.family == "moe") != (cfg.moe is not None):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             "transformer's")
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=dev)
        self.embed = nn.Parameter(L.embed_init(cfg.padded_vocab, cfg.d_model,
                                               dt, **kw))
        self.final_norm = _params(L.norm_init(cfg.d_model, cfg.norm, dt, dev))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.truncated_normal(
                (cfg.d_model, cfg.padded_vocab), dt,
                1.0 / (cfg.d_model ** 0.5), **kw))
        n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(n_dense))
        self.moe_blocks = nn.ModuleList(
            Block(cfg, moe_layer=True, **kw)
            for _ in range(cfg.n_layers - n_dense))

    # ---- forward ---------------------------------------------------------

    def _run_block(self, block: Block, x, seq_sharded: bool = False):
        remat = self.cfg.remat
        kw = {"seq_sharded": True} if seq_sharded else {}
        if remat == "none" or not torch.is_grad_enabled():
            return block(x, **kw)
        if remat == "full":
            return ckpt.checkpoint(block, x, use_reentrant=False, **kw)
        if remat == "dots":
            return ckpt.checkpoint(block, x, use_reentrant=False,
                                   context_fn=_dots_context, **kw)
        raise ValueError(f"unknown remat policy {remat!r}")

    def _groups(self):
        return (("blocks", self.blocks), ("moe_blocks", self.moe_blocks))

    def _hidden(self, tokens, prefix_embeds=None) -> tuple:
        """``(x, seq_sharded)``: the final-normed hidden states, this
        rank's sequence shard of them under sequence parallelism (the
        config's ``seq_parallel``, on a model axis that divides the
        sequence)."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        ax = tp.active()
        sp = bool(cfg.seq_parallel and getattr(self, "model_shards", None)
                  and x.shape[1] % ax.size == 0)
        norm = self.final_norm
        if sp:
            x = tp.scatter(x, 1, ax)
            norm = {k: tp.copy_in(v, ax) for k, v in norm.items()}
        for block in (*self.blocks, *self.moe_blocks):
            x = self._run_block(block, x, sp)
        return L.norm_apply(x, norm, cfg.norm, cfg.norm_eps), sp

    def hidden_states(self, tokens, prefix_embeds=None):
        """tokens: (B, S) int [; prefix_embeds: (B, P, D), the VLM's patch
        embeddings, placed before the text] -> the final-normed hidden
        states."""
        x, sp = self._hidden(tokens, prefix_embeds)
        return tp.gather(x, 1, tp.active()) if sp else x

    def _logits(self, tokens, prefix_embeds=None) -> tuple:
        """``(logits, vocab_sharded)``: this rank's vocabulary columns of
        the logits where the head is sharded over the model axis."""
        return self.head_logits(*self._hidden(tokens, prefix_embeds))

    def forward(self, tokens, prefix_embeds=None):
        logits, sharded = self._logits(tokens, prefix_embeds)
        return tp.gather(logits, -1, tp.active()) if sharded else logits

    def loss_fn(self, batch: dict):
        prefix = batch.get("patch_embeds")
        logits, sharded = self._logits(batch["tokens"], prefix)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]  # loss on text positions
        ce = L.vocab_parallel_cross_entropy if sharded else L.cross_entropy
        return ce(logits, batch["labels"], valid_vocab=self.cfg.vocab_size)

    # ---- serving --------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.embed.device,
                          self.serving_axis())

    def _rows(self):
        """Within: on a data degree dp > 1 the caller's rows are this
        rank's row shard of the batch, so an MoE layer routes them as one
        of the reference's dp token groups (prefill and decode alike),
        unless the caller says otherwise: within ``sharding.row_shards(1)``
        every rank holds the whole batch (one dp does not divide, which
        ``batch_specs`` replicates), whose tokens route in the reference's
        groups of the whole."""
        if shd.row_shards_set():
            return contextlib.nullcontext()
        return shd.row_shards(shd.data_degree(shd.get_active_mesh()))

    @torch.no_grad()
    def prefill(self, tokens, max_len: int) -> tuple:
        """Process a whole prompt (B, S); returns (last-token logits (B, 1,
        V), cache).  The logits come from the cache-free forward (with the
        sliding-window mask where configured); each layer's cache is filled
        from its input's last ``min(S, cache length)`` tokens, so a
        sliding-window model keeps only its window (ring layout).  On a
        model-sharded module ``tokens`` are this rank's rows and the cache
        its shard; the logits are whole."""
        cfg = self.cfg
        B, S = tokens.shape
        cache = self.init_cache(B, max_len)
        T = min(S, cache_len(cfg, max_len))
        with self._rows():
            x = self.embed_tokens(tokens)
            for group, layers in self._groups():
                for i, block in enumerate(layers):
                    with tp.gathered(block):
                        block.tail_kv(x[:, S - T:], S - T,
                                      layer_cache(cache, group, i))
                        x = block(x)
        return self.final_logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos: int) -> tuple:
        """tokens: (B, 1) int at position ``pos`` (a host int).  Writes each
        layer's K / V into ``cache`` in place; returns (logits (B, 1, V),
        cache).  An MoE layer routes the B tokens as one group (on a data
        degree dp > 1, one of dp)."""
        pos = int(pos)
        with self._rows():
            x = self.embed_tokens(tokens)
            for group, layers in self._groups():
                for i, block in enumerate(layers):
                    with tp.gathered(block):
                        x = block(x, layer_cache(cache, group, i), pos)
        return self.final_logits(x), cache


def _by_layer(trees: list) -> dict:
    """Per-layer trees of one structure -> one tree of per-layer lists."""
    return {k: _by_layer([t[k] for t in trees]) if isinstance(v, dict)
            else [t[k] for t in trees] for k, v in trees[0].items()}


def jax_leaves(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in the JAX package's flatten order (dict keys
    sorted).  A leaf is a tensor, an array, or a list of per-layer tensors
    (a stacked ``blocks/*`` leaf)."""
    if isinstance(tree, (dict, nn.ParameterDict)):
        out = []
        for k in sorted(tree.keys()):
            out += jax_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def stacked(leaf) -> torch.Tensor:
    """A leaf as one tensor: a list of per-layer tensors stacked (a copy)."""
    if isinstance(leaf, list):
        return torch.stack([t.detach() for t in leaf])
    return leaf.detach()


def copy_leaf(dst, src, path: str = "") -> None:
    """Copy ``src`` (array or tensor, stacked ``[L, ...]`` when ``dst`` is a
    list of per-layer tensors) into ``dst`` in place (into a DTensor, this
    rank's shard of it; into a parameter sharded over the model axis, its
    slice of a whole ``src``)."""
    if not isinstance(src, torch.Tensor):
        a = np.array(src)  # a JAX bfloat16 array is read from its bits
        src = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if a.dtype.name == "bfloat16" else torch.from_numpy(a)
    if isinstance(dst, list):
        if src.shape[0] != len(dst):
            raise ValueError(f"{path}: {src.shape[0]} layers for {len(dst)}")
        for i, d in enumerate(dst):
            copy_leaf(d, src[i], f"{path}[{i}]")
        return
    dim, ax = tp.shard_of(dst)
    if dim is not None and src.shape[dim] == dst.shape[dim] * ax.size:
        src = tp.part(src, dim, ax)  # a model shard keeps its slice
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    if hasattr(dst, "placements"):  # a DTensor keeps this rank's shard
        dst.to_local().detach().copy_(shd.local_part(src, dst))
        return
    dst.detach().copy_(src)


def loss_fn(model: Transformer, batch: dict):
    """``loss_fn(model, batch) -> scalar`` (the train step's signature)."""
    return model.loss_fn(batch)


def state_to_jax_leaves(state) -> list:
    """A train state (``model``: an ``LM``, ``opt``: AdamW ``{"m",
    "v"}`` in ``model.parameters()`` order, or Adafactor ``{"f"}`` in JAX
    leaf order; ``step``) as the JAX package's ``TrainState(params, opt,
    step)`` leaves, in its flatten order: the parameters, then ``m``, then
    ``v`` (each in the parameter tree's sorted order) or, for Adafactor,
    each leaf's ``vc`` and ``vr`` (or ``v``), then ``step`` as an int32
    scalar.  A layer group's leaf (``blocks/*``, ``moe_blocks/*``, ...)
    is the list of its per-layer tensors (stack it, e.g. on the host, for the ``[L, ...]``
    leaf); Adafactor's state is stored stacked."""
    def pick(group, leaf):
        if isinstance(leaf, list):
            return [group[i].detach() for i in leaf]
        return group[leaf].detach()

    groups = [list(state.model.parameters())]
    if "f" not in state.opt:
        groups += [state.opt["m"], state.opt["v"]]
    order = state.model.param_leaves()
    leaves = [pick(group, leaf) for group in groups for leaf in order]
    for st in state.opt.get("f", ()):
        leaves += [st[k] for k in sorted(st)]
    leaves.append(torch.tensor(state.step, dtype=torch.int32))
    return leaves


def state_model_dims(state) -> list:
    """Beside each leaf of ``state_to_jax_leaves(state)``: ``(dim,
    ModelAxis)`` of its model shard (``dim`` in the coordinates of the
    leaf's tensors: per layer for a list leaf), or ``(None, None)``;
    Adafactor's state is whole over the model axis."""
    params = list(state.model.parameters())
    order = state.model.param_leaves()
    per = [tp.shard_of(params[leaf[0] if isinstance(leaf, list) else leaf])
           for leaf in order]
    dims = per * (1 if "f" in state.opt else 3)
    dims += [(None, None)] * sum(len(st) for st in state.opt.get("f", ()))
    return dims + [(None, None)]


@torch.no_grad()
def load_jax_leaves(state, leaves) -> object:
    """The inverse of ``state_to_jax_leaves``: copy ``leaves`` (arrays or
    tensors; ``blocks/*`` stacked ``[L, ...]``) into ``state``'s parameters
    and optimizer state in place, on their devices, and set its step.
    Returns ``state``."""
    want = state_to_jax_leaves(state)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves for a state of {len(want)}")
    for i, (dst, src) in enumerate(zip(want[:-1], leaves[:-1])):
        copy_leaf(dst, src, f"leaf {i}")
    state.step = int(np.asarray(leaves[-1]))
    return state
