"""Train-step construction (with microbatching: ``training/grad.py``), its
form over a ``(data, model)`` mesh (``shard_train_step``), and the
checkpointed, watchdogged driver loop."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dlrm, transformer
from repro_torch.models import layers as L
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import fault as fault_lib
from repro_torch.training.grad import microbatched_value_and_grad
from repro_torch.training.optimizer import opt_init, opt_update


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer
    state, and the step count."""

    model: nn.Module
    opt: dict
    step: int = 0

    @staticmethod
    def create(model: nn.Module, tcfg: TrainConfig) -> "TrainState":
        """A fresh state for ``tcfg.optimizer``; Adafactor's is keyed by
        the model's JAX leaves (``param_leaves()``, where the model has
        stacked ones), else by parameter."""
        leaves = model.param_leaves() if hasattr(model, "param_leaves") \
            else None
        return TrainState(model=model, opt=opt_init(
            list(model.parameters()), tcfg, leaves=leaves))


def make_train_step(loss_fn: Callable, tcfg: TrainConfig) -> Callable:
    """``loss_fn(model, batch) -> scalar``; returns ``step(state, batch) ->
    (state, {"loss", "grad_norm"})``.  With ``tcfg.microbatch > 1`` the
    batch's rows are split into that many chunks whose gradients are
    accumulated (in ``tcfg.accum_dtype``; in place in ``.grad`` when that is
    the parameters' dtype).  Parameters and optimizer state (AdamW or
    Adafactor, ``tcfg.optimizer``) update in place; gradients are dropped
    after each step."""
    vg = microbatched_value_and_grad(loss_fn, max(tcfg.microbatch, 1),
                                     accum_dtype=tcfg.accum_dtype)

    def train_step(state: TrainState, batch) -> tuple:
        params = list(state.model.parameters())
        loss, grads = vg(state.model, batch)
        gnorm = opt_update(params, grads, state.opt, state.step, tcfg)
        del grads
        state.step += 1
        return state, {"loss": loss.to(torch.float32), "grad_norm": gnorm}

    return train_step


def data_group(mesh):
    """The process group of ``mesh``'s data axes (``("pod", "data")``
    flattened into one dim where there is a pod axis) and its 1-D mesh."""
    axes = shd.data_axes(mesh)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten("dp")
    return sub.get_group(), sub


def _named_leaves(model) -> list:
    """``(JAX path, JAX shape, [parameter names], kind)`` of each JAX leaf
    of an LM or a DLRM: ``kind`` is ``"stacked"`` (a layer group's leaf,
    one parameter a layer), ``"transposed"`` (a DLRM ``w``) or
    ``"plain"``."""
    if isinstance(model, dlrm.DLRM):
        return [(path, shape, [name], "transposed" if tr else "plain")
                for path, shape, name, tr in dlrm.jax_named_leaves(model)]
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    for path, leaf in transformer.jax_leaves(model.jax_tree()):
        if isinstance(leaf, list):
            out.append((path, shd.leaf_shape(leaf),
                        [names[id(t)] for t in leaf], "stacked"))
        else:
            out.append((path, tuple(leaf.shape), [names[id(leaf)]],
                        "plain"))
    return out


def _layer_free_dim(shape, md, sizes) -> int | None:
    """The data dim of one layer's parameter of a stacked leaf whose spec
    shards its layer dim over the data axes (FSDP).  The port holds one
    parameter a layer, so it cannot hold a slice of the layers: each
    layer's parameter is sharded on a dim of its own instead, chosen by the
    reference's rule on the layer's (model-local) shape, the largest dim
    the data degree divides (a rank then holds the reference's bytes of
    the leaf: (48, 32) over 16 is 96 entries a rank either way), else the
    largest dim, which FSDP2's ``Shard`` and ``tensor_parallel.shard_data``
    pad to an even split; None for a scalar."""
    shape = [n // sizes.get("model", 1) if d == md else n
             for d, n in enumerate(shape)]
    if not shape:
        return None
    dp = shd.data_degree(sizes)
    order = sorted(range(len(shape)), key=lambda d: -shape[d])
    return next((d for d in order if shape[d] % dp == 0), order[0])


def _shard_dims(model, sizes, *, fsdp: bool, n_experts: int) -> dict:
    """``{parameter name: (model dim, data dim)}``: the dim of each
    parameter (per layer, for a stacked leaf) that ``param_specs`` shards
    over the "model" axis and, with ``fsdp``, over the data axes (None
    where it does not); a stacked leaf whose layer dim the data axes shard
    has its layers' parameters sharded on ``_layer_free_dim``."""
    dims = {}
    for path, shape, names, kind in _named_leaves(model):
        spec = shd.param_spec(path, shape, sizes, fsdp=fsdp,
                              n_experts=n_experts)
        md, dd = tp.model_dim(spec), shd.data_dim(spec)
        if kind == "stacked":
            md = None if md is None else md - 1
            dd = _layer_free_dim(shape[1:], md, sizes) if dd == 0 else \
                None if dd is None else dd - 1
        elif kind == "transposed":
            md, dd = (None if d is None else 1 - d for d in (md, dd))
        for n in names:
            dims[n] = (md, dd)
    return dims


def _dtype_holders(module, done) -> dict:
    """``{dtype: [submodules]}``: the outermost submodules of ``module``
    whose parameters outside ``done`` (FSDP units already made) are all
    of one dtype other than the majority (by elements) of ``module``'s
    parameters outside ``done``."""
    skip = {id(p) for u in done for p in u.parameters()}

    def dtypes(m) -> dict:
        out = {}
        for p in m.parameters():
            if id(p) not in skip:
                out[p.dtype] = out.get(p.dtype, 0) + p.numel()
        return out

    count = dtypes(module)
    if len(count) < 2:
        return {}
    major = max(count, key=count.get)
    out = {}

    def visit(m):
        for child in m.children():
            dts = dtypes(child)
            if len(dts) == 1 and major not in dts:
                out.setdefault(next(iter(dts)), []).append(child)
            elif len(dts) > 1:
                visit(child)
    visit(module)
    return out


def _fully_shard(model, dmesh, dims, reduce_dtype) -> list:
    """FSDP2 over ``dmesh``: each block of the model's layer groups, then
    the root; each parameter sharded on its ``dims`` entry, the ones it
    lacks (None) left replicated (``ignored_params``).  FSDP2 gathers a
    unit's parameters as one buffer of one dtype, so within each block
    (and at the root) the modules that hold only parameters of another
    dtype than the majority's (the MoE router and the SSM's ``Scalars``,
    float32 beside 16-bit weights) are units of their own first, sharded
    alike.  Returns the FSDP modules."""
    from torch.distributed.fsdp import (FSDPModule, MixedPrecisionPolicy,
                                        fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    ignored = {p for p in model.parameters() if dims[id(p)] is None}
    kw = dict(mesh=dmesh, mp_policy=MixedPrecisionPolicy(
                  reduce_dtype=reduce_dtype),
              shard_placement_fn=lambda p: Shard(dims[id(p)]))

    def unit(m):
        fully_shard(m, ignored_params=ignored & set(m.parameters()), **kw)

    def with_holders(m):
        done = [u for u in m.modules() if isinstance(u, FSDPModule)]
        for holders in _dtype_holders(m, done).values():
            for h in holders:
                unit(h)
        unit(m)

    for name in getattr(model, "LAYER_GROUPS", ()):
        for block in getattr(model, name):
            with_holders(block)
    with_holders(model)
    if hasattr(model, "loss_fn"):
        # an LM's train step calls the loss, not forward: it unshards the
        # root
        register_fsdp_forward_method(model, "loss_fn")
    return [m for m in model.modules() if isinstance(m, FSDPModule)]


def unit_dtypes(model) -> dict:
    """``{module name: dtype}`` of each FSDP unit of ``model``: the dtype
    of the parameters it shards (those of no nested unit), or None where
    it shards none."""
    from torch.distributed.fsdp import FSDPModule

    out = {}
    for name, m in model.named_modules():
        if not isinstance(m, FSDPModule):
            continue
        inner = {id(p) for u in m.modules()
                 if u is not m and isinstance(u, FSDPModule)
                 for p in u.parameters()}
        dts = {p.dtype for p in m.parameters()
               if id(p) not in inner and hasattr(p, "placements")}
        out[name] = dts.pop() if len(dts) == 1 else None
    return out


def shard_train_step(loss_fn: Callable, tcfg: TrainConfig, mesh,
                     state: TrainState, *, batch_rows: int,
                     fsdp: bool = False, n_experts: int = 0) -> tuple:
    """The train step of an LM (``loss_fn`` a cross-entropy over
    ``batch["labels"]``) or a DLRM (``dlrm.loss_fn``, the mean BCE over
    ``batch["label"]``) over ``mesh`` (the JAX package's
    ``jit_train_step``); returns ``(step, state)``.  ``state`` must be
    fresh (step 0: restore into the returned one).  ``mesh`` becomes the
    active mesh.

    - The "model" axis: every parameter whose spec (``param_specs``) names
      it is cut to this rank's slice (``tensor_parallel.shard_model``), and
      the layers meet the other model ranks in explicit collectives
      (tensor, sequence and expert parallelism; every LM family and
      DLRM, its lookahead path included).
    - ``batch_rows`` is the global batch's rows: when the data degree dp
      divides it, each rank's batch is its rows (``put_packed``, with
      ``microbatches=tcfg.microbatch``; the model ranks of one data
      coordinate hold the same rows), else the whole batch, replicated as
      the reference's ``batch_specs`` does.
    - ``fsdp``: FSDP2 (ZeRO-3) over the data axes shards each (local)
      parameter, and so its gradient, on the dim ``param_specs(...,
      fsdp=True)`` chooses (Adafactor's state on its own spec:
      ``optimizer.state_spec``); a leaf it replicates stays whole on every
      rank of the data group.  Gradients are reduce-scattered once a step
      (not per microbatch), accumulated in ``tcfg.accum_dtype``, then
      rounded to the parameter's dtype.
    - otherwise the data group's gradients are all-reduced once a step.
    - A replicated 16-bit parameter's gradient is computed in float32
      on each rank, and the data ranks' parts are summed unrounded and
      rounded to the parameter's dtype, as the reference's one program
      over the mesh sums them (rounded a rank at a time, the parts of a
      near-zero sum flip the sign of Adam's step for zero-initialised
      biases): once a step with one microbatch, else once a microbatch
      (one all-reduce of these small leaves each), each microbatch's
      rounded sum then accumulated in ``tcfg.accum_dtype`` and scaled by
      1/n, the reference's formula.
    - The loss is the reference's mean over the global (micro)batch: on
      more than one data rank each divides its sum by the global count of
      unignored labels (of rows, for a DLRM; one all-reduce a step), and
      the data ranks' gradients are summed.  The loss reported is the global one; the
      gradient norm is global over both axes.
    """
    if state.step != 0:
        raise ValueError("shard a fresh train state, then restore into it")
    model = state.model
    shd.set_active_mesh(mesh)
    ax = tp.model_axis(mesh)
    group, dmesh = data_group(mesh)
    dp = dist.get_world_size(group)
    sharded = batch_rows % dp == 0
    n_micro = max(tcfg.microbatch, 1)
    acc_dtype = getattr(torch, tcfg.accum_dtype)
    dims = _shard_dims(model, shd.axis_sizes(mesh), fsdp=fsdp,
                       n_experts=n_experts)
    fsdp_modules = []
    if ax is not None or fsdp:
        state.opt = None
    if ax is not None:
        tp.shard_model(model, {n: md for n, (md, _) in dims.items()
                               if md is not None}, ax)
    if fsdp:
        by_id = {id(p): dims[n][1] for n, p in model.named_parameters()}
        fsdp_modules = _fully_shard(model, dmesh, by_id, acc_dtype)
        for m in fsdp_modules:  # the ranks' shares of the mean are summed;
            # a replicated batch's equal gradients are averaged
            m.set_gradient_divide_factor(1.0 if sharded else float(dp))
            m.set_force_sum_reduction_for_comms(True)
        tp.mark(model)  # FSDP's parameters are new objects
    if state.opt is None:
        state = TrainState.create(model, tcfg)
    replicated = [i for i, p in enumerate(model.parameters())
                  if not hasattr(p, "placements")]
    # a replicated 16-bit parameter is read in float32 for the step, so
    # each rank's part of its gradient is unrounded until the data ranks'
    # sum is rounded (the docstring's last point)
    params = list(model.parameters())
    widen = [i for i in replicated if sharded and dp > 1 and
             params[i].dtype.is_floating_point and
             params[i].element_size() < 4]

    def summed_rounded(dtype):
        def fn(g):  # one microbatch's gradient, a rank's part of it
            dist.all_reduce(g, group=group)
            return g.to(dtype)
        return fn
    each = {i: summed_rounded(params[i].dtype) for i in widen} \
        if n_micro > 1 else {}
    counts = {}

    @contextlib.contextmanager
    def micro(i):
        if fsdp_modules:  # one reduce-scatter, after the last microbatch
            model.set_requires_gradient_sync(i == n_micro - 1)
        with shd.row_shards(dp if sharded else 1), \
                L.label_count(counts.get(i)):
            yield

    vg = microbatched_value_and_grad(
        loss_fn, n_micro, accum_dtype=tcfg.accum_dtype,
        in_place=True if fsdp_modules else None, micro_context=micro,
        each_micro=each)

    def train_step(state: TrainState, batch) -> tuple:
        counts.clear()
        if sharded and dp > 1:
            if "labels" in batch:
                labels = batch["labels"].reshape(n_micro, -1)
                c = (labels != -100).to(torch.float32).sum(1)
            else:  # every row counts
                c = torch.full((n_micro,), batch["label"].shape[0] / n_micro,
                               dtype=torch.float32,
                               device=batch["label"].device)
            dist.all_reduce(c, group=group)
            counts.update(enumerate(c))
        params = list(state.model.parameters())
        narrow = {i: params[i].data for i in widen}
        for i in widen:
            params[i].data = params[i].data.to(torch.float32)
        try:
            loss, grads = vg(state.model, batch)
        finally:
            for i, data in narrow.items():
                params[i].data = data
        if sharded and dp > 1:
            for i in replicated:
                if i not in each:  # (summed a microbatch at a time)
                    dist.all_reduce(grads[i], group=group)
            for i in widen:
                if i not in each:
                    grads[i] = grads[i].to(params[i].dtype)
            dist.all_reduce(loss, group=group)
        # (a replicated batch: every rank computed the whole gradient)
        gnorm = opt_update(params, grads, state.opt, state.step, tcfg)
        del grads
        state.step += 1
        return state, {"loss": loss.to(torch.float32), "grad_norm": gnorm}

    return train_step, state


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str = ""
    ckpt_every: int = 0
    log_every: int = 50
    watchdog_s: float = 0.0
    keep_ckpts: int = 3


def train_loop(state: TrainState, step_fn, batches, loop_cfg: LoopConfig,
               *, device=None, async_ckpt: bool = True, on_metrics=None,
               embed_cache=None) -> TrainState:
    """Run to ``total_steps`` over ``batches`` (an iterable or a staged
    ``StreamingExecutor``, which is stopped on exit), with a checkpoint
    every ``ckpt_every`` steps into ``ckpt_dir`` (async unless
    ``async_ckpt=False``; the newest ``keep_ckpts`` committed ones are
    kept) and a watchdog of ``watchdog_s`` seconds a step.  ``device``
    (default CUDA) must be where the model lives.

    ``embed_cache`` threads a ``lookahead.EmbedCache`` alongside the train
    state: before each step the batch's lookahead plan is applied against
    the CURRENT embedding tables (``state.model.tables``) so the cached
    forward reads fresh rows.  Plans must be applied in delivery order —
    the loop is that order."""
    dev = resolve_device(device)
    pdev = next(state.model.parameters()).device
    if pdev.type != dev.type or (dev.index is not None
                                 and pdev.index != dev.index):
        raise ValueError(f"model is on {pdev}, train_loop runs on {dev}")
    ckpt = ckpt_lib.AsyncCheckpointer() if async_ckpt else None
    wd = fault_lib.Watchdog(loop_cfg.watchdog_s) if loop_cfg.watchdog_s else None
    etl_stats = getattr(batches, "stats", None)
    t0 = time.perf_counter()
    train_s = 0.0
    try:
        for batch in batches:
            if state.step >= loop_cfg.total_steps:
                break
            if embed_cache is not None:
                batch = embed_cache.advance(state.model.tables, batch)
            if wd:
                wd.arm()
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step to finish
            train_s += time.perf_counter() - ts
            if wd:
                wd.check()
                wd.disarm()
            if loop_cfg.log_every and state.step % loop_cfg.log_every == 0:
                m = {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                     "step": state.step,
                     "train_utilization": train_s / max(
                         time.perf_counter() - t0, 1e-9)}
                if etl_stats is not None:
                    m["etl_starved_s"] = etl_stats.consumer_wait_s
                    m["etl_overlapped_s"] = etl_stats.overlapped_etl_s
                    cache = getattr(etl_stats, "cache", None)
                    if cache is not None:
                        m["emb_cache_hit_rate"] = cache.hit_rate()
                if on_metrics:
                    on_metrics(m)
                else:
                    print(f"[train] step={state.step} "
                          + " ".join(f"{k}={v:.5g}" for k, v in m.items()
                                     if k != "step"), flush=True)
            if (loop_cfg.ckpt_every and loop_cfg.ckpt_dir
                    and state.step % loop_cfg.ckpt_every == 0):
                if ckpt:
                    ckpt.save_async(state, loop_cfg.ckpt_dir, state.step)
                else:
                    ckpt_lib.save(state, loop_cfg.ckpt_dir, state.step)
                ckpt_lib.prune(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts)
    finally:
        stop = getattr(batches, "stop", None)
        if callable(stop):
            stop()
        if ckpt:
            ckpt.wait()
        if wd:
            wd.close()
    return state


def resume_or_init(make_state: Callable[[], TrainState],
                   ckpt_dir: str) -> TrainState:
    """A fresh ``make_state()`` with the newest committed checkpoint under
    ``ckpt_dir`` restored into it (in place, on its device), or the fresh
    state when there is none."""
    state = make_state()
    if dist.is_initialized():  # every rank sees the same commits
        dist.barrier()
    step = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
    if step is None:
        return state
    return ckpt_lib.restore(ckpt_dir, state, step=step)
