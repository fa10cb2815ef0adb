"""Train-step construction (with microbatching: ``training/grad.py``) and
the checkpointed, watchdogged driver loop."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.backend import resolve_device
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
    step = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
    if step is None:
        return state
    return ckpt_lib.restore(ckpt_dir, state, step=step)
