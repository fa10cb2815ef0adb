"""Train-step construction and the driver loop (no checkpointing or
microbatching yet: asking for either raises)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.training.optimizer import adamw_init, opt_update


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer
    moments, and the step count."""

    model: nn.Module
    opt: dict
    step: int = 0

    @staticmethod
    def create(model: nn.Module, tcfg: TrainConfig) -> "TrainState":
        return TrainState(model=model,
                          opt=adamw_init(list(model.parameters()), tcfg))


def make_train_step(loss_fn: Callable, tcfg: TrainConfig) -> Callable:
    """``loss_fn(model, batch) -> scalar``; returns ``step(state, batch) ->
    (state, {"loss", "grad_norm"})``.  Parameters and moments update in
    place; gradients are dropped after each step."""
    if tcfg.microbatch > 1:
        raise NotImplementedError("microbatching is not ported yet")

    def train_step(state: TrainState, batch) -> tuple:
        params = list(state.model.parameters())
        loss = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, params)
        gnorm = opt_update(params, grads, state.opt, state.step, tcfg)
        del grads
        state.step += 1
        return state, {"loss": loss.detach().to(torch.float32),
                       "grad_norm": gnorm}

    return train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str = ""  # checkpointing is not ported yet: setting it raises
    log_every: int = 50


def train_loop(state: TrainState, step_fn, batches, loop_cfg: LoopConfig,
               *, device=None, on_metrics=None) -> TrainState:
    """Run to ``total_steps`` over ``batches`` (an iterable or a staged
    ``StreamingExecutor``, which is stopped on exit).  ``device`` (default
    CUDA) must be where the model lives."""
    if loop_cfg.ckpt_dir:
        raise NotImplementedError("checkpointing is not ported yet")
    dev = resolve_device(device)
    pdev = next(state.model.parameters()).device
    if pdev.type != dev.type or (dev.index is not None
                                 and pdev.index != dev.index):
        raise ValueError(f"model is on {pdev}, train_loop runs on {dev}")
    etl_stats = getattr(batches, "stats", None)
    t0 = time.perf_counter()
    train_s = 0.0
    try:
        for batch in batches:
            if state.step >= loop_cfg.total_steps:
                break
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step to finish
            train_s += time.perf_counter() - ts
            if loop_cfg.log_every and state.step % loop_cfg.log_every == 0:
                m = {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                     "step": state.step,
                     "train_utilization": train_s / max(
                         time.perf_counter() - t0, 1e-9)}
                if etl_stats is not None:
                    m["etl_starved_s"] = etl_stats.consumer_wait_s
                    m["etl_overlapped_s"] = etl_stats.overlapped_etl_s
                if on_metrics:
                    on_metrics(m)
                else:
                    print(f"[train] step={state.step} "
                          + " ".join(f"{k}={v:.5g}" for k, v in m.items()
                                     if k != "step"), flush=True)
    finally:
        stop = getattr(batches, "stop", None)
        if callable(stop):
            stop()
    return state
