"""Gradient machinery: microbatch accumulation, and the int8 quantizer of
the JAX package's compressed all-reduce.

Microbatching (grad accumulation) bounds activation memory: only one
microbatch's activations live at a time.  The gradients of the microbatches
are summed in place into the parameters' ``.grad`` when the accumulation
dtype is the parameters' own, so a step holds one set of gradients (at
``llama3_2_3b``'s full width a second and third gradient-sized buffer would
not fit beside the AdamW state on one 80 GB card).

``compressed_psum_mean`` (int8 all-reduce with error feedback) waits for
distribution (ROADMAP Queue A: distribution) and raises; its error-feedback
state, ``ef_init``, is here.
"""

from __future__ import annotations

from typing import Callable

import torch


def split_microbatches(batch: dict, n_micro: int) -> dict:
    """(rows, ...) -> (n_micro, rows/n_micro, ...) for every batch tensor
    (views, no copy)."""

    def one(x):
        r = x.shape[0]
        assert r % n_micro == 0, (r, n_micro)
        return x.reshape((n_micro, r // n_micro) + tuple(x.shape[1:]))

    return {k: one(v) for k, v in batch.items()}


def microbatched_value_and_grad(loss_fn: Callable, n_micro: int,
                                accum_dtype="float32") -> Callable:
    """``loss_fn(model, batch) -> scalar``; returns ``fn(model, batch) ->
    (loss, grads)``, ``grads`` in ``model.parameters()`` order, both
    averaged over ``n_micro`` equal row chunks of the batch.

    The sum runs as the reference's scan does (``0 + g_1 + ... + g_n``,
    then ``* (1 / n)``).  When ``accum_dtype`` is every parameter's dtype
    the sum is kept in the parameters' ``.grad`` (each chunk's
    ``backward()`` adds into it in place; the returned gradients are those
    tensors, and ``.grad`` is cleared); otherwise one accumulator in
    ``accum_dtype`` holds it.  With ``n_micro <= 1`` it is one
    ``torch.autograd.grad`` over the whole batch."""
    if n_micro <= 1:
        def fn1(model, batch):
            params = list(model.parameters())
            loss = loss_fn(model, batch)
            return loss.detach(), list(torch.autograd.grad(loss, params))
        return fn1

    acc_dtype = getattr(torch, accum_dtype) if isinstance(accum_dtype, str) \
        else accum_dtype
    inv = 1.0 / n_micro

    def fn(model, batch):
        params = list(model.parameters())
        micro = split_microbatches(batch, n_micro)
        in_place = all(p.dtype == acc_dtype for p in params)
        for p in params:
            p.grad = None
        acc = None if in_place else [torch.zeros_like(p, dtype=acc_dtype)
                                     for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        for i in range(n_micro):
            loss = loss_fn(model, {k: v[i] for k, v in micro.items()})
            if in_place:
                loss.backward()
            else:
                for a, g in zip(acc, torch.autograd.grad(loss, params)):
                    a.add_(g.to(acc_dtype))
            loss_sum += loss.detach().to(torch.float32)
            del loss
        if in_place:
            acc = [p.grad for p in params]
            for p in params:
                p.grad = None
        with torch.no_grad():
            for a in acc:
                a.mul_(inv)
        return loss_sum * inv, acc

    return fn


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def ef_init(params):
    """The error-feedback residuals: float32 zeros shaped like ``params`` (a
    tensor, or a dict / list / tuple of them, nested), on their devices."""
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(ef_init(v) for v in params)
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum_mean(grads, ef_state, axis_name: str):
    """Error-feedback int8 all-reduce mean: not ported yet."""
    raise NotImplementedError(
        "compressed_psum_mean is not ported yet (ROADMAP Queue A: "
        "distribution, on torch.distributed)")
