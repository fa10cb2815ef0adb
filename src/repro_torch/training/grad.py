"""Gradient machinery: microbatch accumulation, and the int8 compressed
all-reduce mean with error feedback.

Microbatching (grad accumulation) bounds activation memory: only one
microbatch's activations live at a time.  The gradients of the microbatches
are summed in place into the parameters' ``.grad`` when the accumulation
dtype is the parameters' own, so a step holds one set of gradients (at
``llama3_2_3b``'s full width a second and third gradient-sized buffer would
not fit beside the AdamW state on one 80 GB card).

int8 compression with error feedback: gradients are quantized to int8 with a
per-tensor scale shared by the ranks before the data-parallel mean; the
quantization residual is carried to the next step (EF-SGD).  As in the JAX
package, no train step calls it (``TrainConfig.grad_compression`` is read
by neither).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist


def split_microbatches(batch: dict, n_micro: int) -> dict:
    """(rows, ...) -> (n_micro, rows/n_micro, ...) for every batch tensor
    (views, no copy)."""

    def one(x):
        r = x.shape[0]
        assert r % n_micro == 0, (r, n_micro)
        return x.reshape((n_micro, r // n_micro) + tuple(x.shape[1:]))

    return {k: one(v) for k, v in batch.items()}


def microbatched_value_and_grad(loss_fn: Callable, n_micro: int,
                                accum_dtype="float32", *,
                                in_place: Optional[bool] = None,
                                micro_context: Optional[Callable] = None,
                                each_micro: Optional[dict] = None
                                ) -> Callable:
    """``loss_fn(model, batch) -> scalar``; returns ``fn(model, batch) ->
    (loss, grads)``, ``grads`` in ``model.parameters()`` order, both
    averaged over ``n_micro`` equal row chunks of the batch.

    The sum runs as the reference's scan does (``0 + g_1 + ... + g_n``,
    then ``* (1 / n)``).  When ``accum_dtype`` is every parameter's dtype
    the sum is kept in the parameters' ``.grad`` (each chunk's
    ``backward()`` adds into it in place; the returned gradients are those
    tensors, and ``.grad`` is cleared); otherwise one accumulator in
    ``accum_dtype`` holds it.  With ``n_micro <= 1`` it is one
    ``torch.autograd.grad`` over the whole batch.

    ``in_place=True`` sums in ``.grad`` through ``backward()`` whatever the
    dtypes, one microbatch or more (what FSDP's gradient hooks need).
    ``micro_context(i)``, when given, is a context manager entered around
    microbatch ``i``'s forward and backward.  ``each_micro`` (``{parameter
    index: fn}``, with ``n_micro > 1``): each microbatch's gradient of that
    parameter passes ``fn`` before it is added into an accumulator in
    ``accum_dtype`` of its own (the reference's ``constrain(g)``: a
    data-parallel sum, rounded to the parameter's dtype)."""
    ctx = micro_context or (lambda i: contextlib.nullcontext())
    if n_micro <= 1 and not in_place:
        def fn1(model, batch):
            params = list(model.parameters())
            with ctx(0):
                loss = loss_fn(model, batch)
                grads = list(torch.autograd.grad(loss, params))
            return loss.detach(), grads
        return fn1

    acc_dtype = getattr(torch, accum_dtype) if isinstance(accum_dtype, str) \
        else accum_dtype
    n_micro = max(n_micro, 1)
    inv = 1.0 / n_micro

    own = each_micro or {}

    def fn(model, batch):
        params = list(model.parameters())
        micro = split_microbatches(batch, n_micro)
        summed = in_place if in_place is not None else \
            all(p.dtype == acc_dtype for p in params)
        for p in params:
            p.grad = None
        acc = None if summed else [torch.zeros_like(p, dtype=acc_dtype)
                                   for p in params]
        sep = {j: torch.zeros_like(params[j], dtype=acc_dtype)
               for j in own} if summed else {}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        for i in range(n_micro):
            with ctx(i):
                loss = loss_fn(model, {k: v[i] for k, v in micro.items()})
                if summed:
                    loss.backward()
                    for j, f in own.items():
                        sep[j].add_(f(params[j].grad).to(acc_dtype))
                        params[j].grad = None
                else:
                    for j, (a, g) in enumerate(zip(
                            acc, torch.autograd.grad(loss, params))):
                        a.add_((own[j](g) if j in own else g).to(acc_dtype))
            loss_sum += loss.detach().to(torch.float32)
            del loss
        if summed:
            acc = [sep.get(j, p.grad) for j, p in enumerate(params)]
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


def _group(group):
    """A process group, or the group of the active mesh's dim so named."""
    if isinstance(group, str):
        from repro_torch.distributed.sharding import get_active_mesh
        mesh = get_active_mesh()
        if mesh is None:
            raise ValueError(f"axis {group!r} names no dim: no active mesh")
        return mesh.get_group(group)
    return group


def compressed_psum_mean(grads, ef_state, group=None):
    """Error-feedback int8 all-reduce mean over ``group`` (a process group;
    a mesh-dim name of the active mesh, like the reference's
    ``axis_name``; None: the world).

    Per rank: g' = g + residual; q = int8(g') on a scale shared by the
    ranks (a float32 all-reduce MAX of amax first); residual' = g' -
    deq(q); the int8 payload is summed as int32, then the mean is
    dequantized.  Every division is a division (a scalar divisor on CUDA
    would be a multiplication by its reciprocal).  ``grads`` / ``ef_state``
    are tensors or matching dicts / lists / tuples of them; returns
    ``(mean, new_ef)`` of that structure."""
    group = _group(group)
    if isinstance(grads, dict):
        out = {k: compressed_psum_mean(grads[k], ef_state[k], group)
               for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(grads, (list, tuple)):
        out = [compressed_psum_mean(g, e, group)
               for g, e in zip(grads, ef_state)]
        return (type(grads)(o[0] for o in out),
                type(grads)(o[1] for o in out))
    g, ef = grads, ef_state
    full = lambda v: torch.full((), v, dtype=torch.float32, device=g.device)
    gf = g.to(torch.float32) + ef
    # shared scale: every rank quantizes on the same grid, so the int32 sum
    # is exact in the quantized domain
    amax = torch.max(torch.abs(gf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / full(127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_ef = gf - q.to(torch.float32) * scale
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, group=group)
    n = full(float(dist.get_world_size(group)))
    mean = q_sum.to(torch.float32) * scale / n
    return mean.to(g.dtype), new_ef
