"""Cell construction: (arch x shape x mesh) -> this rank's step and its
arguments on fake tensors (the JAX package's ``launch/cells.py``).

Shared by the dry run (``launch/dryrun.py``: the step run once under a
``FakeTensorMode``, nothing allocated) and by the tests.  A "cell" follows
the task matrix:

- train_4k     : train step (loss + grads + optimizer update)
- prefill_32k  : serve prefill (prompt -> logits + cache)
- decode_32k   : decode step (one token against a seq_len KV cache/state)
- long_500k    : decode step, sub-quadratic families only

Where the reference lowers one SPMD program for all devices, here one
rank stands for the cell: ``param_specs``, ``batch_specs`` and
``cache_specs`` split every dim evenly over an axis or replicate it, so
every rank holds the same shapes, issues the same collectives and runs
the same ops; the plan is the mesh's calling rank's.  The mesh is a
``DeviceMesh`` over a process group of the cell's world (the dry run's
fake one); the module is built under the plan's ``FakeTensorMode`` on the
mesh's device type, so no parameter is ever allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import (ALL_SHAPES, ModelConfig, ShapeCfg,
                                      TrainConfig)
from repro_torch.configs.registry import ARCH_IDS, canonical, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.presets import train_preset
from repro_torch.models.api import build_model, input_specs
from repro_torch.training.train_loop import (TrainState, data_group,
                                             shard_train_step)

# long_500k requires sub-quadratic attention (see DESIGN.md
# §Arch-applicability): SSM state, hybrid, or SWA ring caches qualify.
LONG_CONTEXT_OK = {"mamba2_370m", "zamba2_2_7b", "mixtral_8x7b"}
# the reference's weight-gathered serving threshold: model-sharded
# parameters above this many bytes a device are also sharded over the
# data axes
SERVE_FSDP_BYTES = 12e9


def iter_cells():
    """Yield (arch, shape, skip_reason|None) for the full 10x4 matrix."""
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            skip = None
            if shape.name == "long_500k" and arch not in LONG_CONTEXT_OK:
                skip = ("full quadratic attention at 524k context — shape "
                        "excluded for pure full-attention archs")
            yield arch, shape, skip


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: ShapeCfg
    cfg: ModelConfig
    kind: str
    step: Callable        # this rank's step: step(*make_args())
    make_args: Callable   # () -> this rank's arguments, built on fake tensors
    chips: int
    model_flops: float    # 6ND (train) / 2ND (prefill) / 2N_act*B (decode)
    module: nn.Module     # this rank's module (fake tensors)
    opt: Optional[dict]   # this rank's optimizer state (train), else None
    serve_fsdp: bool      # serving: weights also sharded over the data axes
    fake_mode: Any        # the FakeTensorMode every tensor of the cell is in


def tensor_bytes(tree) -> int:
    """Bytes this rank holds of every tensor in ``tree`` (a module's
    parameters, nested dicts / lists / tuples of tensors; a DTensor by its
    local shard)."""
    if isinstance(tree, nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def local_rows(rows: int, mesh) -> int:
    """A batch's rows on one rank: its row shard where the data degree
    divides them, else all of them (``batch_specs``' rule)."""
    dp = shd.data_degree(mesh)
    return rows // dp if rows % dp == 0 else rows


def weight_gathered(cfg: ModelConfig, mesh) -> bool:
    """The reference's rule: weight-gathered serving where the parameters
    a model shard holds exceed ``SERVE_FSDP_BYTES``."""
    msize = shd.axis_sizes(mesh).get("model", 1)
    pbytes = cfg.param_count() * (2 if cfg.param_dtype == "bfloat16" else 4)
    return pbytes / msize > SERVE_FSDP_BYTES


def _batch(cfg: ModelConfig, shape: ShapeCfg, mesh, device) -> dict:
    rows = local_rows(shape.global_batch, mesh)
    return {k: torch.zeros((rows,) + tuple(shp[1:]), dtype=dt,
                           device=device)
            for k, (shp, dt) in input_specs(cfg, shape).items()}


def plan_cell(arch: str, shape: ShapeCfg, mesh,
              tcfg: Optional[TrainConfig] = None, *,
              cfg: Optional[ModelConfig] = None,
              serve_fsdp: Optional[bool] = None) -> CellPlan:
    """This rank's plan of the cell on ``mesh`` (a ``DeviceMesh`` named
    ``("data", "model")`` or ``("pod", "data", "model")``, which becomes
    the active mesh).  Nothing runs: the step is built, not traced.
    ``cfg`` replaces ``arch``'s published config (a cut of it), and
    ``serve_fsdp`` the reference's weight-gathering rule
    (``weight_gathered``) for a serving cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = canonical(arch)
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    tcfg = tcfg or train_preset(arch)
    # grad-accumulation chunks cannot exceed rows-per-replica
    dp = shd.data_degree(mesh)
    if tcfg.microbatch > 1:
        tcfg = dataclasses.replace(
            tcfg, microbatch=max(1, min(tcfg.microbatch,
                                        shape.global_batch // max(dp, 1))))
    chips = mesh.size()
    n_experts = cfg.moe.n_experts if cfg.moe else 0
    nactive = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    dev = mesh.device_type
    # the data axes' flattened mesh is made here, outside the fake mode:
    # flattening computes on the mesh's rank tensor, and the mesh keeps it
    data_group(mesh)
    fake = FakeTensorMode()
    common = dict(arch=arch, shape=shape, cfg=cfg, chips=chips,
                  fake_mode=fake)

    with fake:
        module = model.init(seed=0, device=dev)
        if shape.kind == "train":
            state = TrainState.create(module, tcfg)
            step, state = shard_train_step(
                model.loss, tcfg, mesh, state,
                batch_rows=shape.global_batch, fsdp=tcfg.fsdp,
                n_experts=n_experts)
            return CellPlan(kind="train", step=step, module=state.model,
                            make_args=lambda: (state, _batch(cfg, shape,
                                                             mesh, dev)),
                            model_flops=6.0 * nactive * tokens,
                            opt=state.opt, serve_fsdp=False, **common)

        # serving cells share param shardings (no optimizer state).
        # Models whose model-sharded weights still exceed ~12GB/chip
        # (Kimi-K2 1T, llama-405B) additionally shard over the data axes
        # (weight-gathered serving — the standard big-model serving layout
        # when chips x HBM is the binding constraint).
        gathered = weight_gathered(cfg, mesh) if serve_fsdp is None \
            else serve_fsdp
        tp.shard_for_serving(module, mesh, fsdp=gathered)
        if shape.kind == "prefill":
            return CellPlan(
                kind="prefill", module=module, opt=None,
                serve_fsdp=gathered,
                step=lambda batch: model.prefill(module, batch,
                                                 shape.seq_len),
                make_args=lambda: (_batch(cfg, shape, mesh, dev),),
                model_flops=2.0 * nactive * tokens, **common)

    # decode: one new token against a seq_len-deep cache
    def decode_args():
        rows = local_rows(shape.global_batch, mesh)
        whole = model.init_cache(rows, shape.seq_len, device="meta")
        ax = tp.model_axis(mesh) or tp.ModelAxis(None, 0, 1)
        cache = tp.local_cache(whole, ax, dev)
        tokens = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        return cache, tokens, shape.seq_len - 1

    return CellPlan(
        kind="decode", module=module, opt=None, serve_fsdp=gathered,
        step=lambda cache, tokens, pos: model.decode_step(module, cache,
                                                          tokens, pos),
        make_args=decode_args,
        model_flops=2.0 * nactive * shape.global_batch, **common)
