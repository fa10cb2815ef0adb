"""Device meshes over ``torch.distributed`` ranks (the JAX package's
``launch/mesh.py``).

One rank a device.  The process group comes from the environment ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) unless the caller initialised one already: NCCL on CUDA
(each rank's device is ``cuda:LOCAL_RANK``, set before the first CUDA
call), gloo on the CPU.  Nothing here runs on import.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels.backend import resolve_device


def init_process_group(device=None) -> torch.device:
    """Join the world ``torchrun`` describes (a no-op when a group exists)
    and return this rank's device: ``cuda:LOCAL_RANK`` (NCCL), or the CPU
    (gloo) when ``device`` is the CPU.  Raises without ``WORLD_SIZE``."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if dev.index is None:  # the rank's own card, before any CUDA call
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no process group: run under torchrun (or set "
                               "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def make_host_mesh(model_axis: int = 1, device=None):
    """A ``(world // m, m)`` mesh named ``("data", "model")`` over every
    rank (``m = min(model_axis, world)``)."""
    dev = init_process_group(device)
    n = dist.get_world_size()
    m = min(model_axis, n)
    return init_device_mesh(dev.type, (n // m, m),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model) — the pod axis is the
    outer data-parallel dimension.  Raises ``ValueError`` on another
    world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = init_process_group(device)
    need = 512 if multi_pod else 256
    if dist.get_world_size() != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
