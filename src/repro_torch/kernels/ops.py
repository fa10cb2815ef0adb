"""Public entry points of the hand-written CUDA kernels.

Each factory encodes a TileStep program once and returns a callable that
launches the kernel for CUDA tensors and runs the kernel's plain PyTorch
version for CPU tensors (see ``kernels/dataflow.py``).  ``LAUNCHES`` counts
CUDA launches per kernel.
"""

from __future__ import annotations

from repro_torch.kernels.dataflow import LAUNCHES, reset_launch_counts
from repro_torch.kernels.dataflow import make_fit_dataflow as fit_dataflow
from repro_torch.kernels.dataflow import make_group_dataflow as group_dataflow
from repro_torch.kernels.dataflow import make_output_dataflow as output_dataflow

__all__ = ["LAUNCHES", "reset_launch_counts", "group_dataflow",
           "output_dataflow", "fit_dataflow"]
