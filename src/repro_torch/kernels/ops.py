"""Public entry points of the hand-written CUDA kernels.

Each entry launches its kernel for CUDA tensors and runs the kernel's plain
PyTorch version for CPU tensors (see ``kernels/dataflow.py``,
``kernels/vocab.py`` and ``kernels/embedding_bag.py``).  The dataflow and
staged factories encode their program once and return the callable; the
vocabulary and embedding-bag functions are called directly.  ``LAUNCHES``
counts CUDA launches per kernel.
"""

from __future__ import annotations

from repro_torch.kernels.backend import LAUNCHES, reset_launch_counts
from repro_torch.kernels.dataflow import make_fit_dataflow as fit_dataflow
from repro_torch.kernels.dataflow import make_fused_stage as fused_stage
from repro_torch.kernels.dataflow import make_group_dataflow as group_dataflow
from repro_torch.kernels.dataflow import make_output_dataflow as output_dataflow
from repro_torch.kernels.dataflow import make_packer as packer
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_cached)
from repro_torch.kernels.vocab import vocab_build_chunk, vocab_lookup

__all__ = ["LAUNCHES", "reset_launch_counts", "group_dataflow",
           "output_dataflow", "fit_dataflow", "fused_stage", "packer",
           "vocab_build_chunk", "vocab_lookup", "embedding_bag",
           "embedding_bag_cached"]
