"""Per-rank cost analysis of a step (the JAX package's
``distributed/hlo_cost.py``).

The reference re-derives FLOPs, bytes and the collective inventory from
XLA's post-optimisation HLO text, since ``cost_analysis()`` counts a
``while`` body once.  Eager PyTorch has no HLO and no loops to unroll:
``analyze(fn, *args)`` runs ``fn`` on this rank under a
``TorchDispatchMode`` (``CostMode``) and counts every aten op it
dispatches, so a Python loop over the layers is counted layer by layer.
Under a ``FakeTensorMode`` (the dry run's) nothing is allocated or
computed, and the counts are those of the same run on real tensors.

Conventions (the reference's, ``HloCostAnalysis``'s):
- a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``; an einsum reaches
  these), a convolution or an attention kernel: ``FlopCounterMode``'s
  formula, 2 x output elements x the contracted dim for a product;
- an elementwise op: 1 flop an output element; transcendentals
  (``exp``, ``log``, ``rsqrt``, ``tanh``, ``sigmoid``, ``silu``, ...)
  are counted apart, in ``transcendentals``;
- a reduction: 1 flop an output element, as the reference counts
  ``reduce``;
- ``bytes_accessed``: the inputs and outputs of every dispatched op,
  leaving out views and metadata ops (the reference leaves out
  ``parameter`` / ``tuple`` / ``bitcast``) and the allocations that write
  nothing (``empty``).  Eager PyTorch fuses nothing, so these are the
  bytes eager really moves, more than XLA's fused module would;
- collectives: every ``c10d`` op (FSDP's and ``tensor_parallel``'s), its
  payload and group size (``hlo_analysis``), its payload also in
  ``bytes_accessed``, as in the reference.

A DTensor (FSDP2's sharded parameters and optimizer state) counts by its
local shard.

Loops: a loop that ``models.loops.uniform`` runs (flash attention's
chunks) runs its body once on fake tensors; ``CostMode`` counts each op
of it ``loops.trips()`` times, as the reference multiplies a ``while``
body by its trip count.  On real tensors every iteration runs and is
counted.  ``FlopCounterMode`` (``flop_counter_total``) counts such a
body once, as XLA's own ``cost_analysis()`` does; ``CostMode.flop_counter``
is that total too.

Composite ops: a composite op reaches a dispatch mode whole where
autograd does not decompose it first: the backward formulas' own
(``silu_backward`` in every SwiGLU block's backward) and, under
``torch.inference_mode``, every one (``matmul``, ``einsum``,
``softmax``).  ``CostMode`` runs such an op as the ops it decomposes
into (``decomposed``) and counts those, as XLA counts the elementwise ops
such a formula lowers to.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.distributed import hlo_analysis
from repro_torch.models import loops

_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "pow", "tanh",
    "sigmoid", "silu", "gelu", "softplus", "rsqrt", "sqrt", "sin", "cos",
    "tan", "erf", "erfinv", "atan2", "logit", "_softmax", "_log_softmax",
    "logsumexp"))
# ops that read or write no tensor data
_NO_BYTES = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "lift_fresh", "detach",
                       "alias", "_local_scalar_dense", "sym_size",
                       "sym_numel", "sym_stride", "sym_storage_offset"))
# c10d op -> the reference's HLO collective name
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "_allgather_base_": "all-gather", "allgather_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "broadcast_": "broadcast", "send": "collective-permute",
         "recv_": "collective-permute"}


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a DTensor's local shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _elems(tree) -> int:
    return sum(_local(t).numel() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    import torch.distributed as dist
    for arg, val in zip(func._schema.arguments, args):
        if arg.name == "process_group":
            return dist.ProcessGroup.unbox(val).size()
    pg = kwargs.get("process_group")
    return dist.ProcessGroup.unbox(pg).size() if pg is not None else 1


def decomposed(mode, func, args, kwargs):
    """A composite aten op (the module docstring) run as the ops it
    decomposes into, each dispatched to ``mode``; ``NotImplemented`` for
    an op that has no decomposition or that ``FlopCounterMode`` counts
    whole."""
    if func.namespace != "aten" or func._overloadpacket in flop_registry:
        return NotImplemented
    with mode:
        return func.decompose(*args, **kwargs)


class CostMode(TorchDispatchMode):
    """Within: every aten and ``c10d`` op dispatched is counted (the
    module docstring's conventions); ``summary()`` is ``analyze``'s
    result, and ``flop_counter`` what ``FlopCounterMode`` would count (its
    formulas, each dispatch once)."""

    def __init__(self):
        super().__init__()
        self.flop_counter = 0.0
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes_accessed = 0.0
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = decomposed(self, func, args, kwargs)
        if out is NotImplemented:
            out = func(*args, **kwargs)
            self.count(func, args, kwargs, out)
        return out

    def count(self, func, args, kwargs, out) -> None:
        """Count one dispatched op (``out`` its result)."""
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        times = loops.trips()
        if ns == "c10d":
            op = _C10D.get(name)
            if op is not None:  # the first argument is the output
                b = _bytes(args[0])
                self.records += [(op, b, _group_size(func, args, kwargs))
                                 ] * times
                self.bytes_accessed += b * times
            return
        if ns != "aten" or func.is_view or name in _NO_BYTES:
            return
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.flop_counter += flops
        elif name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += _elems(out) * times
        elif torch.Tag.pointwise in func.tags or \
                torch.Tag.reduction in func.tags:
            flops = float(_elems(out))
        self.flops += flops * times
        self.bytes_accessed += (_bytes((args, kwargs)) + _bytes(out)) * times

    def summary(self) -> dict:
        coll = hlo_analysis.summarize(self.records)
        return {"flops": self.flops,
                "transcendentals": self.transcendentals,
                "bytes_accessed": self.bytes_accessed, **coll}


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once on this rank, counted: the
    reference's keys (``flops``, ``transcendentals``, ``bytes_accessed``,
    ``per_op``, ``collective_bytes``, ``wire_bytes``,
    ``n_collectives``)."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.summary()


def flop_counter_total(fn, *args, **kwargs) -> float:
    """``FlopCounterMode``'s total for ``fn``'s run (its matmul-family
    formulas only): the cross-check the reference makes against XLA's
    ``cost_analysis()`` (``xla_cost_analysis``)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
