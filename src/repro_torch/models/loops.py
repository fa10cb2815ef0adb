"""Uniform loops: a Python loop whose iterations dispatch the same ops on
tensors of the same shapes (flash attention's query and key chunks).

On fake tensors (a dry run's: no values to compute) such a loop runs its
body once, and ``trips()`` says how many iterations that one run stands
for, so a counter of dispatched ops (``distributed.hlo_cost``) counts the
body once an iteration, as XLA's cost analysis multiplies a ``while``
body by its trip count.  On real tensors every iteration runs and
``trips()`` stays 1.
"""

from __future__ import annotations

import contextlib

# iterations the ops dispatched now stand for (nested loops multiply)
_TRIPS = [1]


def trips() -> int:
    """How many iterations each op dispatched now stands for."""
    return _TRIPS[-1]


@contextlib.contextmanager
def uniform(n: int, *tensors):
    """A loop of ``n`` uniform iterations over ``tensors`` (its inputs):
    yields how many iterations to run, 1 where every input is a fake
    tensor (each op then standing for ``n``), else ``n``."""
    from torch._subclasses.fake_tensor import is_fake
    if n <= 1 or not tensors or not all(is_fake(t) for t in tensors):
        yield n
        return
    _TRIPS.append(_TRIPS[-1] * n)
    try:
        yield 1
    finally:
        _TRIPS.pop()
