"""Host-to-device handoff between the ETL engine and the trainer.

The paper's FPGA writes training-ready batches straight into GPU memory.  On
one H100 the port gets as close as PyTorch allows:

- ``to_device``: raw host columns are copied into pinned host buffers and
  sent with ``non_blocking`` copies on the caller's current stream, so the
  copy overlaps whatever the trainer runs on its own stream.  PyTorch's
  pinned-memory allocator records each buffer's use on that stream, so a
  buffer is not reused before its copy has finished.
- ``StreamTransform``: the executor's transform stage runs the compiled
  pipeline on a CUDA stream of its own and records an event after it.
- ``receive``: the consumer's stream waits on that event (no host sync), and
  every delivered tensor is ``record_stream``-ed on the consumer's stream so
  the caching allocator never hands its memory back to the transform stream
  while the trainer may still read it.
"""

from __future__ import annotations

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def to_device(cols: dict, device: torch.device) -> dict:
    """Host numpy columns -> tensors on ``device`` (pinned, non-blocking
    copies for CUDA; private copies on the CPU)."""
    out = {}
    for k, v in cols.items():
        a = np.asarray(v)
        if device.type != "cuda":
            out[k] = torch.tensor(a, device=device)
            continue
        pinned = torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                             pin_memory=True)
        pinned.numpy()[...] = a
        out[k] = pinned.to(device, non_blocking=True)
    return out


def _tensors(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _tensors(v)


class StreamTransform:
    """Run ``fn(raw)`` on this object's own CUDA stream and return
    ``(result, event)``.  The device is set and the stream created in the
    calling thread on first use (the executor's transform thread)."""

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = device
        self._stream = None

    def __call__(self, raw):
        if self._stream is None:
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = self.fn(raw)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event


def receive(batch, event) -> object:
    """Make ``batch`` safe to use on the caller's current stream: wait on
    the producer's ``event`` and record every tensor on this stream."""
    if event is None:
        return batch
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    for t in _tensors(batch):
        if t.is_cuda:
            t.record_stream(stream)
    return batch
