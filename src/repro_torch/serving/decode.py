"""Batched serving: prefill, then a greedy or sampled decode loop
(the JAX package's ``serving/decode.py``).

The token chosen at each step is appended before the next decode step, so
``generate`` returns ``max_new`` tokens a row: the prefill's choice, then
one a decode step at positions ``S, S + 1, ...``.  Positions are host ints
and the chosen tokens stay on the device until the loop ends, so no step
waits for the card; each phase's time ends in a synchronize on a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.api import Model


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.decode_s if self.decode_s else 0.0


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def next_token(logits, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """(B, V) logits -> (B, 1) int32: the argmax, or with ``temperature >
    0`` a draw from ``softmax(logits / temperature)`` (float32) using
    ``generator``."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, -1)
        tok = torch.multinomial(probs, 1, generator=generator)
    else:
        tok = torch.argmax(logits, -1)[:, None]
    return tok.to(torch.int32)


def generate(model: Model, module, prompts: torch.Tensor, *, max_new: int,
             max_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> tuple[np.ndarray, ServeStats]:
    """prompts: (B, S) int32 on the module's device.  Greedy
    (``temperature=0``) or sampled decode (``generator`` on that device);
    returns the (B, max_new) tokens on the host and the phase times."""
    B, S = prompts.shape
    stats = ServeStats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(module, {"tokens": prompts}, max_len)
        logits = logits[:, -1, :]
        _sync(logits)
        stats.prefill_s = time.perf_counter() - t0

        out = []
        tok = next_token(logits, temperature, generator)
        t0 = time.perf_counter()
        for i in range(max_new):
            out.append(tok)
            logits, cache = model.decode_step(module, cache, tok, S + i)
            tok = next_token(logits[:, -1, :], temperature, generator)
        _sync(tok)
        stats.decode_s = time.perf_counter() - t0
    stats.tokens = B * max_new
    return torch.cat(out, 1).cpu().numpy(), stats
