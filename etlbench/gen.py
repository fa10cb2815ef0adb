"""The benchmark's frozen generator of raw Criteo-shaped batches.

A copy of ``repro_torch.data.synth.gen_batch`` as it stood when the
benchmark was defined (Dataset-I: a float32 label, 13 lognormal dense
columns with 15 % negatives and NaNs, 26 sparse columns of 8-character
lowercase hex over Zipf-distributed ids, all-zero hex for a missing
value), kept here so that a later change to the program cannot change the
yardstick.  One change from that copy: each sparse feature draws its ids
within its own published cardinality (the configuration's
``feature_cardinalities``: Zipf ranks folded onto ``1 .. cardinality``, so
a 3-id feature carries 3 ids), where the program's copy draws every
feature over one universe.  Every batch of a run is drawn from one
``numpy`` generator seeded by the run's ``--seed``, so the same seed gives
the same bytes.
"""

from __future__ import annotations

import numpy as np

N_DENSE = 13
N_SPARSE = 26
HEX_WIDTH = 8

_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def columns() -> list:
    """``(name, kind)`` of Dataset-I's columns, in the order they are drawn."""
    return ([("label", "label")]
            + [(f"dense_{i}", "dense") for i in range(N_DENSE)]
            + [(f"sparse_{i}", "sparse") for i in range(N_SPARSE)])


def hex_encode(vals: np.ndarray, width: int = HEX_WIDTH) -> np.ndarray:
    """uint32[n] -> uint8[n, width] lowercase ASCII hex."""
    out = np.empty(vals.shape + (width,), np.uint8)
    v = vals.astype(np.uint64)
    for i in range(width - 1, -1, -1):
        out[..., i] = _HEX[(v & 0xF).astype(np.int64)]
        v >>= np.uint64(4)
    return out


def gen_batch(n_rows: int, rng: np.random.Generator, *, cardinalities,
              zipf_a: float, missing_rate: float) -> dict:
    """One raw columnar batch of ``n_rows`` rows; sparse feature ``i``'s ids
    lie in ``1 .. cardinalities[i]`` (0 is the missing value's hex)."""
    if len(cardinalities) != N_SPARSE:
        raise ValueError(f"{len(cardinalities)} cardinalities for "
                         f"{N_SPARSE} sparse features")
    batch = {}
    for name, kind in columns():
        if kind == "dense":
            x = rng.lognormal(mean=1.0, sigma=2.0,
                              size=n_rows).astype(np.float32)
            neg = rng.random(n_rows) < 0.15
            x = np.where(neg, -x, x)
            if missing_rate:
                x[rng.random(n_rows) < missing_rate] = np.nan
            batch[name] = x
        elif kind == "sparse":
            card = int(cardinalities[int(name.split("_")[1])])
            ids = 1 + (rng.zipf(zipf_a, size=n_rows) - 1) % card
            col = hex_encode(ids.astype(np.uint32))
            if missing_rate:
                col[rng.random(n_rows) < missing_rate] = 0
            batch[name] = col
        else:
            batch[name] = (rng.random(n_rows) < 0.03).astype(np.float32)
    return batch


def seed_words(seed: int, stream: int) -> list:
    """A ``numpy`` seed sequence entropy for ``(seed, stream)``: any whole
    number (negative or past 64 bits too) maps to non-negative words."""
    s = int(seed)
    words = [stream, 1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            return words


def batches(seed: int, stream: int, n: int, rows: int, traffic: dict,
            cardinalities) -> list:
    """``n`` raw batches of ``rows`` rows from the run's seed; ``stream``
    separates the fit chunks (0), the apply pool (1) and the fresh rows of
    an event stream (2)."""
    rng = np.random.default_rng(seed_words(seed, stream))
    return [gen_batch(rows, rng, cardinalities=cardinalities,
                      zipf_a=float(traffic["zipf_a"]),
                      missing_rate=float(traffic["missing_rate"]))
            for _ in range(n)]


def fresh_rows(seed: int, n_events: int, rows: int, traffic: dict,
               cardinalities) -> list:
    """``n_events`` blocks of ``rows`` new rows (stream 2), one an event,
    drawn one after the other, so event ``k``'s block does not depend on
    how many follow; a list of None where ``rows`` is 0."""
    if not rows:
        return [None] * n_events
    rng = np.random.default_rng(seed_words(seed, 2))
    return [gen_batch(rows, rng, cardinalities=cardinalities,
                      zipf_a=float(traffic["zipf_a"]),
                      missing_rate=float(traffic["missing_rate"]))
            for _ in range(n_events)]


def event(pool: list, fresh: list, k: int) -> dict:
    """Event ``k`` of a stream: pool batch ``k mod len(pool)`` with its
    first rows replaced by the event's own fresh rows (``fresh[k]``,
    None for none): new ids in every event, at the cost of one copy."""
    base = pool[k % len(pool)]
    new = fresh[k]
    if new is None:
        return base
    m = len(new["label"])
    if m > len(base["label"]):
        raise ValueError(f"{m} fresh rows in a batch of {len(base['label'])}")
    return {c: np.concatenate([new[c], base[c][m:]]) for c in base}
