"""Synthetic dataset generators mirroring the paper's three datasets (§4.1.1).

- Dataset-I  : Criteo-Kaggle shape — 13 dense f32 + 26 sparse 8-char hex + label.
- Dataset-II : wide synthetic — 504 dense + 42 sparse hex.
- Dataset-III: Dataset-I column structure, sharded into many files (industrial
  ingest).  Row counts are scaled by ``scale`` so CI-sized runs stay tractable;
  benchmarks report per-row throughput, which is scale-invariant.

Sparse values follow a Zipf-like distribution over a bounded id universe so
vocabulary builds see realistic skew (hot keys + long tail); a configurable
missing-rate produces all-zero hex strings (the paper's FillMissing path).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.schema import Schema

_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def _hex_encode(vals: np.ndarray, width: int) -> np.ndarray:
    """uint32[n] -> uint8[n, width] ASCII hex (lowercase)."""
    out = np.empty(vals.shape + (width,), np.uint8)
    v = vals.astype(np.uint64)
    for i in range(width - 1, -1, -1):
        out[..., i] = _HEX[(v & 0xF).astype(np.int64)]
        v >>= np.uint64(4)
    return out


def _zipf_ids(rng, n, universe, a=1.3):
    ids = rng.zipf(a, size=n) % universe
    return ids.astype(np.uint32)


def gen_batch(schema: Schema, n_rows: int, rng: np.random.Generator, *,
              id_universe: int = 1 << 22, missing_rate: float = 0.02) -> dict:
    """One raw columnar batch for any dense/sparse/label schema."""
    batch = {}
    for f in schema:
        if f.kind == "dense":
            x = rng.lognormal(mean=1.0, sigma=2.0, size=n_rows).astype(np.float32)
            neg = rng.random(n_rows) < 0.15
            x = np.where(neg, -x, x)  # negatives exercise Clamp
            if missing_rate:
                x[rng.random(n_rows) < missing_rate] = np.nan
            batch[f.name] = x
        elif f.kind == "sparse":
            ids = _zipf_ids(rng, n_rows, id_universe)
            col = _hex_encode(ids, f.hex_width)
            if missing_rate:
                col[rng.random(n_rows) < missing_rate] = 0  # all-zero = missing
            batch[f.name] = col
        elif f.kind == "label":
            batch[f.name] = (rng.random(n_rows) < 0.03).astype(np.float32)
        elif f.kind == "token":
            batch[f.name] = rng.integers(
                0, id_universe, size=(n_rows, f.seq_len)).astype(np.int32)
    return batch


def dataset_batches(which: str, *, rows: int, batch_size: int, seed: int = 0,
                    missing_rate: float = 0.02) -> Iterator[dict]:
    """Stream raw batches for dataset I/II/III (III = I's columns)."""
    schema = {"I": Schema.criteo_kaggle(), "II": Schema.synthetic_wide(),
              "III": Schema.criteo_kaggle()}[which]
    rng = np.random.default_rng(seed)
    emitted = 0
    while emitted < rows:
        n = min(batch_size, rows - emitted)
        yield gen_batch(schema, n, rng, missing_rate=missing_rate)
        emitted += n


def dataset_schema(which: str) -> Schema:
    return {"I": Schema.criteo_kaggle(), "II": Schema.synthetic_wide(),
            "III": Schema.criteo_kaggle()}[which]


def lm_event_batches(seq_len: int, *, rows: int, batch_size: int,
                     seed: int = 0, id_universe: int = 1 << 22
                     ) -> Iterator[dict]:
    """Raw LM event-log batches (unbounded ids; SigridHash bounds them)."""
    rng = np.random.default_rng(seed)
    emitted = 0
    while emitted < rows:
        n = min(batch_size, rows - emitted)
        toks = rng.integers(0, id_universe, size=(n, seq_len)).astype(np.int32)
        lbl = np.roll(toks, -1, axis=1)
        yield {"tokens_raw": toks, "label": lbl}
        emitted += n


def materialize(schema: Schema, it: Iterator[dict]) -> dict:
    """Concatenate a batch stream into one in-memory columnar table."""
    cols: dict[str, list] = {}
    for b in it:
        for k, v in b.items():
            cols.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}
