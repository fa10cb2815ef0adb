"""Feature schema for training-aware ETL pipelines.

The schema is the contract between raw columnar data, the operator DAG, and the
format-aware packer.  It mirrors PipeRec's schema-validation step: every pipeline
is validated against the schema before planning (paper §3.1 step 1), and the
planner uses dtype/shape metadata to verify operator type constraints.

Feature kinds
-------------
- ``dense``  : float32 scalar per row (user age, price, ...).
- ``sparse`` : high-cardinality categorical.  Raw encoding is either a
  fixed-width ASCII-hex string (``hex_width`` bytes, Criteo style) or an int32.
- ``label``  : training target (float32 for CTR, int32 for LM tokens).
- ``token``  : raw token-id column for LM trainers (int32 per row position).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Iterable

import numpy as np

DenseKind = "dense"
SparseKind = "sparse"
LabelKind = "label"
TokenKind = "token"

_VALID_KINDS = (DenseKind, SparseKind, LabelKind, TokenKind)


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One column of the raw dataset."""

    name: str
    kind: str
    # Raw on-disk dtype.
    dtype: str = "float32"
    # For sparse hex-string columns: number of ASCII chars (8 -> 32-bit value).
    hex_width: int = 0
    # For token columns: sequence length per row (0 = scalar column).
    seq_len: int = 0

    def __post_init__(self):
        if self.kind not in _VALID_KINDS:
            raise ValueError(f"unknown feature kind {self.kind!r} for {self.name!r}")
        if self.kind == SparseKind and self.hex_width not in (0, 4, 8, 16):
            raise ValueError(f"unsupported hex_width {self.hex_width} for {self.name!r}")

    @property
    def is_hex(self) -> bool:
        return self.kind == SparseKind and self.hex_width > 0

    def raw_shape(self, n_rows: int) -> tuple:
        if self.is_hex:
            return (n_rows, self.hex_width)
        if self.seq_len:
            return (n_rows, self.seq_len)
        return (n_rows,)

    def raw_dtype(self) -> np.dtype:
        if self.is_hex:
            return np.dtype(np.uint8)
        return np.dtype(self.dtype)


class Schema:
    """Ordered collection of FeatureSpecs with glob selection."""

    def __init__(self, features: Iterable[FeatureSpec]):
        self.features = list(features)
        self._by_name = {f.name: f for f in self.features}
        if len(self._by_name) != len(self.features):
            raise ValueError("duplicate feature names in schema")

    def __len__(self) -> int:
        return len(self.features)

    def __iter__(self):
        return iter(self.features)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str) -> FeatureSpec:
        return self._by_name[name]

    def select(self, pattern: str) -> list[FeatureSpec]:
        """Glob-select features by name, preserving schema order."""
        out = [f for f in self.features if fnmatch.fnmatch(f.name, pattern)]
        if not out:
            raise KeyError(f"pattern {pattern!r} matched no schema features")
        return out

    def select_kind(self, kind: str) -> list[FeatureSpec]:
        return [f for f in self.features if f.kind == kind]

    def validate_batch(self, batch: dict) -> None:
        """Validate a raw columnar batch (dict of name -> np.ndarray)."""
        n_rows = None
        for f in self.features:
            if f.name not in batch:
                raise KeyError(f"batch missing column {f.name!r}")
            col = batch[f.name]
            if n_rows is None:
                n_rows = int(col.shape[0])
            expect = f.raw_shape(n_rows)
            if tuple(col.shape) != expect:
                raise ValueError(
                    f"column {f.name!r}: shape {tuple(col.shape)} != expected {expect}")
            if np.dtype(col.dtype) != f.raw_dtype():
                raise TypeError(
                    f"column {f.name!r}: dtype {col.dtype} != expected {f.raw_dtype()}")

    # -- canned schemas used throughout tests/benchmarks ---------------------

    @staticmethod
    def criteo_kaggle() -> "Schema":
        """Dataset-I: 13 dense f32 + 26 sparse 8-char hex + click label."""
        feats = [FeatureSpec("label", LabelKind, "float32")]
        feats += [FeatureSpec(f"dense_{i}", DenseKind, "float32") for i in range(13)]
        feats += [FeatureSpec(f"sparse_{i}", SparseKind, "uint8", hex_width=8)
                  for i in range(26)]
        return Schema(feats)

    @staticmethod
    def synthetic_wide() -> "Schema":
        """Dataset-II: 504 dense + 42 sparse hex columns."""
        feats = [FeatureSpec("label", LabelKind, "float32")]
        feats += [FeatureSpec(f"dense_{i}", DenseKind, "float32") for i in range(504)]
        feats += [FeatureSpec(f"sparse_{i}", SparseKind, "uint8", hex_width=8)
                  for i in range(42)]
        return Schema(feats)

    @staticmethod
    def lm_events(seq_len: int) -> "Schema":
        """Raw LM event-log schema: hashed id columns that the ETL pipeline maps
        into a bounded token id space (SigridHash/VocabMap path)."""
        return Schema([
            FeatureSpec("tokens_raw", TokenKind, "int32", seq_len=seq_len),
            FeatureSpec("label", LabelKind, "int32", seq_len=seq_len),
        ])
