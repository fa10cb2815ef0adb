"""Columnar binary dataset format (offline Parquet stand-in).

The paper stores Criteo as uncompressed, memory-aligned binary Parquet for
columnar processing (§4.1.1).  pyarrow is unavailable offline, so we use an
equivalent self-describing container:

  <dir>/manifest.json      schema + shard index
  <dir>/shard_NNNNN.npz    one np.savez per shard, one array per column

Shards enable Dataset-III-style parallel ingest (the paper shards the 1TB
click logs into 1024 files); readers stream shard-by-shard with selective
column access (only requested columns are materialized).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.schema import FeatureSpec, Schema

MANIFEST = "manifest.json"


def write_dataset(path: str, schema: Schema, batches: Iterator[dict]) -> dict:
    """Write an iterator of columnar batches as shards. Returns the manifest."""
    os.makedirs(path, exist_ok=True)
    shards = []
    total = 0
    for i, batch in enumerate(batches):
        schema.validate_batch(batch)
        n = int(next(iter(batch.values())).shape[0])
        name = f"shard_{i:05d}.npz"
        # atomic publish: write to temp then rename (restart safety);
        # NOTE np.savez appends ".npz" when missing
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz")
        os.close(fd)
        with open(tmp, "wb") as fh:
            np.savez(fh, **batch)
        os.replace(tmp, os.path.join(path, name))
        shards.append({"file": name, "rows": n})
        total += n
    manifest = {
        "format": "repro-columnar-v1",
        "rows": total,
        "shards": shards,
        "schema": [
            {"name": f.name, "kind": f.kind, "dtype": f.dtype,
             "hex_width": f.hex_width, "seq_len": f.seq_len}
            for f in schema],
    }
    with open(os.path.join(path, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return manifest


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as fh:
        return json.load(fh)


def load_schema(path: str) -> Schema:
    man = read_manifest(path)
    return Schema([FeatureSpec(**f) for f in man["schema"]])


def iter_shards(path: str, columns: Optional[Sequence[str]] = None,
                start_shard: int = 0, *, shard_index: int = 0,
                shard_count: int = 1) -> Iterator[dict]:
    """Stream shards with selective column access.

    ``columns`` is the projection pushdown point: ``np.load`` is lazy per
    key, so unrequested columns are never read off disk.  ``shard_index`` /
    ``shard_count`` select every ``shard_count``-th shard file (file-level
    sharding for parallel ingest — reader *i* of *n* touches a disjoint
    subset of shard files).
    """
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
    man = read_manifest(path)
    for sh in man["shards"][start_shard:][shard_index::shard_count]:
        with np.load(os.path.join(path, sh["file"])) as z:
            names = columns if columns is not None else list(z.files)
            yield {c: z[c] for c in names}


def iter_batches(path: str, batch_size: int,
                 columns: Optional[Sequence[str]] = None,
                 drop_remainder: bool = True) -> Iterator[dict]:
    """Re-batch the shard stream to a fixed batch size."""
    carry: Optional[dict] = None
    for shard in iter_shards(path, columns):
        if carry is not None:
            shard = {k: np.concatenate([carry[k], shard[k]]) for k in shard}
        n = next(iter(shard.values())).shape[0]
        ofs = 0
        while n - ofs >= batch_size:
            yield {k: v[ofs:ofs + batch_size] for k, v in shard.items()}
            ofs += batch_size
        carry = {k: v[ofs:] for k, v in shard.items()} if ofs < n else None
    if carry is not None and not drop_remainder:
        n = next(iter(carry.values())).shape[0]
        if n:
            yield carry
