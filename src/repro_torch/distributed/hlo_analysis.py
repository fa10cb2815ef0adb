"""Collective inventory and roofline terms (the JAX package's
``distributed/hlo_analysis.py``).

The reference parses the collectives out of XLA's post-partitioning HLO
text.  Eager PyTorch has no such module: here the inventory is built from
records of the collectives one rank issues, ``(op, payload bytes, group
size)``, as ``distributed/hlo_cost.py`` takes them from the ``c10d`` ops
it sees dispatched (FSDP2's and ``tensor_parallel``'s alike).  The op
names are the reference's HLO names; the payload is what the reference
counts, the op's output: the whole tensor of an all-reduce, an
all-gather or an all-to-all, the scattered shard of a reduce-scatter.

Two numbers are reported per run, as in the reference:
- ``collective_bytes``: the plain sum of the collectives' payloads;
- ``wire_bytes``: ring-algorithm wire traffic per device (all-reduce
  2(S-1)/S, all-gather / all-to-all (S-1)/S of the full payload,
  reduce-scatter (S-1) x shard, a permute or broadcast 1x), the number the
  collective roofline term uses.
"""

from __future__ import annotations

from collections import defaultdict


def wire_bytes(op: str, payload: float, group: int) -> float:
    """The ring model's bytes a device sends for one collective."""
    s = max(int(group), 1)
    if op == "all-reduce":
        return 2.0 * (s - 1) / s * payload
    if op in ("all-gather", "all-to-all"):
        return (s - 1) / s * payload
    if op == "reduce-scatter":
        return float(s - 1) * payload  # the payload is the scattered shard
    return float(payload)  # collective-permute, broadcast


def collect_collectives(records) -> dict:
    """Inventory of ``records`` (``(op, payload bytes, group size)``):
    per op, ``count``, payload ``bytes`` and ``wire_bytes``."""
    stats = defaultdict(lambda: {"count": 0, "bytes": 0, "wire_bytes": 0.0})
    for op, payload, group in records:
        st = stats[op]
        st["count"] += 1
        st["bytes"] += payload
        st["wire_bytes"] += wire_bytes(op, payload, group)
    return dict(stats)


def summarize(records) -> dict:
    st = collect_collectives(records)
    return {
        "per_op": st,
        "collective_bytes": sum(v["bytes"] for v in st.values()),
        "wire_bytes": sum(v["wire_bytes"] for v in st.values()),
        "n_collectives": sum(v["count"] for v in st.values()),
    }


# ---------------------------------------------------------------------------
# roofline terms (NVIDIA H100 SXM data-sheet constants; none is measured)
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12  # H100 SXM data sheet: dense bf16 tensor cores
HBM_BW = 3.35e12          # H100 SXM data sheet: HBM3 bytes/s
# the reference's ICI_BW: a GPU's own link out of its 8-GPU node, one 400
# Gb/s NDR InfiniBand port (ConnectX-7 data sheet), which every 16-rank
# axis of the production mesh crosses
LINK_BW = 50e9            # bytes/s per GPU


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   wire_bytes: float, chips: int) -> dict:
    """Three terms in seconds, the reference's formula and keys.

    ``flops`` and ``hbm_bytes`` are one rank's, so the compute and memory
    terms divide by one GPU's peak; the collective term divides the plain
    byte sum by chips x the link rate, and the ring-model wire time is
    ``wire_bytes / LINK_BW`` (per device)."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    t_collective = collective_bytes / (chips * LINK_BW)
    t_wire = wire_bytes / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", max(t_collective, t_wire))),
                   key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_collective, "t_wire_s": t_wire,
            "dominant": dominant}
