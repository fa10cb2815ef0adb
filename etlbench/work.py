"""The yardstick's arithmetic: the device's peaks, the bytes and operations
each ETL kernel needs for one launch, and a DLRM training step's model
FLOPs and least bytes, all from shapes.

Counting rule (a roofline's): each input byte read once and each output
byte written once, whatever a kernel reads again; a gather reads one row
per distinct index.  A kernel's bound is the larger of bytes over the
memory bandwidth and operations over the arithmetic peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (700 W): HBM3 bandwidth and the
# float32 rate outside the tensor cores, which is the one that applies to a
# float32 step with TF32 off (and to the ETL kernels' 32-bit integer work).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def model_shape(cfg: dict) -> dict:
    """The DLRM's sizes from a configuration file's published keys
    (``arch_mlp_bot`` "13-512-256-128": 13 dense inputs and the bottom
    layers' widths) and the ETL's padding.  Every table has the id cap's
    rows and one OOV row: the program stacks the tables into one tensor,
    so each is padded to the largest."""
    cap = int(cfg["max_ind_range"])
    if int(cfg["assumed"]["vocab_capacity"]) != cap:
        raise ValueError("pipeline III's vocabulary capacity is the id cap")
    bot = [int(x) for x in str(cfg["arch_mlp_bot"]).split("-")]
    top = [int(x) for x in str(cfg["arch_mlp_top"]).split("-")]
    return {"n_dense": bot[0], "n_sparse": int(cfg["num_sparse_features"]),
            "d_emb": int(cfg["arch_sparse_feature_size"]),
            "bot_mlp": bot[1:], "top_mlp": top,
            "rows_per_table": cap + 1,
            "dense_padded": int(cfg["assumed"]["dense_padded"])}


def cardinalities(cfg: dict) -> list:
    """Each sparse feature's published id count, as the generator draws
    its ids."""
    cards = [int(x) for x in cfg["feature_cardinalities"]]
    if len(cards) != int(cfg["num_sparse_features"]):
        raise ValueError("one cardinality a sparse feature")
    return cards


# ---------------------------------------------------------------------------
# ETL kernels, one launch each
# ---------------------------------------------------------------------------

def dataflow_bytes(rows: int, in_row: int, out_row: int,
                   table_bytes: int = 0) -> int:
    """``group_dataflow`` (``apply_kernel``): raw columns in, packed
    outputs out, the OOV-resolved vocabulary table read once."""
    return rows * (in_row + out_row) + table_bytes


def fit_bytes(rows: int, n_sparse: int, hex_width: int, capacity: int) -> int:
    """``fit_dataflow``: the hex columns in, the first-position and count
    accumulators (int32 over the capacity) written once."""
    return rows * n_sparse * hex_width + 2 * 4 * capacity


def stage_bytes(rows: int, n_sparse: int, hex_width: int) -> int:
    """``fused_stage`` (``stage_kernel``): hex in, int32 ids out."""
    return rows * n_sparse * (hex_width + 4)


def packer_bytes(rows: int, cols_in: int, cols_out: int,
                 itemsize: int = 4) -> int:
    """``packer`` (``packer_kernel``): the columns in, the padded block
    out."""
    return rows * (cols_in + cols_out) * itemsize


def build_bytes(rows: int, n_sparse: int, capacity: int) -> int:
    """``vocab_build_chunk`` (``build_kernel``): ids in, the first-position
    state (int32 over the capacity) written once."""
    return rows * n_sparse * 4 + 4 * capacity


def lookup_bytes(rows: int, n_sparse: int, n_distinct: int) -> int:
    """``vocab_lookup`` (``lookup_kernel``): ids in, ranks out, one table
    entry per distinct id."""
    return 2 * rows * n_sparse * 4 + 4 * n_distinct


def etl_kernels(cfg: dict, rows: int, n_distinct: float) -> dict:
    """``{CUDA kernel name: (bytes, operations)}`` of one launch of each
    ETL kernel that the configuration's lowering runs a batch, with
    ``n_distinct`` the mean number of distinct ids a batch looks up."""
    shape = model_shape(cfg)
    etl = cfg["assumed"]
    nd, ns, hw = shape["n_dense"], shape["n_sparse"], int(etl["hex_width"])
    dp, sp = shape["dense_padded"], int(etl["sparse_padded"])
    cap = int(etl["vocab_capacity"])
    dense_in, label = 4 * nd, 4
    if etl["lowering"] == "grouped":
        return {"apply_kernel": (
            dataflow_bytes(rows, dense_in + ns * hw + label,
                           4 * dp + 4 * sp + label, 4 * cap),
            rows * (nd * 4 + ns * (hw + 3) + 1))}
    if etl["lowering"] == "staged":
        return {"apply_kernel": (
                    dataflow_bytes(rows, dense_in + label, 4 * dp + label),
                    rows * (nd * 4 + 1)),
                "stage_kernel": (stage_bytes(rows, ns, hw),
                                 rows * ns * (hw + 1)),
                "lookup_kernel": (lookup_bytes(rows, ns, int(n_distinct)),
                                  rows * ns),
                "packer_kernel": (packer_bytes(rows, ns, sp), rows * sp)}
    raise ValueError(f"unknown lowering {etl['lowering']!r}")


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


# ---------------------------------------------------------------------------
# the DLRM training step
# ---------------------------------------------------------------------------

def _layers(shape: dict) -> list:
    f = shape["n_sparse"]
    bot = [shape["dense_padded"]] + list(shape["bot_mlp"])
    top = [bot[-1] + (f + 1) * f // 2] + list(shape["top_mlp"])
    return list(zip(bot[:-1], bot[1:])) + list(zip(top[:-1], top[1:]))


def param_counts(shape: dict) -> tuple:
    """``(table parameters, MLP parameters)``."""
    tables = shape["n_sparse"] * shape["rows_per_table"] * shape["d_emb"]
    mlp = sum(a * b + b for a, b in _layers(shape))
    return tables, mlp


def step_flops_per_row(shape: dict) -> int:
    """Model FLOPs a row of a training step: three times the forward's
    (the backward's two products per forward product): the MLPs' products
    and the interaction's dots, one per pair of the ``n_sparse + 1``
    vectors."""
    f, d = shape["n_sparse"], shape["d_emb"]
    fwd = sum(2 * a * b for a, b in _layers(shape))
    fwd += 2 * d * (f + 1) * f // 2
    return 3 * fwd


def step_least_bytes(shape: dict, rows: int) -> int:
    """The least bytes a step's arithmetic moves: dense AdamW reads every
    parameter, its gradient and both moments once and writes the
    parameter and both moments once (28 B a parameter); the tables'
    gradient is written once; the MLPs' weights are read in the forward
    and the backward and their gradient written; each gathered embedding
    row is read and its gradient row written; each activation is written
    in the forward and read in the backward; the batch is read once."""
    tables, mlp = param_counts(shape)
    f, d = shape["n_sparse"], shape["d_emb"]
    act = sum(b for _, b in _layers(shape)) + (f + 1) * d + (f + 1) * f // 2
    batch = 4 * (shape["dense_padded"] + f + 1)
    return (28 * (tables + mlp) + 4 * tables + 3 * 4 * mlp
            + rows * (2 * 4 * f * d + 2 * 4 * act + batch))
