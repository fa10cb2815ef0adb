"""The plain reference the benchmark holds the program to.

Written from the operators' and the model's definitions, in NumPy and
plain PyTorch, with no kernel, cache or batching of the program's; it
imports nothing of the program.

- ``etl_fit`` / ``etl_refit`` / ``etl_apply``: the paper's pipeline III
  on Dataset-I.
  Dense: NaN -> 0, clamp below at 0, ``log1p``, padded with zeros to
  ``dense_padded`` columns.  Sparse: 8-character hex -> uint32 read as
  int32 (all-zero hex is missing, ``INT_MISSING``), a positive modulus by
  the vocabulary's capacity, then the vocabulary: values ranked by first
  appearance over the fit's rows (row-major over the 26 columns, chunk
  after chunk; a refit appends a window's new values after the ranks
  held), an unseen value mapped to ``n_unique`` (the OOV row),
  padded with zeros to ``sparse_padded`` columns.  Label as is.
- ``dlrm_loss``: DLRM (arXiv:1906.00091): bottom MLP with ReLU after each
  layer, one embedding row per sparse feature, pairwise dots of the
  bottom output and the embeddings (upper triangle, row-major), the top
  MLP with ReLU after all but the last layer, mean binary cross-entropy on
  the logits.
- ``adamw_step``: global-norm clipping, then AdamW with bias correction
  and decoupled weight decay scaled by the learning rate.

``precision="tf32"`` runs every matrix product in TF32 (the control):
on a card through cuBLAS, on the CPU by rounding each operand's mantissa
to TF32's 10 bits first.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

INT_MISSING = -(2 ** 31)


# ---------------------------------------------------------------------------
# pipeline III
# ---------------------------------------------------------------------------

def _digit_table() -> np.ndarray:
    """Each byte's hex digit value (a zero byte reads as "0")."""
    c = np.arange(256, dtype=np.int64)
    c[0] = 48
    return np.where(c >= 97, c - 87, np.where(c >= 65, c - 55, c - 48))


_DIGIT = _digit_table()


def sparse_ids(raw: dict, n_sparse: int, capacity: int) -> np.ndarray:
    """int64[rows, n_sparse]: hex -> int32 -> positive modulus."""
    cols = np.stack([raw[f"sparse_{i}"] for i in range(n_sparse)], axis=1)
    missing = ~cols.any(axis=-1)
    val = np.zeros(cols.shape[:-1], np.int64)
    for i in range(cols.shape[-1]):
        val = (val << 4) | _DIGIT[cols[..., i]]
    val = (val & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    val = np.where(missing, np.int32(INT_MISSING), val).astype(np.int64)
    return np.mod(val, capacity)


def first_seen(ids) -> np.ndarray:
    """The distinct values of the id arrays ``ids``, read row-major one
    after the other, in the order they first appear."""
    flat = np.concatenate([a.reshape(-1) for a in ids])
    vals, first = np.unique(flat, return_index=True)
    return vals[np.argsort(first, kind="stable")]


def etl_fit(chunks, n_sparse: int, capacity: int) -> np.ndarray:
    """int32[capacity]: each value's rank by first appearance, -1 where
    the fit never saw it."""
    order = first_seen([sparse_ids(c, n_sparse, capacity) for c in chunks])
    table = np.full(capacity, -1, np.int32)
    table[order] = np.arange(len(order), dtype=np.int32)
    return table


def etl_refit(table: np.ndarray, window_ids) -> np.ndarray:
    """An online refit: every value ``table`` holds keeps its rank; values
    first seen in the window's ids (``sparse_ids`` of its batches, read
    row-major one after the other) follow at ``n_unique``, ``n_unique +
    1``, ... in the order they first appear there."""
    flat = np.concatenate([a.reshape(-1) for a in window_ids])
    unseen = flat[table[flat] < 0]
    vals, first = np.unique(unseen, return_index=True)
    new = vals[np.argsort(first, kind="stable")]
    out = table.copy()
    out[new] = int((table >= 0).sum()) + np.arange(len(new), dtype=np.int32)
    return out


def etl_apply(raw: dict, table: np.ndarray, *, n_dense: int, n_sparse: int,
              dense_padded: int, sparse_padded: int,
              dense_precision: str = "float32") -> dict:
    """One raw batch -> ``{"dense", "sparse", "label"}``.
    ``dense_precision="bfloat16"`` is the ETL control: the dense chain's
    input and result rounded to bfloat16."""
    rows = raw["label"].shape[0]
    dense = np.zeros((rows, dense_padded), np.float32)
    for i in range(n_dense):
        x = raw[f"dense_{i}"]
        x = np.where(np.isnan(x), np.float32(0), x)
        x = np.maximum(x, np.float32(0))
        if dense_precision == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(x)).bfloat16()
            x = torch.log1p(t).bfloat16().float().numpy()
        else:
            x = np.log1p(x)
        dense[:, i] = x
    sparse = vocab_map(sparse_ids(raw, n_sparse, len(table)), table,
                       sparse_padded)
    return {"dense": dense, "sparse": sparse,
            "label": raw["label"].astype(np.float32)}


def vocab_map(ids: np.ndarray, table: np.ndarray, padded: int) -> np.ndarray:
    """int32[rows, padded]: each id's rank, ``n_unique`` where the table
    has none, zeros in the pad columns."""
    hit = table[ids]
    out = np.zeros((ids.shape[0], padded), np.int32)
    out[:, :ids.shape[1]] = np.where(hit >= 0, hit,
                                     int((table >= 0).sum()))
    return out


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

def leaf_shapes(model: dict) -> list:
    """``(name, shape, fan_in)`` of every parameter, in the order the
    benchmark makes them: the tables, then each bottom and top layer's
    weight ``(out, in)`` and bias."""
    f, rows, d = model["n_sparse"], model["rows_per_table"], model["d_emb"]
    out = [("tables", (f, rows, d), d)]
    bot = [model["dense_padded"]] + list(model["bot_mlp"])
    top = [bot[-1] + (f + 1) * f // 2] + list(model["top_mlp"])
    for name, dims in (("bot_mlp", bot), ("top_mlp", top)):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out.append((f"{name}.{i}.weight", (b, a), a))
            out.append((f"{name}.{i}.bias", (b,), 0))
    return out


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of the run ``seed``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (index + 1)) \
        % (1 << 63)


@torch.no_grad()
def init_leaf(t: torch.Tensor, seed: int, index: int, fan_in: int) -> None:
    """Fill ``t`` in place: a weight is N(0, 1) truncated to [-2, 2] over
    sqrt(fan_in) (a table's fan-in is its row width), a bias zeros.  One
    generator on ``t``'s device per leaf, so any leaf can be made again
    alone."""
    if not fan_in:
        t.zero_()
        return
    g = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index))
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=g)
    t.mul_(1.0 / math.sqrt(fan_in))


def init_params(model: dict, seed: int, device) -> dict:
    out = {}
    for i, (name, shape, fan_in) in enumerate(leaf_shapes(model)):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        init_leaf(t, seed, i, fan_in)
        out[name] = t
    return out


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its float32 mantissa rounded to 10 bits (nearest, ties
    to even), the operand precision of a TF32 product; the gradient passes
    straight through."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class Precision:
    """Matrix products in float32 (TF32 off) or in TF32."""

    def __init__(self, precision: str, device):
        if precision not in ("float32", "tf32"):
            raise ValueError(precision)
        self.tf32 = precision == "tf32"
        self.emulate = self.tf32 and torch.device(device).type != "cuda"

    def op(self, x):
        return _tf32(x) if self.emulate else x

    @contextlib.contextmanager
    def scope(self):
        mm = torch.backends.cuda.matmul
        old = (mm.allow_tf32, torch.backends.cudnn.allow_tf32)
        mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = \
            self.tf32 and not self.emulate
        try:
            yield
        finally:
            mm.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dlrm_loss(params: dict, batch: dict, model: dict,
              prec: Precision) -> torch.Tensor:
    f = model["n_sparse"]
    x = batch["dense"]
    n_bot, n_top = len(model["bot_mlp"]), len(model["top_mlp"])
    for i in range(n_bot):
        w, b = params[f"bot_mlp.{i}.weight"], params[f"bot_mlp.{i}.bias"]
        x = torch.relu(prec.op(x) @ prec.op(w).t() + b)
    sparse = batch["sparse"][:, :f].long()
    feat = torch.arange(f, device=sparse.device)
    emb = params["tables"][feat, sparse]
    z = torch.cat([x[:, None, :], emb], dim=1)
    inter = torch.bmm(prec.op(z), prec.op(z).transpose(1, 2))
    iu, ju = torch.triu_indices(f + 1, f + 1, 1, device=z.device)
    y = torch.cat([x, inter[:, iu, ju]], dim=1)
    for i in range(n_top):
        w, b = params[f"top_mlp.{i}.weight"], params[f"top_mlp.{i}.bias"]
        y = prec.op(y) @ prec.op(w).t() + b
        if i < n_top - 1:
            y = torch.relu(y)
    logit = y[:, 0]
    lbl = batch["label"]
    per = (torch.clamp(logit, min=0) - logit * lbl
           + torch.log1p(torch.exp(-logit.abs())))
    return per.mean()


_CHUNK = 1 << 26


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int,
               train: dict) -> dict:
    """One clipped AdamW step in place (``step`` counts from 1); returns
    the clipped gradients' norms by leaf."""
    b1, b2, eps = train["beta1"], train["beta2"], train["eps"]
    lr, wd = train["lr"], train["weight_decay"]
    total = torch.sqrt(sum(g.double().square().sum()
                           for g in grads.values())).float()
    scale = torch.clamp(train["max_grad_norm"] / torch.clamp(total, min=1e-9),
                        max=1.0)
    c1 = float(1 - np.float32(b1) ** np.float32(step))
    c2 = float(1 - np.float32(b2) ** np.float32(step))
    norms = {}
    for name, p in params.items():
        g = grads[name].mul_(scale)
        norms[name] = float(torch.linalg.vector_norm(g))
        for pc, gc, mc, vc in zip(*(t.view(-1).split(_CHUNK)
                                    for t in (p, g, m[name], v[name]))):
            mc.mul_(b1).add_(gc, alpha=1 - b1)
            vc.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            upd = (mc / c1) / ((vc / c2).sqrt_().add_(eps))
            pc.sub_(upd.add_(pc, alpha=wd), alpha=lr)
    return norms


def train_three(model: dict, train: dict, seed: int, batches: list,
                device, precision: str = "float32") -> dict:
    """The reference's first steps from the run's initial weights over
    ``batches`` (packed by ``etl_apply``, as numpy): each step's loss, the
    first step's clipped gradient norm by leaf, and each leaf's change
    after the last step (its norm)."""
    prec = Precision(precision, device)
    params = init_params(model, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    with prec.scope():
        for step, b in enumerate(batches, 1):
            tb = {k: torch.as_tensor(a, device=device) for k, a in b.items()}
            loss = dlrm_loss(params, tb, model, prec)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            norms = adamw_step({k: p.data for k, p in params.items()},
                               dict(zip(params, grads)), m, v, step, train)
            del grads, tb, loss
            if first is None:
                first = norms
    del m, v
    change = change_norms(params, model, seed)
    return {"losses": losses, "grad_norms": first, "change_norms": change}


@torch.no_grad()
def change_norms(params: dict, model: dict, seed: int) -> dict:
    """Each leaf's ``||p - p0||``, ``p0`` made again from the seed one
    leaf at a time."""
    out = {}
    for i, (name, _, fan_in) in enumerate(leaf_shapes(model)):
        p = params[name].detach()
        p0 = torch.empty_like(p)
        init_leaf(p0, seed, i, fan_in)
        out[name] = float(torch.linalg.vector_norm(torch.sub(p, p0, out=p0)))
        del p0
    return out
