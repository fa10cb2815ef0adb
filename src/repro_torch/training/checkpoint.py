"""Atomic, async checkpointing in the JAX package's layout.

Layout (one directory per step)::

    <dir>/step_00000100/manifest.json   structure + leaf index
    <dir>/step_00000100/leaf_00042.npy  one array per leaf
    <dir>/step_00000100/COMMITTED       written last (publish marker)

- Atomicity: leaves, manifest and the COMMITTED marker are written into a
  temp dir, which is then renamed; restore ignores uncommitted directories,
  so a crash mid-save never corrupts the restore path.
- Async: ``AsyncCheckpointer.save_async`` copies every tensor to the host on
  the caller's thread (for a CUDA tensor that waits for the caller's
  stream), then writes in a background thread while training goes on.
- Leaves follow the JAX package's flatten order: dict keys sorted, lists
  and tuples in order, ``None`` holds no leaf.  A train state whose model
  is a ``DLRM`` or an LM of any family is flattened as the JAX
  package's ``TrainState(params, opt, step)``
  (``models/dlrm.state_to_jax_leaves``: ``w`` as ``[in, out]``;
  ``models/transformer.state_to_jax_leaves``, for every LM: each layer
  group's leaf the layers stacked ``[L, ...]``, on the host), so a
  checkpoint written by either package restores in the other.
- Sharded states (``training/train_loop.shard_train_step``): a save gathers
  each leaf's whole array over both axes, the DTensor's data shards and
  then the model shards (``state_model_dims``; collectives, so every rank
  saves, on the trainer's thread; the writer thread issues none), and
  rank 0 alone writes and commits.  A restore reads the whole arrays on
  every rank and keeps each rank's slice of each model-sharded leaf and
  its shard of each DTensor leaf, whatever ``(data, model)`` mesh wrote
  the files (elastic: 1 -> N ranks, N -> 1, one mesh shape to another,
  either package).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import dlrm, encdec, hybrid, ssm, transformer

_COMMIT = "COMMITTED"


_STATE_LAYOUTS = {dlrm.DLRM: dlrm, transformer.Transformer: transformer,
                  ssm.SSM: transformer, hybrid.Hybrid: transformer,
                  encdec.EncDec: transformer}


def _is_train_state(tree) -> bool:
    return hasattr(tree, "model") and hasattr(tree, "opt") and \
        hasattr(tree, "step")


def _flatten(tree) -> tuple:
    """``(leaves, rebuild, description)``: ``rebuild(arrays)`` returns the
    structure of ``tree`` holding ``arrays`` (a train state is filled in
    place; a tensor leaf comes back as a tensor on that leaf's device, any
    other leaf as a numpy array)."""
    if _is_train_state(tree):
        kind = type(tree.model).__name__
        # FSDP's wrapped module is a subclass of the model's class
        mod = next((_STATE_LAYOUTS[c] for c in type(tree.model).__mro__
                    if c in _STATE_LAYOUTS), None)
        if mod is None:
            raise NotImplementedError(
                f"checkpointing a {kind} train state is not ported yet "
                "(DLRM and the LMs are)")

        def rebuild_state(arrays):
            return mod.load_jax_leaves(tree, arrays)
        leaves = [leaf if d is None else _ModelShard(leaf, d, ax)
                  for leaf, (d, ax) in zip(mod.state_to_jax_leaves(tree),
                                           mod.state_model_dims(tree))]
        return leaves, rebuild_state, f"TrainState({kind})"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        desc = "{" + ", ".join(f"{k!r}: {p[2]}"
                               for k, p in zip(keys, parts)) + "}"
        return _join(parts, lambda vals: dict(zip(keys, vals)), desc)
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        kind = type(tree)
        desc = ("[" if kind is list else "(") + ", ".join(
            p[2] for p in parts) + ("]" if kind is list else ")")
        return _join(parts, lambda vals: kind(vals), desc)
    if tree is None:
        return [], lambda arrays: None, "None"
    if isinstance(tree, torch.Tensor):
        dev = tree.device
        return [tree], lambda arrays: torch.as_tensor(arrays[0]).to(dev), "*"
    return [tree], lambda arrays: arrays[0], "*"


def _join(parts: list, make: Callable, desc: str) -> tuple:
    leaves = [leaf for p in parts for leaf in p[0]]
    counts = [len(p[0]) for p in parts]

    def rebuild(arrays):
        vals, i = [], 0
        for (_, rb, _), n in zip(parts, counts):
            vals.append(rb(arrays[i:i + n]))
            i += n
        return make(vals)
    return leaves, rebuild, desc


# numpy has no bfloat16: a bfloat16 leaf is written as the JAX package
# writes one (2-byte void records holding the bits; "bfloat16" in the
# manifest) and read back from its bits
_BF16_HOST = np.dtype("V2")


def _writer() -> bool:
    """Whether this process writes checkpoints (rank 0 of a world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class _ModelShard:
    """A train state's leaf sharded over the model axis: its tensor (or
    per-layer list), the dim of each tensor the shard cuts, and the
    axis."""

    def __init__(self, leaf, dim: int, ax):
        self.leaf, self.dim, self.ax = leaf, dim, ax

    @property
    def shape(self) -> tuple:
        """The whole leaf's shape (a list leaf's stacked)."""
        first = self.leaf[0] if isinstance(self.leaf, list) else self.leaf
        shape = list(first.shape)
        shape[self.dim] *= self.ax.size
        if isinstance(self.leaf, list):
            shape.insert(0, len(self.leaf))
        return tuple(shape)

    def part(self, whole):
        """This rank's slice of a whole (stacked) array of the leaf."""
        d = self.dim + isinstance(self.leaf, list)
        n = whole.shape[d] // self.ax.size
        index = [slice(None)] * whole.ndim
        index[d] = slice(self.ax.rank * n, (self.ax.rank + 1) * n)
        return whole[tuple(index)]


def _whole(leaf):
    """A DTensor leaf gathered into its whole tensor, then a model shard
    (a ``_ModelShard``, or a parameter ``tensor_parallel.shard_model``
    tagged) over the model axis (collectives); a list leaf element by
    element; any other leaf as is."""
    if isinstance(leaf, _ModelShard):
        one = lambda t: tp.whole(_whole(t), leaf.dim, leaf.ax)
        return [one(t) for t in leaf.leaf] if isinstance(leaf.leaf, list) \
            else one(leaf.leaf)
    if isinstance(leaf, list):
        return [_whole(t) for t in leaf]
    dim, ax = tp.shard_of(leaf)
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.detach().full_tensor()
    return tp.whole(leaf, dim, ax)


def _snapshot(leaves: list, copy: bool) -> list:
    """The host arrays of ``leaves`` on the writer; every rank takes part in
    the gathers, the others keep nothing."""
    out = []
    for x in leaves:
        x = _whole(x)
        out.append(_to_host(x, copy=copy) if _writer() else None)
    return out


def _to_host(leaf, copy: bool) -> np.ndarray:
    if isinstance(leaf, list):  # per-layer tensors: stacked on the host
        return np.stack([_to_host(t, copy=False) for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        a = (t.to("cpu", copy=True) if copy else t.cpu()).numpy()
        return a.view(_BF16_HOST) if bf16 else a
    return np.array(leaf) if copy else np.asarray(leaf)


def _from_host(a: np.ndarray, dtype: str):
    """A loaded leaf: a bfloat16 one as a tensor, any other as is."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return a


def _write(arrays: list, desc: str, ckpt_dir: str, step: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        index = []
        for i, arr in enumerate(arrays):
            name = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, name), arr.copy(order="C")
                    if not arr.flags.c_contiguous else arr)
            index.append({"file": name, "shape": list(arr.shape),
                          "dtype": "bfloat16" if arr.dtype == _BF16_HOST
                          else str(arr.dtype)})
        manifest = {"step": step, "n_leaves": len(arrays),
                    "treedef": desc, "index": index}
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        with open(os.path.join(tmp, _COMMIT), "w") as fh:
            fh.write("ok")
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save(tree: Any, ckpt_dir: str, step: int) -> str:
    """Blocking save (every rank calls it; rank 0 writes).  Returns the
    committed directory path."""
    leaves, _, desc = _flatten(tree)
    arrays = _snapshot(leaves, copy=False)
    if _writer():
        _write(arrays, desc, ckpt_dir, step)
    return os.path.join(ckpt_dir, f"step_{step:08d}")


class AsyncCheckpointer:
    """Snapshot to host, then write in a daemon thread; at most one in
    flight."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, tree, ckpt_dir: str, step: int):
        self.wait()
        leaves, _, desc = _flatten(tree)
        arrays = _snapshot(leaves, copy=True)
        if not _writer():
            return

        def work():
            try:
                _write(arrays, desc, ckpt_dir, step)
            except BaseException as e:  # surfaced by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, name="ckpt-write",
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, d, _COMMIT)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            mesh=None) -> Any:
    """Restore into the structure of ``template`` (the newest committed step
    unless ``step`` is given).  A train state template is filled in place
    and returned, each DTensor leaf with this rank's shard; elsewhere a
    tensor leaf comes back as a tensor on the template leaf's device and
    any other leaf as a numpy array.  ``mesh``: the ranks restoring
    together; they wait for each other before picking the newest step."""
    if mesh is not None:
        dist.barrier()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"checkpoint {d} not committed")
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    leaves_t, rebuild, _ = _flatten(template)
    if len(leaves_t) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; template has "
            f"{len(leaves_t)} — structure mismatch")
    arrays = [_from_host(np.load(os.path.join(d, e["file"])), e["dtype"])
              for e in manifest["index"]]
    for i, (a, t) in enumerate(zip(arrays, leaves_t)):
        shape = ((len(t),) + tuple(t[0].shape) if isinstance(t, list)
                 else tuple(t.shape) if hasattr(t, "shape") else np.shape(t))
        if tuple(a.shape) != shape:
            raise ValueError(f"leaf shape {a.shape} != template {shape}")
        if isinstance(t, _ModelShard):  # this rank's slice
            arrays[i] = t.part(a)
    return rebuild(arrays)


def prune(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` *committed* checkpoints (on the
    writer, rank 0).

    Only committed directories count toward ``keep``: a ``step_*`` dir
    without the COMMITTED marker is crash garbage (the marker is written
    inside the temp dir before the rename, so an in-flight save is never
    visible as an uncommitted ``step_*``) and is deleted outright — it must
    not displace a committed checkpoint from the keep window.
    """
    if not os.path.isdir(ckpt_dir) or not _writer():
        return
    committed, garbage = [], []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        if os.path.exists(os.path.join(ckpt_dir, d, _COMMIT)):
            committed.append(int(d.split("_")[1]))
        else:
            garbage.append(d)
    for d in garbage:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    committed.sort()
    for s in committed[:-keep] if keep else committed:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
