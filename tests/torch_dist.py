"""Spawning a world of ``torch.distributed`` ranks for the tests, and the
rank-side halves of ``tests/test_torch_distributed.py``.

A world is at most 4 gloo processes on the CPU, joined through a file store
under the test's temporary directory (never a fixed port: the suite runs
with several workers side by side), each started with the ``torchrun``
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  ``spawn`` waits
``timeout`` seconds at most for all of them, so a hang fails the test.
Imports no JAX: the ranks import this module.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _main(rank, world, store, backend, fn, args, q):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        q.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 120.0,
          grace: float = 10.0, backend: str = "gloo") -> list:
    """``fn(rank, world, *args)`` in ``world`` fresh processes (gloo; or
    NCCL, a card a rank); returns their results by rank.  Raises ``RuntimeError`` with the failed ranks'
    tracebacks when one fails (the others get ``grace`` seconds to finish,
    as ``torchrun`` would end them), or when they have not all finished
    within ``timeout`` seconds.  Every process is gone on return."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{backend}")
    if os.path.exists(store):
        os.remove(store)
    procs = [ctx.Process(target=_main,
                         args=(r, world, store, backend, fn, args, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, status, out = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and q.empty():
                    break  # a rank died without reporting
                continue
            if status == "ok":
                got[rank] = out
            else:
                errors[rank] = out
                deadline = min(deadline, time.monotonic() + grace)
    finally:
        for p in procs:
            p.join(timeout=1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError(f"{fn.__name__} failed:" + "".join(
            f"\n--- rank {r} ---\n{e}" for r, e in sorted(errors.items())))
    if len(got) < world:
        raise RuntimeError(f"{fn.__name__}: {world - len(got)} rank(s) "
                           f"did not finish (exit codes "
                           f"{[p.exitcode for p in procs]}; {timeout} s)")
    return [got[r] for r in range(world)]


def save(obj, path) -> None:
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def load(path):
    with open(path, "rb") as fh:  # written by this suite's own processes
        return pickle.load(fh)


# ---------------------------------------------------------------------------
# shared builders (the reference side builds the same in its subprocess)
# ---------------------------------------------------------------------------

def lm_batch(vocab: int, rows: int, seq: int, seed: int,
             uneven: bool = False) -> dict:
    """Seeded tokens / labels; ``uneven`` sets -100 on a different number
    of each row's labels (row i: i * 3 of them), so the data shards count
    different numbers of labels."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    if uneven:
        for i in range(rows):
            labels[i, :min(3 * i, seq)] = -100
    return {"tokens": tokens, "labels": labels}


def lm_cfg(arch: str, capacity_factor=None):
    """The port's reduced config of ``arch`` at float32 compute (the MoE
    capacity factor replaced when given)."""
    from repro_torch.configs import registry as treg
    cfg = dataclasses.replace(treg.get_reduced(arch), compute_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def whole_leaves(model) -> list:
    """The model's JAX leaves as whole numpy arrays, a 16-bit one widened
    to float32 (DTensors gathered: a collective, so every rank calls
    it)."""
    from repro_torch.models.transformer import jax_leaves
    from repro_torch.training.checkpoint import _whole
    out = []
    for _, leaf in jax_leaves(model.jax_tree()):
        leaf = _whole(leaf)
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        out.append(t.detach().to(torch.promote_types(t.dtype, torch.float32))
                   .cpu().numpy())
    return out


def microbatch_sums(module, loss_fn, batch: dict, group, n_micro: int,
                    idx: list) -> tuple:
    """Each microbatch's gradient of ``module``'s parameters ``idx`` on
    this rank, in float32 (the 16-bit ones read widened), as the sharded
    train step computes its part (``batch`` this rank's rows, the loss
    divided by each microbatch's global label count): ``(parts, sums)``,
    a list a microbatch of this rank's parts and of their sums over the
    data ``group``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.training.grad import split_microbatches

    dp = dist.get_world_size(group)
    params = list(module.parameters())
    micro = split_microbatches(batch, n_micro)
    counts = (batch["labels"].reshape(n_micro, -1) != -100).to(
        torch.float32).sum(1)
    dist.all_reduce(counts, group=group)
    narrow = {i: params[i].data for i in idx}
    parts, sums = [], []
    try:
        for i in idx:
            params[i].data = params[i].data.to(torch.float32)
        for k in range(n_micro):
            with shd.row_shards(dp), L.label_count(counts[k]):
                loss = loss_fn(module, {n: v[k] for n, v in micro.items()})
                g = torch.autograd.grad(loss, [params[i] for i in idx])
            parts.append([t.clone() for t in g])
            for t in g:
                dist.all_reduce(t, group=group)
            sums.append(list(g))
    finally:
        for i, data in narrow.items():
            params[i].data = data
    return parts, sums


def per_microbatch_formula(sums: list, dtypes: list, accum) -> list:
    """The reference's microbatched gradient (``training/grad.py``) from
    each microbatch's data-parallel sum: rounded to the parameter's dtype,
    added into zeros of ``accum``, then scaled by 1/n."""
    out = []
    for j, dt in enumerate(dtypes):
        a = torch.zeros_like(sums[0][j], dtype=accum)
        for s in sums:
            a = a + s[j].to(dt).to(accum)
        out.append(a * (1.0 / len(sums)))
    return out


def rounding_check(kind: str, state, step, batch: dict, case: dict,
                   mesh, loss_fn) -> tuple:
    """One step of ``step`` on ``batch`` (16-bit parameters, microbatch >
    1), its gradients taken where the optimizer receives them, against
    the reference's per-microbatch formula (``per_microbatch_formula``)
    over each rank's float32 parts: ``kind`` ``"replicated"`` (the data
    axes replicate the parameters: ``microbatch_sums`` on the step's own
    model; each leaf bit-equal, and the rule before it, the parts summed
    over microbatches and ranks and rounded once, not) or ``"fsdp"`` (the
    parts on an unsharded copy of the parameters; each FSDP-sharded leaf's
    relative error in norm).  Returns ``(state, metrics, report)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.training import train_loop as ttl

    tc = TrainConfig(**case["tcfg"])
    group, _ = ttl.data_group(mesh)
    accum = getattr(torch, tc.accum_dtype)
    if kind == "replicated":
        module = state.model
        params = list(module.parameters())
        idx = [i for i, p in enumerate(params)
               if not hasattr(p, "placements") and p.element_size() < 4]
    else:
        module = tp_model(case)[0]
        params = list(module.parameters())
        idx = [i for i, p in enumerate(params) if p.element_size() < 4]
    parts, sums = microbatch_sums(module, loss_fn, batch, group,
                                  tc.microbatch, idx)
    want = per_microbatch_formula(sums, [params[i].dtype for i in idx],
                                  accum)
    seen = {}
    real = ttl.opt_update

    def spy(ps, grads, *a):
        seen["grads"] = [g.detach().clone() for g in grads]
        return real(ps, grads, *a)
    ttl.opt_update = spy
    try:
        state, m = step(state, batch)
    finally:
        ttl.opt_update = real
    got = seen["grads"]
    if kind == "replicated":
        old = []
        for j, i in enumerate(idx):  # the parts summed, then rounded once
            a = torch.zeros_like(parts[0][j])
            for p in parts:
                a = a + p[j]
            a = a * (1.0 / len(parts))
            dist.all_reduce(a, group=group)
            old.append(a.to(params[i].dtype))
        report = {
            "leaves": len(idx),
            "bit_equal": all(same_bits(got[i], w)
                             for i, w in zip(idx, want)),
            "old_rule_differs": any(not torch.equal(o.to(w.dtype), w)
                                    for o, w in zip(old, want))}
    else:
        names = [n for n, _ in module.named_parameters()]
        sharded = {n: g for n, g in zip(
            [n for n, _ in state.model.named_parameters()], got)
            if hasattr(g, "full_tensor")}
        errs = {}
        for j, i in enumerate(idx):
            if names[i] in sharded:
                g = sharded[names[i]].full_tensor().to(torch.float64)
                w = want[j].to(torch.float64)
                errs[names[i]] = float((g - w).norm() / w.norm())
        report = {"leaves": len(errs), "rel_err": errs}
    return state, m, report


def same_bits(a, b) -> bool:
    """Whether two float tensors hold the same dtype and bits (-0.0 is not
    +0.0)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def train_cases(rank, world, inputs_path):
    """Each case of ``inputs_path`` (``{name: {arch, tcfg, params,
    batches, capacity_factor, over, pod, mesh, rounding}}``; ``over``:
    config fields replaced) on a ``(world, 1)`` mesh, with ``pod`` a ``(2,
    world / 2, 1)`` one, or a ``(data, model)`` ``mesh``: 3 data-parallel
    steps; returns ``{name: (losses, grad norms, whole leaves, {FSDP
    unit: its dtype's name}, [{JAX path: elements each rank holds}],
    [each rank's rounding_check report of its first step, with
    ``rounding``])}``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.etl_runtime.transfer import batch_sharding, put_packed
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.training import train_loop as ttl

    from torch.distributed.device_mesh import init_device_mesh

    host = make_host_mesh(device="cpu")
    out = {}
    for name, case in load(inputs_path).items():
        mesh = host
        if case.get("pod"):  # ("pod", "data", "model") of (2, world / 2, 1)
            mesh = init_device_mesh("cpu", (2, world // 2, 1),
                                    mesh_dim_names=("pod", "data", "model"))
        if case.get("mesh"):
            mesh = init_device_mesh("cpu", tuple(case["mesh"]),
                                    mesh_dim_names=("data", "model"))
        shd.set_active_mesh(mesh)
        cf = case.get("capacity_factor")
        over = dict(case.get("over", {}))
        if cf is not None:
            over["moe"] = {"capacity_factor": cf}
        cfg = tp_cfg(case["arch"], over)
        model = api.build_model(cfg)
        module = api.params_from_jax(model.init(device="cpu"),
                                     case["params"])
        tc = TrainConfig(**case["tcfg"])
        state = ttl.TrainState.create(module, tc)
        rows = case["batches"][0]["tokens"].shape[0]
        step, state = ttl.shard_train_step(
            model.loss, tc, mesh, state, batch_rows=rows, fsdp=tc.fsdp,
            n_experts=cfg.moe.n_experts if cfg.moe else 0)
        dp = shd.data_degree(mesh)
        sharding = batch_sharding(mesh) if rows % dp == 0 else None
        losses, norms, report = [], [], None
        for i, b in enumerate(case["batches"]):
            b = put_packed({k: torch.from_numpy(v) for k, v in b.items()},
                           sharding, microbatches=max(tc.microbatch, 1))
            if i == 0 and case.get("rounding"):
                state, m, report = rounding_check(
                    case["rounding"], state, step, b, case, mesh, model.loss)
            else:
                state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        units = {k: str(v) for k, v in ttl.unit_dtypes(state.model).items()}
        held = [None] * world
        dist.all_gather_object(held, {
            path: sum((t.to_local() if hasattr(t, "to_local") else t
                       ).numel() for t in ts)
            for path, ts, _ in jax_order(state.model)})
        reports = [None] * world
        dist.all_gather_object(reports, report)
        out[name] = (losses, norms, whole_leaves(state.model), units, held,
                     reports)
    return out if rank == 0 else None


def local_leaves(state) -> list:
    """``(local array, shard dim or None)`` of each checkpoint leaf of a
    train state (a stacked leaf's shard dim in its ``[L, ...]`` shape)."""
    from repro_torch.models.transformer import state_to_jax_leaves
    out = []
    for leaf in state_to_jax_leaves(state):
        first = leaf[0] if isinstance(leaf, list) else leaf
        dim = None
        if hasattr(first, "placements") and first.placements[0].is_shard():
            dim = first.placements[0].dim + isinstance(leaf, list)
        loc = [t.to_local() if hasattr(t, "to_local") else t
               for t in (leaf if isinstance(leaf, list) else [leaf])]
        a = torch.stack(loc) if isinstance(leaf, list) else loc[0]
        out.append((a.detach().cpu().numpy(), dim))
    return out


def misc(rank, world, paths: dict):
    """On a ``(world, 1)`` mesh: the int8 mean over 5 error-feedback steps,
    ``EtlJob(mesh=)``'s rows (and its error on rows the world does not
    divide), elastic restores (a one-process port checkpoint, a reference
    one, then a save from this world) and ``make_production_mesh``'s
    error."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import api
    from repro_torch.session import EtlJob
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.grad import compressed_psum_mean, ef_init

    mesh = make_host_mesh(device="cpu")
    out = {}
    # int8 mean with error feedback: grads[step][name] is [world, ...]
    grads = load(paths["int8"])
    ef = ef_init({k: torch.from_numpy(v[rank]) for k, v in grads[0].items()})
    out["int8"] = []
    for g in grads:
        mine = {k: torch.from_numpy(v[rank]).to(
            torch.bfloat16 if k.startswith("bf16") else torch.float32)
            for k, v in g.items()}
        mean, ef = compressed_psum_mean(mine, ef, mesh.get_group("data"))
        out["int8"].append(
            ({k: v.float().numpy() for k, v in mean.items()},
             {k: v.numpy() for k, v in ef.items()}))
    # the ETL's rows
    etl = paths["etl"]
    rows = []
    for batch in (etl["batch"], etl["bad_batch"]):
        job = EtlJob(lm_token_pipeline(etl["seq"], etl["vocab"],
                                       batch_size=batch),
                     Source.lm_events(etl["seq"], rows=batch * 3,
                                      batch_size=batch),
                     backend="torch", device="cpu", mesh=mesh)
        try:
            with job.batches() as batches:
                rows.append([{k: v.numpy() for k, v in b.items()}
                             for b in batches])
        except RuntimeError as e:  # the place stage's error, re-raised
            rows.append(repr(e.__cause__))
    out["etl"] = rows
    # elastic restores into an FSDP-sharded state
    cfg = lm_cfg("llama3_2_3b")
    model = api.build_model(cfg)
    tc = TrainConfig(fsdp=True)

    def sharded():
        state = ttl.TrainState.create(model.init(seed=5, device="cpu"), tc)
        return ttl.shard_train_step(model.loss, tc, mesh, state,
                                    batch_rows=world, fsdp=True)[1]
    state = ckpt.restore(paths["port_ckpt"], sharded(), mesh=mesh)
    out["port_1_to_n"] = (state.step, local_leaves(state))
    ckpt.save(state, paths["saved_ckpt"], state.step)
    state = ckpt.restore(paths["ref_ckpt"], sharded(), mesh=mesh)
    out["ref_1_to_n"] = (state.step, local_leaves(state))
    try:
        make_production_mesh(device="cpu")
        out["production"] = "built"
    except ValueError as e:
        out["production"] = str(e)
    return out


def launcher(rank, world, argv, fail_at=None):
    """``launch.train.main(argv)`` on this rank with its step tapped: the
    losses it reports, a step at a time; with ``fail_at`` the last rank
    raises before that step."""
    from repro_torch.launch import train as launch
    real = launch.shard_train_step
    losses = []

    def tapped(*a, **kw):
        step, state = real(*a, **kw)

        def run(state, batch):
            if fail_at is not None and rank == world - 1 \
                    and state.step + 1 == fail_at:
                raise RuntimeError(f"rank {rank} fails at step {fail_at}")
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run, state

    launch.shard_train_step = tapped
    summary = launch.main(argv)
    return losses, summary["state"].step


def card_rank(rank, world, device: str):
    """On one rank of ``device``: ``compressed_psum_mean`` of seeded
    gradients, ``put_packed`` of a seeded batch (2 microbatches) and two
    FSDP steps of reduced llama3_2_3b at float32 from the same parameters
    (made on the CPU); returns them on the host."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.etl_runtime.transfer import batch_sharding, put_packed
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.grad import compressed_psum_mean, ef_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh = make_host_mesh(device=device)
    shd.set_active_mesh(mesh)
    rng = np.random.default_rng(5)
    grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
             for s in ((300, 7), (1000,))]
    mean, ef = compressed_psum_mean(grads, ef_init(grads))
    cfg = lm_cfg("llama3_2_3b")
    b = lm_batch(cfg.vocab_size, 8, 16, 3)
    placed = put_packed({k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                        batch_sharding(mesh), microbatches=2)
    model = api.build_model(cfg)
    tc = TrainConfig(fsdp=True, microbatch=2, lr=3e-3)
    state = ttl.TrainState.create(model.init(seed=0, device="cpu").to(dev),
                                  tc)
    step, state = ttl.shard_train_step(model.loss, tc, mesh, state,
                                       batch_rows=8, fsdp=True)
    losses = []
    for i in range(2):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 lm_batch(cfg.vocab_size, 8, 16, 10 + i).items()}
        state, m = step(state, put_packed(batch, batch_sharding(mesh), 2))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return {"mean": [t.cpu().numpy() for t in mean],
            "ef": [t.cpu().numpy() for t in ef],
            "placed": {k: v.cpu().numpy() for k, v in placed.items()},
            "losses": losses, "leaves": whole_leaves(state.model)}


def cache_rows_rank(rank, world, device: str) -> list:
    """``EmbedCache.advance`` on stacked tables FSDP-style sharded over the
    ``world`` ranks (a DTensor ``Shard(d)`` of a 1-D mesh on ``device``,
    for d = 2, 0, 1), each rank with plans of its own rows, against the
    same plans applied from the whole tables: ``[(d, ext bit-equal on
    every plan, TRAFFIC["embed_cache_gather"])]``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.etl_runtime.lookahead import (EmbedCache,
                                                   EmbedCacheConfig,
                                                   LookaheadPlanner)
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = init_device_mesh(device, (world,))
    out = []
    for d, shape in ((2, (26, 4096, 128)), (0, (26, 4096, 16)),
                     (1, (3, 4096, 16))):
        whole = torch.from_numpy(np.random.default_rng(0).normal(
            size=shape).astype(np.float32)).to(device)
        shard = distribute_tensor(whole, mesh, [Shard(d)])
        cc = EmbedCacheConfig(rows=64, window=2, stage_max=32, refresh=True)
        rng = np.random.default_rng(10 + rank)
        planner = LookaheadPlanner(cc, shape[0])
        caches = [EmbedCache(cc, shape[0], shape[2], device=device)
                  for _ in range(2)]
        tp.reset_traffic()
        ok = True
        for _ in range(4):
            planner.push(rng.zipf(1.2, (256 + 64 * rank, shape[0]))
                         % shape[1])
            if planner.window_depth() < cc.window:
                continue
            plan = planner.pop_plan()[1].as_payload()
            caches[0].advance(whole, dict(plan))
            caches[1].advance(shard, dict(plan))
            ok &= torch.equal(caches[0].ext, caches[1].ext)
        out.append((d, bool(ok), list(tp.TRAFFIC["embed_cache_gather"])))
    return out


# ---------------------------------------------------------------------------
# the "model" axis (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

DLRM_SMALL = dict(vocab_size=1000, d_emb=16, bot_mlp=(32, 16),
                  top_mlp=(32, 16, 1))


def dlrm_batch(rows: int, seed: int) -> dict:
    """A seeded DLRM batch: dense (rows, 16), sparse (rows, 32) ids in
    ``[0, DLRM_SMALL vocab)``, 0 / 1 labels."""
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(rows, 16)).astype(np.float32),
            "sparse": rng.integers(0, DLRM_SMALL["vocab_size"],
                                   (rows, 32)).astype(np.int32),
            "label": rng.integers(0, 2, (rows,)).astype(np.float32)}


def tp_cfg(arch: str, over: dict):
    """``lm_cfg(arch)`` with the fields of ``over`` replaced (``"moe"`` /
    ``"ssm"``: a dict of the MoE / SSM config's fields)."""
    cfg = lm_cfg(arch)
    over = dict(over)
    for sub in ("moe", "ssm"):
        if sub in over:
            over[sub] = dataclasses.replace(getattr(cfg, sub), **over[sub])
    return dataclasses.replace(cfg, **over)


def tp_model(case: dict):
    """``(module, loss_fn, n_experts)`` of a case (``arch`` an LM's or
    ``"dlrm"``; ``over``: config fields replaced), its parameters the
    reference's ``params``."""
    from repro_torch.models import api, dlrm
    if case["arch"] == "dlrm":
        model = dlrm.DLRM(dlrm.DLRMConfig(**case.get("dlrm", DLRM_SMALL)),
                          device="cpu")
        model.load_state_dict(dlrm.params_from_jax(case["params"]))
        return model, dlrm.loss_fn, 0
    cfg = tp_cfg(case["arch"], case.get("over", {}))
    model = api.build_model(cfg)
    module = api.params_from_jax(model.init(device="cpu"), case["params"])
    return module, model.loss, cfg.moe.n_experts if cfg.moe else 0


def jax_order(model) -> list:
    """``(JAX path, tensors, transposed)`` of each JAX leaf of an LM or a
    DLRM, in the JAX flatten order (a stacked leaf's tensors per layer)."""
    from repro_torch.models import dlrm
    from repro_torch.models.transformer import jax_leaves
    if isinstance(model, dlrm.DLRM):
        params = dict(model.named_parameters())
        return [(path, [params[name]], tr)
                for path, _, name, tr in dlrm.jax_named_leaves(model)]
    return [(path, leaf if isinstance(leaf, list) else [leaf], False)
            for path, leaf in jax_leaves(model.jax_tree())]


def stacked(model, path: str) -> bool:
    """Whether the JAX leaf at ``path`` stacks a layer group's layers."""
    return path.split("/")[0] in getattr(model, "LAYER_GROUPS", ())


def tp_whole_leaves(model) -> list:
    """The JAX leaves as whole numpy arrays, gathered over both axes (a
    collective: every rank calls it)."""
    from repro_torch.training.checkpoint import _whole
    out = []
    for path, ts, tr in jax_order(model):
        ws = [_whole(t).detach() for t in ts]
        a = torch.stack(ws) if stacked(model, path) else ws[0]
        out.append((a.t() if tr else a).cpu().numpy())
    return out


def tp_local_shapes(model) -> dict:
    """``{JAX path: this rank's local shape}`` (a stacked leaf's layers
    first, a DLRM ``w`` in the JAX ``[in, out]`` layout)."""
    out = {}
    for path, ts, tr in jax_order(model):
        loc = ts[0].to_local() if hasattr(ts[0], "to_local") else ts[0]
        shape = tuple(loc.shape)[::-1] if tr else tuple(loc.shape)
        if stacked(model, path):
            shape = (len(ts),) + shape
        out[path] = shape
    return out


def lookahead_plans(batches: list, cache_cfg, n_tables: int) -> tuple:
    """The lookahead plans (``PLAN_KEYS`` payloads) of ``batches`` in
    delivery order, from ``LookaheadPlanner`` over each batch's first
    ``n_tables`` sparse columns (numpy), as the executor's lookahead stage
    makes them; and the planner, drained."""
    from repro_torch.etl_runtime.lookahead import LookaheadPlanner
    planner = LookaheadPlanner(cache_cfg, n_tables)
    plans = []
    for b in batches:
        planner.push(np.asarray(b["sparse"])[:, :n_tables].astype(np.int64))
        if planner.window_depth() >= cache_cfg.window:
            plans.append(planner.pop_plan()[1].as_payload())
    while planner.window_depth():
        plans.append(planner.pop_plan()[1].as_payload())
    return plans, planner


def foreign_rows_zero(cache, planner, last_plan: dict, tables) -> tuple:
    """``(zero, foreign)``: whether every slot of ``cache.ext`` that holds
    a row outside this rank's rows of ``tables`` (the resident slots by the
    planner's map, the staging slots by ``last_plan``; a ``-1`` stage row is
    row 0) is zero, and how many such slots there are."""
    from repro_torch.distributed import tensor_parallel as tp
    d, ax = tp.shard_of(tables)
    vocab = tables.shape[1]
    first = ax.rank * vocab if d == 1 else 0
    rows = cache.cfg.rows
    zero, foreign = True, 0
    for t in range(cache.n_tables):
        held = np.concatenate([planner._row_of[t],
                               np.maximum(last_plan["emb_stage_rows"][t], 0)])
        for s, g in enumerate(held):
            if s < rows and g < 0:
                continue  # a free resident slot
            if not first <= g < first + vocab:
                foreign += 1
                zero &= bool((cache.ext[t, s] == 0).all())
    return zero, foreign


def tp_cases(rank, world, inputs_path, ckpt_dir):
    """Each case of ``inputs_path`` (``{name: {arch, over, tcfg, params,
    batches, mesh}}``; ``embed_cache``: an ``EmbedCacheConfig``'s fields,
    DLRM's lookahead path; ``dlrm``: a DLRM's config fields) on its
    ``(data, model)`` mesh: 3 steps; returns ``{name: (losses, grad norms,
    whole leaves, local shapes, extra)}`` (the leaves on rank 0 only).
    ``extra["traffic"]`` is ``tensor_parallel.TRAFFIC`` over each step.
    The lookahead path plans on this rank's rows, as the executor's stage
    after place does, and threads an ``EmbedCache`` against the current
    tables (a DTensor under FSDP: ``DTensor.full_tensor`` raises while the
    cache advances); ``extra`` holds a digest of the plans, the cache's
    counters, ``foreign_rows_zero`` and the table's whole bytes.  The case
    named in the inputs' key ``"ckpt"`` saves its state after the last step
    into ``ckpt_dir``."""
    import hashlib
    from unittest import mock

    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.etl_runtime.lookahead import EmbedCache, EmbedCacheConfig
    from repro_torch.etl_runtime.transfer import batch_sharding, put_packed
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as ttl

    from torch.distributed.device_mesh import init_device_mesh

    inputs = load(inputs_path)
    out = {}
    for name, case in inputs["cases"].items():
        mesh = init_device_mesh("cpu", case["mesh"],
                                mesh_dim_names=("data", "model"))
        module, loss_fn, n_exp = tp_model(case)
        tc = TrainConfig(**case["tcfg"])
        state = ttl.TrainState.create(module, tc)
        rows = next(iter(case["batches"][0].values())).shape[0]
        step, state = ttl.shard_train_step(
            loss_fn, tc, mesh, state, batch_rows=rows, fsdp=tc.fsdp,
            n_experts=n_exp)
        batches = [put_packed({k: torch.from_numpy(v) for k, v in b.items()},
                              batch_sharding(mesh),
                              microbatches=max(tc.microbatch, 1))
                   for b in case["batches"]]
        extra = {}
        if case.get("embed_cache"):
            cc = EmbedCacheConfig(**case["embed_cache"])
            n = module.cfg.n_sparse
            plans, planner = lookahead_plans(batches, cc, n)
            cache = EmbedCache(cc, n, module.cfg.d_emb, device="cpu")
            batches = [dict(b, **p) for b, p in zip(batches, plans)]
            extra["plan_digest"] = hashlib.sha256(b"".join(
                np.ascontiguousarray(p[k]).tobytes()
                for p in plans for k in sorted(p))).hexdigest()
            extra["cache_stats"] = planner.stats.as_dict()
        losses, norms = [], []
        extra["traffic"] = []
        for b in batches:
            tp.reset_traffic()
            if case.get("embed_cache"):
                with mock.patch.object(DTensor, "full_tensor",
                                       side_effect=AssertionError(
                                           "the table gathered whole")):
                    b = cache.advance(state.model.tables, b)
            state, m = step(state, b)
            extra["traffic"].append({k: list(v)
                                     for k, v in tp.TRAFFIC.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        if case.get("embed_cache"):
            tables = state.model.tables
            extra["foreign_zero"] = foreign_rows_zero(
                cache, planner, plans[-1], tables)
            extra["table_bytes"] = tables.numel() * tables.element_size()
        leaves = tp_whole_leaves(state.model)
        out[name] = (losses, norms, leaves if rank == 0 else None,
                     tp_local_shapes(state.model), extra)
        if name == inputs["ckpt"]:
            ckpt.save(state, ckpt_dir, state.step)
    return out


def tp_local_leaves(state) -> list:
    """``(local array, model dim, data dim)`` of each checkpoint leaf of a
    sharded train state (dims in the leaf's stacked layout, None where
    whole)."""
    from repro_torch.training.checkpoint import _flatten, _ModelShard
    out = []
    for leaf in _flatten(state)[0]:
        md = None
        if isinstance(leaf, _ModelShard):
            md = leaf.dim + isinstance(leaf.leaf, list)
            leaf = leaf.leaf
        ts = leaf if isinstance(leaf, list) else [leaf]
        dd = None
        if hasattr(ts[0], "placements") and ts[0].placements[0].is_shard():
            dd = ts[0].placements[0].dim + isinstance(leaf, list)
        loc = [t.to_local() if hasattr(t, "to_local") else t for t in ts]
        a = torch.stack(loc) if isinstance(leaf, list) else loc[0]
        out.append((a.detach().cpu().numpy().copy(), md, dd))
    return out


def tp_misc(rank, world, paths: dict):
    """On 4 ranks: the (2, 2) checkpoint restored onto (1, 4), then the
    reference's parameters loaded into that state (``params_from_jax``
    into model shards under FSDP); a reference checkpoint restored onto
    (2, 2) FSDP and saved back; ``EtlJob(mesh=)``'s
    rows on (2, 2); ``launch.train --mesh pod``'s error."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source
    from repro_torch.launch import train as launch
    from repro_torch.models import api
    from repro_torch.session import EtlJob
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as ttl

    from torch.distributed.device_mesh import init_device_mesh

    def mesh(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    def sharded(shape, tc):
        cfg = lm_cfg("llama3_2_3b")
        model = api.build_model(cfg)
        state = ttl.TrainState.create(model.init(seed=5, device="cpu"), tc)
        m = mesh(shape)
        return ttl.shard_train_step(model.loss, tc, m, state, batch_rows=8,
                                    fsdp=tc.fsdp)[1], m

    out = {}
    tc = TrainConfig(**paths["tcfg"])
    state, m = sharded((1, 4), tc)
    state = ckpt.restore(paths["port_ckpt"], state, mesh=m)
    out["port_22_to_14"] = (state.step, tp_local_leaves(state))
    api.params_from_jax(state.model, paths["ref_params"])
    out["params_from_jax_14"] = tp_whole_leaves(state.model)
    state, m = sharded((2, 2), TrainConfig(fsdp=True))
    state = ckpt.restore(paths["ref_ckpt"], state, mesh=m)
    out["ref_to_22"] = (state.step, tp_local_leaves(state))
    ckpt.save(state, paths["saved_ckpt"], state.step)
    # the ETL's rows on (2, 2)
    e = paths["etl"]
    job = EtlJob(lm_token_pipeline(e["seq"], e["vocab"],
                                   batch_size=e["batch"]),
                 Source.lm_events(e["seq"], rows=e["batch"] * 3,
                                  batch_size=e["batch"]),
                 backend="torch", device="cpu", mesh=mesh((2, 2)))
    with job.batches() as batches:
        out["etl"] = [{k: v.numpy() for k, v in b.items()} for b in batches]
    for arch in ("llama3_2_3b", "mamba2_370m"):
        try:
            launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "1", "--mesh", "pod"])
            out[f"pod_{arch}"] = "ran"
        except ValueError as err:
            out[f"pod_{arch}"] = str(err)
    return out


def tp_family_misc(rank, world, paths: dict):
    """On 4 ranks: the (2, 2) ``mamba_tp22`` checkpoint restored onto a
    (1, 4) state; ``EtlJob(mesh=, embed_cache=)`` on (2, 2): each rank's
    delivered rows and lookahead plans (the stage runs after place)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import paper_pipeline
    from repro_torch.data.source import Source
    from repro_torch.etl_runtime.lookahead import PLAN_KEYS, EmbedCacheConfig
    from repro_torch.models import api
    from repro_torch.session import EtlJob
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as ttl

    from torch.distributed.device_mesh import init_device_mesh

    def mesh(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    out = {}
    cfg = lm_cfg(paths["arch"])
    model = api.build_model(cfg)
    tc = TrainConfig(**paths["tcfg"])
    m = mesh((1, 4))
    state = ttl.TrainState.create(model.init(seed=5, device="cpu"), tc)
    state = ttl.shard_train_step(model.loss, tc, m, state, batch_rows=8,
                                 fsdp=tc.fsdp)[1]
    state = ckpt.restore(paths["port_ckpt"], state, mesh=m)
    out["ckpt_22_to_14"] = (state.step, tp_local_leaves(state))
    e = paths["etl"]
    job = EtlJob(paper_pipeline("II", small_vocab=e["vocab"],
                                batch_size=e["batch"]),
                 Source.synth("I", rows=e["batch"] * e["batches"],
                              batch_size=e["batch"], seed=2),
                 backend="cuda", device="cpu", mesh=mesh((2, 2)),
                 fit_source=Source.synth("I", rows=1000, batch_size=500,
                                         seed=1),
                 embed_cache=EmbedCacheConfig(**e["cache"]))
    job.fit()
    with job.batches() as batches:
        out["etl"] = [{k: np.asarray(b[k]) for k in ("sparse",) + PLAN_KEYS}
                      for b in batches]
    return out


# ---------------------------------------------------------------------------
# serving on the "model" axis (tests/test_torch_serve_model_axis.py)
# ---------------------------------------------------------------------------

def numpy_tree(tree):
    """A (nested dict of) tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def greedy_serve(model, module, batch: dict, max_len: int, steps: int):
    """Prefill ``batch`` and ``steps`` greedy decode steps: ``(logits,
    tokens, caches)``, the last-token logits of the prefill and of each
    step (numpy), the tokens each step was fed (B, steps) and the cache
    after the prefill and after the last step."""
    from repro_torch.serving.decode import next_token
    S = batch["tokens"].shape[1]
    with torch.inference_mode():
        lg, cache = model.prefill(module, batch, max_len)
        caches = [numpy_tree(cache)]
        logits, toks = [lg[:, -1].numpy().copy()], []
        for i in range(steps):
            toks.append(next_token(lg[:, -1]))
            lg, cache = model.decode_step(module, cache, toks[-1], S + i)
            logits.append(lg[:, -1].numpy().copy())
        caches.append(numpy_tree(cache))
    return logits, torch.cat(toks, 1).numpy(), caches


def serve_cases(rank, world, inputs_path):
    """Each case of ``inputs_path`` (``{name: {arch, over, mesh, params,
    batch, max_len, steps, fsdp}}``) on its ``(data, model)`` mesh: the
    reference's parameters in a module sharded for serving
    (``tensor_parallel.shard_for_serving``, weight-gathered with
    ``fsdp``), this rank's rows of the batch, greedy; returns ``{name:
    {"rows", "logits", "tokens", "caches", "param_bytes"}}``
    (``greedy_serve``'s, ``rows`` the first and the count of this rank's
    rows, ``param_bytes`` what the rank holds) and, for a weight-gathered
    case, ``"analyzed"``: ``hlo_cost.analyze`` of one more
    prefill of its rows with a cache of the prompt's length and the
    data-group gathers' bytes a decode step (``TRAFFIC``); and
    ``"trained"``: for each of ``inputs["trained"]``
    (an arch's reduced config, seed 0) a state that ``shard_train_step``
    sharded on (1, 4) against a module ``shard_for_serving`` sharded, both
    serving one batch: ``(logits, caches)`` of each."""
    import contextlib

    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import hlo_cost
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import api
    from repro_torch.training import train_loop as ttl

    from torch.distributed.device_mesh import init_device_mesh

    def mesh(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    inputs = load(inputs_path)
    out = {}
    for name, case in inputs["cases"].items():
        m = mesh(case["mesh"])
        cfg = tp_cfg(case["arch"], case["over"])
        model = api.build_model(cfg)
        fsdp = case.get("fsdp", False)
        module = tp.shard_for_serving(api.params_from_jax(
            model.init(device="cpu"), case["params"]), m, fsdp=fsdp)
        rows, dp = case["batch"]["tokens"].shape[0], case["mesh"][0]
        # a batch dp does not divide is whole on every rank (batch_specs
        # replicates it), which the caller says with row_shards(1)
        per = rows // dp if rows % dp == 0 else rows
        first = m.get_local_rank("data") * per if per < rows else 0
        batch = {k: torch.from_numpy(v[first:first + per])
                 for k, v in case["batch"].items()}
        with shd.row_shards(1) if per == rows and dp > 1 else \
                contextlib.nullcontext():
            logits, tokens, caches = greedy_serve(
                model, module, batch, case["max_len"], case["steps"])
        out[name] = {"rows": (first, per), "logits": logits,
                     "tokens": tokens, "caches": caches,
                     "param_bytes": sum(p.numel() * p.element_size()
                                        for p in module.parameters())}
        if fsdp:  # every rank: the prefill's collectives need them all
            S = batch["tokens"].shape[1]
            with torch.no_grad():
                cost = hlo_cost.analyze(model.prefill, module, batch, S)
                cache = model.prefill(module, batch, S + 1)[1]
                tp.reset_traffic()
                model.decode_step(module, cache, batch["tokens"][:, :1], S)
            out[name]["analyzed"] = {
                "flops": cost["flops"],
                "collective_bytes": cost["collective_bytes"],
                "n_collectives": cost["n_collectives"],
                "gathered_a_step": tp.TRAFFIC["data_all_gather"][0]}
    out["trained"] = {}
    for arch, batch in inputs["trained"].items():
        cfg = lm_cfg(arch)
        model = api.build_model(cfg)
        state = ttl.TrainState.create(model.init(device="cpu"), TrainConfig())
        state = ttl.shard_train_step(model.loss, TrainConfig(), mesh((1, 4)),
                                     state, batch_rows=8)[1]
        served = tp.shard_for_serving(model.init(device="cpu"), mesh((1, 4)))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        out["trained"][arch] = [greedy_serve(model, mod, batch, 12, 1)
                                for mod in (state.model, served)]
    return out
