"""The embedding-bag kernels of ``repro_torch`` against the JAX package.

Each plain version (``embedding_bag``, ``embedding_bag_cached``, the table
gradient) against the JAX Pallas kernel in interpret mode (or the JAX
``ref`` for the gradient, which has no kernel), on seeded numpy inputs at
the shapes of ``tests/test_kernels.py``: ragged batches, ``-1`` sentinels,
``partitions`` 1 and 4 on the JAX side, the two-level and the cache-only
variant, and the masking edges (an index ``>= vocab``, a slot
``>= cache_rows``).  Floats by the reference's policy (rtol 1e-5: the two
packages may sum over ``nnz`` in another order); inside the port, cached and
uncached bags are bit-equal.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.kernels import embedding_bag as rbag  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import embedding_bag as kbag  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([13, zlib.crc32(repr(key).encode())])


def _bag(rng, vocab, dim, batch, nnz, sentinels=0.0):
    tbl = rng.normal(size=(vocab, dim)).astype(np.float32)
    idx = rng.integers(0, vocab, size=(batch, nnz)).astype(np.int32)
    idx[rng.random(idx.shape) < sentinels] = -1
    return tbl, idx


def _t(*xs):
    return [None if x is None else torch.tensor(x) for x in xs]


@pytest.mark.parametrize("vocab,dim,batch,nnz,parts", [
    (64, 16, 33, 5, 4), (128, 32, 8, 1, 1), (256, 8, 100, 7, 8),
    (67, 12, 50, 4, 4), (100, 12, 50, 4, 8), (33, 12, 50, 4, 1)])
def test_embedding_bag_matches_pallas(vocab, dim, batch, nnz, parts):
    tbl, idx = _bag(_rng(vocab, dim, batch), vocab, dim, batch, nnz)
    want = rkops.embedding_bag(jnp.asarray(tbl), jnp.asarray(idx),
                               partitions=parts, interpret=True)
    tp.assert_match(want, kops.embedding_bag(*_t(tbl, idx)), "embedding_bag")


@pytest.mark.parametrize("batch,nnz,block_batch", [
    (33, 5, 8), (7, 1, 128), (129, 3, 128)])
def test_embedding_bag_sentinels_and_ragged_batch(batch, nnz, block_batch):
    tbl, idx = _bag(_rng(batch, nnz), 90, 16, batch, nnz, sentinels=0.3)
    idx[0, :] = -1  # an entirely empty bag pools to the zero vector
    want = rbag.embedding_bag(jnp.asarray(tbl), jnp.asarray(idx),
                              partitions=3, block_batch=block_batch,
                              interpret=True)
    got = kops.embedding_bag(*_t(tbl, idx))
    assert got.shape == (batch, 16)
    tp.assert_match(want, got, "embedding_bag")
    assert torch.equal(got[0], torch.zeros(16))


def _plan(rng, tbl, idx, staged: bool, cache_rows: int = 32):
    """(cache, slot, cold) whose cache rows mirror the table rows the remap
    assigned: every distinct row staged (cold None), or a random hot set."""
    vocab = tbl.shape[0]
    rows = (np.unique(idx[idx >= 0]) if staged
            else rng.choice(vocab, size=cache_rows, replace=False))
    slot_of = np.full(vocab, -1, np.int64)
    slot_of[rows] = np.arange(len(rows))
    slot = np.where(idx >= 0, slot_of[idx.clip(min=0)], -1).astype(np.int32)
    cold = None if staged else np.where(slot < 0, idx, -1).astype(np.int32)
    return tbl[rows], slot, cold


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("staged", [False, True])
def test_cached_matches_pallas_and_equals_uncached(parts, staged):
    rng = _rng(parts, staged)
    tbl, idx = _bag(rng, 150, 8, 40, 6, sentinels=0.1)
    cache, slot, cold = _plan(rng, tbl, idx, staged)
    want = rkops.embedding_bag_cached(
        jnp.asarray(tbl), jnp.asarray(cache), jnp.asarray(slot),
        None if cold is None else jnp.asarray(cold), partitions=parts,
        interpret=True)
    got = kops.embedding_bag_cached(*_t(tbl, cache, slot, cold))
    tp.assert_match(want, got, "embedding_bag_cached")
    # inside the port: bit-identical to the uncached bag
    assert torch.equal(got, kops.embedding_bag(*_t(tbl, idx)))


def test_masking_edges_match_pallas():
    """An index >= vocab contributes zero; a slot >= cache_rows contributes
    zero and never falls through to the table (the Pallas kernels' rule)."""
    rng = _rng("edges")
    vocab, dim, cache_rows = 40, 8, 6
    tbl, idx = _bag(rng, vocab, dim, 30, 3)
    idx[::3, 0] = vocab + 7
    idx[1::3, 1] = -1
    want = rkops.embedding_bag(jnp.asarray(tbl), jnp.asarray(idx),
                               partitions=2, interpret=True)
    tp.assert_match(want, kops.embedding_bag(*_t(tbl, idx)), "bag edges")
    cache = rng.normal(size=(cache_rows, dim)).astype(np.float32)
    slot = rng.integers(-1, cache_rows + 4, size=idx.shape).astype(np.int32)
    cold = idx.copy()
    for c in (cold, None):
        want = rkops.embedding_bag_cached(
            jnp.asarray(tbl), jnp.asarray(cache), jnp.asarray(slot),
            None if c is None else jnp.asarray(c), partitions=2,
            interpret=True)
        got = kops.embedding_bag_cached(*_t(tbl, cache, slot, c))
        tp.assert_match(want, got, f"cached edges, cold={c is not None}")
    # a slot past the cache with a valid cold id still contributes zero
    one = kops.embedding_bag_cached(*_t(tbl, cache, np.full((1, 1), 99, np.int32),
                                        np.zeros((1, 1), np.int32)))
    assert torch.equal(one, torch.zeros(1, dim))


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_bag_and_table_gradient_match_jax_ref(weighted):
    rng = _rng("grad", weighted)
    tbl, idx = _bag(rng, 70, 12, 25, 4)
    g = rng.normal(size=(25, 12)).astype(np.float32)
    w = rng.random(size=idx.shape).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.tensor(w)
    tp.assert_match(rref.embedding_bag(jnp.asarray(tbl), jnp.asarray(idx), jw),
                    kref.embedding_bag(*_t(tbl, idx), tw), "weighted bag")
    want = rref.embedding_bag_grad_table(tbl.shape, jnp.asarray(idx),
                                         jnp.asarray(g), jw)
    got = kref.embedding_bag_grad_table(tbl.shape, *_t(idx, g), tw)
    tp.assert_match(want, got, "grad table")
    # the gradient is autograd's through the plain bag
    t = torch.tensor(tbl, requires_grad=True)
    (auto,) = torch.autograd.grad(kref.embedding_bag(t, torch.tensor(idx), tw),
                                  t, torch.tensor(g))
    torch.testing.assert_close(got, auto, rtol=1e-6, atol=1e-6)


def test_wrappers_route_by_device_and_refuse_other_dtypes():
    tbl, idx = _bag(_rng("route"), 20, 8, 5, 2)
    before = dict(backend.LAUNCHES)
    kops.embedding_bag(*_t(tbl, idx))
    kops.embedding_bag_cached(*_t(tbl, tbl, idx, idx))
    assert backend.LAUNCHES == before  # CPU tensors: plain versions only
    # 16-bit tables are taken and give their own dtype; float64 and integer
    # tables are refused (the reference's bags take neither), and so is a
    # cached bag whose cache and table differ in dtype
    for dt in (torch.bfloat16, torch.float16):
        got = kops.embedding_bag(torch.tensor(tbl).to(dt), torch.tensor(idx))
        assert got.dtype == dt and got.shape == (5, 8)
    with pytest.raises(ValueError, match="float32"):
        kops.embedding_bag(torch.tensor(tbl).double(), torch.tensor(idx))
    with pytest.raises(ValueError, match="float32"):
        kops.embedding_bag(torch.tensor(idx), torch.tensor(idx))
    with pytest.raises(ValueError, match="differ"):
        kops.embedding_bag_cached(torch.tensor(tbl), torch.tensor(tbl).half(),
                                  torch.tensor(idx), torch.tensor(idx))
    meta = torch.empty(5, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kops.embedding_bag(torch.tensor(tbl), meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kops.embedding_bag_cached(torch.tensor(tbl), torch.tensor(tbl), meta)


def _stacked_plan(rng, n_feat, width, vocab, cache_rows, dim, batch=37):
    """Stacked tables and caches with ``[batch, n_feat]`` slot and cold
    columns cut from wider ``[batch, width]`` plan matrices (row stride
    ``width``), holding -1 entries, slots past the cache and cold ids past
    the vocabulary."""
    tables = rng.normal(size=(n_feat, vocab, dim)).astype(np.float32)
    cache = rng.normal(size=(n_feat, cache_rows, dim)).astype(np.float32)
    cache[:, 0] = -0.0  # 0.0 + -0.0 is +0.0 in every form
    slot = rng.integers(-1, cache_rows + 3, size=(batch, width))
    cold = rng.integers(-1, vocab + 3, size=(batch, width))
    slot[rng.random(slot.shape) < 0.3] = -1
    off = width - n_feat
    return (tables, cache, torch.tensor(slot.astype(np.int32))[:, off:],
            torch.tensor(cold.astype(np.int32))[:, :n_feat])


@pytest.mark.parametrize("n_feat,width,dim", [
    (3, 5, 8), (1, 4, 12), (26, 32, 16), (4, 4, 13)])
def test_stacked_cached_bag_equals_per_feature_bags(n_feat, width, dim):
    """The stacked bag is the per-feature bag of every feature, stacked, bit
    for bit (its plain version and the wrapper), and matches the JAX
    package's per-feature Pallas kernel, stacked as its lookup stacks it."""
    tables, cache, slot, cold = _stacked_plan(_rng("stacked", n_feat, width),
                                              n_feat, width, 40, 6, dim)
    assert slot.stride(0) == width and cold.stride(0) == width
    tt, tc = torch.tensor(tables), torch.tensor(cache)
    per_feature = torch.stack([
        kref.embedding_bag_cached(tt[t], tc[t], slot[:, t:t + 1],
                                  cold[:, t:t + 1]) for t in range(n_feat)],
        dim=1)
    got = kbag._stacked_cached_bag(tt, tc, slot, cold)
    assert torch.equal(got, per_feature)
    assert torch.equal(got, kbag._stacked_cached_bag.plain(
        tt, tc, slot, cold))
    assert not torch.signbit(got).logical_and(got == 0).any()
    want = jnp.stack([rkops.embedding_bag_cached(
        jnp.asarray(tables[t]), jnp.asarray(cache[t]),
        jnp.asarray(slot[:, t:t + 1].numpy()),
        jnp.asarray(cold[:, t:t + 1].numpy()), partitions=2, interpret=True)
        for t in range(n_feat)], axis=1)
    tp.assert_match(want, got, "stacked cached bag")


def test_stacked_cached_bag_routes_and_refuses_bad_shapes():
    tables, cache, slot, cold = _stacked_plan(_rng("stacked-route"), 3, 3,
                                              20, 4, 8)
    tt, tc = torch.tensor(tables), torch.tensor(cache)
    before = dict(backend.LAUNCHES)
    kbag._stacked_cached_bag(tt, tc, slot, cold)
    assert backend.LAUNCHES == before  # CPU tensors: the plain version
    with pytest.raises(ValueError, match=r"float32 \[T, rows, dim\]"):
        kbag._stacked_cached_bag(tt[0], tc, slot, cold)
    with pytest.raises(ValueError, match=r"float32 \[T, rows, dim\]"):
        kbag._stacked_cached_bag(tt, tc.double(), slot, cold)
    meta = torch.empty(5, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kbag._stacked_cached_bag(tt, tc, meta, meta)


# one unit in the last place of each 16-bit dtype, relative: both packages
# sum a 16-bit bag in float32 and round once, but may add in another order
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("variant", ["uncached", "two_level", "cache_only"])
@pytest.mark.parametrize("dtype", sorted(ULP))
def test_16bit_bags_match_pallas_and_cached_equals_uncached(dtype, variant):
    """bfloat16 / float16 tables against the JAX kernels in interpret mode
    (the table's dtype out; within one unit in the last place, relative,
    plus 1e-6 absolute for sums that cancel), and inside the port the
    cached bag bit-equal to the uncached one on the same logical ids."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = _rng("16bit", dtype, variant)
    tbl, idx = _bag(rng, 90, 12, 41, 6, sentinels=0.2)
    tt, jt = torch.tensor(tbl).to(tdt), jnp.asarray(tbl).astype(jdt)
    uncached = kops.embedding_bag(tt, torch.tensor(idx))
    assert uncached.dtype == tdt
    if variant == "uncached":
        got = uncached
        want = rkops.embedding_bag(jt, jnp.asarray(idx), partitions=2,
                                   interpret=True)
    else:
        # hot ids below 30 sit in the cache at their own row; the rest fall
        # through to the table (two_level) or are staged (cache_only)
        cache_rows = 30 if variant == "two_level" else 90
        slot = np.where(idx < cache_rows, idx, -1).astype(np.int32)
        cold = idx if variant == "two_level" else None
        got = kops.embedding_bag_cached(
            tt, tt[:cache_rows].clone(), torch.tensor(slot),
            None if cold is None else torch.tensor(cold))
        want = rkops.embedding_bag_cached(
            jt, jt[:cache_rows], jnp.asarray(slot),
            None if cold is None else jnp.asarray(cold), partitions=2,
            interpret=True)
        assert torch.equal(got, uncached)
    assert tp.dtype_name(want) == tp.dtype_name(got) == dtype
    np.testing.assert_allclose(tp.to_np(got), tp.to_np(want),
                               rtol=ULP[dtype], atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(ULP))
def test_16bit_stacked_bag_equals_per_feature_bags(dtype):
    """The stacked cached bag at a 16-bit dtype is the per-feature bag of
    every feature, stacked, bit for bit, in the tables' dtype."""
    tables, cache, slot, cold = _stacked_plan(_rng("stacked16", dtype), 4, 6,
                                              30, 5, 8)
    tdt = getattr(torch, dtype)
    tt, tc = torch.tensor(tables).to(tdt), torch.tensor(cache).to(tdt)
    got = kbag._stacked_cached_bag(tt, tc, slot, cold)
    per_feature = torch.stack([kops.embedding_bag_cached(
        tt[t], tc[t], slot[:, t:t + 1], cold[:, t:t + 1]) for t in range(4)],
        dim=1)
    assert got.dtype == tdt and torch.equal(got, per_feature)
