"""The port's plain oracles and operator expressions against the JAX
package's, on seeded numpy inputs that include NaN, negatives,
``INT_MISSING``, arbitrary (non-hex) bytes and out-of-range one-hot values.
Integers must be bit-equal; floats within rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

INT_MIN = -(2 ** 31)


def _ints(rng, shape):
    x = rng.integers(INT_MIN, 2 ** 31, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[:6] = [INT_MIN, -1, 0, 1, 2 ** 31 - 1, -7]
    return x.astype(np.int32)


def _floats(rng, shape):
    x = rng.lognormal(0.0, 2.0, size=shape).astype(np.float32)
    x = np.where(rng.random(shape) < 0.3, -x, x)
    flat = x.reshape(-1)
    flat[:5] = [np.nan, -0.5, -1.0, 0.0, 1e30]
    return x


def _hex(rng, shape):
    """Digit-major uint8[8, ...]: real hex digits, arbitrary bytes, and
    all-zero (missing) strings."""
    digits = np.frombuffer(b"0123456789abcdefABCDEF", np.uint8)
    x = digits[rng.integers(0, len(digits), size=(8,) + shape)]
    junk = rng.random((8,) + shape) < 0.05
    x = np.where(junk, rng.integers(1, 256, size=(8,) + shape), x)
    x = x.astype(np.uint8)
    x[:, rng.random(shape) < 0.1] = 0
    x[3, 0, 0] = 0  # one zero digit inside a present string
    return x


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_hex2int_digit_major(rng):
    x = _hex(rng, (64, 5))
    tp.assert_match(rref.hex2int_digit_major(jnp.asarray(x)),
                    tref.hex2int_digit_major(torch.tensor(x)))


@pytest.mark.parametrize("capacity", [64, 1000])
def test_vocab_build_and_counts(rng, capacity):
    v = rng.integers(0, capacity, size=3000).astype(np.int32)
    v[:50] = 3  # a hot id
    tp.assert_match(rref.vocab_build_chunk(jnp.asarray(v), capacity),
                    tref.vocab_build_chunk(torch.tensor(v), capacity))
    tp.assert_match(rref.vocab_counts_chunk(jnp.asarray(v), capacity),
                    tref.vocab_counts_chunk(torch.tensor(v), capacity))


@pytest.mark.parametrize("min_count", [1, 3])
def test_vocab_state_merge_finalize(rng, min_count):
    capacity = 500
    rs = rref.vocab_state_init(capacity)
    ts = tref.vocab_state_init(capacity)
    for a, b in zip(rs, ts):
        tp.assert_match(a, b)
    for ci in range(4):
        v = rng.integers(0, capacity // (ci + 1), size=700).astype(np.int32)
        rfp = rref.vocab_build_chunk(jnp.asarray(v), capacity)
        rcnt = rref.vocab_counts_chunk(jnp.asarray(v), capacity)
        rs = rref.vocab_merge(rs, rfp, ci, chunk_counts=rcnt)
        ts = tref.vocab_merge(ts, torch.tensor(np.asarray(rfp)), ci,
                              chunk_counts=torch.tensor(np.asarray(rcnt)))
        for a, b in zip(rs, ts):
            tp.assert_match(a, b, f"chunk {ci}")
    tp.assert_match(rref.vocab_finalize(rs, min_count=min_count),
                    tref.vocab_finalize(ts, min_count=min_count))


def test_vocab_lookup(rng):
    table = np.where(rng.random(300) < 0.4, -1,
                     rng.permutation(300)).astype(np.int32)
    x = rng.integers(0, 300, size=(50, 7)).astype(np.int32)
    tp.assert_match(rref.vocab_lookup(jnp.asarray(x), jnp.asarray(table), 123),
                    tref.vocab_lookup(torch.tensor(x), torch.tensor(table), 123))


def test_pack_blocks(rng):
    a = _floats(rng, (20, 3))
    b = _ints(rng, (20, 5)) % 1000
    tp.assert_match(
        rref.pack_blocks([jnp.asarray(a), jnp.asarray(b)], jnp.float32, 16),
        tref.pack_blocks([torch.tensor(a), torch.tensor(b)], torch.float32, 16))


UNARY = {
    "clamp": (lambda m: m.Clamp(0.0), _floats),
    "clamp_hi": (lambda m: m.Clamp(-1.0, 50.0), _floats),
    "log": (lambda m: m.Logarithm(), _floats),
    "fill_f32": (lambda m: m.FillMissing(2.5), _floats),
    "fill_i32": (lambda m: m.FillMissing(7), _ints),
    "bucket_f32": (lambda m: m.Bucketize((-1.0, 0.5, 2.0, 100.0)), _floats),
    "bucket_i32": (lambda m: m.Bucketize((-100.5, 0.0, 3.7, 1e6)), _ints),
    "onehot": (lambda m: m.OneHot(4), lambda rng, s: _ints(rng, s) % 7 - 1),
    "modulus": (lambda m: m.Modulus(997), _ints),
    "sigrid": (lambda m: m.SigridHash(65536), _ints),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_operator_torch_expr_matches_jnp(rng, name):
    make, gen = UNARY[name]
    x = gen(rng, (40, 6))
    tp.assert_match(make(rops).jnp_expr(jnp.asarray(x)),
                    make(tops).torch_expr(torch.tensor(x)), name)
    # and the numpy oracles are the reference's own
    tp.assert_match(make(rops).numpy(x), make(tops).numpy(x), name)


def test_hex2int_operator(rng):
    x = _hex(rng, (30, 4))
    trailing = np.moveaxis(x, 0, -1)
    tp.assert_match(rops.Hex2Int(8).numpy(trailing),
                    tops.Hex2Int(8).torch_expr(torch.tensor(x)))


def test_cartesian(rng):
    a, b = _ints(rng, (40, 3)), _ints(rng, (40, 3))
    tp.assert_match(rops.Cartesian(4096).jnp_expr2(jnp.asarray(a), jnp.asarray(b)),
                    tops.Cartesian(4096).torch_expr2(torch.tensor(a),
                                                     torch.tensor(b)))


def test_mix32_handles_full_uint32_range(rng):
    x = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64)
    x[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    want = rops._mix32_np(x.astype(np.uint32))
    got = tref.mix32(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)
