// Per-element semantics of the ETL opcodes, shared by every kernel of the
// library: the tile-program interpreter (dataflow.cu) and the staged chain
// kernel (stage.cu) run one copy of each rule.
//
// The rules follow the JAX package bit for bit: Clamp is written with
// comparisons so NaN propagates (fmaxf would drop it), Modulus is a positive
// mod, Hex2Int decodes non-hex bytes as c-87 / c-55 / c-48 OR'd in as
// uint32 (all-zero strings are missing -> INT_MIN), and no fast-math flag is
// used.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_INSTR 32
#define MAX_PARAM 64
#define THREADS 256

enum Kind { K_F32 = 0, K_I32 = 1, K_HEX = 2 };

// mirrored by the OP_* constants in repro_torch/core/operators.py
enum Op {
  OP_FILL_F32 = 1, OP_FILL_I32 = 2, OP_CLAMP = 3, OP_LOG1P = 4,
  OP_BUCKET_F32 = 5, OP_BUCKET_I32 = 6, OP_ONEHOT = 7, OP_HEX2INT = 8,
  OP_MOD = 9, OP_SIGRID = 10, OP_CROSS = 11, OP_LOOKUP = 12
};

// mirrored by _CInstr in repro_torch/kernels/dataflow.py
struct Instr { int op, dst, a, b, i0, i1; float f0, f1; };

static __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Digit-major ASCII hex: digit d of the element lies at p[d * stride].
static __device__ __forceinline__ int hex2int(const uint8_t* p, size_t stride,
                                              int width) {
  bool missing = true;
  uint32_t v = 0;
  for (int d = 0; d < width; ++d) {
    int c = p[d * stride];
    if (c != 0) missing = false; else c = 48;
    const int dig = (c >= 97) ? c - 87 : ((c >= 65) ? c - 55 : c - 48);
    v = (v << 4) | static_cast<uint32_t>(dig);
  }
  return missing ? INT_MIN : static_cast<int>(v);
}

// Cartesian: mix32(mix32(a) ^ mix32(b) * golden) mod m.
static __device__ __forceinline__ int cross32(int a, int b, int m) {
  const uint32_t ha = mix32(static_cast<uint32_t>(a));
  const uint32_t hb = mix32(static_cast<uint32_t>(b));
  const uint32_t h = mix32(ha ^ (hb * 0x9E3779B1u));
  return static_cast<int>(h % static_cast<uint32_t>(m));
}

// One shape-preserving unary opcode on a 32-bit value held as its bit
// pattern (a float as __float_as_int).  `params` is the program's pool of
// bucket boundaries.  The caller routes ONEHOT, HEX2INT, CROSS and LOOKUP
// elsewhere; any other opcode leaves the value as it is.
static __device__ __forceinline__ int unary_op(const Instr& in, int x,
                                               const int* params) {
  switch (in.op) {
    case OP_FILL_F32:
      return isnan(__int_as_float(x)) ? __float_as_int(in.f0) : x;
    case OP_FILL_I32:
      return (x == INT_MIN) ? in.i0 : x;
    case OP_CLAMP: {
      float f = __int_as_float(x);
      f = (f < in.f0) ? in.f0 : f;
      if (in.i0) f = (f > in.f1) ? in.f1 : f;
      return __float_as_int(f);
    }
    case OP_LOG1P:
      return __float_as_int(log1pf(__int_as_float(x)));
    case OP_BUCKET_F32: {
      const float f = __int_as_float(x);
      int c = 0;
      for (int j = 0; j < in.i1; ++j)
        c += (f >= __int_as_float(params[in.i0 + j])) ? 1 : 0;
      return c;
    }
    case OP_BUCKET_I32: {
      int c = 0;
      for (int j = 0; j < in.i1; ++j) c += (x >= params[in.i0 + j]) ? 1 : 0;
      return c;
    }
    case OP_MOD: {
      const int r = x % in.i0;
      return (r < 0) ? r + in.i0 : r;
    }
    case OP_SIGRID:
      return static_cast<int>(mix32(static_cast<uint32_t>(x)) %
                              static_cast<uint32_t>(in.i0));
    default:
      return x;
  }
}

// Blocks of a grid-stride launch over n elements: enough to fill the 132
// SMs many times over, never more than the elements need.
static inline int grid_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<int>(want < 132LL * 32 ? want : 132LL * 32);
}
