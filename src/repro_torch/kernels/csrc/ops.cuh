// Per-element semantics of the ETL opcodes, shared by every kernel of the
// library: the tile-program interpreter (dataflow.cu) and the staged chain
// kernel (stage.cu) run one copy of each rule, and one copy of the cast of a
// 32-bit value to the output dtype (cast_out).
//
// The rules follow the JAX package bit for bit: Clamp is written with
// comparisons so NaN propagates (fmaxf would drop it), Modulus is a positive
// mod, Hex2Int decodes non-hex bytes as c-87 / c-55 / c-48 OR'd in as
// uint32 (all-zero strings are missing -> INT_MIN), and no fast-math flag is
// used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_INSTR 32
#define MAX_PARAM 64
#define THREADS 256

// Buffer kinds: a buffer inside a program is f32 or i32 (or a raw hex
// source); an output may be any kind below K_HEX's, one past it too.
// Mirrored by the KIND_* constants in repro_torch/kernels/dataflow.py.
enum Kind {
  K_F32 = 0, K_I32 = 1, K_HEX = 2, K_F16 = 3, K_BF16 = 4, K_I8 = 5,
  K_U8 = 6, K_I16 = 7, K_U16 = 8, K_U32 = 9, K_BOOL = 10
};

// Bytes of one element of an output kind.
static constexpr __host__ __device__ __forceinline__ int kind_size(int k) {
  return (k == K_F32 || k == K_I32 || k == K_U32) ? 4
         : (k == K_F16 || k == K_BF16 || k == K_I16 || k == K_U16) ? 2 : 1;
}

// A 32-bit value (a float's bits when is_float) cast to output kind k, as
// the element's raw bits, zero-extended.  The rules are torch's .to(dtype)
// on the card (c10::static_cast_with_inter_type), which in range is numpy's
// and JAX's astype: float -> int truncates toward zero (to uint8 through
// int64), float -> float16 / bfloat16 rounds to nearest even, int ->
// float16 / bfloat16 goes through float32, int -> a narrower int wraps,
// anything -> bool is != 0 (NaN is true).  Out of range, float -> int
// follows the device's conversion (saturating), as torch's does on the card.
static __device__ __forceinline__ uint32_t cast_out(int k, int bits,
                                                    bool is_float) {
  const float f = is_float ? __int_as_float(bits) : static_cast<float>(bits);
  switch (k) {
    case K_F32: return __float_as_uint(f);
    case K_I32: return is_float ? static_cast<uint32_t>(static_cast<int>(f))
                                : static_cast<uint32_t>(bits);
    case K_F16: return __half_as_ushort(__float2half_rn(f));
    case K_BF16: return __bfloat16_as_ushort(__float2bfloat16_rn(f));
    case K_I8:
      return static_cast<uint8_t>(is_float ? static_cast<int8_t>(f)
                                           : static_cast<int8_t>(bits));
    case K_U8:
      return is_float ? static_cast<uint8_t>(static_cast<long long>(f))
                      : static_cast<uint8_t>(bits);
    case K_I16:
      return static_cast<uint16_t>(is_float ? static_cast<int16_t>(f)
                                            : static_cast<int16_t>(bits));
    case K_U16: return is_float ? static_cast<uint16_t>(f)
                                : static_cast<uint16_t>(bits);
    case K_U32: return is_float ? static_cast<uint32_t>(f)
                                : static_cast<uint32_t>(bits);
    default:  // K_BOOL
      return is_float ? (f != 0.0f) : (bits != 0);
  }
}

// Store element i of an output of kind k (cast_out's bits).
static __device__ __forceinline__ void store_out(void* out, long long i,
                                                 int k, uint32_t v) {
  switch (kind_size(k)) {
    case 4: static_cast<uint32_t*>(out)[i] = v; break;
    case 2: static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(v); break;
    default: static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(v);
  }
}

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
