// The staged lowering's elementwise kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/dataflow.py:
//   stage_kernel  <- make_fused_stage (l.93): one stage's elementwise chain
//                    (FillMissing, Clamp, Log, Bucketize, Hex2Int, Modulus,
//                    SigridHash) over f32 / i32 [rows, cols] or digit-major
//                    uint8 [w, rows, cols] hex, cast to the output dtype;
//   packer_kernel <- make_packer (l.149): concatenate [rows, w_k] f32 / i32
//                    blocks, cast, zero-pad the width to pad_cols_to.
//
// Bound on an H100: bytes.  The stage reads its input once and writes its
// output once (a hex element is w bytes in, 4 out); the packer reads every
// block once and writes the padded output once.  Both do a few integer
// operations per byte.
//
// stage_kernel: each thread owns ELEMS consecutive elements: 16 of a hex
// input, 4 of an f32 / i32 one (whose chains, Log among them, cost more
// per byte).  It issues one 16-byte load per hex digit plane (one per 4
// words), all of them before it decodes any, so a hex thread keeps 128
// bytes in flight; it decodes in registers, runs the chain one opcode at a
// time over its values (the opcode a constant of each loop, as the
// dataflow interpreter's unary_loop), casts once and writes its elements
// with 16-byte (or narrower whole-vector) streaming stores.  Decoding the
// hex one digit at a time cost as much as the bytes, so Hex2Int(8) has a
// cheaper form: where all 32 bytes of 4 elements are 0 or ASCII hex digits
// (what every real hex column holds), their digits are their nibbles: four
// bytes at a time are checked and converted in SWAR, and the nibbles are
// gathered into words with byte permutes.  Anything else takes the exact
// rule of ops.cuh (hex_digit below): the same result.  The input and the
// output are read and written once, so both go through
// the streaming cache path (__ldcs / __stcs).  The elements before the
// input's first 16-byte boundary and those past the last whole vector run
// as scalar code in the same kernel (as vocab.cu's lookup_kernel does),
// and so does the whole launch when the hex planes lie a stride apart that
// is not a multiple of 16 bytes.  The output is stored as vectors where its
// element at the first vector lies on a 16-byte boundary (the wrapper
// allocates it so), else element by element from the same registers.  The
// grid is sized to the work: one pass of one vector a thread, in blocks of
// STAGE_THREADS (smaller blocks spread the last wave's work more evenly).
//
// packer_kernel: one thread per output element in a grid-stride loop (the
// TPU kernels' lane and sublane padding has no counterpart: the ragged edge
// is the loop bound).
//
// The per-opcode rules and the output cast are ops.cuh's, the same copy the
// dataflow interpreter runs.  Arguments travel by value as one
// __grid_constant__ struct each: no per-launch copy to the device.
// PackArgs takes up to 32 blocks; a packer of more (up to 128) takes
// WidePackArgs, the same kernel at a larger struct (both under 4 KiB).
// One 128-block struct for every packer measured 4-5 % slower on the
// narrow packers (a launch copies 2.6 KB of parameters instead of 0.7).

#include "ops.cuh"

#define HEX_ELEMS 16     // elements a thread owns of a hex input
#define WORD_ELEMS 4     // of an f32 / i32 input
#define HEX_GROUP 8      // digit planes a thread has in flight
#define STAGE_THREADS 128

// mirrored by _CStage in repro_torch/kernels/dataflow.py
struct StageArgs {
  const void* src;
  void* out;
  long long n;  // output elements
  int in_kind, hex_width, val_kind, out_kind;
  int n_instr, n_param;
  Instr instr[MAX_INSTR];
  int param[MAX_PARAM];
};

// mirrored by _pack_type(max_block) in repro_torch/kernels/dataflow.py
template <int MAXB>
struct PackArgsT {
  const void* src[MAXB];
  void* out;
  long long rows;
  int out_cols, n_block, out_kind;
  int kind[MAXB];
  int width[MAXB];
  int col[MAXB];
};
using PackArgs = PackArgsT<32>;
using WidePackArgs = PackArgsT<128>;
static_assert(sizeof(WidePackArgs) <= 4096, "the kernel parameter limit");

// ---- the stage: one element (the scalar code) ------------------------------

// The chain on element i, cast to the output kind: the value's bits.
template <bool HEX>
static __device__ __forceinline__ uint32_t stage_one(const StageArgs& a,
                                                     long long i) {
  int v;
  int k = 0;
  if (HEX) {  // instr[0] is the Hex2Int the encoder checked
    v = hex2int(static_cast<const uint8_t*>(a.src) + i,
                static_cast<size_t>(a.n), a.hex_width);
    k = 1;
  } else {
    v = __ldcs(static_cast<const int*>(a.src) + i);
  }
  for (; k < a.n_instr; ++k) v = unary_op(a.instr[k], v, a.param);
  return cast_out(a.out_kind, v, a.val_kind == K_F32);
}

// ---- the stage: ELEMS elements a thread (the vector pass) ------------------

// One hex digit: the rule of ops.cuh's hex2int (0x00 reads as '0'; a byte
// that is no hex digit decodes as c-87 / c-55 / c-48, sign and all).
static __device__ __forceinline__ int hex_digit(int c) {
  c = c ? c : 48;
  return c - ((c >= 97) ? 87 : ((c >= 65) ? 55 : 48));
}

// 4 elements from word q of 8 digit planes (x[d]: digit d of each, one
// byte an element), when every byte is 0 or an ASCII hex digit; false
// (and v untouched) otherwise.  Per byte b (bit 7 of each lane): digit =
// 0x30 <= b <= 0x39, alpha = 0x61 <= (b | 0x20) <= 0x66, zero = b == 0;
// the nibble of any of them is (b & 15) + 9 * bit 6 (0 for a zero byte).
static __device__ __forceinline__ bool hex4_fast(const uint32_t* x, int* v) {
  uint32_t bad = 0, seen = 0, p[4];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const uint32_t b = x[d];
    const uint32_t b7 = b & 0x7F7F7F7Fu;
    const uint32_t dig = (b7 + 0x50505050u) & ~(b7 + 0x46464646u);
    const uint32_t a7 = b7 | 0x20202020u;
    const uint32_t alpha = (a7 + 0x1F1F1F1Fu) & ~(a7 + 0x19191919u);
    const uint32_t zero = ~(b7 + 0x7F7F7F7Fu);
    bad |= ~(dig | alpha | zero) | b;
    seen |= b;
    const uint32_t nib = (b & 0x0F0F0F0Fu) + 9u * ((b >> 6) & 0x01010101u);
    p[d >> 1] = (d & 1) ? p[d >> 1] * 16u + nib : nib;  // two digits a byte
  }
  if (bad & 0x80808080u) return false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // element j: byte j of p[0], p[1], p[2], p[3]
    const uint32_t sel = j | (j + 4) << 4;
    const uint32_t lo = __byte_perm(p[3], p[2], sel);
    const uint32_t hi = __byte_perm(p[1], p[0], sel);
    v[j] = ((seen >> (8 * j)) & 0xFF)
               ? static_cast<int>(__byte_perm(lo, hi, 0x5410)) : INT_MIN;
  }
  return true;
}

// Decode 16 elements from their digit planes: plane d of them is the int4 at
// src + d * n.  Planes go HEX_GROUP at a time, every load of a group issued
// before any decode; 8-digit hex first tries hex4_fast on each 4 elements.
static __device__ __forceinline__ void hex_decode16(const uint8_t* src,
                                                    long long n, int width,
                                                    int v[HEX_ELEMS]) {
  int4 w[HEX_GROUP];
#pragma unroll
  for (int d = 0; d < HEX_GROUP; ++d)
    if (d < width) w[d] = __ldcs(reinterpret_cast<const int4*>(src + d * n));
  bool fast = width == HEX_GROUP;
#pragma unroll
  for (int q = 0; q < 4 && fast; ++q) {
    uint32_t x[HEX_GROUP];
#pragma unroll
    for (int d = 0; d < HEX_GROUP; ++d)
      x[d] = static_cast<uint32_t>(q == 0 ? w[d].x : q == 1 ? w[d].y
                                   : q == 2 ? w[d].z : w[d].w);
    fast = hex4_fast(x, v + 4 * q);
  }
  if (fast) return;
  uint32_t seen[4] = {0, 0, 0, 0};  // OR of every byte: zero means missing
#pragma unroll
  for (int j = 0; j < HEX_ELEMS; ++j) v[j] = 0;
  for (int d0 = 0; d0 < width; d0 += HEX_GROUP) {
    if (d0 > 0) {
#pragma unroll
      for (int d = 0; d < HEX_GROUP; ++d)
        if (d0 + d < width)
          w[d] = __ldcs(reinterpret_cast<const int4*>(src + (d0 + d) * n));
    }
#pragma unroll
    for (int d = 0; d < HEX_GROUP; ++d) {
      if (d0 + d >= width) break;
      const uint32_t q4[4] = {static_cast<uint32_t>(w[d].x),
                              static_cast<uint32_t>(w[d].y),
                              static_cast<uint32_t>(w[d].z),
                              static_cast<uint32_t>(w[d].w)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        seen[q] |= q4[q];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = (q4[q] >> (8 * b)) & 0xFF;
          v[4 * q + b] = static_cast<int>(
              (static_cast<uint32_t>(v[4 * q + b]) << 4) |
              static_cast<uint32_t>(hex_digit(c)));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (((seen[q] >> (8 * b)) & 0xFF) == 0) v[4 * q + b] = INT_MIN;
}

// One opcode over the values, the opcode a constant of the loop.
template <int OP, int ELEMS>
static __device__ __forceinline__ void unary_vec(Instr in, int* v,
                                                 const int* params) {
  in.op = OP;
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) v[j] = unary_op(in, v[j], params);
}

template <int ELEMS>
static __device__ __forceinline__ void chain_vec(const StageArgs& a, int k,
                                                 int* v) {
  for (; k < a.n_instr; ++k) {
    const Instr& in = a.instr[k];
    switch (in.op) {
      case OP_FILL_F32: unary_vec<OP_FILL_F32, ELEMS>(in, v, a.param); break;
      case OP_FILL_I32: unary_vec<OP_FILL_I32, ELEMS>(in, v, a.param); break;
      case OP_CLAMP: unary_vec<OP_CLAMP, ELEMS>(in, v, a.param); break;
      case OP_LOG1P: unary_vec<OP_LOG1P, ELEMS>(in, v, a.param); break;
      case OP_BUCKET_F32:
        unary_vec<OP_BUCKET_F32, ELEMS>(in, v, a.param);
        break;
      case OP_BUCKET_I32:
        unary_vec<OP_BUCKET_I32, ELEMS>(in, v, a.param);
        break;
      case OP_MOD: unary_vec<OP_MOD, ELEMS>(in, v, a.param); break;
      case OP_SIGRID: unary_vec<OP_SIGRID, ELEMS>(in, v, a.param); break;
      default: break;
    }
  }
}

// Store ELEMS output elements of SIZE bytes from their bits: whole-vector
// streaming stores (16 bytes each, or one narrower store when the vector
// is smaller) when `vec`, else one element at a time.
template <int ELEMS, int SIZE>
static __device__ __forceinline__ void store_vec(void* out, long long e,
                                                 const uint32_t* o, bool vec) {
  if (!vec) {
#pragma unroll
    for (int j = 0; j < ELEMS; ++j)
      if (SIZE == 4) static_cast<uint32_t*>(out)[e + j] = o[j];
      else if (SIZE == 2) static_cast<uint16_t*>(out)[e + j] = o[j];
      else static_cast<uint8_t*>(out)[e + j] = o[j];
    return;
  }
  constexpr int WORDS = ELEMS * SIZE / 4;  // 1, 2, 4, 8 or 16
  constexpr int PER = 4 / SIZE;            // elements a word
  uint32_t w[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    w[i] = 0;
#pragma unroll
    for (int b = 0; b < PER; ++b) w[i] |= o[i * PER + b] << (8 * SIZE * b);
  }
  unsigned char* dst = static_cast<unsigned char*>(out) + e * SIZE;
  if (WORDS >= 4) {
#pragma unroll
    for (int q = 0; q < WORDS / 4; ++q)
      __stcs(reinterpret_cast<int4*>(dst) + q,
             make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]));
  } else if (WORDS == 2) {
    __stcs(reinterpret_cast<int2*>(dst), make_int2(w[0], w[1]));
  } else {
    __stcs(reinterpret_cast<int*>(dst), static_cast<int>(w[0]));
  }
}

// HEX: the input is digit-major hex (else f32 / i32 words); SIZE: bytes of
// an output element.  `head` elements come before the first vector; n_vec
// vectors of ELEMS follow; the rest is the tail.
template <bool HEX, int SIZE>
__global__ void __launch_bounds__(STAGE_THREADS)
stage_kernel(const __grid_constant__ StageArgs a, long long head,
             long long n_vec) {
  constexpr int ELEMS = HEX ? HEX_ELEMS : WORD_ELEMS;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long tail = head + n_vec * ELEMS;
  if (tid < head)
    store_out(a.out, tid, a.out_kind, stage_one<HEX>(a, tid));
  if (tid < a.n - tail)
    store_out(a.out, tail + tid, a.out_kind, stage_one<HEX>(a, tail + tid));
  if (tid >= n_vec) return;
  const long long e = head + tid * ELEMS;
  int v[ELEMS];
  int k = 0;
  if constexpr (HEX) {
    hex_decode16(static_cast<const uint8_t*>(a.src) + e, a.n, a.hex_width,
                 v);
    k = 1;
  } else {
    const int4* s =
        reinterpret_cast<const int4*>(static_cast<const int*>(a.src) + e);
    int4 w[ELEMS / 4];
#pragma unroll
    for (int q = 0; q < ELEMS / 4; ++q) w[q] = __ldcs(s + q);
#pragma unroll
    for (int q = 0; q < ELEMS / 4; ++q) {
      v[4 * q] = w[q].x;
      v[4 * q + 1] = w[q].y;
      v[4 * q + 2] = w[q].z;
      v[4 * q + 3] = w[q].w;
    }
  }
  chain_vec<ELEMS>(a, k, v);
  uint32_t o[ELEMS];
  const bool is_float = a.val_kind == K_F32;
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) o[j] = cast_out(a.out_kind, v[j], is_float);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.out) + head * SIZE) &
                    15) == 0;
  store_vec<ELEMS, SIZE>(a.out, e, o, vec);
}

// ---- the packer --------------------------------------------------------------

// WORD: the output is f32 / i32 (a 4-byte word, the one-branch cast);
// else any other kind through cast_out.
template <class A, bool WORD>
__global__ void __launch_bounds__(THREADS)
packer_kernel(const __grid_constant__ A a) {
  const long long n = a.rows * a.out_cols;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long r = i / a.out_cols;
    const int c = static_cast<int>(i - r * a.out_cols);
    int b = -1;
    for (int k = 0; k < a.n_block; ++k)
      if (c >= a.col[k] && c < a.col[k] + a.width[k]) b = k;
    int bits = 0;  // zero in the padding columns, as every kind
    bool is_float = false;
    if (b >= 0) {
      const long long e = r * a.width[b] + (c - a.col[b]);
      bits = static_cast<const int*>(a.src[b])[e];
      is_float = a.kind[b] == K_F32;
      if (WORD && a.kind[b] != a.out_kind)  // float -> int truncates
        bits = (a.out_kind == K_F32)
                   ? __float_as_int(static_cast<float>(bits))
                   : static_cast<int>(__int_as_float(bits));
    }
    if (WORD) static_cast<int*>(a.out)[i] = bits;
    else store_out(a.out, i, a.out_kind, cast_out(a.out_kind, bits, is_float));
  }
}

template <class A>
static void launch_pack(const A* a, long long n, cudaStream_t s) {
  if (a->out_kind == K_F32 || a->out_kind == K_I32)
    packer_kernel<A, true><<<grid_blocks(n), THREADS, 0, s>>>(*a);
  else
    packer_kernel<A, false><<<grid_blocks(n), THREADS, 0, s>>>(*a);
}

template <bool HEX, int SIZE>
static int launch_stage(const StageArgs* a, cudaStream_t s) {
  constexpr int ELEMS = HEX ? HEX_ELEMS : WORD_ELEMS;
  long long head;
  const uintptr_t src = reinterpret_cast<uintptr_t>(a->src);
  if (HEX) {  // every plane shares plane 0's phase iff n % 16 == 0
    head = (a->n % 16 == 0) ? static_cast<long long>((16 - (src & 15)) & 15)
                            : a->n;
  } else {
    head = static_cast<long long>(((16 - (src & 15)) & 15) / 4);
  }
  if (head > a->n) head = a->n;
  const long long n_vec = (a->n - head) / ELEMS;
  const long long scalar = a->n - n_vec * ELEMS;  // head + tail
  const long long threads = n_vec > scalar ? n_vec : scalar;
  const long long blocks = (threads + STAGE_THREADS - 1) / STAGE_THREADS;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  stage_kernel<HEX, SIZE><<<static_cast<int>(blocks), STAGE_THREADS, 0, s>>>(
      *a, head, n_vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool HEX>
static int launch_stage_sized(const StageArgs* a, cudaStream_t s) {
  switch (kind_size(a->out_kind)) {
    case 4: return launch_stage<HEX, 4>(a, s);
    case 2: return launch_stage<HEX, 2>(a, s);
    default: return launch_stage<HEX, 1>(a, s);
  }
}

extern "C" {

// out: the wrapper allocates it so that its element `head` (the first
// vector's) lies on a 16-byte boundary where it can.
int launch_fused_stage(const void* args, void* stream) {
  const StageArgs* a = static_cast<const StageArgs*>(args);
  if (a->n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->in_kind == K_HEX ? launch_stage_sized<true>(a, s)
                             : launch_stage_sized<false>(a, s);
}

// `args` is a PackArgs, or a WidePackArgs when `wide` is nonzero.
int launch_packer(const void* args, int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    const WidePackArgs* a = static_cast<const WidePackArgs*>(args);
    const long long n = a->rows * a->out_cols;
    if (n == 0) return 0;
    launch_pack(a, n, s);
  } else {
    const PackArgs* a = static_cast<const PackArgs*>(args);
    const long long n = a->rows * a->out_cols;
    if (n == 0) return 0;
    launch_pack(a, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int stage_args_size() { return static_cast<int>(sizeof(StageArgs)); }

int pack_args_size(int wide) {
  return static_cast<int>(wide ? sizeof(WidePackArgs) : sizeof(PackArgs));
}

}  // extern "C"
