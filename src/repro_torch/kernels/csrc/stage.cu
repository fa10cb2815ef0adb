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
// packer_kernel: one block of THREADS per tile of R rows (R a multiple of
// 16, chosen on the host: pack_tile in repro_torch/kernels/dataflow.py).
// For every column block k, rows [r0, r0 + R) are one contiguous span of
// R * w_k words; a warp a block (several warps a block where there are
// fewer blocks than warps) puts the span in flight into shared memory with
// cp.async (16-byte copies, which skip L1; 4-byte ones for the head before
// the first 16-byte boundary and for the tail), every span of the tile
// before any is read, and no register holds them.  The same warp writes
// the block's entries of the tile's column map (per output column: the
// shared word of row 0, the row pitch and whether the word is a float;
// padding columns read one zero word), so no element searches the blocks
// and the work per element does not depend on the block count.  The output
// tile [R, out_cols] is one contiguous span too, which starts on a 16-byte
// boundary for any output size because R is a multiple of 16: a thread
// gathers 16 bytes of it (4 words, 8 halves or 16 bytes) from shared
// memory through the map, casts in registers and writes them with one
// streaming store (__stcs); (row, column) step by a fixed amount from one
// vector to the thread's next and by one column within a vector, so no
// element costs a division, and all index math in a tile is 32-bit.  The
// ragged last tile is the loop bound, not padding.  A row too wide for 16
// rows of it to fit PACK_SMEM_MAX is walked in windows of output columns
// (the grid's second dimension), each row's part copied and written a word
// at a time.  The launcher takes both structs and every output kind, each
// kind its own instantiation (the cast is one case).
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
  int tile_rows, tile_cols;  // R (a multiple of 16); out_cols or a window
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

#define PACK_SMEM_MAX (48 * 1024)  // shared memory of one tile, no opt-in

// Shared memory of a tile of R rows and C output columns (words): the column
// map (entry c at c + c / 32, so the lanes of a warp read it without bank
// conflicts), the zero word the padding columns read, then from
// pack_data(C) on block k's rows at R * (its first column in the window) +
// 4 * pack_skew(k) + the 16-byte phase of its source, so that its 16-byte
// copies land on 16-byte boundaries.  The skew grows by 1 a block and by 2
// every 8th: one-column blocks read 4 columns apart by a warp (a 16-byte
// store of 4-byte elements) then fall in 8 banks, not 2 (4 k alone put
// 16 lanes on one bank).  Mirrored by pack_smem_bytes in
// repro_torch/kernels/dataflow.py.
static __host__ __device__ __forceinline__ int pack_zero(int cols) {
  return cols + (cols >> 5);
}
static __host__ __device__ __forceinline__ int pack_data(int cols) {
  return (pack_zero(cols) + 4) & ~3;
}
static __host__ __device__ __forceinline__ int pack_skew(int k) {
  return k + (k >> 3);
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One word / one 16-byte vector from global into shared memory, through no
// register (cp.async; the 16-byte form caches in L2 only).
static __device__ __forceinline__ void copy4(int* s, const int* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(s)),
               "l"(g) : "memory");
}
static __device__ __forceinline__ void copy16(int* s, const int* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(s)),
               "l"(g) : "memory");
}

// Output column c of the window in tile row r, cast to KIND: map entry =
// shared word of row 0 | row pitch << 16 | is-float << 31.
template <int KIND>
static __device__ __forceinline__ uint32_t pack_elem(const int* sm,
                                                     const uint32_t* map,
                                                     int r, int c) {
  const uint32_t m = map[c + (c >> 5)];
  const int bits = sm[(m & 0xFFFF) + r * ((m >> 16) & 0x7FFF)];
  return cast_out(KIND, bits, m >> 31);
}

// KIND: the output kind (ops.cuh), so the cast is one case.
template <class A, int KIND>
__global__ void __launch_bounds__(THREADS)
packer_kernel(const __grid_constant__ A a) {
  extern __shared__ __align__(16) int sm[];
  constexpr int SIZE = kind_size(KIND);
  constexpr int V = 16 / SIZE;  // elements of one 16-byte store
  uint32_t* map = reinterpret_cast<uint32_t*>(sm);
  const int R = a.tile_rows;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R),
                                        a.rows - r0));
  const int c0 = blockIdx.y * a.tile_cols;
  const int cols = min(a.tile_cols, a.out_cols - c0);  // of the window
  const int zero = pack_zero(a.tile_cols);
  const int data = pack_data(a.tile_cols);
  const int lane = threadIdx.x & 31;
  // every block's rows in flight, and the block's map entries: a warp a
  // block, or `parts` warps a block where there are fewer blocks than warps
  const int parts = max(THREADS / 32 / a.n_block, 1);
  for (int u = threadIdx.x >> 5; u < a.n_block * parts; u += THREADS / 32) {
    const int k = u / parts;
    const int first = 32 * (u - k * parts) + lane, step = 32 * parts;
    const int w = a.width[k], col = a.col[k];
    const int lo = max(c0 - col, 0), hi = min(c0 + cols - col, w);
    if (lo >= hi) continue;
    const int n = hi - lo;  // the block's columns in the window
    const int* g = static_cast<const int*>(a.src[k]) + r0 * w + lo;
    const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(g) >> 2) & 3;
    const int at = data + R * (col + lo - c0) + 4 * pack_skew(k) + ph;
    int* s = sm + at;
    if (n == w) {  // whole rows: one span, 16 bytes a copy past its head
      const int len = rows * w;
      const int head = min((4 - ph) & 3, len);
      const int n_vec = (len - head) >> 2;
      const int tail = head + 4 * n_vec;
      if (first < head) copy4(s + first, g + first);
      for (int v = first; v < n_vec; v += step)
        copy16(s + head + 4 * v, g + head + 4 * v);
      if (first < len - tail) copy4(s + tail + first, g + tail + first);
    } else {  // a window's part of each row
      for (int r = 0; r < rows; ++r)
        for (int j = first; j < n; j += step)
          copy4(s + r * n + j, g + static_cast<long long>(r) * w + j);
    }
    const uint32_t entry = static_cast<uint32_t>(a.kind[k] == K_F32) << 31 |
                           static_cast<uint32_t>(n) << 16;
    for (int j = first; j < n; j += step) {
      const int c = col + lo + j - c0;
      map[c + (c >> 5)] = entry | static_cast<uint32_t>(at + j);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int used = a.col[a.n_block - 1] + a.width[a.n_block - 1];
  for (int c = max(used - c0, 0) + threadIdx.x; c < cols; c += THREADS)
    map[c + (c >> 5)] = static_cast<uint32_t>(zero);  // pitch 0, an int
  if (threadIdx.x == 0) sm[zero] = 0;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  if (cols != a.out_cols) {  // a window: each row's part, a word at a time
    for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32)
      for (int c = lane; c < cols; c += 32)
        store_out(a.out, (r0 + r) * a.out_cols + c0 + c, KIND,
                  pack_elem<KIND>(sm, map, r, c));
    return;
  }
  // whole rows: the tile's output is one span from a 16-byte boundary
  void* out = static_cast<unsigned char*>(a.out) + r0 * cols * SIZE;
  const int total = rows * cols;
  const int n_vec = total / V;
  int r = threadIdx.x * V / cols;
  int c = threadIdx.x * V - r * cols;
  const int dr = THREADS * V / cols;
  const int dc = THREADS * V - dr * cols;
  for (int i = threadIdx.x; i < n_vec; i += THREADS) {
    uint32_t o[V];
    int rr = r, cc = c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o[j] = pack_elem<KIND>(sm, map, rr, cc);
      if (++cc == cols) {
        cc = 0;
        ++rr;
      }
    }
    store_vec<V, SIZE>(out, static_cast<long long>(i) * V, o, true);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
  const int e = n_vec * V + threadIdx.x;  // past the last whole vector
  if (e < total) {
    const int er = e / cols;
    store_out(out, e, KIND, pack_elem<KIND>(sm, map, er, e - er * cols));
  }
}

template <class A, int KIND>
static int launch_pack_kind(const A* a, cudaStream_t s) {
  const int R = a->tile_rows, C = a->tile_cols;
  const int used = a->col[a->n_block - 1] + a->width[a->n_block - 1];
  const long long tiles = (a->rows + R - 1) / R;
  const int windows = (a->out_cols + C - 1) / C;
  const size_t smem = 4 * static_cast<size_t>(
      pack_data(C) + R * min(used, C) + 4 * pack_skew(a->n_block));
  if (smem > PACK_SMEM_MAX || tiles > 0x7FFFFFFFLL || windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  packer_kernel<A, KIND>
      <<<dim3(static_cast<unsigned>(tiles), windows), THREADS, smem, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <class A>
static int launch_pack(const A* a, cudaStream_t s) {
  if (a->rows == 0 || a->out_cols == 0) return 0;
  if (a->n_block < 1 || a->tile_rows < 16 || a->tile_rows % 16 != 0 ||
      a->tile_cols < 1 || (reinterpret_cast<uintptr_t>(a->out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a->out_kind) {
    case K_F32: return launch_pack_kind<A, K_F32>(a, s);
    case K_I32: return launch_pack_kind<A, K_I32>(a, s);
    case K_F16: return launch_pack_kind<A, K_F16>(a, s);
    case K_BF16: return launch_pack_kind<A, K_BF16>(a, s);
    case K_I8: return launch_pack_kind<A, K_I8>(a, s);
    case K_U8: return launch_pack_kind<A, K_U8>(a, s);
    case K_I16: return launch_pack_kind<A, K_I16>(a, s);
    case K_U16: return launch_pack_kind<A, K_U16>(a, s);
    case K_U32: return launch_pack_kind<A, K_U32>(a, s);
    case K_BOOL: return launch_pack_kind<A, K_BOOL>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// `args` is a PackArgs, or a WidePackArgs when `wide` is nonzero; its
// output starts on a 16-byte boundary (the wrapper allocates it).
int launch_packer(const void* args, int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_pack(static_cast<const WidePackArgs*>(args), s)
              : launch_pack(static_cast<const PackArgs*>(args), s);
}

int stage_args_size() { return static_cast<int>(sizeof(StageArgs)); }

int pack_args_size(int wide) {
  return static_cast<int>(wide ? sizeof(WidePackArgs) : sizeof(PackArgs));
}

}  // extern "C"
