// Streaming dataflow kernels for Hopper (sm_90a): one tile-program
// interpreter serves every ETL pipeline.
//
// Replaces the Pallas kernels of src/repro/kernels/dataflow.py:
//   apply_kernel  <- make_group_dataflow (l.367) and make_output_dataflow
//                    (l.299): the TileStep program over a row tile, then the
//                    packer epilogue of every output (n_out >= 1);
//   fit_kernel    <- make_fit_dataflow (l.440): the same program, then the
//                    chunk first-occurrence / count build.
//
// The program (slots, instructions, terminals) is encoded on the host by
// repro_torch/kernels/dataflow.py and passed by value as one
// __grid_constant__ struct; no per-launch copy to the device.  Two
// instantiations of one template: Program, whose maxima (8 sources, 24
// slots, 32 instructions, 4 tables, 4 outputs, 16 terminals) keep it under
// the classic 4 KiB of kernel parameters, takes every program within them;
// WideProgram (128 / 384 / 384 / 128 / 16 / 128, 25 KB) takes the larger
// ones, such as one vocabulary per Criteo feature (28 sources, 81 slots and
// instructions, 26 tables), through the 32,764 bytes of parameters that
// CUDA 12.1 and later allow on sm_70 and up.  Both run the same code.
//
// Outputs may be of any kind of ops.cuh (f32, i32, f16, bf16, i8, u8, i16,
// u16, u32, bool): the program computes in 32 bits and casts at the store.
//
// Bound on an H100: bytes (raw sources in once, packed outputs out once; a
// few integer operations per byte).  What the design does about it:
//
// - Persistent grid.  The launcher starts min(tiles, SMs x resident blocks)
//   blocks; each walks tiles blockIdx.x, += gridDim.x.
// - A two-stage ring of source tiles in shared memory (only the sources are
//   doubled; intermediates have one copy).  While tile t runs, thread 0 has
//   tile t+1's copies in flight: one 1-D bulk async copy (cp.async.bulk,
//   the TMA's linear form) per hex digit plane and per f32/i32 source,
//   completing on the stage's mbarrier.  A range whose global address,
//   shared address or size is not a multiple of 16 bytes (the tail tile, a
//   source view off a 16-byte boundary) is copied by every thread when its
//   tile comes up, words where it can, bytes where not.  Only thread 0
//   walks a tile's ranges: it records in shared memory the bytes it put in
//   flight and whether a range is left for the threads, which the others
//   read after the next barrier (a program of 26 one-column hex sources
//   has 208 ranges a tile).  Every loop walks (plane, offset): no division
//   per byte.
// - Barriers only where they are needed: encode_program sets bit k of
//   sync_mask when a later reader could take an element of instruction k's
//   output that another thread wrote.  The same-shape elementwise opcodes
//   read each element at the index the same thread wrote, so a chain runs
//   without one; ONEHOT and CROSS keep theirs, and so does the last
//   instruction (the epilogue and the fold read any element).
// - Apply epilogue: each block expands the terminals once into a column
//   map in shared memory (per output column: byte offset, row pitch,
//   conversion, or the zero word for padding; the host's
//   TileProgram.colmap, which the plain version packs from), and a thread
//   writes 16-byte stores where the output's width and base allow (scalar
//   stores elsewhere), walking (row, column) without a division and with
//   no search per element.
// - Fit: the tile's values in [0, capacity) fold into an open-addressing
//   table in shared memory (key, count, least position; FIT_SLOTS entries,
//   atomicCAS / atomicAdd / atomicMin).  At the tile's end every occupied
//   entry is flushed with one global atomicAdd and one atomicMin, neither of
//   which returns a value (no round trip; a plain read of first_pos before
//   the atomicMin measured slower).  A value that finds no entry within
//   FIT_PROBE probes takes the global atomics itself.  Both
//   combiners are order-independent, so the result is bit-exact whatever
//   the order; the hottest synthetic id (a quarter of a chunk's values)
//   costs one global atomic a tile instead of one a value.  The launcher
//   sets the accumulators first (fit_init_kernel, one pass over both).
//
// The vocabulary table is gathered from global memory (L2-resident at
// 2 MiB), not staged per tile.  The per-element rule of every opcode lives
// in ops.cuh, shared with the staged chain kernel (stage.cu).

#include <mutex>

#include "ops.cuh"

#define FIT_SLOTS 1024    // entries of the fit's shared-memory table
#define FIT_LOG2 10
#define FIT_PROBE 8
#define FIT_EMPTY (-1)

struct Slot { int kind, width, hex_width, offset; };
// a terminal: `width` columns of slot `slot` at column `col` of output `out`
struct Term { int out, slot, col, width; };

// mirrored by _program_type(limits) in repro_torch/kernels/dataflow.py
template <int NSRC, int NSLOT, int NINSTR, int NTABLE, int NOUT, int NTERM,
          int NPARAM>
struct ProgramT {
  const void* src[NSRC];
  const int* table[NTABLE];
  void* out[NOUT];
  int* first_pos;
  int* counts;
  int n_rows, tile_rows, smem_bytes, stage_bytes;
  int n_src, n_instr, n_out, n_term;
  int value_slot, capacity, aux_off;
  unsigned sync_mask[(NINSTR + 31) / 32];  // bit k: a barrier follows instr k
  int table_cap[NTABLE];
  int out_kind[NOUT];
  int out_cols[NOUT];
  Slot slot[NSLOT];
  Instr instr[NINSTR];
  Term term[NTERM];
  int param[NPARAM];

  __device__ __forceinline__ bool sync_after(int k) const {
    if constexpr (NINSTR <= 32) return (sync_mask[0] >> k) & 1u;
    else return (sync_mask[k >> 5] >> (k & 31)) & 1u;
  }
};
using Program = ProgramT<8, 24, MAX_INSTR, 4, 4, 16, MAX_PARAM>;
using WideProgram = ProgramT<128, 384, 384, 128, 16, 128, 512>;
static_assert(sizeof(Program) <= 4096, "the classic kernel parameter limit");
static_assert(sizeof(WideProgram) <= 32764, "the kernel parameter limit");

// ---- bulk async copies on an mbarrier -----------------------------------

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred P1;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, P1;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

static __device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

static __device__ __forceinline__ bool bulk_ok(const void* dst,
                                               const void* src, int bytes) {
  return ((reinterpret_cast<uintptr_t>(dst) |
           reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
}

// ---- the load stage -------------------------------------------------------

// f(dst, src, bytes) for each contiguous range of one tile's sources: one
// per hex digit plane (plane d of the tile lies tile_rows * width bytes
// after plane d-1 in shared memory), one per f32/i32 source.  `stage` is
// the ring stage the tile goes to.
template <class P, class F>
static __device__ __forceinline__ void for_each_range(const P& p,
                                                      unsigned char* stage,
                                                      int r0, int rows, F f) {
  for (int s = 0; s < p.n_src; ++s) {
    const Slot& sl = p.slot[s];
    const unsigned char* g = static_cast<const unsigned char*>(p.src[s]);
    if (sl.kind == K_HEX) {
      const size_t plane = static_cast<size_t>(p.n_rows) * sl.width;
      const int tile_plane = p.tile_rows * sl.width;
      g += static_cast<size_t>(r0) * sl.width;
      for (int d = 0; d < sl.hex_width; ++d)
        f(stage + sl.offset + d * tile_plane, g + d * plane, rows * sl.width);
    } else {
      f(stage + sl.offset, g + static_cast<size_t>(r0) * sl.width * 4,
        rows * sl.width * 4);
    }
  }
}

// Thread 0: put a tile's aligned ranges in flight on the stage's mbarrier,
// and record in `info` the bytes in flight and whether any range is left to
// copy_unaligned (every thread reads both after the next barrier, so no
// thread walks the ranges but thread 0).
template <class P>
static __device__ void issue_tile(const P& p, unsigned char* stage,
                                  int r0, int rows, uint64_t* bar,
                                  uint2* info) {
  uint32_t total = 0, by_hand = 0;
  for_each_range(p, stage, r0, rows,
                 [&](unsigned char* d, const unsigned char* g, int n) {
                   if (bulk_ok(d, g, n)) total += n;
                   else by_hand = 1;
                 });
  *info = make_uint2(total, by_hand);
  if (total == 0) return;
  // order the generic-proxy reads and writes of this stage (the tile before
  // last, behind the block's barrier) before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(bar, total);
  for_each_range(p, stage, r0, rows,
                 [&](unsigned char* d, const unsigned char* g, int n) {
                   if (bulk_ok(d, g, n)) bulk_copy(d, g, n, bar);
                 });
}

// Every thread: copy a tile's unaligned ranges.  Where the destination is
// word-aligned, each destination word comes from the two aligned source
// words it straddles (one funnel shift); the bytes past the last whole word,
// and a destination off a word boundary, go a byte at a time.
template <class P>
static __device__ void copy_unaligned(const P& p, unsigned char* stage,
                                      int r0, int rows) {
  for_each_range(p, stage, r0, rows,
                 [&](unsigned char* d, const unsigned char* g, int n) {
    if (bulk_ok(d, g, n)) return;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(d) & 3) == 0) {
      const int a = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 3);
      const unsigned* gw = reinterpret_cast<const unsigned*>(g - a);
      unsigned* dw = reinterpret_cast<unsigned*>(d);
      const int words = n >> 2;
      if (a == 0) {
        for (int i = threadIdx.x; i < words; i += blockDim.x) dw[i] = gw[i];
      } else {  // gw[i + 1] holds a byte of the range: inside its buffer
        for (int i = threadIdx.x; i < words; i += blockDim.x)
          dw[i] = __funnelshift_r(gw[i], gw[i + 1], 8 * a);
      }
      done = words << 2;
    }
    for (int i = done + threadIdx.x; i < n; i += blockDim.x) d[i] = g[i];
  });
}

// ---- the program ----------------------------------------------------------

// One shape-preserving unary opcode over n elements, the opcode a constant
// of the loop (ops.cuh's switch folds away).
template <int OP>
static __device__ __forceinline__ void unary_loop(Instr in, const int* ai,
                                                  int* di, int n,
                                                  const int* params) {
  in.op = OP;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    di[i] = unary_op(in, ai[i], params);
}

// The vocabulary gather, four ids a thread in flight: the 2 MiB table is
// read through L2, and a thread's gathers are independent.
static __device__ __forceinline__ void lookup_loop(const int* tbl, int cap,
                                                   const int* ai, int* di,
                                                   int n) {
  const int step = blockDim.x;
  int i = threadIdx.x;
  for (; i + 3 * step < n; i += 4 * step) {
    int x[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = ai[i + u * step];
      x[u] = (x[u] < 0) ? 0 : ((x[u] >= cap) ? cap - 1 : x[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(tbl + x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) di[i + u * step] = v[u];
  }
  for (; i < n; i += step) {
    int x = ai[i];
    x = (x < 0) ? 0 : ((x >= cap) ? cap - 1 : x);
    di[i] = __ldg(tbl + x);
  }
}

// Run every instruction over the tile.  A source slot lives in the ring
// stage `shift` bytes past its stage-0 offset; every other slot has one
// copy.  Each thread owns whole elements, so an instruction may write in
// place over its own input.
template <class P>
static __device__ void run_program(const P& p, unsigned char* sm,
                                   int shift, int rows) {
  for (int k = 0; k < p.n_instr; ++k) {
    const Instr& in = p.instr[k];
    const Slot& D = p.slot[in.dst];
    const Slot& A = p.slot[in.a];
    const int n = rows * D.width;
    float* df = reinterpret_cast<float*>(sm + D.offset);
    int* di = reinterpret_cast<int*>(sm + D.offset);
    const unsigned char* ab = sm + A.offset + (in.a < p.n_src ? shift : 0);
    const int* ai = reinterpret_cast<const int*>(ab);
    switch (in.op) {
      case OP_ONEHOT: {  // element i of A expands to D[i * depth + j]
        const int na = rows * A.width;
        for (int i = threadIdx.x; i < na; i += blockDim.x) {
          const int x = ai[i];
          for (int j = 0; j < in.i0; ++j)
            df[i * in.i0 + j] = (x == j) ? 1.0f : 0.0f;
        }
        break;
      }
      case OP_HEX2INT: {
        const int plane = p.tile_rows * A.width;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = hex2int(ab + i, plane, A.hex_width);
        break;
      }
      case OP_CROSS: {
        const int* bi = reinterpret_cast<const int*>(
            sm + p.slot[in.b].offset + (in.b < p.n_src ? shift : 0));
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = cross32(ai[i], bi[i], in.i0);
        break;
      }
      case OP_LOOKUP:
        lookup_loop(p.table[in.i0], p.table_cap[in.i0], ai, di, n);
        break;
      case OP_FILL_F32: unary_loop<OP_FILL_F32>(in, ai, di, n, p.param); break;
      case OP_FILL_I32: unary_loop<OP_FILL_I32>(in, ai, di, n, p.param); break;
      case OP_CLAMP: unary_loop<OP_CLAMP>(in, ai, di, n, p.param); break;
      case OP_LOG1P: unary_loop<OP_LOG1P>(in, ai, di, n, p.param); break;
      case OP_BUCKET_F32:
        unary_loop<OP_BUCKET_F32>(in, ai, di, n, p.param);
        break;
      case OP_BUCKET_I32:
        unary_loop<OP_BUCKET_I32>(in, ai, di, n, p.param);
        break;
      case OP_MOD: unary_loop<OP_MOD>(in, ai, di, n, p.param); break;
      case OP_SIGRID: unary_loop<OP_SIGRID>(in, ai, di, n, p.param); break;
      default: break;
    }
    if (p.sync_after(k)) __syncthreads();
  }
}

// ---- the apply epilogue ---------------------------------------------------

// Expand the terminals into the column map in shared memory, every
// output's columns in order: per column the byte offset of row 0, and (row
// pitch | conversion << 16 | is-source << 18 | is-float << 19).  The
// conversion is 0 (same kind), 1 (int -> f32), 2 (f32 -> int) or 3 (an
// output of another kind: the raw word, cast at the store by cast_out).  A
// padding column reads the zero word after the map.
template <class P>
static __device__ void expand_colmap(const P& p, unsigned char* sm) {
  int2* map = reinterpret_cast<int2*>(sm + p.aux_off);
  int n_cols = 0;
  for (int o = 0; o < p.n_out; ++o) n_cols += p.out_cols[o];
  const int zero_off = p.aux_off + 8 * n_cols;
  int base = 0;
  for (int o = 0; o < p.n_out; ++o) {
    int used = 0;  // the terminals fill columns [0, used) of output o
    for (int t = 0; t < p.n_term; ++t) {
      const Term& T = p.term[t];
      if (T.out != o) continue;
      const Slot& S = p.slot[T.slot];
      const int ok = p.out_kind[o];
      const int conv = (ok != K_F32 && ok != K_I32) ? 3
                       : (ok == S.kind) ? 0 : (ok == K_F32 ? 1 : 2);
      const int y = 4 * S.width | conv << 16 |
                    (T.slot < p.n_src ? 1 : 0) << 18 |
                    (S.kind == K_F32 ? 1 : 0) << 19;
      for (int c = threadIdx.x; c < T.width; c += blockDim.x)
        map[base + T.col + c] = make_int2(S.offset + 4 * c, y);
      used = T.col + T.width;
    }
    for (int c = used + threadIdx.x; c < p.out_cols[o]; c += blockDim.x)
      map[base + c] = make_int2(zero_off, 0);
    base += p.out_cols[o];
  }
  if (threadIdx.x == 0) *reinterpret_cast<int*>(sm + zero_off) = 0;
}

// One output element: the 32-bit word of column entry `e` in row r, cast to
// the output's kind (float -> int truncates toward zero).
static __device__ __forceinline__ int fetch(const unsigned char* sm, int2 e,
                                            int r, int shift) {
  const int at = e.x + r * (e.y & 0xFFFF) + ((e.y >> 18) & 1) * shift;
  const int bits = *reinterpret_cast<const int*>(sm + at);
  switch ((e.y >> 16) & 3) {
    case 1: return __float_as_int(static_cast<float>(bits));
    case 2: return static_cast<int>(__int_as_float(bits));
    default: return bits;
  }
}

// The tile's rows of one output of a kind other than f32 / i32: each
// element cast_out's bits, 4 columns a store (4, 8 or 16 bytes) where the
// width and base allow, else one.
static __device__ void write_cast(const int2* m, int kind, void* out_base,
                                  int cols, const unsigned char* sm,
                                  int shift, int r0, int rows) {
  const int size = kind_size(kind);
  unsigned char* out = static_cast<unsigned char*>(out_base) +
                       static_cast<size_t>(r0) * cols * size;
  const bool vec = ((cols & 3) == 0) &&
                   ((reinterpret_cast<uintptr_t>(out_base) & 15) == 0);
  const int units = vec ? cols >> 2 : cols;
  const int total = rows * units;
  int r = threadIdx.x / units;
  int c = threadIdx.x - r * units;
  const int dr = blockDim.x / units;
  const int dc = blockDim.x - dr * units;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    if (vec) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int2 e = m[4 * c + u];
        v[u] = cast_out(kind, fetch(sm, e, r, shift), (e.y >> 19) & 1);
      }
      if (size == 4)
        reinterpret_cast<uint4*>(out)[i] = make_uint4(v[0], v[1], v[2], v[3]);
      else if (size == 2)
        reinterpret_cast<uint2*>(out)[i] =
            make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
      else
        reinterpret_cast<uint32_t*>(out)[i] =
            v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
    } else {
      const int2 e = m[c];
      store_out(out, i, kind,
                cast_out(kind, fetch(sm, e, r, shift), (e.y >> 19) & 1));
    }
    c += dc;
    r += dr;
    if (c >= units) {
      c -= units;
      ++r;
    }
  }
}

// Write the tile's rows of every output.  Thread t takes units t, t +
// THREADS, ... of the tile's contiguous output (a unit is 4 columns where
// the width and base allow 16-byte stores, else one); (row, column) step
// by a fixed amount, so no unit costs a division.
template <class P>
static __device__ void write_outputs(const P& p,
                                     const unsigned char* sm, int shift,
                                     int r0, int rows) {
  const int2* map = reinterpret_cast<const int2*>(sm + p.aux_off);
  for (int o = 0; o < p.n_out; ++o) {
    const int cols = p.out_cols[o];
    const int2* m = map;
    map += cols;
    if (p.out_kind[o] != K_F32 && p.out_kind[o] != K_I32) {
      write_cast(m, p.out_kind[o], p.out[o], cols, sm, shift, r0, rows);
      continue;
    }
    unsigned char* out = static_cast<unsigned char*>(p.out[o]) +
                         static_cast<size_t>(r0) * cols * 4;
    const bool vec = ((cols & 3) == 0) &&
                     ((reinterpret_cast<uintptr_t>(p.out[o]) & 15) == 0);
    const int units = vec ? cols >> 2 : cols;
    const int total = rows * units;
    int r = threadIdx.x / units;
    int c = threadIdx.x - r * units;
    const int dr = blockDim.x / units;
    const int dc = blockDim.x - dr * units;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      if (vec) {
        const int2* e = m + 4 * c;
        reinterpret_cast<int4*>(out)[i] =
            make_int4(fetch(sm, e[0], r, shift), fetch(sm, e[1], r, shift),
                      fetch(sm, e[2], r, shift), fetch(sm, e[3], r, shift));
      } else {
        reinterpret_cast<int*>(out)[i] = fetch(sm, m[c], r, shift);
      }
      c += dc;
      r += dr;
      if (c >= units) {
        c -= units;
        ++r;
      }
    }
  }
}

// ---- the fit fold -----------------------------------------------------------

template <class P>
static __device__ void clear_table(const P& p, unsigned char* sm) {
  int* key = reinterpret_cast<int*>(sm + p.aux_off);
  for (int h = threadIdx.x; h < FIT_SLOTS; h += blockDim.x) {
    key[h] = FIT_EMPTY;
    key[FIT_SLOTS + h] = 0;
    key[2 * FIT_SLOTS + h] = INT_MAX;
  }
}

// Count value v at position `at` in the shared table; false if no entry
// within FIT_PROBE probes holds v or is free.  A plain read skips the CAS
// on a taken entry and the atomicMin on a settled position.
static __device__ __forceinline__ bool table_add(int* key, int v, int at) {
  volatile int* vkey = key;
  int* cnt = key + FIT_SLOTS;
  int* pos = key + 2 * FIT_SLOTS;
  uint32_t h = (static_cast<uint32_t>(v) * 2654435761u) >> (32 - FIT_LOG2);
  for (int probe = 0; probe < FIT_PROBE; ++probe) {
    int k = vkey[h];
    if (k == FIT_EMPTY) {
      k = atomicCAS(key + h, FIT_EMPTY, v);
      if (k == FIT_EMPTY) k = v;
    }
    if (k == v) {
      atomicAdd(cnt + h, 1);
      if (static_cast<volatile int*>(pos)[h] > at) atomicMin(pos + h, at);
      return true;
    }
    h = (h + 1) & (FIT_SLOTS - 1);
  }
  return false;
}

template <class P>
static __device__ void fit_fold(const P& p, unsigned char* sm,
                                int shift, int r0, int rows) {
  int* key = reinterpret_cast<int*>(sm + p.aux_off);
  const Slot& V = p.slot[p.value_slot];
  const int* vals = reinterpret_cast<const int*>(
      sm + V.offset + (p.value_slot < p.n_src ? shift : 0));
  const int n = rows * V.width;
  const int base = r0 * V.width;  // global row-major position of the tile
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = vals[i];
    if (v < 0 || v >= p.capacity) continue;
    const int at = base + i;
    if (!table_add(key, v, at)) {
      atomicMin(p.first_pos + v, at);
      atomicAdd(p.counts + v, 1);
    }
  }
  __syncthreads();
  int* cnt = key + FIT_SLOTS;
  int* pos = key + 2 * FIT_SLOTS;
  for (int h = threadIdx.x; h < FIT_SLOTS; h += blockDim.x) {
    const int k = key[h];
    if (k == FIT_EMPTY) continue;
    atomicAdd(p.counts + k, cnt[h]);
    atomicMin(p.first_pos + k, pos[h]);
    key[h] = FIT_EMPTY;  // each thread resets the entries it flushed
    cnt[h] = 0;
    pos[h] = INT_MAX;
  }
}

// ---- the tile loop ----------------------------------------------------------

template <bool FIT, class P>
static __device__ __forceinline__ void run_tiles(const P& p) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ uint2 info[2];  // per stage: bytes in flight, ranges by hand
  const int n_tiles = (p.n_rows + p.tile_rows - 1) / p.tile_rows;
  if (FIT) clear_table(p, sm);
  else expand_colmap(p, sm);
  int tile = blockIdx.x;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tile < n_tiles) {
      const int r0 = tile * p.tile_rows;
      issue_tile(p, sm, r0, min(p.tile_rows, p.n_rows - r0), &bar[0],
                 &info[0]);
    }
  }
  __syncthreads();
  uint32_t parity = 0;  // bit s: the phase stage s's barrier completes next
  for (int k = 0; tile < n_tiles; tile += gridDim.x, ++k) {
    const int s = k & 1;
    const int shift = s * p.stage_bytes;
    const int r0 = tile * p.tile_rows;
    const int rows = min(p.tile_rows, p.n_rows - r0);
    // every thread is done with the tile before (its stage, the
    // intermediates, the fit table), and info[s] is written
    __syncthreads();
    const int next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) {  // before the wait: thread 0's
      const int n0 = next * p.tile_rows;       // issue overlaps it
      issue_tile(p, sm + (shift ^ p.stage_bytes), n0,
                 min(p.tile_rows, p.n_rows - n0), &bar[s ^ 1],
                 &info[s ^ 1]);
    }
    const uint2 in = info[s];
    if (in.x) {  // the tile's bulk copies have landed
      mbar_wait(&bar[s], (parity >> s) & 1u);
      parity ^= 1u << s;
    }
    if (in.y) {  // and its other ranges, by every thread
      copy_unaligned(p, sm + shift, r0, rows);
      __syncthreads();
    }
    run_program(p, sm, shift, rows);
    if (FIT) fit_fold(p, sm, shift, r0, rows);
    else write_outputs(p, sm, shift, r0, rows);
  }
}

__global__ void __launch_bounds__(THREADS)
fit_init_kernel(int* __restrict__ first_pos, int* __restrict__ counts,
                int n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    first_pos[i] = INT_MAX;
    counts[i] = 0;
  }
}

// At least RESIDENT blocks an SM: shared memory holds four of Pipeline
// III's, so up to 64 registers a thread cost no residency (without it
// ptxas aims at eight blocks, 32 registers, and spills).
#define RESIDENT 4

template <class P>
__global__ void __launch_bounds__(THREADS, RESIDENT)
apply_kernel(const __grid_constant__ P p) {
  run_tiles<false>(p);
}

template <class P>
__global__ void __launch_bounds__(THREADS, RESIDENT)
fit_kernel(const __grid_constant__ P p) {
  run_tiles<true>(p);
}

// Resident blocks on the whole card (blocks an SM holds x SMs), per kernel,
// shared-memory size and device: the occupancy query costs more than the
// launch, so its answer is kept.  The kernel's dynamic shared-memory cap is
// set once to all a block may opt into, so no launch depends on the size
// another program set before it.
static cudaError_t resident_blocks(const void* kernel, int smem,
                                   int* blocks) {
  struct Entry { const void* kernel; int device, smem, blocks; };
  static std::mutex lock;
  static Entry seen[8];
  static int next = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& s : seen)
    if (s.kernel == kernel && s.device == device && s.smem == smem) {
      *blocks = s.blocks;
      return cudaSuccess;
    }
  int optin = 0, per_sm = 0, sms = 0;
  cudaFuncAttributes attr;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  seen[next] = Entry{kernel, device, smem, per_sm * sms};
  next = (next + 1) % 8;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The persistent grid: min(tiles, resident blocks).  The fit first sets its
// accumulators (first_pos to ABSENT32 = INT_MAX, counts to 0) in one pass.
template <class P>
static int launch(bool fit, const P* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fit && p->capacity > 0) {
    fit_init_kernel<<<grid_blocks(p->capacity), THREADS, 0, s>>>(
        p->first_pos, p->counts, p->capacity);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_tiles = (p->n_rows + p->tile_rows - 1) / p->tile_rows;
  if (n_tiles == 0) return 0;
  const void* kernel = fit ? reinterpret_cast<const void*>(fit_kernel<P>)
                           : reinterpret_cast<const void*>(apply_kernel<P>);
  int blocks = 0;
  const cudaError_t e = resident_blocks(kernel, p->smem_bytes, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_tiles < blocks) blocks = n_tiles;
  if (fit) fit_kernel<P><<<blocks, THREADS, p->smem_bytes, s>>>(*p);
  else apply_kernel<P><<<blocks, THREADS, p->smem_bytes, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// `program` is a Program, or a WideProgram when `wide` is nonzero.
static int launch_any(bool fit, const void* program, int wide,
                      void* stream) {
  return wide ? launch(fit, static_cast<const WideProgram*>(program), stream)
              : launch(fit, static_cast<const Program*>(program), stream);
}

extern "C" {

int launch_dataflow_apply(const void* program, int wide, void* stream) {
  return launch_any(false, program, wide, stream);
}

int launch_dataflow_fit(const void* program, int wide, void* stream) {
  return launch_any(true, program, wide, stream);
}

int dataflow_program_size(int wide) {
  return static_cast<int>(wide ? sizeof(WideProgram) : sizeof(Program));
}

const char* dataflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
