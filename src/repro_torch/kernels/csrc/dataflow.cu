// Streaming dataflow kernels for Hopper (sm_90a): one tile-program
// interpreter serves every ETL pipeline.
//
// Replaces the Pallas kernels of src/repro/kernels/dataflow.py:
//   apply_kernel  <- make_group_dataflow (l.367) and make_output_dataflow
//                    (l.299): the TileStep program over a row tile, then the
//                    packer epilogue of every output (n_out >= 1);
//   fit_kernel    <- make_fit_dataflow (l.440): the same program, then the
//                    chunk first-occurrence / count build with atomics.
//
// The program (slots, instructions, terminals) is encoded on the host by
// repro_torch/kernels/dataflow.py and passed by value as one struct; no
// per-launch copy to the device.  A thread block takes one tile of rows,
// loads every source tile into shared memory, runs the instructions with a
// barrier between them, and ends in its epilogue.  Intermediates never
// leave shared memory.
//
// Bound on an H100: bytes (raw sources in once, packed outputs out once; a
// few integer operations per byte).  The vocabulary table is gathered from
// global memory (L2-resident at 2 MiB), not staged per tile.  Fit atomics
// contend on hot ids; both combiners (min, add) are order-independent, so the
// result is bit-exact whatever the order.
//
// Semantics follow the JAX package bit for bit: Clamp is written with
// comparisons so NaN propagates (fmaxf would drop it), Modulus is a
// positive mod, Hex2Int decodes non-hex bytes as c-87 / c-55 / c-48 OR'd in
// as uint32, and no fast-math flag is used.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define MAX_SRC 8
#define MAX_SLOT 24
#define MAX_INSTR 32
#define MAX_TABLE 4
#define MAX_OUT 4
#define MAX_TERM 16
#define MAX_PARAM 64
#define THREADS 256

enum Kind { K_F32 = 0, K_I32 = 1, K_HEX = 2 };

// mirrored by the OP_* constants in repro_torch/core/operators.py
enum Op {
  OP_FILL_F32 = 1, OP_FILL_I32 = 2, OP_CLAMP = 3, OP_LOG1P = 4,
  OP_BUCKET_F32 = 5, OP_BUCKET_I32 = 6, OP_ONEHOT = 7, OP_HEX2INT = 8,
  OP_MOD = 9, OP_SIGRID = 10, OP_CROSS = 11, OP_LOOKUP = 12
};

struct Slot { int kind, width, hex_width, offset; };
struct Instr { int op, dst, a, b, i0, i1; float f0, f1; };
struct Term { int out, slot, col, width; };

// mirrored by _CProgram in repro_torch/kernels/dataflow.py
struct Program {
  const void* src[MAX_SRC];
  const int* table[MAX_TABLE];
  void* out[MAX_OUT];
  int* first_pos;
  int* counts;
  int n_rows, tile_rows, smem_bytes, n_src;
  int n_slot, n_instr, n_table, n_out;
  int n_term, n_param, value_slot, capacity;
  int table_cap[MAX_TABLE];
  int out_kind[MAX_OUT];
  int out_cols[MAX_OUT];
  Slot slot[MAX_SLOT];
  Instr instr[MAX_INSTR];
  Term term[MAX_TERM];
  int param[MAX_PARAM];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Copy this tile's rows of every source into its shared-memory slot.
// Hex sources are digit-major: plane d of the tile holds rows*width bytes.
__device__ void load_sources(const Program& p, unsigned char* sm, int r0,
                             int rows) {
  for (int s = 0; s < p.n_src; ++s) {
    const Slot& sl = p.slot[s];
    const int plane = rows * sl.width;
    if (sl.kind == K_HEX) {
      const uint8_t* g = static_cast<const uint8_t*>(p.src[s]);
      uint8_t* d = sm + sl.offset;
      const int total = plane * sl.hex_width;
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int dg = i / plane;
        const int rem = i - dg * plane;
        d[i] = g[(size_t)dg * p.n_rows * sl.width + (size_t)r0 * sl.width + rem];
      }
    } else {
      const int* g = static_cast<const int*>(p.src[s]) + (size_t)r0 * sl.width;
      int* d = reinterpret_cast<int*>(sm + sl.offset);
      for (int i = threadIdx.x; i < plane; i += blockDim.x) d[i] = g[i];
    }
  }
}

// Run every instruction over the tile; each thread owns whole elements, so
// an instruction may write in place over its own input.
__device__ void run_program(const Program& p, unsigned char* sm, int rows) {
  for (int k = 0; k < p.n_instr; ++k) {
    const Instr in = p.instr[k];
    const Slot D = p.slot[in.dst];
    const Slot A = p.slot[in.a];
    const int n = rows * D.width;
    float* df = reinterpret_cast<float*>(sm + D.offset);
    int* di = reinterpret_cast<int*>(sm + D.offset);
    const float* af = reinterpret_cast<const float*>(sm + A.offset);
    const int* ai = reinterpret_cast<const int*>(sm + A.offset);
    switch (in.op) {
      case OP_FILL_F32:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const float x = af[i];
          df[i] = isnan(x) ? in.f0 : x;
        }
        break;
      case OP_FILL_I32:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const int x = ai[i];
          di[i] = (x == INT_MIN) ? in.i0 : x;
        }
        break;
      case OP_CLAMP:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          float x = af[i];
          x = (x < in.f0) ? in.f0 : x;
          if (in.i0) x = (x > in.f1) ? in.f1 : x;
          df[i] = x;
        }
        break;
      case OP_LOG1P:
        for (int i = threadIdx.x; i < n; i += blockDim.x) df[i] = log1pf(af[i]);
        break;
      case OP_BUCKET_F32:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const float x = af[i];
          int c = 0;
          for (int j = 0; j < in.i1; ++j)
            c += (x >= __int_as_float(p.param[in.i0 + j])) ? 1 : 0;
          di[i] = c;
        }
        break;
      case OP_BUCKET_I32:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const int x = ai[i];
          int c = 0;
          for (int j = 0; j < in.i1; ++j) c += (x >= p.param[in.i0 + j]) ? 1 : 0;
          di[i] = c;
        }
        break;
      case OP_ONEHOT:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const int r = i / D.width;
          const int k2 = i - r * D.width;
          const int c = k2 / in.i0;
          const int j = k2 - c * in.i0;
          df[i] = (ai[r * A.width + c] == j) ? 1.0f : 0.0f;
        }
        break;
      case OP_HEX2INT: {
        const uint8_t* ab = sm + A.offset;
        const int plane = rows * A.width;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          bool missing = true;
          uint32_t v = 0;
          for (int d = 0; d < A.hex_width; ++d) {
            int c = ab[d * plane + i];
            if (c != 0) missing = false; else c = 48;
            const int dig = (c >= 97) ? c - 87 : ((c >= 65) ? c - 55 : c - 48);
            v = (v << 4) | static_cast<uint32_t>(dig);
          }
          di[i] = missing ? INT_MIN : static_cast<int>(v);
        }
        break;
      }
      case OP_MOD:
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          int r = ai[i] % in.i0;
          di[i] = (r < 0) ? r + in.i0 : r;
        }
        break;
      case OP_SIGRID:
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = static_cast<int>(mix32(static_cast<uint32_t>(ai[i])) %
                                   static_cast<uint32_t>(in.i0));
        break;
      case OP_CROSS: {
        const int* bi = reinterpret_cast<const int*>(sm + p.slot[in.b].offset);
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const uint32_t ha = mix32(static_cast<uint32_t>(ai[i]));
          const uint32_t hb = mix32(static_cast<uint32_t>(bi[i]));
          const uint32_t h = mix32(ha ^ (hb * 0x9E3779B1u));
          di[i] = static_cast<int>(h % static_cast<uint32_t>(in.i0));
        }
        break;
      }
      case OP_LOOKUP: {
        const int* tbl = p.table[in.i0];
        const int cap = p.table_cap[in.i0];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          int x = ai[i];
          x = (x < 0) ? 0 : ((x >= cap) ? cap - 1 : x);
          di[i] = __ldg(tbl + x);
        }
        break;
      }
      default:
        break;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) apply_kernel(const Program p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int r0 = blockIdx.x * p.tile_rows;
  const int rows = min(p.tile_rows, p.n_rows - r0);
  load_sources(p, sm, r0, rows);
  __syncthreads();
  run_program(p, sm, rows);
  // packer epilogue: every column of every output, zero in the padding
  for (int o = 0; o < p.n_out; ++o) {
    const int cols = p.out_cols[o];
    const int total = rows * cols;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      int slot = -1, col = 0;
      for (int t = 0; t < p.n_term; ++t) {
        const Term& T = p.term[t];
        if (T.out == o && c >= T.col && c < T.col + T.width) {
          slot = T.slot;
          col = c - T.col;
        }
      }
      const size_t g = (size_t)(r0 + r) * cols + c;
      if (p.out_kind[o] == K_F32) {
        float v = 0.0f;
        if (slot >= 0) {
          const Slot& S = p.slot[slot];
          const int e = r * S.width + col;
          v = (S.kind == K_F32) ? reinterpret_cast<const float*>(sm + S.offset)[e]
                                : static_cast<float>(
                                      reinterpret_cast<const int*>(sm + S.offset)[e]);
        }
        static_cast<float*>(p.out[o])[g] = v;
      } else {
        int v = 0;
        if (slot >= 0) {
          const Slot& S = p.slot[slot];
          const int e = r * S.width + col;
          v = (S.kind == K_I32) ? reinterpret_cast<const int*>(sm + S.offset)[e]
                                : static_cast<int>(
                                      reinterpret_cast<const float*>(sm + S.offset)[e]);
        }
        static_cast<int*>(p.out[o])[g] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) fit_kernel(const Program p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int r0 = blockIdx.x * p.tile_rows;
  const int rows = min(p.tile_rows, p.n_rows - r0);
  load_sources(p, sm, r0, rows);
  __syncthreads();
  run_program(p, sm, rows);
  const Slot& V = p.slot[p.value_slot];
  const int* vals = reinterpret_cast<const int*>(sm + V.offset);
  const int n = rows * V.width;
  const int base = r0 * V.width;  // global row-major position of the tile
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = vals[i];
    if (v >= 0 && v < p.capacity) {
      const int pos = base + i;
      // a plain read skips most atomics on hot ids, whose first position
      // is settled early; atomicMin keeps the result exact regardless
      if (p.first_pos[v] > pos) atomicMin(p.first_pos + v, pos);
      atomicAdd(p.counts + v, 1);
    }
  }
}

static int launch(void (*kernel)(const Program), const Program* p,
                  void* stream) {
  const int n_tiles = (p->n_rows + p->tile_rows - 1) / p->tile_rows;
  if (n_tiles == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_tiles, THREADS, p->smem_bytes, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int launch_dataflow_apply(const void* program, void* stream) {
  return launch(apply_kernel, static_cast<const Program*>(program), stream);
}

int launch_dataflow_fit(const void* program, void* stream) {
  return launch(fit_kernel, static_cast<const Program*>(program), stream);
}

int dataflow_program_size() { return static_cast<int>(sizeof(Program)); }

const char* dataflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
