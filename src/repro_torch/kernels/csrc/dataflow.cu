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
// The per-element rule of every opcode lives in ops.cuh, shared with the
// staged chain kernel (stage.cu).

#include "ops.cuh"

#define MAX_SRC 8
#define MAX_SLOT 24
#define MAX_TABLE 4
#define MAX_OUT 4
#define MAX_TERM 16

struct Slot { int kind, width, hex_width, offset; };
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
    const int* ai = reinterpret_cast<const int*>(sm + A.offset);
    switch (in.op) {
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
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = hex2int(ab + i, plane, A.hex_width);
        break;
      }
      case OP_CROSS: {
        const int* bi = reinterpret_cast<const int*>(sm + p.slot[in.b].offset);
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = cross32(ai[i], bi[i], in.i0);
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
      default:  // the shape-preserving unary opcodes (ops.cuh)
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          di[i] = unary_op(in, ai[i], p.param);
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
