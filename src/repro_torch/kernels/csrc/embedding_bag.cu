// The embedding-bag kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/embedding_bag.py:
//   bag_kernel<TableRows>  <- embedding_bag / _gather_kernel (l.113 / l.94):
//                             out[b] = sum_k table[idx[b, k]]; an index
//                             outside [0, vocab) (the -1 sentinel among
//                             them) adds nothing;
//   bag_kernel<CachedRows> <- embedding_bag_cached (l.187) with
//                             _cache_gather_kernel (l.143) and
//                             _two_level_kernel (l.154): an entry reads
//                             cache[slot] where 0 <= slot < cache_rows, else
//                             table[cold] where slot < 0 and
//                             0 <= cold < vocab, else adds nothing.  A null
//                             cold pointer is the cache-only variant, which
//                             never reads the table.
//
// The TPU kernels turn the irregular gather into dense VMEM passes over
// table partitions, a sequential grid step per partition.  Hopper has no
// VMEM of that size and no sequential grid, so rows are read from device
// memory where they lie: one warp pools one bag.  Its lanes run over dim
// (16-byte float4 loads when dim % 4 == 0 and the row bases are 16-byte
// aligned, scalar loads otherwise), k runs in order, the sum stays in f32
// registers, and each output element is written once.  Both kernels are one
// template over a row resolver and pool through the same routine
// (pool_bag), so a cached bag whose cache rows mirror the table rows is
// bit-identical to the uncached bag: the JAX package's _pool (l.59) exists
// for the same reason.  The index arrays may be column slices of a wider
// matrix ([batch, T] -> [:, t:t+1]): each takes its row stride.
//
// Bound on an H100: bytes (the ids in and the output out once, plus one
// row per distinct id: repeated hot rows come from the 50 MB L2).

#include "ops.cuh"

#define WARP 32

struct TableRows {
  const float* table;
  const int* idx;
  long long idx_stride;
  int vocab, dim;

  __device__ __forceinline__ const float* operator()(int b, int k) const {
    const int i = __ldg(idx + b * idx_stride + k);
    return (i >= 0 && i < vocab) ? table + static_cast<long long>(i) * dim
                                 : nullptr;
  }
};

struct CachedRows {
  const float* cache;
  const float* table;  // unused when cold == nullptr
  const int* slot;
  const int* cold;     // nullptr: the cache-only variant
  long long slot_stride, cold_stride;
  int cache_rows, vocab, dim;

  __device__ __forceinline__ const float* operator()(int b, int k) const {
    const int s = __ldg(slot + b * slot_stride + k);
    if (s >= 0)  // a slot never falls through, even when out of range
      return s < cache_rows ? cache + static_cast<long long>(s) * dim
                            : nullptr;
    if (cold == nullptr) return nullptr;
    const int c = __ldg(cold + b * cold_stride + k);
    return (c >= 0 && c < vocab) ? table + static_cast<long long>(c) * dim
                                 : nullptr;
  }
};

// out[b, :] = sum over k in order of rows(b, k)[:], null rows skipped.
template <class Rows>
static __device__ __forceinline__ void pool_bag(const Rows& rows, int b,
                                                int nnz, int dim, bool vec,
                                                float* __restrict__ out) {
  const int lane = threadIdx.x & (WARP - 1);
  float* dst = out + static_cast<long long>(b) * dim;
  if (vec) {
    for (int c = 4 * lane; c < dim; c += 4 * WARP) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < nnz; ++k) {
        const float* r = rows(b, k);
        if (r == nullptr) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(r + c));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(dst + c) = acc;
    }
  } else {
    for (int c = lane; c < dim; c += WARP) {
      float acc = 0.f;
      for (int k = 0; k < nnz; ++k) {
        const float* r = rows(b, k);
        if (r != nullptr) acc += __ldg(r + c);
      }
      dst[c] = acc;
    }
  }
}

// One warp per bag, THREADS / WARP bags per block.
template <class Rows>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const Rows rows, int batch, int nnz, int dim, int vec,
           float* __restrict__ out) {
  const int b = blockIdx.x * (THREADS / WARP) + threadIdx.x / WARP;
  if (b < batch) pool_bag(rows, b, nnz, dim, vec != 0, out);
}

static inline int bag_blocks(int batch) {
  return (batch + THREADS / WARP - 1) / (THREADS / WARP);
}

extern "C" {

// table: f32[vocab, dim]; idx: int32 rows of nnz at idx_stride; out:
// f32[batch, dim].  vec: every row base and out are 16-byte aligned and
// dim % 4 == 0.
int launch_embedding_bag(const void* table, const void* idx,
                         long long idx_stride, void* out, int batch, int nnz,
                         int vocab, int dim, int vec, void* stream) {
  if (batch == 0 || dim == 0) return 0;
  const TableRows rows{static_cast<const float*>(table),
                       static_cast<const int*>(idx), idx_stride, vocab, dim};
  bag_kernel<TableRows><<<bag_blocks(batch), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rows, batch, nnz, dim, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// cache: f32[cache_rows, dim]; table: f32[vocab, dim]; slot / cold: int32
// rows of nnz at their strides, cold may be null.
int launch_embedding_bag_cached(const void* cache, const void* table,
                                const void* slot, long long slot_stride,
                                const void* cold, long long cold_stride,
                                void* out, int batch, int nnz, int cache_rows,
                                int vocab, int dim, int vec, void* stream) {
  if (batch == 0 || dim == 0) return 0;
  const CachedRows rows{static_cast<const float*>(cache),
                        static_cast<const float*>(table),
                        static_cast<const int*>(slot),
                        static_cast<const int*>(cold),
                        slot_stride, cold_stride, cache_rows, vocab, dim};
  bag_kernel<CachedRows><<<bag_blocks(batch), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rows, batch, nnz, dim, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
