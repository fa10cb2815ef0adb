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
//                             never reads the table;
//   cached_row_kernel      <- the same, over every feature of a lookahead
//                             plan at once (the JAX package calls
//                             embedding_bag_cached once per feature and
//                             stacks the results, etl_runtime/lookahead.py
//                             l.513-517).
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
// cached_row_kernel takes a single-hot plan [batch, n_feat] against stacked
// tables [n_feat, vocab, dim] and caches [n_feat, cache_rows, dim] and
// writes the (batch, n_feat, dim) result in place, in one launch.  An entry
// is one row (512 bytes at dim 128), so one entry per warp would leave the
// warp waiting on three dependent loads (slot, cold, row) for each 512
// bytes it writes.  Here a warp takes 32 consecutive entries: each lane
// loads its entry's slot and cold ids (one coalesced load each when the
// plan's rows are contiguous) and resolves its row pointer; the warp then
// walks the entries ROW_GROUP at a time with the pointers broadcast by
// __shfl_sync, issuing all ROW_GROUP row loads (one float4 per lane = one
// 512-byte row) before the first store, so each warp keeps ROW_GROUP rows
// in flight.  The output is written once and never read here, so its
// stores are streaming (__stcs) and leave L2 to the hot cache rows.  The
// grid is sized to the work: one 32-entry chunk a warp.  It needs the
// plan's size to fill the card (at 65536 entries, one feature, it runs
// 256 blocks and the warp-per-bag kernel is faster), so the single-feature
// call stays on bag_kernel<CachedRows>.  Each output element is 0.0f plus
// its row, as pool_bag sums, so out[:, t] equals the single-feature bag of
// feature t bit for bit.  A row is never copied as bytes: 0.0f + -0.0f is
// +0.0f, as in the plain version.
//
// Tables of float32, float16 or bfloat16 (T): rows are read in T, every sum
// runs in float32 in the one order above, and each output element is
// rounded to T once, to nearest even, at its store (the JAX package sums a
// 16-bit bag in float32 too: jnp.sum upcasts).  The plain versions round
// the same float32 sum, so each bag equals its plain version bit for bit
// on the card and cached == uncached holds at every dtype.  The vector path
// loads 4 elements at once (16 bytes of f32, 8 of a 16-bit type) when dim %
// 4 == 0 and the row bases are aligned to that.
//
// Bound on an H100: bytes (the ids in and the output out once, plus one
// row per distinct id: repeated hot rows come from the 50 MB L2).

#include "ops.cuh"

#define WARP 32

// Element I/O of a table of T: four consecutive elements as a float4 (from
// 4 * sizeof(T) aligned bytes) or one as a float; stores round to T.
template <class T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void store4_stream(float* p, float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ void store1(float* p, float v) {
    *p = v;
  }
  static __device__ __forceinline__ void store1_stream(float* p, float v) {
    __stcs(p, v);
  }
};

// The 16-bit types: raw 16-bit patterns move as uint2 (4 elements) or
// unsigned short; conversions are the cuda_fp16 / cuda_bf16 intrinsics.
template <class T, class Ops>
struct Elem16 {
  static __device__ __forceinline__ float4 load4(const T* p) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(Ops::to_f(r.x & 0xFFFFu), Ops::to_f(r.x >> 16),
                       Ops::to_f(r.y & 0xFFFFu), Ops::to_f(r.y >> 16));
  }
  static __device__ __forceinline__ float load1(const T* p) {
    return Ops::to_f(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ uint2 pack(float4 v) {
    return make_uint2(Ops::from_f(v.x) | Ops::from_f(v.y) << 16,
                      Ops::from_f(v.z) | Ops::from_f(v.w) << 16);
  }
  static __device__ __forceinline__ void store4(T* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = pack(v);
  }
  static __device__ __forceinline__ void store4_stream(T* p, float4 v) {
    __stcs(reinterpret_cast<uint2*>(p), pack(v));
  }
  static __device__ __forceinline__ void store1(T* p, float v) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(Ops::from_f(v));
  }
  static __device__ __forceinline__ void store1_stream(T* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(Ops::from_f(v)));
  }
};

struct HalfOps {
  static __device__ __forceinline__ float to_f(unsigned b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  static __device__ __forceinline__ unsigned from_f(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

struct Bf16Ops {
  static __device__ __forceinline__ float to_f(unsigned b) {
    return __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(b)));
  }
  static __device__ __forceinline__ unsigned from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <>
struct Elem<__half> : Elem16<__half, HalfOps> {};
template <>
struct Elem<__nv_bfloat16> : Elem16<__nv_bfloat16, Bf16Ops> {};

template <class T>
struct TableRows {
  const T* table;
  const int* idx;
  long long idx_stride;
  int vocab, dim;

  __device__ __forceinline__ const T* operator()(int b, int k) const {
    const int i = __ldg(idx + b * idx_stride + k);
    return (i >= 0 && i < vocab) ? table + static_cast<long long>(i) * dim
                                 : nullptr;
  }
};

template <class T>
struct CachedRows {
  const T* cache;
  const T* table;      // unused when cold == nullptr
  const int* slot;
  const int* cold;     // nullptr: the cache-only variant
  long long slot_stride, cold_stride;
  int cache_rows, vocab, dim;

  __device__ __forceinline__ const T* operator()(int b, int k) const {
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

// out[b, :] = sum over k in order of rows(b, k)[:], null rows skipped,
// summed in float32 and rounded to T at the store.
template <class T, class Rows>
static __device__ __forceinline__ void pool_bag(const Rows& rows, int b,
                                                int nnz, int dim, bool vec,
                                                T* __restrict__ out) {
  const int lane = threadIdx.x & (WARP - 1);
  T* dst = out + static_cast<long long>(b) * dim;
  if (vec) {
    for (int c = 4 * lane; c < dim; c += 4 * WARP) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < nnz; ++k) {
        const T* r = rows(b, k);
        if (r == nullptr) continue;
        const float4 v = Elem<T>::load4(r + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      Elem<T>::store4(dst + c, acc);
    }
  } else {
    for (int c = lane; c < dim; c += WARP) {
      float acc = 0.f;
      for (int k = 0; k < nnz; ++k) {
        const T* r = rows(b, k);
        if (r != nullptr) acc += Elem<T>::load1(r + c);
      }
      Elem<T>::store1(dst + c, acc);
    }
  }
}

// One warp per bag, THREADS / WARP bags per block.
template <class T, class Rows>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const Rows rows, int batch, int nnz, int dim, int vec,
           T* __restrict__ out) {
  const int b = blockIdx.x * (THREADS / WARP) + threadIdx.x / WARP;
  if (b < batch) pool_bag<T>(rows, b, nnz, dim, vec != 0, out);
}

static inline int bag_blocks(int batch) {
  return (batch + THREADS / WARP - 1) / (THREADS / WARP);
}

#define ROW_GROUP 8  // rows a lane has in flight

// Entry e = b * n_feat + t of a single-hot plan: its row of feature t.
template <class T>
struct CachedEntries {
  const T* cache;      // feature t at t * cache_stride: [cache_rows, dim]
  const T* table;      // feature t at t * table_stride: [vocab, dim]
  const int* slot;     // slot[b * slot_b + t * slot_t]
  const int* cold;     // cold[b * cold_b + t * cold_t]
  long long cache_stride, table_stride, slot_b, slot_t, cold_b, cold_t;
  int n_feat, cache_rows, vocab, dim;

  // nullptr where the entry adds nothing
  __device__ __forceinline__ const T* row(int e) const {
    const long long b = e / n_feat;
    const long long t = e - b * n_feat;
    const int s = __ldg(slot + b * slot_b + t * slot_t);
    if (s >= 0)  // a slot never falls through, even when out of range
      return s < cache_rows
                 ? cache + t * cache_stride + static_cast<long long>(s) * dim
                 : nullptr;
    const int c = __ldg(cold + b * cold_b + t * cold_t);
    return (c >= 0 && c < vocab)
               ? table + t * table_stride + static_cast<long long>(c) * dim
               : nullptr;
  }
};

// V: float4 (4 elements a lane) or float (one).
template <class T>
static __device__ __forceinline__ void load_row(const T* p, float4& v) {
  v = Elem<T>::load4(p);
}
template <class T>
static __device__ __forceinline__ void load_row(const T* p, float& v) {
  v = Elem<T>::load1(p);
}
template <class T>
static __device__ __forceinline__ void store_stream(T* p, float4 v) {
  Elem<T>::store4_stream(p, v);
}
template <class T>
static __device__ __forceinline__ void store_stream(T* p, float v) {
  Elem<T>::store1_stream(p, v);
}
// 0.0f + v, as pool_bag starts its sum: -0.0f becomes +0.0f
static __device__ __forceinline__ float4 from_zero(float4 v) {
  return make_float4(0.f + v.x, 0.f + v.y, 0.f + v.z, 0.f + v.w);
}
static __device__ __forceinline__ float from_zero(float v) { return 0.f + v; }

template <class T>
static __device__ __forceinline__ const T* shfl_ptr(const T* p, int src) {
  return reinterpret_cast<const T*>(__shfl_sync(
      0xffffffffu, reinterpret_cast<long long>(p), src));
}

// One 32-entry chunk a warp.  V = float4 (dim % 4 == 0, aligned rows and
// out) or float.  Every loop bound a __shfl_sync sits in is uniform across
// the warp, and so is the early return.
template <class T, class V>
__global__ void __launch_bounds__(THREADS)
cached_row_kernel(const CachedEntries<T> p, int n_entries,
                  T* __restrict__ out) {
  constexpr int W = sizeof(V) / sizeof(float);
  const int lane = threadIdx.x & (WARP - 1);
  const int e0 = (blockIdx.x * THREADS + threadIdx.x) / WARP * WARP;
  if (e0 >= n_entries) return;
  const int count = n_entries - e0 < WARP ? n_entries - e0 : WARP;
  // the row of the entry whose ids this lane loads
  const T* mine = lane < count ? p.row(e0 + lane) : nullptr;
  for (int g = 0; g < count; g += ROW_GROUP) {
    for (int c0 = 0; c0 < p.dim; c0 += W * WARP) {
      const int c = c0 + W * lane;
      V v[ROW_GROUP];
#pragma unroll
      for (int u = 0; u < ROW_GROUP; ++u) {
        const T* r = shfl_ptr(mine, g + u);
        v[u] = V{};
        if (r != nullptr && c < p.dim) load_row(r + c, v[u]);
      }
      if (c < p.dim) {
#pragma unroll
        for (int u = 0; u < ROW_GROUP; ++u)
          if (g + u < count)
            store_stream(out + static_cast<long long>(e0 + g + u) * p.dim + c,
                         from_zero(v[u]));
      }
    }
  }
}

// dtype codes of the table (mirrored in repro_torch/kernels/embedding_bag.py)
enum BagDtype { BAG_F32 = 0, BAG_F16 = 1, BAG_BF16 = 2 };

template <class T>
static int bag(const void* table, const void* idx, long long idx_stride,
               void* out, int batch, int nnz, int vocab, int dim, int vec,
               cudaStream_t s) {
  const TableRows<T> rows{static_cast<const T*>(table),
                          static_cast<const int*>(idx), idx_stride, vocab,
                          dim};
  bag_kernel<T><<<bag_blocks(batch), THREADS, 0, s>>>(
      rows, batch, nnz, dim, vec, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static int bag_cached(const void* cache, const void* table, const void* slot,
                      long long slot_stride, const void* cold,
                      long long cold_stride, void* out, int batch, int nnz,
                      int cache_rows, int vocab, int dim, int vec,
                      cudaStream_t s) {
  const CachedRows<T> rows{static_cast<const T*>(cache),
                           static_cast<const T*>(table),
                           static_cast<const int*>(slot),
                           static_cast<const int*>(cold),
                           slot_stride, cold_stride, cache_rows, vocab, dim};
  bag_kernel<T><<<bag_blocks(batch), THREADS, 0, s>>>(
      rows, batch, nnz, dim, vec, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static int bag_stacked(const void* cache, long long cache_stride,
                       const void* table, long long table_stride,
                       const void* slot, long long slot_b, long long slot_t,
                       const void* cold, long long cold_b, long long cold_t,
                       void* out, int batch, int n_feat, int cache_rows,
                       int vocab, int dim, int vec, cudaStream_t s) {
  const CachedEntries<T> p{static_cast<const T*>(cache),
                           static_cast<const T*>(table),
                           static_cast<const int*>(slot),
                           static_cast<const int*>(cold),
                           cache_stride, table_stride, slot_b, slot_t, cold_b,
                           cold_t, n_feat, cache_rows, vocab, dim};
  const long long n_entries = static_cast<long long>(batch) * n_feat;
  const int n = static_cast<int>(n_entries);
  const int blocks = static_cast<int>((n_entries + THREADS - 1) / THREADS);
  T* o = static_cast<T*>(out);
  if (vec)
    cached_row_kernel<T, float4><<<blocks, THREADS, 0, s>>>(p, n, o);
  else
    cached_row_kernel<T, float><<<blocks, THREADS, 0, s>>>(p, n, o);
  return static_cast<int>(cudaGetLastError());
}

#define BY_DTYPE(dtype, call)                                     \
  ((dtype) == BAG_F16 ? call<__half>                              \
   : (dtype) == BAG_BF16 ? call<__nv_bfloat16> : call<float>)

extern "C" {

// table: T[vocab, dim] (T by `dtype`); idx: int32 rows of nnz at
// idx_stride; out: T[batch, dim].  vec: every row base and out are aligned
// to 4 elements and dim % 4 == 0.
int launch_embedding_bag(const void* table, const void* idx,
                         long long idx_stride, void* out, int batch, int nnz,
                         int vocab, int dim, int vec, int dtype,
                         void* stream) {
  if (batch == 0 || dim == 0) return 0;
  return BY_DTYPE(dtype, bag)(table, idx, idx_stride, out, batch, nnz, vocab,
                              dim, vec, static_cast<cudaStream_t>(stream));
}

// cache: T[cache_rows, dim]; table: T[vocab, dim]; slot / cold: int32 rows
// of nnz at their strides, cold may be null.
int launch_embedding_bag_cached(const void* cache, const void* table,
                                const void* slot, long long slot_stride,
                                const void* cold, long long cold_stride,
                                void* out, int batch, int nnz, int cache_rows,
                                int vocab, int dim, int vec, int dtype,
                                void* stream) {
  if (batch == 0 || dim == 0) return 0;
  return BY_DTYPE(dtype, bag_cached)(
      cache, table, slot, slot_stride, cold, cold_stride, out, batch, nnz,
      cache_rows, vocab, dim, vec, static_cast<cudaStream_t>(stream));
}

// Stacked caches and tables at their feature strides; slot / cold: int32
// [batch, n_feat] at (b, t) strides; out: T[batch, n_feat, dim]; batch *
// n_feat < 2**31.  vec: dim % 4 == 0 and every row base and out aligned to
// 4 elements.
int launch_embedding_bag_cached_stacked(
    const void* cache, long long cache_stride, const void* table,
    long long table_stride, const void* slot, long long slot_b,
    long long slot_t, const void* cold, long long cold_b, long long cold_t,
    void* out, int batch, int n_feat, int cache_rows, int vocab, int dim,
    int vec, int dtype, void* stream) {
  const long long n_entries = static_cast<long long>(batch) * n_feat;
  if (n_entries == 0 || dim == 0) return 0;
  if (n_entries > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return BY_DTYPE(dtype, bag_stacked)(
      cache, cache_stride, table, table_stride, slot, slot_b, slot_t, cold,
      cold_b, cold_t, out, batch, n_feat, cache_rows, vocab, dim, vec,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
