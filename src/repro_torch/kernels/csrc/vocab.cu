// The staged vocabulary kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/vocab.py:
//   build_kernel  <- vocab_build_chunk / _build_kernel (l.86 / l.58): the
//                    first-occurrence position of every value of a flat
//                    int32 chunk, ABSENT32 where a value is absent; values
//                    outside [0, capacity) (the -1 padding among them) drop;
//   lookup_kernel <- vocab_lookup / _lookup_kernel (l.137 / l.118):
//                    table[x] where 0 <= x < capacity and table[x] >= 0,
//                    else the OOV index n_unique.
//
// The TPU kernels split the table across a sequential grid of VMEM-sized
// partitions (the paper's HBM banks) and walk the stream serially inside
// each.  Here the table stays whole in device memory:
// - build: fill the table with ABSENT32, then one atomicMin per value of a
//   grid-stride loop.  min is order-independent, so the result is bit-exact
//   whatever order the blocks run in; a plain read first skips the atomic
//   once a hot id's position is settled (as fit_kernel in dataflow.cu does).
// - lookup: a gather whose time is latency, not bytes: each id waits on its
//   own table read.  So every thread keeps LOOKUP_VECS int4 vectors of ids
//   (4 ids each) in flight: it issues all their id loads, then all their
//   table gathers (read-only, __ldg), then int4 stores.  The id stream is
//   read and the output written once, so both go through the streaming
//   cache path (__ldcs / __stcs) and leave L2 to the table's gathered lines
//   (at 4 M entries the 16 MiB table fits the 50 MB L2).  The grid is sized
//   to the work: one pass of LOOKUP_VECS vectors a thread.  x and out
//   share their 16-byte phase (the wrapper allocates out so): the first
//   ids up to a 16-byte boundary and the ragged tail past the last whole
//   vector are scalar code of the same kernel.
//
// Bound on an H100: bytes (the stream in once, the table or the ids out
// once); the gathers and atomics are scattered, so the achieved rate sits
// below the streaming rate.

#include "ops.cuh"

#define ABSENT32 0x7FFFFFFF

// grid-stride indices are 64-bit so the last step cannot overflow int
__global__ void __launch_bounds__(THREADS)
fill_kernel(int* __restrict__ out, int n, int value) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    out[i] = value;
}

__global__ void __launch_bounds__(THREADS)
build_kernel(const int* __restrict__ vals, int* first_pos, int n,
             int capacity) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int v = vals[i];
    const int pos = static_cast<int>(i);
    if (v >= 0 && v < capacity && first_pos[v] > pos)
      atomicMin(first_pos + v, pos);
  }
}

#define LOOKUP_VECS 2  // int4 vectors of ids per thread per pass

static __device__ __forceinline__ int lookup_one(int v, const int* table,
                                                 int capacity, int n_unique) {
  const int t = (v >= 0 && v < capacity) ? __ldg(table + v) : -1;
  return t >= 0 ? t : n_unique;
}

// One pass: block blk owns the LOOKUP_VECS * THREADS vectors from
// blk * LOOKUP_VECS * THREADS on, vector u of a thread at u * THREADS past
// its own index, so each of the LOOKUP_VECS loads is coalesced.
__global__ void __launch_bounds__(THREADS)
lookup_kernel(const int* __restrict__ x, const int* __restrict__ table,
              int* __restrict__ out, long long n, int capacity, int n_unique) {
  // ids before the first 16-byte boundary of x (and of out: same phase)
  long long head = static_cast<long long>(
      (16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long n_vec = (n - head) / 4;
  const long long tail = head + 4 * n_vec;  // first id past the last vector
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid < head) out[tid] = lookup_one(__ldcs(x + tid), table, capacity,
                                        n_unique);
  if (tid < n - tail)
    out[tail + tid] = lookup_one(__ldcs(x + tail + tid), table, capacity,
                                 n_unique);
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  const long long v0 =
      static_cast<long long>(blockIdx.x) * LOOKUP_VECS * THREADS + threadIdx.x;
  int4 ids[LOOKUP_VECS];
#pragma unroll
  for (int u = 0; u < LOOKUP_VECS; ++u) {
    const long long v = v0 + u * THREADS;
    ids[u] = v < n_vec ? __ldcs(xv + v) : make_int4(-1, -1, -1, -1);
  }
  int4 r[LOOKUP_VECS];
#pragma unroll
  for (int u = 0; u < LOOKUP_VECS; ++u) {
    r[u].x = lookup_one(ids[u].x, table, capacity, n_unique);
    r[u].y = lookup_one(ids[u].y, table, capacity, n_unique);
    r[u].z = lookup_one(ids[u].z, table, capacity, n_unique);
    r[u].w = lookup_one(ids[u].w, table, capacity, n_unique);
  }
#pragma unroll
  for (int u = 0; u < LOOKUP_VECS; ++u) {
    const long long v = v0 + u * THREADS;
    if (v < n_vec) __stcs(ov + v, r[u]);
  }
}

extern "C" {

// first_pos: int32[capacity]; n < 2**31 (positions are int32)
int launch_vocab_build(const void* vals, void* first_pos, int n, int capacity,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (capacity > 0)
    fill_kernel<<<grid_blocks(capacity), THREADS, 0, s>>>(
        static_cast<int*>(first_pos), capacity, ABSENT32);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  build_kernel<<<grid_blocks(n), THREADS, 0, s>>>(
      static_cast<const int*>(vals), static_cast<int*>(first_pos), n,
      capacity);
  return static_cast<int>(cudaGetLastError());
}

// x and out: int32[n] with the same address modulo 16.  The grid is sized
// to the work: one pass of LOOKUP_VECS int4 vectors a thread.
int launch_vocab_lookup(const void* x, const void* table, void* out,
                        long long n, int capacity, int n_unique,
                        void* stream) {
  if (n == 0) return 0;
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long per_block = 4LL * LOOKUP_VECS * THREADS;
  const int blocks = static_cast<int>((n + per_block - 1) / per_block);
  lookup_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(table),
      static_cast<int*>(out), n, capacity, n_unique);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
