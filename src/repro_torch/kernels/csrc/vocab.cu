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
// - build: fill the table with ABSENT32 (fill_kernel: 16-byte stores,
//   FILL_VECS vectors a thread, the grid sized to the work; plain stores,
//   so the table stays in L2 for the atomics that follow), then
//   build_kernel: each block takes BUILD_VECS * THREADS int4 vectors of
//   consecutive positions, every thread issuing its BUILD_VECS loads before
//   it folds any, and folds its ids into a shared-memory table of id ->
//   least position (BUILD_SLOTS entries, open addressing: atomicCAS for the
//   key, atomicMin for the position, BUILD_PROBE probes).  The block then
//   flushes one return-free atomicMin per distinct id it saw; an id that
//   finds no entry takes the global atomicMin itself.  The ids are heavily
//   repeated (a batch of the staged path holds 83,876 distinct ids in
//   1,703,936), so a hot id costs one global atomic a block, not one a
//   position.  Every block but block 0 reads first_pos (through L2)
//   before each atomic and skips it where the value there is already at
//   most its own: the blocks flush at slightly different times, and block
//   0 (the lowest positions, dispatched first) flushes without reads, so
//   for a hot id only a few atomics land.  With no read anywhere (every
//   block's atomic on the hottest ids queued on one address), and with a
//   read in block 0 too, the build took a fifth longer.  min
//   is order-independent, so the table is bit-exact whatever order the
//   threads and blocks run in.  The ids before the
//   stream's first 16-byte boundary and past its last whole vector take the
//   global atomicMin from block 0's threads.
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

#define FILL_VECS 4      // int4 stores a thread in the fill
#define BUILD_VECS 4     // int4 loads of ids a thread in the build
#define BUILD_SLOTS 4096 // entries of the build's shared-memory table
#define BUILD_LOG2 12
#define BUILD_PROBE 8
#define BUILD_EMPTY (-1)

// out[0, n) = value: int4 vectors (out is 16-byte aligned: the wrapper's
// own allocation), the last n % 4 entries by the first threads.
__global__ void __launch_bounds__(THREADS)
fill_kernel(int* __restrict__ out, long long n, int value) {
  const long long n_vec = n / 4;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid < n - 4 * n_vec) out[4 * n_vec + tid] = value;
  const int4 v = make_int4(value, value, value, value);
  int4* ov = reinterpret_cast<int4*>(out);
  const long long v0 =
      static_cast<long long>(blockIdx.x) * FILL_VECS * THREADS + threadIdx.x;
#pragma unroll
  for (int u = 0; u < FILL_VECS; ++u)
    if (v0 + u * THREADS < n_vec) ov[v0 + u * THREADS] = v;
}

static __device__ __forceinline__ void build_global(int* first_pos, int v,
                                                    int pos, int capacity) {
  if (v >= 0 && v < capacity) atomicMin(first_pos + v, pos);
}

// atomicMin(first_pos + v, pos); with `check`, skipped where first_pos[v]
// (read through L2, not L1) is already at most pos.
static __device__ __forceinline__ void min_global(int* first_pos, int v,
                                                  int pos, bool check) {
  if (!check || __ldcg(first_pos + v) > pos) atomicMin(first_pos + v, pos);
}

// Fold id v at position pos into the shared table; false if no entry
// within BUILD_PROBE probes holds v or is free.
static __device__ __forceinline__ bool build_add(int* key, int* least, int v,
                                                 int pos) {
  uint32_t h = (static_cast<uint32_t>(v) * 2654435761u) >> (32 - BUILD_LOG2);
  for (int probe = 0; probe < BUILD_PROBE; ++probe) {
    int k = static_cast<volatile int*>(key)[h];
    if (k == BUILD_EMPTY) {
      k = atomicCAS(key + h, BUILD_EMPTY, v);
      if (k == BUILD_EMPTY) k = v;
    }
    if (k == v) {
      atomicMin(least + h, pos);
      return true;
    }
    h = (h + 1) & (BUILD_SLOTS - 1);
  }
  return false;
}

// `head` ids come before vals' first 16-byte boundary; n_vec int4 vectors
// follow; the rest is the tail.  Block b takes the BUILD_VECS * THREADS
// vectors from b * BUILD_VECS * THREADS on; block 0 also takes the head and
// the tail.
__global__ void __launch_bounds__(THREADS)
build_kernel(const int* __restrict__ vals, int* first_pos, int n, int head,
             int n_vec, int capacity) {
  __shared__ int key[BUILD_SLOTS];
  __shared__ int least[BUILD_SLOTS];
  const bool check = blockIdx.x != 0;
  if (blockIdx.x == 0) {
    const int tail = head + 4 * n_vec;
    const int t = threadIdx.x;
    if (t < head) build_global(first_pos, __ldcs(vals + t), t, capacity);
    if (t < n - tail)
      build_global(first_pos, __ldcs(vals + tail + t), tail + t, capacity);
  }
  const int4* xv = reinterpret_cast<const int4*>(vals + head);
  const int v0 = blockIdx.x * BUILD_VECS * THREADS + threadIdx.x;
  int4 ids[BUILD_VECS];
#pragma unroll
  for (int u = 0; u < BUILD_VECS; ++u) {
    const int v = v0 + u * THREADS;
    ids[u] = v < n_vec ? __ldcs(xv + v) : make_int4(-1, -1, -1, -1);
  }
  for (int h = threadIdx.x; h < BUILD_SLOTS; h += blockDim.x) {
    key[h] = BUILD_EMPTY;
    least[h] = INT_MAX;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < BUILD_VECS; ++u) {
    const int at = head + 4 * (v0 + u * THREADS);  // position of .x
    const int x[4] = {ids[u].x, ids[u].y, ids[u].z, ids[u].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x[j] >= 0 && x[j] < capacity && !build_add(key, least, x[j], at + j))
        min_global(first_pos, x[j], at + j, check);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < BUILD_SLOTS; h += blockDim.x)
    if (key[h] != BUILD_EMPTY) min_global(first_pos, key[h], least[h], check);
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

// first_pos: int32[capacity], 16-byte aligned; n < 2**31 (positions are
// int32).  The grids are sized to the work: one pass a thread each.
int launch_vocab_build(const void* vals, void* first_pos, int n, int capacity,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (capacity > 0) {
    const long long per_fill = 4LL * FILL_VECS * THREADS;
    fill_kernel<<<static_cast<int>((capacity + per_fill - 1) / per_fill),
                  THREADS, 0, s>>>(static_cast<int*>(first_pos), capacity,
                                   ABSENT32);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(vals) & 15)) & 15) / 4);
  if (head > n) head = n;
  const int n_vec = (n - head) / 4;
  const int per_block = BUILD_VECS * THREADS;  // vectors a block
  int blocks = (n_vec + per_block - 1) / per_block;
  if (blocks == 0) blocks = 1;  // the head and the tail
  build_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const int*>(vals), static_cast<int*>(first_pos), n, head,
      n_vec, capacity);
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
