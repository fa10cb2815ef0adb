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
// each.  Here the table stays whole in device memory and every element is
// one thread of a grid-stride loop:
// - build: fill the table with ABSENT32, then one atomicMin per value.  min
//   is order-independent, so the result is bit-exact whatever order the
//   blocks run in; a plain read first skips the atomic once a hot id's
//   position is settled (as fit_kernel in dataflow.cu does).
// - lookup: one read-only (__ldg) gather per element.  At 4 M entries the
//   16 MiB table fits the 50 MB L2, so repeated ids hit in L2.
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

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const int* __restrict__ x, const int* __restrict__ table,
              int* __restrict__ out, long long n, int capacity, int n_unique) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int v = x[i];
    int r = n_unique;
    if (v >= 0 && v < capacity) {
      const int t = __ldg(table + v);
      if (t >= 0) r = t;
    }
    out[i] = r;
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

int launch_vocab_lookup(const void* x, const void* table, void* out,
                        long long n, int capacity, int n_unique,
                        void* stream) {
  if (n == 0) return 0;
  lookup_kernel<<<grid_blocks(n), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(table),
      static_cast<int*>(out), n, capacity, n_unique);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
