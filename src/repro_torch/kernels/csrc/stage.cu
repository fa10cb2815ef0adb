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
// Both are one thread per output element in a grid-stride loop.  The chain's
// value stays in a register from load to store (no shared memory: an
// elementwise chain needs none), and the per-opcode rules are ops.cuh's,
// the same copy the dataflow interpreter runs.  The TPU kernels' lane and
// sublane padding has no counterpart: the ragged edge is the loop bound.
//
// Bound on an H100: bytes.  The stage reads its input once and writes its
// output once (a hex element is w bytes in, 4 out); the packer reads every
// block once and writes the padded output once.  Both do a few integer
// operations per byte.  Neighbouring threads touch neighbouring addresses,
// so every warp access is coalesced; a hex digit plane is read one byte a
// thread, w planes apart.
//
// Arguments travel by value as one __grid_constant__ struct each: no
// per-launch copy to the device and no per-thread copy of the struct.

#include "ops.cuh"

#define MAX_BLOCK 32

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

// mirrored by _CPack in repro_torch/kernels/dataflow.py
struct PackArgs {
  const void* src[MAX_BLOCK];
  void* out;
  long long rows;
  int out_cols, n_block, out_kind;
  int kind[MAX_BLOCK];
  int width[MAX_BLOCK];
  int col[MAX_BLOCK];
};

__global__ void __launch_bounds__(THREADS)
stage_kernel(const __grid_constant__ StageArgs a) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += step) {
    int v;
    int k = 0;
    if (a.in_kind == K_HEX) {  // instr[0] is the Hex2Int the encoder checked
      v = hex2int(static_cast<const uint8_t*>(a.src) + i,
                  static_cast<size_t>(a.n), a.hex_width);
      k = 1;
    } else {
      v = static_cast<const int*>(a.src)[i];
    }
    for (; k < a.n_instr; ++k) v = unary_op(a.instr[k], v, a.param);
    if (a.out_kind == a.val_kind) {
      static_cast<int*>(a.out)[i] = v;
    } else if (a.out_kind == K_F32) {
      static_cast<float*>(a.out)[i] = static_cast<float>(v);
    } else {  // float -> int32 truncates toward zero, as astype does
      static_cast<int*>(a.out)[i] = static_cast<int>(__int_as_float(v));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
packer_kernel(const __grid_constant__ PackArgs a) {
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
    int bits = 0;  // zero in the padding columns, as either dtype
    if (b >= 0) {
      const long long e = r * a.width[b] + (c - a.col[b]);
      const int x = static_cast<const int*>(a.src[b])[e];
      if (a.kind[b] == a.out_kind) bits = x;
      else if (a.out_kind == K_F32) bits = __float_as_int(static_cast<float>(x));
      else bits = static_cast<int>(__int_as_float(x));
    }
    static_cast<int*>(a.out)[i] = bits;
  }
}

extern "C" {

int launch_fused_stage(const void* args, void* stream) {
  const StageArgs* a = static_cast<const StageArgs*>(args);
  if (a->n == 0) return 0;
  stage_kernel<<<grid_blocks(a->n), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int launch_packer(const void* args, void* stream) {
  const PackArgs* a = static_cast<const PackArgs*>(args);
  const long long n = a->rows * a->out_cols;
  if (n == 0) return 0;
  packer_kernel<<<grid_blocks(n), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int stage_args_size() { return static_cast<int>(sizeof(StageArgs)); }

int pack_args_size() { return static_cast<int>(sizeof(PackArgs)); }

}  // extern "C"
