// Layout probes of the segmented scan's rows for Hopper (sm_90a): y = 2x
// over x (rows, 16) f32, walked three ways.
//
// Replaces the TPU kernels of tools/tools_bench_segscan_fold.py:
// copy_kernel (:26, launched by run_copy_folded :31 and run_copy_padded
// :45) and reshape_kernel (:57, launched by run_reshape :64). The TPU probe
// asked whether a 16-lane row layout wastes bandwidth (a (R, 16) block pads
// to 128 lanes in VMEM) and whether an in-kernel (R, 128) → (8R, 16)
// reshape lowers. On this card the same question is how the row width and
// on-chip staging cost on HBM: the port's segscan (csrc/segscan.cu) reads a
// lane-major (lanes, pairs) tensor, a row-major one would read 64-byte
// rows.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. Each element is read
// once and written once with one multiply, 8 bytes an element: at
// (2^19, 16), 2 × 32 MiB, 0.0200 ms. ×2 is exact in f32, so every variant
// is bit-equal to x * 2.
//
// Variants (rows % 4096 == 0: whole (512, 128) blocks of the TPU probe):
//   fold_copy_folded: the (rows/8, 128) view, one warp per 512-byte row,
//     a float4 per lane, grid-stride over the rows: every warp access is
//     one contiguous 512 bytes.
//   fold_copy_padded: the (rows, 16) view, one 64-byte row per thread
//     (four float4 loads, then four stores), grid-stride: successive lanes
//     of a warp touch addresses 64 bytes apart, the thread-per-row mapping
//     a row-major segscan would use.
//   fold_reshape: one block per (512, 128) block (256 KiB, more than the
//     227 KiB a block may use), staged through shared memory 64 rows
//     (32 KiB) at a time: loaded through the (·, 128) view (a float4 per
//     thread, coalesced), scaled through the (·, 16) view of the staged
//     slice (one 64-byte row per thread), stored through the (·, 128) view.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVec = 4;      // float4 per 16-lane row (64 bytes)
constexpr int kFoldVec = 32;    // float4 per folded 128-lane row (512 bytes)
constexpr int kBlockRows = 512;  // folded rows of one TPU block
constexpr int kSliceRows = 64;   // folded rows staged at a time (32 KiB)
constexpr long long kRowsQuantum = 8LL * kBlockRows;  // 16-lane rows

__device__ __forceinline__ float4 twice(float4 v) {
  v.x *= 2.f;
  v.y *= 2.f;
  v.z *= 2.f;
  v.w *= 2.f;
  return v;
}

__global__ void __launch_bounds__(kThreads)
fold_copy_folded(const float4* __restrict__ x, float4* __restrict__ y,
                 long long folded_rows) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long r = warp; r < folded_rows; r += warps) {
    const long long i = r * kFoldVec + lane;
    y[i] = twice(x[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
fold_copy_padded(const float4* __restrict__ x, float4* __restrict__ y,
                 long long rows) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       r < rows; r += step) {
    float4 v[kRowVec];
#pragma unroll
    for (int k = 0; k < kRowVec; ++k) v[k] = x[r * kRowVec + k];
#pragma unroll
    for (int k = 0; k < kRowVec; ++k) y[r * kRowVec + k] = twice(v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
fold_reshape(const float4* __restrict__ x, float4* __restrict__ y) {
  __shared__ float4 slice[kSliceRows * kFoldVec];
  const long long block0 =
      static_cast<long long>(blockIdx.x) * kBlockRows * kFoldVec;
  for (int s = 0; s < kBlockRows / kSliceRows; ++s) {
    const long long base = block0 + static_cast<long long>(s) * kSliceRows *
                                        kFoldVec;
    // the (·, 128) view: 2048 float4, 8 a thread, coalesced
    for (int i = threadIdx.x; i < kSliceRows * kFoldVec; i += kThreads)
      slice[i] = x[base + i];
    __syncthreads();
    // the (·, 16) view of the staged slice: 512 rows of four float4
    for (int r = threadIdx.x; r < kSliceRows * kFoldVec / kRowVec;
         r += kThreads) {
#pragma unroll
      for (int k = 0; k < kRowVec; ++k)
        slice[r * kRowVec + k] = twice(slice[r * kRowVec + k]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSliceRows * kFoldVec; i += kThreads)
      y[base + i] = slice[i];
    __syncthreads();  // the next slice reuses the buffer
  }
}

// Blocks for a grid-stride kernel: enough to fill every SM, no more than
// the work needs.
int grid_blocks(long long threads_of_work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (threads_of_work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  return static_cast<int>(want < cap ? want : cap);
}

bool bad_rows(long long rows) { return rows <= 0 || rows % kRowsQuantum; }

}  // namespace

// C interface, loaded with ctypes. x and y are (rows, 16) row-major f32,
// 16-byte aligned, rows a multiple of igs_fold_rows_quantum(). Each returns
// the launch error (0 on success).
extern "C" long long igs_fold_rows_quantum() { return kRowsQuantum; }

extern "C" int igs_fold_copy_folded(const float* x, float* y, long long rows,
                                    void* stream) {
  if (bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  const long long folded = rows / 8;
  fold_copy_folded<<<grid_blocks(folded * 32), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      folded);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int igs_fold_copy_padded(const float* x, float* y, long long rows,
                                    void* stream) {
  if (bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  fold_copy_padded<<<grid_blocks(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int igs_fold_reshape(const float* x, float* y, long long rows,
                                void* stream) {
  if (bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = rows / kRowsQuantum;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fold_reshape<<<static_cast<int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
