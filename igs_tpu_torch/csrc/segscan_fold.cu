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
// Bound on this card (H100 SXM, 3.35 TB/s at a 700 W power limit): bytes.
// Each element is read once and written once with one multiply, 8 bytes an
// element: at (2^19, 16), 2 × 32 MiB, 0.0200 ms. ×2 is exact in f32, so
// every variant is bit-equal to x * 2.
//
// Two kernel bodies, as the TPU probe has two (rows % 4096 == 0: whole
// (512, 128) blocks of the TPU probe):
//
//   fold_scale, launched by fold_copy_folded and fold_copy_padded. In HBM
//     the (rows/8, 128) and the (rows, 16) view are the same contiguous
//     bytes; what the TPU's BlockSpecs changed (lane padding in VMEM) has
//     no counterpart here, so the two entry points launch one body and
//     differ only in the view they name: 16-byte vector i is element
//     (i / 32, i % 32) of a 512-byte folded row (a warp per row) or
//     (i / 4, i % 4) of a 64-byte row (four threads per row). Block b's
//     thread t owns the vectors b·V·T + k·T + t for k < V (T threads a
//     block): each warp instruction touches 512 contiguous bytes, and a
//     thread issues its V loads (evict-first, nothing is reused) before
//     any store, so V·16 bytes per thread are in flight with no
//     load → store → load chain. The grid covers the vectors exactly once,
//     with no grid-stride loop; the wrapper picks V (at least one block per
//     SM), T and the grid.
//
//   fold_reshape: a persistent grid (blocks per SM from the wrapper) walks
//     the tensor in slices of slice_vec vectors, round-robin (block b takes
//     slices b, b + grid, ...), through a ring of `stages` slices in
//     dynamic shared memory. Thread 0 keeps stages − 1 slices loading with
//     cp.async.bulk (global → shared, completion counted in bytes on the
//     stage's mbarrier); every thread waits on the stage's barrier phase,
//     scales the slice through its (·, 16) view (four threads per 64-byte
//     row, consecutive threads on consecutive 16-byte vectors, so the
//     LDS.128/STS.128 are conflict-free), fences its shared-memory writes
//     to the async proxy, and after a block barrier thread 0 stores the
//     slice with one cp.async.bulk (shared → global, a bulk group). A stage
//     is refilled only after cp.async.bulk.wait_group.read has released its
//     store, so one slice's store overlaps the next slices' loads. The
//     (512, 128) TPU block (256 KiB) is the unit of the row quantum, not of
//     the grid. A stage is held from its load through the scale until its
//     store has been read out, longer than a register copy holds its
//     bytes, so the ring has to be deep: the wrapper takes 14 stages of
//     8 KiB and two blocks per SM (208 KiB of loads in flight per SM), the
//     fastest ring measured; a ring of 4 × 16 KiB trailed torch.mul
//     (PERF.md).
//
// What the first design (before the redesign) lost on this card, against
// torch.mul(x, 2.0) at 0.0256 ms: the (rows, 16) copy gave each thread one
// 64-byte row (four float4 loads, then four stores), so a warp's load
// instruction spanned 2 KiB in 64-byte steps, pulled 32 sectors for 512
// useful bytes and leaned on L1 for the rest, and its stores had no such
// help: 0.0439 ms. The staged reshape gave each 256 KiB TPU block to one
// 256-thread block (128 blocks for 132 SMs) and walked it in 32 KiB slices
// load → sync → scale → sync → store → sync, with nothing in flight across
// slices, so every slice paid two HBM round trips: 0.0399 ms. The folded
// copy (a warp per 512-byte row, grid-stride over 8 blocks per SM, one
// float4 per thread per iteration) read 0.0261 ms. (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 16;
constexpr int kFoldVec = 32;   // float4 per folded 128-lane row (512 bytes)
constexpr int kRowVec = 4;     // float4 per 16-lane row (64 bytes)
constexpr long long kRowsQuantum = 4096;  // 16-lane rows of one TPU block
constexpr long long kQuantumVec = kRowsQuantum * kRowVec;
constexpr int kMaxRingBytes = 227 * 1024;  // dynamic shared memory a block
                                           // may use on sm_90

__device__ __forceinline__ float4 twice(float4 v) {
  v.x *= 2.f;
  v.y *= 2.f;
  v.z *= 2.f;
  v.w *= 2.f;
  return v;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
fold_scale(const float4* __restrict__ x, float4* __restrict__ y) {
  const long long base =
      static_cast<long long>(blockIdx.x) * V * blockDim.x + threadIdx.x;
  float4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __ldcs(x + base + k * blockDim.x);
#pragma unroll
  for (int k = 0; k < V; ++k) __stcs(y + base + k * blockDim.x, twice(v[k]));
}

// --- Hopper async-copy primitives (PTX) -----------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads)
fold_reshape(const float4* __restrict__ x, float4* __restrict__ y,
             long long n_slices, int slice_vec, int stages) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  const uint32_t bytes = static_cast<uint32_t>(slice_vec) * 16u;
  const long long grid = gridDim.x;
  const int mine =
      static_cast<int>((n_slices - blockIdx.x + grid - 1) / grid);
  // slice k of this block goes through stage k % stages
  auto load = [&](int k) {
    const int s = k % stages;
    const long long slice = blockIdx.x + k * grid;
    mbar_expect_tx(smem(&full[s]), bytes);
    bulk_load(smem(ring + static_cast<long long>(s) * slice_vec),
              x + slice * slice_vec, bytes, smem(&full[s]));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < stages - 1 && k < mine; ++k) load(k);
  }
  __syncthreads();
  for (int k = 0; k < mine; ++k) {
    const int s = k % stages;
    float4* stage = ring + static_cast<long long>(s) * slice_vec;
    mbar_wait(smem(&full[s]), static_cast<uint32_t>(k / stages) & 1u);
    // the (·, 16) view: vector i is lane group i % 4 of 16-lane row i / 4
#pragma unroll 4
    for (int i = threadIdx.x; i < slice_vec; i += blockDim.x)
      stage[i] = twice(stage[i]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long slice = blockIdx.x + k * grid;
      bulk_store(y + slice * slice_vec, smem(stage), bytes);
      const int next = k + stages - 1;
      if (next < mine) {
        // stage next % stages was stored at k − 1: one group after it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(next);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool bad_rows(long long rows) { return rows <= 0 || rows % kRowsQuantum; }

bool bad_threads(int threads) {
  return threads < 32 || threads > kMaxThreads || threads % 32;
}

// n_vec 16-byte vectors, exactly blocks · vec · threads of them.
int launch_scale(const float* x, float* y, long long n_vec, int vec,
                 int threads, long long blocks, void* stream) {
  if (bad_threads(threads) || blocks <= 0 || blocks > 0x7fffffffLL ||
      blocks * vec * threads != n_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* xv = reinterpret_cast<const float4*>(x);
  auto* yv = reinterpret_cast<float4*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1: fold_scale<1><<<grid, threads, 0, s>>>(xv, yv); break;
    case 2: fold_scale<2><<<grid, threads, 0, s>>>(xv, yv); break;
    case 4: fold_scale<4><<<grid, threads, 0, s>>>(xv, yv); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ring size fold_reshape was last allowed, per device: raising the
// limit is a host call, made once per size and not on every launch (nor
// inside a CUDA graph capture, after a first eager launch).
int ring_allowed[64];

}  // namespace

// C interface, loaded with ctypes. x and y are (rows, 16) row-major f32,
// 16-byte aligned, rows a multiple of igs_fold_rows_quantum(). The launch
// geometry comes from the caller; each function checks that it covers the
// rows exactly and returns the launch error (0 on success).
extern "C" long long igs_fold_rows_quantum() { return kRowsQuantum; }

// vec float4 per thread (1, 2 or 4), threads per block (a multiple of
// 32, at most 512), blocks · vec · threads == rows · 4.
extern "C" int igs_fold_copy_folded(const float* x, float* y, long long rows,
                                    int vec, int threads, long long blocks,
                                    void* stream) {
  if (bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  // the (rows/8, 128) view: 32 vectors a folded row
  return launch_scale(x, y, rows / 8 * kFoldVec, vec, threads, blocks,
                      stream);
}

extern "C" int igs_fold_copy_padded(const float* x, float* y, long long rows,
                                    int vec, int threads, long long blocks,
                                    void* stream) {
  if (bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  // the (rows, 16) view: 4 vectors a row
  return launch_scale(x, y, rows * kRowVec, vec, threads, blocks, stream);
}

// slice_vec float4 per ring stage (a multiple of threads dividing the
// 16 384 vectors of a TPU block, so a stage's bytes stay below the
// mbarrier's 2^20 transaction count), 2 ≤ stages ≤ 16, a ring of
// stages · slice_vec · 16 bytes of dynamic shared memory (at most 227 KiB),
// 1 ≤ blocks ≤ rows · 4 / slice_vec. A refused launch returns its error:
// there is no fallback.
extern "C" int igs_fold_reshape(const float* x, float* y, long long rows,
                                int slice_vec, int stages, int threads,
                                long long blocks, void* stream) {
  if (bad_rows(rows) || bad_threads(threads) || slice_vec <= 0 ||
      slice_vec % threads || kQuantumVec % slice_vec || stages < 2 ||
      stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slices = rows * kRowVec / slice_vec;
  const long long ring = static_cast<long long>(stages) * slice_vec * 16;
  if (blocks <= 0 || blocks > n_slices || blocks > 0x7fffffffLL ||
      ring > kMaxRingBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (ring > 48 * 1024 && ring > ring_allowed[dev]) {
    err = cudaFuncSetAttribute(fold_reshape,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ring));
    if (err != cudaSuccess) return static_cast<int>(err);
    ring_allowed[dev] = static_cast<int>(ring);
  }
  fold_reshape<<<static_cast<unsigned>(blocks), threads,
                 static_cast<size_t>(ring),
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      n_slices, slice_vec, stages);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
