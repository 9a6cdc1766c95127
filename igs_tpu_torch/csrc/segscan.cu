// Segmented inclusive scan for Hopper (sm_90a): per lane row, the prefix
// sum over contiguous runs of equal ids.
//
// Replaces the TPU kernel igs_tpu/ops/segred.py:_segscan_kernel (launched
// by segmented_scan). It computes
//   out[l, i] = sum of x[l, j] over j <= i with ids[j] == ids[i]
// where runs of equal ids are contiguous, on the port's (lanes, pairs)
// layout: each lane row is contiguous along the pairs. Accumulation is
// fp32 throughout; the TPU kernel's bf16 hi/lo split was an MXU artifact.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. Each element is read
// once and written once (plus the ids), a few adds each; the scan moves
// 8·L + 4 bytes per pair.
//
// Design, three deterministic passes, no atomics on floats:
//   1. segscan_local, one block of 256 threads per 1024 elements of one
//      lane row: each thread scans its 4 elements, the block combines the
//      threads' (head-flag, value) aggregates with a segmented warp-shuffle
//      scan, then across the 8 warps through shared memory. It writes the
//      block-local scan, the block's aggregate and the offset of its first
//      segment head (1024 if none).
//   2. segscan_carry, one block per lane row: an exclusive segmented scan
//      over the block aggregates gives the carry into each block.
//   3. segscan_fixup adds a block's carry to its elements before its first
//      head: the rows that continue the segment carried in.
// The segmented operator is (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2),
// with f the flag "a segment starts here"; a row continues the carried
// segment iff its id equals the previous row's (segred.py:91-107).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kElems = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive segmented scan of one (flag, value) per thread over the block;
// also returns the block's inclusive total. blockDim.x is a multiple of 32.
__device__ void block_scan(int f, float v, int& ef, float& ev, int& tf,
                           float& tv) {
  __shared__ int wf[32];
  __shared__ float wv[32];
  __shared__ int total_f;
  __shared__ float total_v;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  int incf = f;
  float incv = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(kFull, incf, d);
    const float ov = __shfl_up_sync(kFull, incv, d);
    if (lane >= d) {
      incv = incf ? incv : ov + incv;
      incf |= of;
    }
  }
  int xf = __shfl_up_sync(kFull, incf, 1);
  float xv = __shfl_up_sync(kFull, incv, 1);
  if (lane == 0) {
    xf = 0;
    xv = 0.f;
  }
  __syncthreads();  // wf/wv free from an earlier call
  if (lane == 31) {
    wf[warp] = incf;
    wv[warp] = incv;
  }
  __syncthreads();
  if (warp == 0) {
    int a = lane < nw ? wf[lane] : 0;
    float b = lane < nw ? wv[lane] : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int of = __shfl_up_sync(kFull, a, d);
      const float ov = __shfl_up_sync(kFull, b, d);
      if (lane >= d) {
        b = a ? b : ov + b;
        a |= of;
      }
    }
    int pf = __shfl_up_sync(kFull, a, 1);
    float pv = __shfl_up_sync(kFull, b, 1);
    if (lane == 0) {
      pf = 0;
      pv = 0.f;
    }
    if (lane == nw - 1) {
      total_f = a;
      total_v = b;
    }
    if (lane < nw) {
      wf[lane] = pf;
      wv[lane] = pv;
    }
  }
  __syncthreads();
  const int pf = wf[warp];
  const float pv = wv[warp];
  ef = pf | xf;
  ev = xf ? xv : pv + xv;
  tf = total_f;
  tv = total_v;
}

__global__ void __launch_bounds__(kThreads)
segscan_local(const float* __restrict__ x, const int* __restrict__ ids,
              long long mp, int nblk, float* __restrict__ out,
              int* __restrict__ first_head, float* __restrict__ agg) {
  __shared__ int fh;
  const long long b = blockIdx.x;
  const int row = blockIdx.y;
  const long long base = b * kElems + threadIdx.x * kItems;
  const float* xr = x + row * mp;
  float* orow = out + row * mp;

  float v[kItems];
  int head[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < mp) {
      v[k] = xr[i];
      head[k] = (i == 0 || ids[i] != ids[i - 1]) ? 1 : 0;
    } else {
      v[k] = 0.f;
      head[k] = 0;
    }
  }
  int f = 0;
  float s = 0.f;
  int mine = kElems;  // this thread's first head, as a block offset
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (head[k]) {
      s = v[k];
      if (!f) mine = threadIdx.x * kItems + k;
      f = 1;
    } else {
      s += v[k];
    }
    v[k] = s;
  }
  if (threadIdx.x == 0) fh = kElems;
  __syncthreads();
  if (mine < kElems) atomicMin(&fh, mine);  // integer min: order-free
  int ef, tf;
  float ev, tv;
  block_scan(f, s, ef, ev, tf, tv);
  int seen = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    seen |= head[k];
    const long long i = base + k;
    if (i < mp) orow[i] = seen ? v[k] : v[k] + ev;
  }
  if (threadIdx.x == 0) {
    agg[static_cast<long long>(row) * nblk + b] = tv;
    if (row == 0) first_head[b] = fh;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
segscan_carry(const int* __restrict__ first_head,
              const float* __restrict__ agg, int nblk,
              float* __restrict__ carry) {
  const int row = blockIdx.x;
  float rv = 0.f;  // the running segment's sum entering this tile
  for (int t0 = 0; t0 < nblk; t0 += kCarryThreads) {
    const int j = t0 + threadIdx.x;
    const int f = j < nblk ? (first_head[j] < kElems) : 0;
    const float v = j < nblk ? agg[static_cast<long long>(row) * nblk + j] : 0.f;
    int ef, tf;
    float ev, tv;
    block_scan(f, v, ef, ev, tf, tv);
    if (j < nblk)
      carry[static_cast<long long>(row) * nblk + j] = ef ? ev : rv + ev;
    rv = tf ? tv : rv + tv;
  }
}

__global__ void __launch_bounds__(kThreads)
segscan_fixup(long long mp, int nblk, const int* __restrict__ first_head,
              const float* __restrict__ carry, float* __restrict__ out) {
  const long long b = blockIdx.x;
  const int row = blockIdx.y;
  if (b == 0) return;
  const int fh = first_head[b];
  if (fh == 0) return;
  const float c = carry[static_cast<long long>(row) * nblk + b];
  float* orow = out + row * mp + b * kElems;
  const long long left = mp - b * kElems;
  for (int i = threadIdx.x; i < fh && i < left; i += kThreads) orow[i] += c;
}

}  // namespace

// C interface, loaded with ctypes. x and out are (lanes, mp) row-major f32,
// ids is (mp,) i32; first_head is (nblk,) i32, agg and carry (lanes, nblk)
// f32 scratch, with nblk = ceil(mp / 1024). Returns the first launch error.
extern "C" int igs_segscan_block_elems() { return kElems; }

extern "C" int igs_segmented_scan(const float* x, const int* ids,
                                  long long mp, int lanes, float* out,
                                  int* first_head, float* agg, float* carry,
                                  void* stream) {
  if (mp <= 0 || lanes <= 0) return 0;
  if (lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>((mp + kElems - 1) / kElems);
  const dim3 grid(nblk, lanes);
  segscan_local<<<grid, kThreads, 0, s>>>(x, ids, mp, nblk, out, first_head,
                                          agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segscan_carry<<<lanes, kCarryThreads, 0, s>>>(first_head, agg, nblk, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segscan_fixup<<<grid, kThreads, 0, s>>>(mp, nblk, first_head, carry, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
