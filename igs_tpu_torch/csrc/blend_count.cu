// Contribution counting for Hopper (sm_90a): per Gaussian, the number of
// pixels whose accepted contributor set holds it (LightGaussian importance).
//
// Replaces the TPU kernel igs_tpu/ops/pallas_blend.py:_count_kernel /
// _count_one_tile (launched by count_contributions_pallas) together with
// the segment_sum that reduces its per-slot counts to Gaussians. It walks
// each tile's depth-ordered pair segment exactly as csrc/blend_fwd.cu does:
//   power = -1/2 (c0 dx^2 + c2 dy^2) - c1 dx dy,   dx = mean_x - pix_x
//   alpha = min(0.99, o * exp(power)), candidate iff power <= 0 and
//   alpha >= 1/255; accept while logT + log1p(-alpha) >= log(1e-4), else
//   the pixel is done
// with the same rounding (each operation of the candidate test and the logT
// sum rounded on its own), so the sum of all counts equals the forward
// kernel's accepted pixel-pairs on the same pairs. Pixels outside the image
// (the partial tiles of the right and bottom edge) start done, as in the
// TPU kernel; blend_fwd.cu has no such rule.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the bytes are the walked pairs' ids and six feature floats
// (xy, conic, opacity) read once plus one int32 per Gaussian written; the
// work is the candidate test (16 flops) per pixel-pair up to each pixel's
// termination, and a few more for the pairs accepted. A feature row feeds
// 256 pixels, so the kernel is bound by operations where tiles are deep and
// by bytes where they are shallow.
//
// Design: one block per tile, 256 threads, one pixel each, as the forward.
// A batch of 256 pairs is staged in shared memory (thread p gathers pair
// p's row through its Gaussian id: three 8-byte loads of a 24-byte row).
// Every thread walks the batch; per pair, each warp counts its accepting
// pixels with __ballot_sync + __popc into a shared (warps x batch) table,
// and after the batch thread j sums pair j's 8 warp counts and adds them to
// its Gaussian with one integer atomicAdd. Integer addition is exact and
// order-free, so the result repeats bit for bit without a reduction pass.
// A warp whose pixels are all done stops walking (__all_sync), and the tile
// ends once every pixel is done (__syncthreads_and), the TPU kernel's early
// exit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 256;
constexpr int kLanes = 6;  // xy conic(3) opacity
constexpr float kLogTerm = -9.210340371976182f;  // log(1e-4)
constexpr float kMinAlpha = 1.0f / 255.0f;

__global__ void __launch_bounds__(kPix)
count_contributions_kernel(const float* __restrict__ rows,
                           const int* __restrict__ gauss_id,
                           const int* __restrict__ tile_start,
                           const int* __restrict__ tile_count, int grid_x,
                           int tiles_per_view, int width, int height,
                           int* __restrict__ counts) {
  __shared__ float sf[kLanes][kBatch];
  __shared__ int sg[kBatch];
  __shared__ int sc[kWarps][kBatch];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int lt = t % tiles_per_view;
  const int ix = (lt % grid_x) * kTile + (p % kTile);
  const int iy = (lt / grid_x) * kTile + (p / kTile);
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(iy);
  const long long start = tile_start[t];
  const int count = tile_count[t];

  float logT = 0.f;
  bool done = ix >= width || iy >= height;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier that frees the shared tables of the previous batch
    if (__syncthreads_and(done)) break;
    const int nb = min(kBatch, count - b0);
    if (p < nb) {
      const int g = gauss_id[start + b0 + p];
      sg[p] = g;
      float2 a = make_float2(0.f, 0.f), b = a, c = a;
      if (g >= 0) {
        const float2* r = reinterpret_cast<const float2*>(
            rows + static_cast<long long>(kLanes) * g);
        a = r[0];
        b = r[1];
        c = r[2];
      }
      sf[0][p] = a.x;
      sf[1][p] = a.y;
      sf[2][p] = b.x;
      sf[3][p] = b.y;
      sf[4][p] = c.x;
      sf[5][p] = c.y;  // opacity 0 for a pad: never a candidate
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sc[w][p] = 0;
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      if (__all_sync(0xffffffffu, done)) break;
      bool accept = false;
      if (!done) {
        const float dx = sf[0][j] - px;
        const float dy = sf[1][j] - py;
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(sf[2][j], dx), dx),
                                       __fmul_rn(__fmul_rn(sf[4][j], dy), dy))),
            __fmul_rn(__fmul_rn(sf[3][j], dx), dy));
        // the forward's test: skip on power > 0, then on alpha < 1/255
        if (!(power > 0.f)) {
          const float alpha = fminf(0.99f, sf[5][j] * expf(power));
          if (alpha >= kMinAlpha) {
            const float next = __fadd_rn(logT, log1pf(-alpha));
            if (next < kLogTerm) {
              done = true;
            } else {
              logT = next;
              accept = true;
            }
          }
        }
      }
      const unsigned hits = __ballot_sync(0xffffffffu, accept);
      if (lane == 0 && hits) sc[warp][j] = __popc(hits);
    }
    __syncthreads();
    if (p < nb && sg[p] >= 0) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += sc[w][p];
      if (c > 0) atomicAdd(counts + sg[p], c);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. rows is (R, 6) row-major f32 [x y c0 c1
// c2 opacity] per (view, Gaussian) row; gauss_id indexes it per pair;
// tile_start / tile_count delimit each tile's segment (num_tiles = views *
// tiles_per_view); counts is (R,) int32, zeroed by the caller, and receives
// the per-row counts. Returns the launch's cudaError_t.
extern "C" int igs_count_contributions_packed(
    const float* rows, const int* gauss_id, const int* tile_start,
    const int* tile_count, int num_tiles, int grid_x, int tiles_per_view,
    int width, int height, int* counts, void* stream) {
  if (num_tiles <= 0) return 0;
  count_contributions_kernel<<<num_tiles, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      rows, gauss_id, tile_start, tile_count, grid_x, tiles_per_view, width,
      height, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
