// Windowed forward blend for Hopper (sm_90a): per-tile front-to-back alpha
// blending over each tile's window of gathered pair features.
//
// Replaces the TPU kernel igs_tpu/ops/pallas_blend.py:_fwd_kernel /
// _fwd_one_tile (launched by blend_raw, the impl="pallas" route). Tile t
// reads rows [0, counts[t]) of its window, a (max_per_tile, 32) block of
// pair features in depth order (counts = min(tile_count, max_per_tile);
// rows past the count are never read). Per pixel, as blend_fwd.cu:
//   power = -1/2 (c0 dx^2 + c2 dy^2) - c1 dx dy,   dx = mean_x - pix_x
//   alpha = min(0.99, o * exp(min(power, 0)))
//   candidate iff power <= 0 and alpha >= 1/255
//   accept while logT + log1p(-alpha) >= log(1e-4), else the pixel is done
//   w = alpha * exp(logT_before)
// The raw block has 24 lanes in every mode, as the TPU kernel writes it
// (pallas_blend.py:260-273): C(3) W | coord(3) D | nrm(3) | mcoord(3)
// mdepth | logT n_contrib med_pos | pad(6); color mode leaves the geometry
// lanes zero, and modes other than full leave the median lanes zero with
// med_pos -1. Pixels outside the image are not started as done (the TPU
// kernel's rule; the untiling crops them).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the bytes are the windows' live rows read once (9/21/24
// of their 32 floats used) plus the 24-lane raw block written once; the
// work is the candidate test (16 flops) per pixel per row up to the
// pixel's last contributor and the accumulation (29/61/68 flops in all)
// per accepted pixel-pair. A 512^2 view has 1024 tiles of up to ~6 500
// rows, where operations bound it.
//
// Design: one block per tile, 256 threads, one pixel each. The window is
// staged through shared memory in chunks of 128 rows (16 KiB), loaded as
// float4 by all threads so that a warp reads 512 contiguous bytes; every
// thread then walks the chunk from shared memory, where all threads read
// the same address (broadcast). __syncthreads_and ends the tile once every
// pixel is done, the TPU kernel's early exit (pallas_blend.py:188-189).
// The candidate test and the logT sum are rounded operation by operation
// (__fmul_rn/__fadd_rn) as in blend_fwd.cu and blend_count.cu, so the
// windowed and packed kernels end each pixel at the same pair. The mode is
// a template parameter. Left for later: cp.async/TMA double buffering and
// a warp-level footprint test.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kLanes = 32;   // feature lanes of a window row
constexpr int kRaw = 24;     // raw lanes per pixel
constexpr int kChunk = 128;  // rows staged per step
constexpr float kLogTerm = -9.210340371976182f;  // log(1e-4)
constexpr float kMinAlpha = 1.0f / 255.0f;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;

template <int MODE>
__global__ void __launch_bounds__(kPix)
blend_fwd_win_kernel(const float* __restrict__ windows, int max_per_tile,
                     const int* __restrict__ counts, int grid_x,
                     int tiles_per_view, float* __restrict__ out) {
  __shared__ __align__(16) float sf[kChunk][kLanes];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lt = t % tiles_per_view;
  const float px = static_cast<float>((lt % grid_x) * kTile + (p % kTile));
  const float py = static_cast<float>((lt / grid_x) * kTile + (p / kTile));
  const int count = min(counts[t], max_per_tile);
  const float4* win = reinterpret_cast<const float4*>(
      windows + static_cast<long long>(t) * max_per_tile * kLanes);

  float logT = 0.f;
  bool done = false;
  float acc_c[4] = {0.f, 0.f, 0.f, 0.f};   // rgb, weight
  float acc_cd[4] = {0.f, 0.f, 0.f, 0.f};  // coord, depth
  float acc_n[3] = {0.f, 0.f, 0.f};        // normal
  float acc_med[4] = {0.f, 0.f, 0.f, 0.f}; // median coord, depth
  float med_pos = -1.f;
  float n_contrib = 0.f;

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    // also the barrier that frees sf from the previous chunk
    if (__syncthreads_and(done ? 1 : 0)) break;
    const int nb = min(kChunk, count - c0);
    float4* dst = reinterpret_cast<float4*>(&sf[0][0]);
    const float4* src = win + static_cast<long long>(c0) * (kLanes / 4);
    for (int i = p; i < nb * (kLanes / 4); i += kPix) dst[i] = src[i];
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float* f = sf[j];
      const float dx = f[0] - px;
      const float dy = f[1] - py;
      // the candidate test rounded op by op (no FMA contraction), as the
      // plain version and the packed kernels (ROADMAP C7)
      const float power = __fsub_rn(
          __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(f[2], dx), dx),
                                     __fmul_rn(__fmul_rn(f[4], dy), dy))),
          __fmul_rn(__fmul_rn(f[3], dx), dy));
      if (power > 0.f) continue;
      const float alpha = fminf(0.99f, f[5] * expf(power));
      if (alpha < kMinAlpha) continue;
      const float next = __fadd_rn(logT, log1pf(-alpha));
      if (next < kLogTerm) {
        done = true;
        break;
      }
      const float t_before = expf(logT);
      const float w = alpha * t_before;
      acc_c[0] += w * f[6];
      acc_c[1] += w * f[7];
      acc_c[2] += w * f[8];
      acc_c[3] += w;
      if (MODE != kColor) {
        const float c0v = f[9] + dx * f[13] + dy * f[16];
        const float c1v = f[10] + dx * f[14] + dy * f[17];
        const float c2v = f[11] + dx * f[15] + dy * f[18];
        const float d = f[12] + dx * f[19] + dy * f[20];
        acc_cd[0] += w * c0v;
        acc_cd[1] += w * c1v;
        acc_cd[2] += w * c2v;
        acc_cd[3] += w * d;
        if (MODE == kFull) {
          acc_n[0] += w * f[21];
          acc_n[1] += w * f[22];
          acc_n[2] += w * f[23];
          if (t_before > 0.5f) {
            acc_med[0] = c0v;
            acc_med[1] = c1v;
            acc_med[2] = c2v;
            acc_med[3] = d;
            med_pos = static_cast<float>(c0 + j);
          }
        }
      }
      logT = next;
      n_contrib = static_cast<float>(c0 + j + 1);
    }
  }

  float4* o = reinterpret_cast<float4*>(
      out + (static_cast<long long>(t) * kPix + p) * kRaw);
  o[0] = make_float4(acc_c[0], acc_c[1], acc_c[2], acc_c[3]);
  o[1] = make_float4(acc_cd[0], acc_cd[1], acc_cd[2], acc_cd[3]);
  o[2] = make_float4(acc_n[0], acc_n[1], acc_n[2], acc_med[0]);
  o[3] = make_float4(acc_med[1], acc_med[2], acc_med[3], logT);
  o[4] = make_float4(n_contrib, med_pos, 0.f, 0.f);
  o[5] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// C interface, loaded with ctypes. windows is (num_tiles, max_per_tile, 32)
// row-major f32, 16-byte aligned; counts (num_tiles,) i32; out is
// (num_tiles, 256, 24) f32. Returns the launch's cudaError_t.
extern "C" int igs_blend_fwd_windowed(const float* windows, int max_per_tile,
                                      const int* counts, int num_tiles,
                                      int grid_x, int tiles_per_view, int mode,
                                      float* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kColor:
      blend_fwd_win_kernel<kColor><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, out);
      break;
    case kColorDepth:
      blend_fwd_win_kernel<kColorDepth><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, out);
      break;
    case kFull:
      blend_fwd_win_kernel<kFull><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
