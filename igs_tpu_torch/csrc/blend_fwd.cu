// Packed forward blend for Hopper (sm_90a): per-tile front-to-back alpha
// blending over the tile-sorted pair list.
//
// Replaces the TPU kernel igs_tpu/ops/pallas_blend.py:_fwd_kernel_packed /
// _fwd_one_tile_packed (launched by blend_raw_packed). It computes what
// that kernel computes, per pixel, walking the tile's pair segment in depth
// order:
//   power = -1/2 (c0 dx^2 + c2 dy^2) - c1 dx dy,   dx = mean_x - pix_x
//   alpha = min(0.99, o * exp(min(power, 0)))
//   candidate iff power <= 0 and alpha >= 1/255
//   accept while logT + log1p(-alpha) >= log(1e-4), else the pixel is done
//   w = alpha * exp(logT_before)
// Transmittance stays in log space as on the TPU, so termination at the
// threshold is decided on the same quantity. Accumulators per mode:
//   color       C(3) W | logT n_contrib                    ( 8 raw lanes)
//   color_depth + coord(3) depth from vp/t + dx*cpx + dy*cpy (24 raw lanes)
//   full        + normal(3), median coord/depth/slot taken from the last
//                 accepted Gaussian with T_before > 0.5
// Pixel coordinates are tile*16 + p%16 with no +0.5 (pallas_blend.py:846).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the bytes are the live pairs' features read once
// (9/21/24 floats a pair) plus the raw block written once (T*256*nl
// floats); the work is about 30 flops per pixel per live pair up to the
// pixel's termination. The 256 pixels of a tile share every feature, so a
// feature byte feeds up to 256*30 flops. At the eval shape (5440 tiles,
// 1.2M pairs) color mode is bound by operations (exp/log1p per pixel-pair
// on the SFU and the FMA pipes); color_depth and full by bytes, because
// their 24-lane raw block is as large as the features read. At the 128²
// depth-carry shape (256 tiles, ~3000 pairs each) all modes are bound by
// operations, and this design is short of blocks there.
//
// Design: one block per tile, 256 threads, one pixel each. The segment is
// staged through shared memory in batches of 256 pairs loaded cooperatively
// (thread p loads pair p of the batch, lane by lane, so a warp reads 128
// contiguous bytes of each lane row); every thread then walks the batch
// from shared memory, where all threads read the same address (broadcast,
// no bank conflicts). __syncthreads_count ends the tile once every pixel is
// done — the TPU kernel's early exit. The mode is a template parameter.
// Left for later: cp.async/TMA double buffering of the batches and a
// warp-level layout that skips pairs whose footprint misses the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kBatch = 256;
constexpr float kLogTerm = -9.210340371976182f;  // log(1e-4)
constexpr float kMinAlpha = 1.0f / 255.0f;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;

template <int MODE>
struct ModeLanes {
  // feature lanes read: xy conic o rgb | vp t cpx cpy rp | nrm
  static constexpr int in = MODE == kColor ? 9 : (MODE == kColorDepth ? 21 : 24);
  static constexpr int out = MODE == kColor ? 8 : 24;
};

template <int MODE>
__global__ void __launch_bounds__(kPix)
blend_fwd_packed_kernel(const float* __restrict__ feats, long long mp,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count, int grid_x,
                        int tiles_per_view, float* __restrict__ out) {
  constexpr int L = ModeLanes<MODE>::in;
  constexpr int NL = ModeLanes<MODE>::out;
  __shared__ float sf[L][kBatch];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lt = t % tiles_per_view;
  const float px = static_cast<float>((lt % grid_x) * kTile + (p % kTile));
  const float py = static_cast<float>((lt / grid_x) * kTile + (p / kTile));
  const long long start = tile_start[t];
  const int count = tile_count[t];

  float logT = 0.f;
  bool done = false;
  float acc_c[4] = {0.f, 0.f, 0.f, 0.f};   // rgb, weight
  float acc_cd[4] = {0.f, 0.f, 0.f, 0.f};  // coord, depth
  float acc_n[3] = {0.f, 0.f, 0.f};        // normal
  float acc_med[4] = {0.f, 0.f, 0.f, 0.f}; // median coord, depth
  float med_pos = -1.f;
  float n_contrib = 0.f;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier that frees sf from the previous batch
    if (__syncthreads_count(done ? 1 : 0) == kPix) break;
    const int nb = min(kBatch, count - b0);
    if (p < nb) {
      const long long col = start + b0 + p;
#pragma unroll
      for (int l = 0; l < L; ++l) sf[l][p] = feats[l * mp + col];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float dx = sf[0][j] - px;
      const float dy = sf[1][j] - py;
      // The candidate test decides on power and alpha: round each operation
      // on its own (no FMA contraction), as the plain version does, so the
      // two agree on which Gaussians touch a pixel. A contracted FMA moves
      // power by an ulp and flips alpha >= 1/255 for a few pixel-pairs.
      const float power = __fsub_rn(
          __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(sf[2][j], dx), dx),
                                     __fmul_rn(__fmul_rn(sf[4][j], dy), dy))),
          __fmul_rn(__fmul_rn(sf[3][j], dx), dy));
      if (power > 0.f) continue;
      const float alpha = fminf(0.99f, sf[5][j] * expf(power));
      if (alpha < kMinAlpha) continue;
      // rounded on its own, as in csrc/blend_count.cu, so the two kernels
      // end each pixel's walk at the same pair
      const float next = __fadd_rn(logT, log1pf(-alpha));
      if (next < kLogTerm) {
        done = true;
        break;
      }
      const float t_before = expf(logT);
      const float w = alpha * t_before;
      acc_c[0] += w * sf[6][j];
      acc_c[1] += w * sf[7][j];
      acc_c[2] += w * sf[8][j];
      acc_c[3] += w;
      if (MODE != kColor) {
        const float c0 = sf[9][j] + dx * sf[13][j] + dy * sf[16][j];
        const float c1 = sf[10][j] + dx * sf[14][j] + dy * sf[17][j];
        const float c2 = sf[11][j] + dx * sf[15][j] + dy * sf[18][j];
        const float d = sf[12][j] + dx * sf[19][j] + dy * sf[20][j];
        acc_cd[0] += w * c0;
        acc_cd[1] += w * c1;
        acc_cd[2] += w * c2;
        acc_cd[3] += w * d;
        if (MODE == kFull) {
          acc_n[0] += w * sf[21][j];
          acc_n[1] += w * sf[22][j];
          acc_n[2] += w * sf[23][j];
          if (t_before > 0.5f) {
            acc_med[0] = c0;
            acc_med[1] = c1;
            acc_med[2] = c2;
            acc_med[3] = d;
            med_pos = static_cast<float>(b0 + j);
          }
        }
      }
      logT = next;
      n_contrib = static_cast<float>(b0 + j + 1);
    }
  }

  float4* o = reinterpret_cast<float4*>(out + (static_cast<long long>(t) * kPix + p) * NL);
  if (MODE == kColor) {
    o[0] = make_float4(acc_c[0], acc_c[1], acc_c[2], acc_c[3]);
    o[1] = make_float4(logT, n_contrib, 0.f, 0.f);
  } else {
    o[0] = make_float4(acc_c[0], acc_c[1], acc_c[2], acc_c[3]);
    o[1] = make_float4(acc_cd[0], acc_cd[1], acc_cd[2], acc_cd[3]);
    o[2] = make_float4(acc_n[0], acc_n[1], acc_n[2], acc_med[0]);
    o[3] = make_float4(acc_med[1], acc_med[2], acc_med[3], logT);
    o[4] = make_float4(n_contrib, med_pos, 0.f, 0.f);
    o[5] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// C interface, loaded with ctypes. feats is (lanes, mp) row-major f32 with
// lanes >= 9 (color) or 24 (color_depth, full); out is (num_tiles, 256, nl)
// f32 with nl = 8 (color) or 24. Returns the launch's cudaError_t.
extern "C" int igs_blend_fwd_packed(const float* feats, long long mp,
                                    const int* tile_start, const int* tile_count,
                                    int num_tiles, int grid_x, int tiles_per_view,
                                    int mode, float* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kColor:
      blend_fwd_packed_kernel<kColor><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, out);
      break;
    case kColorDepth:
      blend_fwd_packed_kernel<kColorDepth><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, out);
      break;
    case kFull:
      blend_fwd_packed_kernel<kFull><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
