// Packed blend backward for Hopper (sm_90a): the analytic VJP of
// blend_fwd.cu with respect to the packed per-pair features.
//
// Replaces the TPU kernel igs_tpu/ops/pallas_blend.py:_bwd_kernel_packed /
// _bwd_one_tile_packed (launched by _blend_raw_packed_bwd). Per tile, every
// pixel walks the tile's pair segment in reverse from the tile's largest
// n_contrib. Pair j counts for pixel p iff the forward accepted it:
//   j + 1 <= n_contrib(p), power <= 0 and alpha >= 1/255,
// with power and alpha recomputed with the forward's rounding. With
// T_j = exp(logT before j), w_j = alpha_j T_j and the cotangent u,
//   g_j  = uC.color + uW [+ uCD.(vp,t) + dx uCD.cpx + dy uCD.cpy] [+ uN.nrm]
//   da_j = T_j g_j - (s_{>j} + u_logT) / (1 - alpha_j),  s_{>j} = sum_{k>j} w_k g_k
//   dpower = da alpha, dopacity = da exp(power)  (both 0 where alpha hit 0.99)
// and the chain to dxy, dconic, dcolor and, in color_depth/full, the
// camera-plane lanes; full adds normals and the median contributor's terms
// (pallas_blend.py:1282-1349). Output lanes are the input lanes read: 9
// (color), 21 (color_depth) or 24 (full) of the 16/32-lane pack.
//
// T recovery: logT before j is logT after j minus log1p(-alpha_j), walked
// back from the forward's final logT. A plain fp32 walk adds one rounding
// per pair (about 3 150 pairs per tile at the 128^2 depth-carry shape), so
// the subtraction and the suffix sum s are compensated (Kahan): the error
// stays at a few roundings whatever the segment length.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the walked pairs' feature lanes read once and grad lanes
// written once, plus the raw and cotangent blocks read once; the work is
// roughly 3x the forward's flops per walked pixel-pair plus the per-pair
// reduction over the tile's 256 pixels. Operations bound it in all three
// modes, at the eval shape and at the 128^2 depth-carry shape.
//
// Design: one block per tile, 256 threads, one pixel each, as in the
// forward. The segment is staged through shared memory in batches of 32
// pairs, highest first. Each thread walks the batch in descending order
// and keeps its per-pair contributions; a warp sums each pair's values
// over its 32 pixels with xor shuffles (skipped when no pixel of the warp
// touches the pair) into shared memory, and after the batch the 8 warps'
// partials are summed in a fixed order and written out. Every pair belongs
// to one tile, so one block writes each output column: no atomics, and two
// launches give the same bits. Pairs past the tile's largest n_contrib are
// never written (the wrapper zero-fills the output).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 32;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;

template <int MODE>
struct ModeLanes {
  // feature lanes read, and grad lanes written
  static constexpr int feat = MODE == kColor ? 9 : (MODE == kColorDepth ? 21 : 24);
  // raw / cotangent lanes per pixel
  static constexpr int raw = MODE == kColor ? 8 : 24;
};

// Kahan: (sum, comp) += x
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

template <int MODE>
__global__ void __launch_bounds__(kPix)
blend_bwd_packed_kernel(const float* __restrict__ feats, long long mp,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count, int grid_x,
                        int tiles_per_view, const float* __restrict__ raw,
                        const float* __restrict__ cot,
                        float* __restrict__ dfeats) {
  constexpr int L = ModeLanes<MODE>::feat;
  constexpr int NL = ModeLanes<MODE>::raw;
  __shared__ float sf[L][kBatch];
  __shared__ float part[kWarps][L][kBatch];
  __shared__ int warp_nc[kWarps];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int lt = t % tiles_per_view;
  const float px = static_cast<float>((lt % grid_x) * kTile + (p % kTile));
  const float py = static_cast<float>((lt / grid_x) * kTile + (p / kTile));
  const long long start = tile_start[t];
  const int count = tile_count[t];

  const float* r = raw + (static_cast<long long>(t) * kPix + p) * NL;
  const float* u = cot + (static_cast<long long>(t) * kPix + p) * NL;
  const int ncontrib = static_cast<int>(r[MODE == kColor ? 5 : 16]);
  const float medpos = MODE == kFull ? r[17] : -1.f;
  float logT = r[MODE == kColor ? 4 : 15];
  float logT_c = 0.f;
  float s = 0.f, s_c = 0.f;
  const float uC0 = u[0], uC1 = u[1], uC2 = u[2], uW = u[3];
  const float ulogT = u[MODE == kColor ? 4 : 15];
  float uCD[4] = {0.f, 0.f, 0.f, 0.f};
  float uN[3] = {0.f, 0.f, 0.f};
  float uM[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (MODE != kColor) {
#pragma unroll
    for (int k = 0; k < 4; ++k) uCD[k] = u[4 + k];
  }
  if constexpr (MODE == kFull) {
#pragma unroll
    for (int k = 0; k < 3; ++k) uN[k] = u[8 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) uM[k] = u[11 + k];
  }

  // the walk starts at the tile's largest n_contrib (the forward's
  // early-termination point, pallas_blend.py:1089-1102)
  int wmax = ncontrib;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(kFullMask, wmax, o));
  if (lane == 0) warp_nc[warp] = wmax;
  __syncthreads();
  int limit = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) limit = max(limit, warp_nc[w]);
  limit = min(limit, count);

  for (int b_end = limit; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int nb = b_end - b0;
    __syncthreads();  // sf and part free from the previous batch
    if (p < nb) {
      const long long col = start + b0 + p;
#pragma unroll
      for (int l = 0; l < L; ++l) sf[l][p] = feats[l * mp + col];
    }
    __syncthreads();
    const bool warp_live = warp_nc[warp] > b0;
    for (int jj = nb - 1; jj >= 0; --jj) {
      float c[L];
#pragma unroll
      for (int l = 0; l < L; ++l) c[l] = 0.f;
      bool touch = false;
      if (warp_live) {
        const int j = b0 + jj;
        const float dx = sf[0][jj] - px;
        const float dy = sf[1][jj] - py;
        const float c0 = sf[2][jj], c1 = sf[3][jj], c2 = sf[4][jj];
        // the forward's candidate test, rounded operation by operation
        // (blend_fwd.cu:105-115), so both sides take the same pairs
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(c0, dx), dx),
                                       __fmul_rn(__fmul_rn(c2, dy), dy))),
            __fmul_rn(__fmul_rn(c1, dx), dy));
        const float expp = expf(fminf(power, 0.f));
        const float alpha = fminf(0.99f, sf[5][jj] * expp);
        const bool accept = j + 1 <= ncontrib && power <= 0.f && alpha >= kMinAlpha;
        float ddx = 0.f, ddy = 0.f;
        if (accept) {
          touch = true;
          const float l1m = log1pf(-alpha);
          kahan_add(logT, logT_c, -l1m);  // logT before j
          const float T = expf(logT);
          const float w = alpha * T;
          float g = uC0 * sf[6][jj] + uC1 * sf[7][jj] + uC2 * sf[8][jj] + uW;
          float gx = 0.f, gy = 0.f;
          if constexpr (MODE != kColor) {
            gx = uCD[0] * sf[13][jj] + uCD[1] * sf[14][jj] + uCD[2] * sf[15][jj] +
                 uCD[3] * sf[19][jj];
            gy = uCD[0] * sf[16][jj] + uCD[1] * sf[17][jj] + uCD[2] * sf[18][jj] +
                 uCD[3] * sf[20][jj];
            g += uCD[0] * sf[9][jj] + uCD[1] * sf[10][jj] + uCD[2] * sf[11][jj] +
                 uCD[3] * sf[12][jj] + dx * gx + dy * gy;
          }
          if constexpr (MODE == kFull)
            g += uN[0] * sf[21][jj] + uN[1] * sf[22][jj] + uN[2] * sf[23][jj];
          const float da = T * g - (s + ulogT) / (1.f - alpha);
          kahan_add(s, s_c, w * g);
          const float notclip = alpha < 0.99f ? 1.f : 0.f;
          const float dpower = da * alpha * notclip;
          ddx = dpower * (-(c0 * dx + c1 * dy));
          ddy = dpower * (-(c2 * dy + c1 * dx));
          c[2] = dpower * (-0.5f * dx * dx);
          c[3] = dpower * (-dx * dy);
          c[4] = dpower * (-0.5f * dy * dy);
          c[5] = da * expp * notclip;
          c[6] = w * uC0;
          c[7] = w * uC1;
          c[8] = w * uC2;
          if constexpr (MODE != kColor) {
            ddx += w * gx;
            ddy += w * gy;
            const float wdx = w * dx, wdy = w * dy;
            c[9] = w * uCD[0];
            c[10] = w * uCD[1];
            c[11] = w * uCD[2];
            c[12] = w * uCD[3];
            c[13] = wdx * uCD[0];
            c[14] = wdx * uCD[1];
            c[15] = wdx * uCD[2];
            c[16] = wdy * uCD[0];
            c[17] = wdy * uCD[1];
            c[18] = wdy * uCD[2];
            c[19] = wdx * uCD[3];
            c[20] = wdy * uCD[3];
          }
          if constexpr (MODE == kFull) {
            c[21] = w * uN[0];
            c[22] = w * uN[1];
            c[23] = w * uN[2];
          }
        }
        if constexpr (MODE == kFull) {
          if (medpos >= 0.f && static_cast<float>(j) == medpos) {
            // the median contributor: mcoord/mdepth = (vp,t) + dx cpx + dy cpy
            touch = true;
            ddx += uM[0] * sf[13][jj] + uM[1] * sf[14][jj] + uM[2] * sf[15][jj] +
                   uM[3] * sf[19][jj];
            ddy += uM[0] * sf[16][jj] + uM[1] * sf[17][jj] + uM[2] * sf[18][jj] +
                   uM[3] * sf[20][jj];
            c[9] += uM[0];
            c[10] += uM[1];
            c[11] += uM[2];
            c[12] += uM[3];
            c[13] += dx * uM[0];
            c[14] += dx * uM[1];
            c[15] += dx * uM[2];
            c[16] += dy * uM[0];
            c[17] += dy * uM[1];
            c[18] += dy * uM[2];
            c[19] += dx * uM[3];
            c[20] += dy * uM[3];
          }
        }
        c[0] = ddx;
        c[1] = ddy;
      }
      // this warp's sum over its 32 pixels, fixed xor order
      if (__any_sync(kFullMask, touch)) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float v = c[l];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
          c[l] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < L; ++l) part[warp][l][jj] = c[l];
      }
    }
    __syncthreads();
    // the 8 warps' partials, summed in warp order; one column per pair
    for (int idx = p; idx < L * nb; idx += kPix) {
      const int l = idx / nb;
      const int jj = idx - l * nb;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w][l][jj];
      dfeats[l * mp + start + b0 + jj] = v;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. feats and dfeats are (lanes, mp)
// row-major f32 with lanes >= 9 (color) or 24 (color_depth, full); raw and
// cot are (num_tiles, 256, nl) f32, nl = 8 (color) or 24. dfeats must be
// zero on entry: only the walked pairs' grad lanes are written. Returns
// the launch's cudaError_t.
extern "C" int igs_blend_bwd_packed(const float* feats, long long mp,
                                    const int* tile_start, const int* tile_count,
                                    int num_tiles, int grid_x, int tiles_per_view,
                                    int mode, const float* raw, const float* cot,
                                    float* dfeats, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kColor:
      blend_bwd_packed_kernel<kColor><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    case kColorDepth:
      blend_bwd_packed_kernel<kColorDepth><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    case kFull:
      blend_bwd_packed_kernel<kFull><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
