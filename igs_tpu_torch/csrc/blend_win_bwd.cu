// Windowed blend backward for Hopper (sm_90a): the analytic VJP of
// blend_win_fwd.cu with respect to the windows of pair features.
//
// Replaces the TPU kernel igs_tpu/ops/pallas_blend.py:_bwd_kernel /
// _bwd_one_tile (launched by _blend_raw_bwd, the impl="pallas" route).
// Per tile, every pixel walks its window in reverse from
// limit = min(counts[t], the tile's largest n_contrib). Row j counts for
// pixel p iff the forward accepted it (pallas_blend.py:442-447):
//   j < counts[t], power <= 0, alpha >= 1/255 and j + 1 <= n_contrib(p),
// with power and alpha recomputed with the forward's rounding. With
// T_j = exp(logT before j), w_j = alpha_j T_j and the cotangent u,
//   g_j  = uC.color + uW [+ uCD.(vp,t) + dx uCD.cpx + dy uCD.cpy] [+ uN.nrm]
//   da_j = T_j g_j - (s_{>j} + u_logT) / (1 - alpha_j),  s_{>j} = sum_{k>j} w_k g_k
//   dpower = da alpha, dopacity = da exp(power)  (both 0 where alpha hit 0.99)
// and the chain to dxy, dconic, dcolor and, in color_depth/full, the
// camera-plane lanes; full adds normals and the median contributor's terms
// (pallas_blend.py:482-540). The output is shaped like the windows: per
// slot the 9 (color), 21 (color_depth) or 24 (full) grad lanes read, zero
// in the other lanes and in every slot the walk does not reach
// (pallas_blend.py:427).
//
// T recovery: logT before j is logT after j minus log1p(-alpha_j), walked
// back from the forward's final logT; the subtraction and the suffix sum s
// are compensated (Kahan), as in blend_bwd.cu, so the error stays at a few
// roundings over windows of thousands of rows.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the walked rows read once and their grads written once,
// the untouched rows of the window written once as zeros, the raw and
// cotangent blocks read once; the work is the candidate test (18 flops)
// per walked pixel-pair and the chain (75/137/150 flops with the per-pair
// pixel sum) per accepted one. Operations bound it at a 512^2 training
// view.
//
// Design: one block per tile, 256 threads, one pixel each, as the forward.
// The window is staged through shared memory in batches of 32 rows,
// highest first, loaded as float4. Each thread walks the batch in
// descending order and keeps its per-row contributions; a warp sums each
// row's values over its 32 pixels with xor shuffles (skipped when no pixel
// of the warp touches the row) into shared memory, and after the batch the
// 8 warps' partials are summed in a fixed order and written as whole
// 128-byte rows. No atomics: every slot belongs to one block, and two
// launches give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kLanes = 32;  // feature lanes of a window row
constexpr int kRaw = 24;    // raw / cotangent lanes per pixel
constexpr int kBatch = 32;  // rows staged per step
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;

template <int MODE>
struct ModeLanes {
  // feature lanes read, and grad lanes written
  static constexpr int feat = MODE == kColor ? 9 : (MODE == kColorDepth ? 21 : 24);
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
blend_bwd_win_kernel(const float* __restrict__ windows, int max_per_tile,
                     const int* __restrict__ counts, int grid_x,
                     int tiles_per_view, const float* __restrict__ raw,
                     const float* __restrict__ cot,
                     float* __restrict__ dwindows) {
  constexpr int L = ModeLanes<MODE>::feat;
  __shared__ __align__(16) float sf[kBatch][kLanes];
  __shared__ float part[kWarps][L][kBatch];
  __shared__ int warp_nc[kWarps];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int lt = t % tiles_per_view;
  const float px = static_cast<float>((lt % grid_x) * kTile + (p % kTile));
  const float py = static_cast<float>((lt / grid_x) * kTile + (p / kTile));
  const int count = min(counts[t], max_per_tile);
  const long long base = static_cast<long long>(t) * max_per_tile;
  const float4* win = reinterpret_cast<const float4*>(windows + base * kLanes);
  float4* dwin = reinterpret_cast<float4*>(dwindows + base * kLanes);

  const float* r = raw + (static_cast<long long>(t) * kPix + p) * kRaw;
  const float* u = cot + (static_cast<long long>(t) * kPix + p) * kRaw;
  const int ncontrib = static_cast<int>(r[16]);
  const float medpos = MODE == kFull ? r[17] : -1.f;
  float logT = r[15];
  float logT_c = 0.f;
  float s = 0.f, s_c = 0.f;
  const float uC0 = u[0], uC1 = u[1], uC2 = u[2], uW = u[3];
  const float ulogT = u[15];
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

  // the walk starts at the tile's largest n_contrib (pallas_blend.py:429-431)
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

  // the slots the walk never reaches take zero grads
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = static_cast<long long>(limit) * (kLanes / 4) + p;
       i < static_cast<long long>(max_per_tile) * (kLanes / 4); i += kPix)
    dwin[i] = zero;

  for (int b_end = limit; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int nb = b_end - b0;
    __syncthreads();  // sf and part free from the previous batch
    {
      float4* dst = reinterpret_cast<float4*>(&sf[0][0]);
      const float4* src = win + static_cast<long long>(b0) * (kLanes / 4);
      for (int i = p; i < nb * (kLanes / 4); i += kPix) dst[i] = src[i];
    }
    __syncthreads();
    const bool warp_live = warp_nc[warp] > b0;
    for (int jj = nb - 1; jj >= 0; --jj) {
      const float* f = sf[jj];
      float c[L];
#pragma unroll
      for (int l = 0; l < L; ++l) c[l] = 0.f;
      bool touch = false;
      if (warp_live) {
        const int j = b0 + jj;
        const float dx = f[0] - px;
        const float dy = f[1] - py;
        const float c0 = f[2], c1 = f[3], c2 = f[4];
        // the forward's candidate test, rounded operation by operation
        // (blend_win_fwd.cu), so both sides take the same rows
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(c0, dx), dx),
                                       __fmul_rn(__fmul_rn(c2, dy), dy))),
            __fmul_rn(__fmul_rn(c1, dx), dy));
        const float expp = expf(fminf(power, 0.f));
        const float alpha = fminf(0.99f, f[5] * expp);
        const bool accept = j + 1 <= ncontrib && power <= 0.f && alpha >= kMinAlpha;
        float ddx = 0.f, ddy = 0.f;
        if (accept) {
          touch = true;
          const float l1m = log1pf(-alpha);
          kahan_add(logT, logT_c, -l1m);  // logT before j
          const float T = expf(logT);
          const float w = alpha * T;
          float g = uC0 * f[6] + uC1 * f[7] + uC2 * f[8] + uW;
          float gx = 0.f, gy = 0.f;
          if constexpr (MODE != kColor) {
            gx = uCD[0] * f[13] + uCD[1] * f[14] + uCD[2] * f[15] + uCD[3] * f[19];
            gy = uCD[0] * f[16] + uCD[1] * f[17] + uCD[2] * f[18] + uCD[3] * f[20];
            g += uCD[0] * f[9] + uCD[1] * f[10] + uCD[2] * f[11] + uCD[3] * f[12] +
                 dx * gx + dy * gy;
          }
          if constexpr (MODE == kFull)
            g += uN[0] * f[21] + uN[1] * f[22] + uN[2] * f[23];
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
            ddx += uM[0] * f[13] + uM[1] * f[14] + uM[2] * f[15] + uM[3] * f[19];
            ddy += uM[0] * f[16] + uM[1] * f[17] + uM[2] * f[18] + uM[3] * f[20];
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
    // the 8 warps' partials, summed in warp order; whole rows, one thread
    // per lane, so a warp writes one 128-byte row
    float* out = dwindows + (base + b0) * kLanes;
    for (int idx = p; idx < nb * kLanes; idx += kPix) {
      const int jj = idx / kLanes;
      const int l = idx - jj * kLanes;
      float v = 0.f;
      if (l < L) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += part[w][l][jj];
      }
      out[idx] = v;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. windows and dwindows are
// (num_tiles, max_per_tile, 32) row-major f32, 16-byte aligned; counts
// (num_tiles,) i32; raw and cot (num_tiles, 256, 24) f32. Every element of
// dwindows is written. Returns the launch's cudaError_t.
extern "C" int igs_blend_bwd_windowed(const float* windows, int max_per_tile,
                                      const int* counts, int num_tiles,
                                      int grid_x, int tiles_per_view, int mode,
                                      const float* raw, const float* cot,
                                      float* dwindows, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kColor:
      blend_bwd_win_kernel<kColor><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, raw, cot,
          dwindows);
      break;
    case kColorDepth:
      blend_bwd_win_kernel<kColorDepth><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, raw, cot,
          dwindows);
      break;
    case kFull:
      blend_bwd_win_kernel<kFull><<<num_tiles, kPix, 0, s>>>(
          windows, max_per_tile, counts, grid_x, tiles_per_view, raw, cot,
          dwindows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
