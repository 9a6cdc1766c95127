// Blend backward for Hopper (sm_90a): the analytic VJP of blend_fwd.cu's
// packed and windowed blends with respect to the per-pair features.
//
// Replaces two TPU kernels, one body serving both:
//  - B2, igs_tpu/ops/pallas_blend.py:_bwd_kernel_packed /
//    _bwd_one_tile_packed (launched by _blend_raw_packed_bwd), entry
//    igs_blend_bwd_packed;
//  - B5b, :_bwd_kernel / _bwd_one_tile (launched by _blend_raw_bwd),
//    whose VJP goes to the (T, max_per_tile, 32) windows and which XLA
//    then folds through gather_tile_windows to the pair features. Entry
//    igs_blend_bwd_windowed computes that composition directly: tile t
//    walks pairs tile_start[t] + r, r < counts[t] = min(tile_count,
//    max_per_tile), and writes their grads in place; the windows exist
//    on the TPU only because a BlockSpec needs a rectangular block, and
//    writing them would cost more than the walk (1 GiB at a 512^2 view
//    and window 8192). The two differ only in the raw / cotangent
//    layout (RawLanes): the windowed one has 24 lanes in every mode.
//
// Per tile, every
// pixel walks the tile's pair segment in reverse from the tile's largest
// n_contrib. Pair j counts for pixel p iff the forward accepted it:
//   j + 1 <= n_contrib(p), power <= 0 and alpha >= 1/255,
// with power and alpha recomputed with the forward's rounding (C7). With
// T_j = exp(logT before j), w_j = alpha_j T_j and the cotangent u,
//   g_j  = uC.color + uW [+ uCD.(vp,t) + dx uCD.cpx + dy uCD.cpy] [+ uN.nrm]
//   da_j = T_j g_j - (s_{>j} + u_logT) / (1 - alpha_j),  s_{>j} = sum_{k>j} w_k g_k
//   dpower = da alpha, dopacity = da exp(power)  (both 0 where alpha hit 0.99)
// and the chain to dxy, dconic, dcolor and, in color_depth/full, the
// camera-plane lanes; full adds normals and the median contributor's terms
// (pallas_blend.py:1282-1349). Output lanes are the input lanes read: 9
// (color), 21 (color_depth) or 24 (full) of the 16/32-lane pack (the
// windowed route's pack has 32 lanes in every mode).
//
// T recovery (C8): logT before j is logT after j minus log1p(-alpha_j),
// walked back from the forward's final logT. A plain fp32 walk adds one
// rounding per pair (about 3 150 pairs per tile at the 128^2 depth-carry
// shape), so the subtraction and the suffix sum s are compensated (Kahan):
// the error stays at a few roundings whatever the segment length.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the walked pairs' feature lanes read once and grad lanes
// written once, plus the raw and cotangent blocks read once; the work is
// roughly 3x the forward's flops per walked pixel-pair plus the per-pair
// reduction over the tile's 256 pixels; bytes are the larger in every
// case of PERF.md's kernel table (0.007-0.093 ms). The first kernel (one pixel a thread, 8 warps a tile) tested
// every pair at every pixel, summed each grad lane of a pair with five
// xor shuffles (45 in color mode, 120 in full), wrote the L sums from
// lane 0 alone, and loaded each 32-pair batch with no prefetch.
//
// Design: one block per tile, 256 threads, one pixel each; warp w covers
// an 8x4 pixel rectangle, as in the forward.
//  - Skipping by candidate box, as the forward: when a stage lands, thread t
//    computes pair t's candidate box (blend_common.cuh) and a bit per warp
//    whose rectangle it meets; each warp walks only its pairs (a ballot
//    over 32 pairs' bytes, the set bits from the top). A skipped pair is
//    rejected at every pixel of the warp, so no pixel's walk changes.
//  - The warp sum is a transpose-reduce: the per-thread grad vector is
//    padded to LP = 16 (color) or 32 lanes, and each xor step sends the
//    half of the vector the partner keeps: 8+4+2+1+1 = 16 shuffles for
//    color (45 before), 16+8+4+2+1 = 31 otherwise (120 before). Lane l
//    ends with the sum of grad lane l (color: lanes 2l, 2l+1), so the
//    shared store is one per lane. The order is fixed: bitwise
//    repeatable, no atomics.
//  - Stages of 128 pairs in color mode and 32 otherwise (two stages and
//    the 8 warps' partials within 48 KB of static shared memory), highest
//    first, staged with cp.async: the next (lower) stage loads while this
//    one is walked. The partials' rows are padded by one float, so the
//    lanes of one store fall in distinct banks.
//  - Tiles launch deepest first, as in the forward (tile_order_kernel).
//  - After a stage the warps' partials are summed in warp order (a warp
//    that took no pixel of a pair adds nothing) and written, one block
//    per tile, so one block writes each output column. Pairs past the
//    tile's largest n_contrib are never written (the wrapper zero-fills
//    the output).
// The constants are the fastest of the variants timed against the first
// kernel on the same inputs in one call on an H100 (PERF.md, Findings).
// Several pixels a thread (4 or 2, 64-128 threads a tile, sums started in
// registers) lost: a warp's rectangle grows, so fewer pairs are skipped,
// and fewer warps walk a deep tile (4 a thread: 18 % slower than one at
// eval color, 2.5x at 128^2). 16x2 rectangles lost 3-11 % in color mode.
// Taking the T-independent work of two pairs ahead of the chain lost 7 %
// at eval color and up to 41 % in color_depth/full at 128^2; __expf for T
// and a reciprocal for the division moved nothing (within 1.5 %); writing
// a pair's grads from its one lane without the reduce lost 3-5 %; the box
// in fp32 but for the determinant was up to 8 % faster than in double,
// and holding each rectangle the box meets against the ellipse itself
// lost 4-37 %; the deepest-first order cut 11-17 % at eval and 512^2;
// 128-pair stages in color mode cut 6-10 % at 512^2 and 128^2 against 64,
// the padding 0-1.4 %. Faster than the first kernel in every case
// measured, but short of 0.24 ms at eval color: per warp and pair it
// still runs the candidate test, the accepted chain and the reduce, and
// its deepest tile alone takes 0.12 of its 0.31 ms (PERF.md).
// -Xptxas -v (chip_smoke.py logs it at every build): 58 / 62 / 72
// registers (color / color_depth / full), 47 680 / 27 904 / 31 840 bytes
// of shared memory, no spills; the order kernel 32 registers, 512 bytes.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using igs_blend::cp_async4;
using igs_blend::cp_async_commit;
using igs_blend::cp_async_wait_all;
using igs_blend::tile_order_kernel;
using igs_blend::warp_mask;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;

template <int MODE>
struct ModeLanes {
  // feature lanes read, and grad lanes written
  static constexpr int feat = MODE == kColor ? 9 : (MODE == kColorDepth ? 21 : 24);
  // the transpose-reduce's vector
  static constexpr int pad = MODE == kColor ? 16 : 32;
  // pairs a stage (two stages and 8 warps' partials within 48 KB)
  static constexpr int batch = MODE == kColor ? 128 : 32;
};

// The raw / cotangent layout per pixel: NL = 8 is the packed color
// layout [C W logT n_contrib pad]; NL = 24 is the packed color_depth/full
// layout and the windowed one in every mode [C W coord D nrm mcoord
// mdepth_t logT n_contrib med_pos pad] (ops/blend_windowed.py).
template <int NL>
struct RawLanes {
  static_assert(NL == 8 || NL == 24, "raw layouts are 8 or 24 lanes");
  static constexpr int logT = NL == 8 ? 4 : 15;
  static constexpr int ncontrib = NL == 8 ? 5 : 16;
  static constexpr int medpos = 17;  // NL = 24 only
};

// Kahan: (sum, comp) += x
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// one step of the transpose-reduce: v[0, N) → v[0, N/2), exchanging with
// the lane O apart; the lane with bit O keeps the upper half
template <int LP, int N, int O>
__device__ __forceinline__ void tr_step(float (&v)[LP], int lane) {
  const bool up = (lane & O) != 0;
  if constexpr (N > 1) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float send = up ? v[k] : v[k + N / 2];
      const float keep = up ? v[k + N / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(kFullMask, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(kFullMask, v[0], O);
  }
}

// the warp's sum of v[l] over its 32 lanes, for every l < LP: lane l
// (LP = 32) or lanes 2l and 2l+1 (LP = 16) end with it in v[0]
template <int LP>
__device__ __forceinline__ void transpose_reduce(float (&v)[LP], int lane) {
  tr_step<LP, LP, 16>(v, lane);
  tr_step<LP, LP / 2, 8>(v, lane);
  tr_step<LP, LP / 4, 4>(v, lane);
  tr_step<LP, LP / 8, 2>(v, lane);
  tr_step<LP, LP / 16, 1>(v, lane);
}

template <int MODE, int NL>
__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ feats, long long mp,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const int* __restrict__ order, int grid_x,
                        int tiles_per_view, const float* __restrict__ raw,
                        const float* __restrict__ cot,
                        float* __restrict__ dfeats) {
  constexpr int L = ModeLanes<MODE>::feat;
  constexpr int LP = ModeLanes<MODE>::pad;
  constexpr int B = ModeLanes<MODE>::batch;
  __shared__ float sf[2][L][B];
  __shared__ float part[kWarps][L][B + 1];  // +1: one store, 32 banks
  __shared__ unsigned char smask[2][B];
  __shared__ unsigned char took[kWarps][B];  // warp w wrote part[w][.][j]
  __shared__ int warp_nc[kWarps];

  const int t = order[blockIdx.x];  // deepest tiles first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // warp w covers an 8x4 pixel rectangle, as in the forward
  const int lx = (warp & 1) * 8 + (lane & 7);
  const int ly = (warp >> 1) * 4 + (lane >> 3);
  const int lt = t % tiles_per_view;
  const int tx0 = (lt % grid_x) * kTile;
  const int ty0 = (lt / grid_x) * kTile;
  const float px = static_cast<float>(tx0 + lx);
  const float py = static_cast<float>(ty0 + ly);
  const long long start = tile_start[t];
  const int count = tile_count[t];

  const long long pix = static_cast<long long>(t) * kPix + ly * kTile + lx;
  const float* r = raw + pix * NL;
  const float* u = cot + pix * NL;
  const int ncontrib = static_cast<int>(r[RawLanes<NL>::ncontrib]);
  const float medpos = MODE == kFull ? r[RawLanes<NL>::medpos] : -1.f;
  float logT = r[RawLanes<NL>::logT];
  float logT_c = 0.f;
  float s = 0.f, s_c = 0.f;
  const float uC0 = u[0], uC1 = u[1], uC2 = u[2], uW = u[3];
  const float ulogT = u[RawLanes<NL>::logT];
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

  auto stage = [&](int buf, int b0, int nb) {
    for (int i = tid; i < nb; i += kPix) {
      const float* src = feats + start + b0 + i;
#pragma unroll
      for (int l = 0; l < L; ++l) cp_async4(&sf[buf][l][i], src + l * mp);
    }
    cp_async_commit();
  };

  if (limit > 0) {
    const int b0 = max(0, limit - B);
    stage(0, b0, limit - b0);
  }
  int buf = 0;
  for (int b_end = limit; b_end > 0; b_end -= B, buf ^= 1) {
    const int b0 = max(0, b_end - B);
    const int nb = b_end - b0;
    cp_async_wait_all();
    __syncthreads();  // the stage has landed; part and took are free
    for (int i = tid; i < nb; i += kPix) {
      const unsigned m = warp_mask(
          sf[buf][0][i], sf[buf][1][i], sf[buf][2][i], sf[buf][3][i],
          sf[buf][4][i], sf[buf][5][i], kMinAlpha, tx0, ty0);
      smask[buf][i] = static_cast<unsigned char>(m);
    }
    for (int i = lane; i < nb; i += 32) took[warp][i] = 0;
    if (b0 > 0) {
      const int nb0 = max(0, b0 - B);
      stage(buf ^ 1, nb0, b0 - nb0);
    }
    __syncthreads();  // the masks

    float (*f)[B] = sf[buf];
    for (int g = ((nb - 1) / 32) * 32; g >= 0; g -= 32) {
      unsigned bits = __ballot_sync(
          kFullMask, g + lane < nb && ((smask[buf][g + lane] >> warp) & 1u));
      while (bits) {
        const int hi = 31 - __clz(bits);
        bits ^= 1u << hi;
        const int jj = g + hi;
        const int j = b0 + jj;
        float c[LP];
#pragma unroll
        for (int l = 0; l < LP; ++l) c[l] = 0.f;
        bool touch = false;
        const float dx = f[0][jj] - px;
        const float dy = f[1][jj] - py;
        const float c0 = f[2][jj], c1 = f[3][jj], c2 = f[4][jj];
        // the forward's candidate test, rounded operation by operation
        // (blend_fwd.cu), so both sides take the same pairs
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(c0, dx), dx),
                                       __fmul_rn(__fmul_rn(c2, dy), dy))),
            __fmul_rn(__fmul_rn(c1, dx), dy));
        const float expp = expf(fminf(power, 0.f));
        const float alpha = fminf(0.99f, f[5][jj] * expp);
        const bool accept = j + 1 <= ncontrib && power <= 0.f && alpha >= kMinAlpha;
        float ddx = 0.f, ddy = 0.f;
        if (accept) {
          touch = true;
          const float l1m = log1pf(-alpha);
          kahan_add(logT, logT_c, -l1m);  // logT before j
          const float T = expf(logT);
          const float w = alpha * T;
          float g_ = uC0 * f[6][jj] + uC1 * f[7][jj] + uC2 * f[8][jj] + uW;
          float gx = 0.f, gy = 0.f;
          if constexpr (MODE != kColor) {
            gx = uCD[0] * f[13][jj] + uCD[1] * f[14][jj] + uCD[2] * f[15][jj] +
                 uCD[3] * f[19][jj];
            gy = uCD[0] * f[16][jj] + uCD[1] * f[17][jj] + uCD[2] * f[18][jj] +
                 uCD[3] * f[20][jj];
            g_ += uCD[0] * f[9][jj] + uCD[1] * f[10][jj] + uCD[2] * f[11][jj] +
                  uCD[3] * f[12][jj] + dx * gx + dy * gy;
          }
          if constexpr (MODE == kFull)
            g_ += uN[0] * f[21][jj] + uN[1] * f[22][jj] + uN[2] * f[23][jj];
          const float da = T * g_ - (s + ulogT) / (1.f - alpha);
          kahan_add(s, s_c, w * g_);
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
            ddx += uM[0] * f[13][jj] + uM[1] * f[14][jj] + uM[2] * f[15][jj] +
                   uM[3] * f[19][jj];
            ddy += uM[0] * f[16][jj] + uM[1] * f[17][jj] + uM[2] * f[18][jj] +
                   uM[3] * f[20][jj];
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
        if (__any_sync(kFullMask, touch)) {
          transpose_reduce<LP>(c, lane);
          const int l = LP == 32 ? lane : lane >> 1;
          if (l < L && (LP == 32 || (lane & 1) == 0)) part[warp][l][jj] = c[0];
          if (lane == 0) took[warp][jj] = 1;
        }
      }
    }
    __syncthreads();
    // the warps' partials, summed in warp order; one column per pair
    for (int idx = tid; idx < L * nb; idx += kPix) {
      const int l = idx / nb;
      const int jj = idx - l * nb;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (took[w][jj]) acc += part[w][l][jj];
      dfeats[l * mp + start + b0 + jj] = acc;
    }
  }
  cp_async_wait_all();
}

// the order kernel, then the backward in `mode` with raw / cotangent
// layout NL (wide: 24 lanes in every mode)
template <bool WIDE>
int launch(const float* feats, long long mp, const int* tile_start,
           const int* tile_count, int* order, int num_tiles, int grid_x,
           int tiles_per_view, int mode, const float* raw, const float* cot,
           float* dfeats, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, 1024, 0, s>>>(tile_count, num_tiles, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (mode) {
    case kColor:
      blend_bwd_kernel<kColor, WIDE ? 24 : 8><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, order, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    case kColorDepth:
      blend_bwd_kernel<kColorDepth, 24><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, order, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    case kFull:
      blend_bwd_kernel<kFull, 24><<<num_tiles, kPix, 0, s>>>(
          feats, mp, tile_start, tile_count, order, grid_x, tiles_per_view, raw, cot,
          dfeats);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. feats and dfeats are (lanes, mp)
// row-major f32 with lanes >= 9 (color) or 24 (color_depth, full); dfeats
// must be zero on entry: only the walked pairs' grad lanes are written.
// Tile t's pairs are feats[:, tile_start[t] + j] for j < tile_count[t].
// order is num_tiles int32 of scratch (the launch order, written here).
// Each returns the launches' cudaError_t.
//
// The packed backward (B2): raw and cot are (num_tiles, 256, nl) f32,
// nl = 8 (color) or 24.
extern "C" int igs_blend_bwd_packed(const float* feats, long long mp,
                                    const int* tile_start, const int* tile_count,
                                    int* order, int num_tiles, int grid_x,
                                    int tiles_per_view, int mode,
                                    const float* raw, const float* cot,
                                    float* dfeats, void* stream) {
  return launch<false>(feats, mp, tile_start, tile_count, order, num_tiles,
                       grid_x, tiles_per_view, mode, raw, cot, dfeats, stream);
}

// The windowed backward (B5b): the same walk over the pairs of the
// windowed route, tile_count = counts = min(tile_count, max_per_tile);
// raw and cot are (num_tiles, 256, 24) f32 in every mode.
extern "C" int igs_blend_bwd_windowed(const float* feats, long long mp,
                                      const int* tile_start, const int* counts,
                                      int* order, int num_tiles, int grid_x,
                                      int tiles_per_view, int mode,
                                      const float* raw, const float* cot,
                                      float* dfeats, void* stream) {
  return launch<true>(feats, mp, tile_start, counts, order, num_tiles, grid_x,
                      tiles_per_view, mode, raw, cot, dfeats, stream);
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
