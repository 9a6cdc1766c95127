// Forward blend for Hopper (sm_90a): per-tile front-to-back alpha blending
// over the tile-sorted pair list, and the contribution count on the same
// walk.
//
// Replaces three TPU kernels, one body serving all:
//  - B1, igs_tpu/ops/pallas_blend.py:_fwd_kernel_packed /
//    _fwd_one_tile_packed (launched by blend_raw_packed), entry
//    igs_blend_fwd_packed;
//  - B5a, :_fwd_kernel / _fwd_one_tile (launched by blend_raw, the
//    impl="pallas" route), which blends (T, max_per_tile, 32) windows
//    gathered from the pair features. Entry igs_blend_fwd_windowed reads
//    the pair rows in place instead: tile t walks pairs tile_start[t] + r,
//    r < counts[t] = min(tile_count, max_per_tile), which are the rows of
//    its window the TPU kernel reads; the window exists on the TPU only
//    because a BlockSpec needs a rectangular block (1 GiB at a 512^2 view
//    and window 8192). It differs from B1 only in the raw layout (NL):
//    24 lanes in every mode, the geometry lanes zero in color mode and
//    med_pos -1 outside full mode;
//  - B4, :_count_kernel / _count_one_tile (launched by
//    count_contributions_pallas) with the segment_sum after it, entry
//    igs_count_contributions_packed (MODE kCount): per (view, Gaussian)
//    row, the pixels whose accepted contributor set holds it. The walk is
//    B1's; each pair's row is read through gauss_id (six words from
//    rows + 6 g, opacity 0 for an id of -1), and pixels outside the image
//    (the partial tiles of the right and bottom edge) start done, as in
//    the TPU kernel; the blends have no such rule (the untiling crops).
//
// Per pixel, walking the tile's pair segment in depth order:
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
//   count       none: each warp's accepting pixels, per pair
// Pixel coordinates are tile*16 + p%16 with no +0.5 (pallas_blend.py:846).
//
// Pairs taken (C7): every mode walks each pixel's chain the same way, and
// so does the backward (csrc/blend_bwd.cu): the candidate test rounded op
// by op, alpha = fminf(0.99, o * expf(power)), logT advanced by
// __fadd_rn(logT, log1pf(-alpha)) in pair order. So n_contrib and med_pos
// are bit-equal to the first (unskipped) kernel's, the windowed raw is
// bit-equal to the packed one where no window truncates, and the count's
// total equals the packed forward's accepted pixel-pairs inside the image.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the bytes are the live pairs' features read once
// (9/21/24 floats a pair; the count: the id and 6 floats) plus the raw
// block written once (T*256*nl floats; the count: one int a row); the
// work is about 30 flops per pixel per live pair up to the pixel's
// termination (16 for a rejected candidate test), counted on the
// pixel-pairs each run accepts; bytes are the larger for the blends in
// every case of PERF.md's kernel table (0.007-0.026 ms).
// What held the first kernels back was not that work but the pairs each
// warp tested for nothing: at 128^2 most of a tile's pairs (up to 36 629
// in one tile) touch a few of its 256 pixels, and every warp still ran
// the test, serially, one pair in flight, for every pair; the launch
// lasted as long as its deepest tile.
//
// Design: one block per tile, 256 threads, one pixel each; warp w covers
// an 8x4 pixel rectangle (x = (w&1)*8 + lane%8, y = (w>>1)*4 + lane/8).
//  - Batches of pairs (256 in color and count mode, 128 otherwise, so
//    that two stages of 21/24 lanes fit the 48 KB of static shared memory)
//    are staged with cp.async into two stages: batch b+1 loads while batch
//    b is walked. The count loads the ids of batch b+2 as b+1 is staged.
//  - When a batch lands, thread t computes pair t's candidate box
//    (blend_common.cuh: a conservative bound on where its candidate test
//    can pass) and stores one byte with a bit per warp whose rectangle it
//    meets (warp_mask).
//  - Each warp walks only its pairs: a ballot over 32 pairs' bytes, then
//    the set bits in ascending order. The logT-independent work (the
//    candidate test, alpha, log1pf(-alpha)) of two pairs is computed
//    before either enters the chain, so two pairs are in flight.
//  - The count: per walked pair, each warp adds __popc of the ballot of
//    its accepting pixels to the pair's shared counter (an integer
//    atomic); after the stage, one global atomicAdd per pair with a
//    nonzero count. Integer sums are exact and order-free: the output
//    repeats bit for bit.
//  - A warp stops once its 32 pixels are done; __syncthreads_count ends
//    the tile once all 256 are (the TPU kernel's early exit).
//  - Tiles launch deepest first (tile_order_kernel, blend_common.cuh, a
//    one-block bucket sort in the same C call), so the deepest tile no
//    longer starts wherever it lies in the image and sets the tail.
// The mode and raw layout are template parameters. The constants are the
// fastest of the variants timed against the first kernel on the same
// inputs in one call on an H100 (PERF.md, Findings): 128-pair stages in
// color mode lost 8-13 % at 128^2 and 512^2; the walk written for any
// number of pairs in flight lost up to 36 %, and four pairs at a time
// (then two) up to 19 % at 128^2 color_depth; the box in fp32 but for the
// determinant was up to 13 % faster than in double at 128^2 and 512^2 and
// within 5 % elsewhere, and holding each rectangle the box meets against
// the ellipse itself lost 1-20 %. The deepest-first order cut 11-17 % at
// eval and 512^2, where torch.argsort's 0.03-0.05 ms ate it; the bucket
// kernel keeps it. Faster than the first kernels in every case measured.
// -Xptxas -v (chip_smoke.py logs it at every build): 40 / 48 / 56
// registers (color in either layout / color_depth / full) and 39 for the
// count, 18 944 / 21 760 / 24 832 / 15 872 bytes of shared memory, no
// spills; the order kernel 32 registers, 512 bytes.

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
constexpr float kLogTerm = -9.210340371976182f;  // log(1e-4)
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kColor = 0;
constexpr int kColorDepth = 1;
constexpr int kFull = 2;
constexpr int kCount = 3;  // not a blend mode: the contribution count
constexpr int kCountLanes = 6;  // a count row: xy conic(3) opacity

template <int MODE>
struct ModeLanes {
  // feature lanes read: xy conic o rgb | vp t cpx cpy rp | nrm
  static constexpr int in = MODE == kCount ? kCountLanes
                            : MODE == kColor ? 9
                            : MODE == kColorDepth ? 21 : 24;
  static constexpr int batch = MODE == kColor || MODE == kCount ? 256 : 128;
};

// MODE kColor/kColorDepth/kFull: feats is (lanes, mp) row-major, tile t's
// pairs its columns tile_start[t] + j, j < tile_count[t]; the raw block
// out is (num_tiles, 256, NL) with NL = 8 (color only) or 24. MODE kCount:
// feats is the (R, 6) row-major rows, pair j's row is gauss_id[j]; counts
// is (R,) int32, added to; width/height mark the pixels that start done.
template <int MODE, int NL>
__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ feats, long long mp,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 const int* __restrict__ order, int grid_x,
                 int tiles_per_view, int width, int height,
                 float* __restrict__ out, int* __restrict__ counts) {
  constexpr bool kCounting = MODE == kCount;
  constexpr int L = ModeLanes<MODE>::in;
  constexpr int B = ModeLanes<MODE>::batch;
  static_assert(NL == 8 || NL == 24, "raw layouts are 8 or 24 lanes");
  static_assert(NL == 24 || MODE == kColor || kCounting,
                "the 8-lane layout is color mode's");
  static_assert(!kCounting || B == kPix, "the count stages a pair a thread");
  __shared__ float sf[2][L][B];
  __shared__ unsigned char smask[2][B];
  // the count: each staged pair's row, and its accepting pixels
  __shared__ int sg[kCounting ? 2 : 1][kCounting ? B : 1];
  __shared__ int shits[kCounting ? B : 1];

  const int t = order[blockIdx.x];  // deepest tiles first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lx = (warp & 1) * 8 + (lane & 7);
  const int ly = (warp >> 1) * 4 + (lane >> 3);
  const int p = ly * kTile + lx;
  const int lt = t % tiles_per_view;
  const int tx0 = (lt % grid_x) * kTile;
  const int ty0 = (lt / grid_x) * kTile;
  const float px = static_cast<float>(tx0 + lx);
  const float py = static_cast<float>(ty0 + ly);
  const long long start = tile_start[t];
  const int count = tile_count[t];

  float logT = 0.f;
  bool done = kCounting && (tx0 + lx >= width || ty0 + ly >= height);
  float acc_c[4] = {0.f, 0.f, 0.f, 0.f};   // rgb, weight
  float acc_cd[4] = {0.f, 0.f, 0.f, 0.f};  // coord, depth
  float acc_n[3] = {0.f, 0.f, 0.f};        // normal
  float acc_med[4] = {0.f, 0.f, 0.f, 0.f}; // median coord, depth
  float med_pos = -1.f;
  float n_contrib = 0.f;

  // the count: the row id of pair b0 + tid, loaded a stage ahead
  auto load_id = [&](int b0) {
    return b0 + tid < count ? gauss_id[start + b0 + tid] : -1;
  };
  int next_id = kCounting ? load_id(0) : -1;

  auto stage = [&](int buf, int b0) {
    const int nb = min(B, count - b0);
    if constexpr (kCounting) {
      const int g = next_id;
      next_id = load_id(b0 + B);
      if (tid < nb) {
        sg[buf][tid] = g;
        if (g >= 0) {
          const float* src = feats + static_cast<long long>(kCountLanes) * g;
#pragma unroll
          for (int l = 0; l < L; ++l) cp_async4(&sf[buf][l][tid], src + l);
        } else {
#pragma unroll
          for (int l = 0; l < L; ++l) sf[buf][l][tid] = 0.f;  // never taken
        }
      }
    } else {
      for (int i = tid; i < nb; i += kPix) {
        const float* src = feats + start + b0 + i;
#pragma unroll
        for (int l = 0; l < L; ++l) cp_async4(&sf[buf][l][i], src + l * mp);
      }
    }
    cp_async_commit();
  };

  // the logT-independent part of pair j of the stage: the candidate test
  // rounded op by op (no FMA contraction, as the plain versions), alpha,
  // and log1pf(-alpha)
  struct Pre {
    float dx, dy, alpha, l1m;
    bool cand;
  };
  auto pre = [&](float (*s)[B], int j) {
    Pre e;
    e.dx = s[0][j] - px;
    e.dy = s[1][j] - py;
    const float power = __fsub_rn(
        __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(s[2][j], e.dx), e.dx),
                                   __fmul_rn(__fmul_rn(s[4][j], e.dy), e.dy))),
        __fmul_rn(__fmul_rn(s[3][j], e.dx), e.dy));
    e.alpha = fminf(0.99f, s[5][j] * expf(power));
    e.cand = !(power > 0.f) && !(e.alpha < kMinAlpha);
    e.l1m = log1pf(-e.alpha);
    return e;
  };

  // the chain: pair j (slot b0 + j) after every earlier pair; true when
  // the pixel accepts it
  auto chain = [&](float (*s)[B], int b0, int j, const Pre& e) {
    if (done || !e.cand) return false;
    const float next = __fadd_rn(logT, e.l1m);
    if (next < kLogTerm) {
      done = true;
      return false;
    }
    if constexpr (!kCounting) {
      const float dx = e.dx, dy = e.dy;
      const float t_before = expf(logT);
      const float w = e.alpha * t_before;
      acc_c[0] += w * s[6][j];
      acc_c[1] += w * s[7][j];
      acc_c[2] += w * s[8][j];
      acc_c[3] += w;
      if constexpr (MODE != kColor) {
        const float c0 = s[9][j] + dx * s[13][j] + dy * s[16][j];
        const float c1 = s[10][j] + dx * s[14][j] + dy * s[17][j];
        const float c2 = s[11][j] + dx * s[15][j] + dy * s[18][j];
        const float d = s[12][j] + dx * s[19][j] + dy * s[20][j];
        acc_cd[0] += w * c0;
        acc_cd[1] += w * c1;
        acc_cd[2] += w * c2;
        acc_cd[3] += w * d;
        if constexpr (MODE == kFull) {
          acc_n[0] += w * s[21][j];
          acc_n[1] += w * s[22][j];
          acc_n[2] += w * s[23][j];
          if (t_before > 0.5f) {
            acc_med[0] = c0;
            acc_med[1] = c1;
            acc_med[2] = c2;
            acc_med[3] = d;
            med_pos = static_cast<float>(b0 + j);
          }
        }
      }
      n_contrib = static_cast<float>(b0 + j + 1);
    }
    logT = next;
    return true;
  };

  // the count: the warp's accepting pixels of pair j, onto its counter
  auto tally = [&](int j, bool accepted) {
    if constexpr (kCounting) {
      const unsigned hits = __ballot_sync(kFullMask, accepted);
      if (lane == 0 && hits) atomicAdd(&shits[j], __popc(hits));
    }
  };

  // per stage: land, mark each pair's warps, load the next, walk
  if (count > 0) stage(0, 0);
  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += B, buf ^= 1) {
    cp_async_wait_all();
    // the stage has landed; also the barrier after the previous walk
    if (__syncthreads_count(done ? 1 : 0) == kPix) break;
    const int nb = min(B, count - b0);
    for (int i = tid; i < nb; i += kPix) {
      const unsigned m = warp_mask(
          sf[buf][0][i], sf[buf][1][i], sf[buf][2][i], sf[buf][3][i],
          sf[buf][4][i], sf[buf][5][i], kMinAlpha, tx0, ty0);
      smask[buf][i] = static_cast<unsigned char>(m);
      if constexpr (kCounting) shits[i] = 0;
    }
    if (b0 + B < count) stage(buf ^ 1, b0 + B);
    __syncthreads();  // the masks
    float (*s)[B] = sf[buf];
    for (int g = 0; g < nb; g += 32) {
      if (__all_sync(kFullMask, done)) break;
      unsigned bits = __ballot_sync(
          kFullMask, g + lane < nb && ((smask[buf][g + lane] >> warp) & 1u));
      while (bits) {
        const int j0 = g + __ffs(bits) - 1;
        bits &= bits - 1;
        if (bits) {
          const int j1 = g + __ffs(bits) - 1;
          bits &= bits - 1;
          const Pre e0 = pre(s, j0);
          const Pre e1 = pre(s, j1);
          const bool a0 = chain(s, b0, j0, e0);
          const bool a1 = chain(s, b0, j1, e1);
          tally(j0, a0);
          tally(j1, a1);
        } else {
          const Pre e0 = pre(s, j0);
          tally(j0, chain(s, b0, j0, e0));
        }
      }
    }
    if constexpr (kCounting) {
      __syncthreads();  // the stage's tallies
      if (tid < nb && shits[tid] > 0) atomicAdd(counts + sg[buf][tid], shits[tid]);
    }
  }
  cp_async_wait_all();  // a break may leave a stage in flight

  if constexpr (!kCounting) {
    float4* o = reinterpret_cast<float4*>(
        out + (static_cast<long long>(t) * kPix + p) * NL);
    if constexpr (NL == 8) {
      o[0] = make_float4(acc_c[0], acc_c[1], acc_c[2], acc_c[3]);
      o[1] = make_float4(logT, n_contrib, 0.f, 0.f);
    } else {
      // color mode: the geometry and median lanes stay zero, med_pos -1
      o[0] = make_float4(acc_c[0], acc_c[1], acc_c[2], acc_c[3]);
      o[1] = make_float4(acc_cd[0], acc_cd[1], acc_cd[2], acc_cd[3]);
      o[2] = make_float4(acc_n[0], acc_n[1], acc_n[2], acc_med[0]);
      o[3] = make_float4(acc_med[1], acc_med[2], acc_med[3], logT);
      o[4] = make_float4(n_contrib, med_pos, 0.f, 0.f);
      o[5] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the order kernel over tile_count, then the kernel in MODE with raw
// layout NL over the tiles
template <int MODE, int NL>
int launch(const float* feats, long long mp, const int* gauss_id,
           const int* tile_start, const int* tile_count, int* order,
           int num_tiles, int grid_x, int tiles_per_view, int width,
           int height, float* out, int* counts, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, 1024, 0, s>>>(tile_count, num_tiles, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_fwd_kernel<MODE, NL><<<num_tiles, kPix, 0, s>>>(
      feats, mp, gauss_id, tile_start, tile_count, order, grid_x,
      tiles_per_view, width, height, out, counts);
  return static_cast<int>(cudaGetLastError());
}

// a blend in `mode`, its raw layout 24 lanes in every mode when WIDE, else
// 8 lanes in color mode
template <bool WIDE>
int launch_blend(const float* feats, long long mp, const int* tile_start,
                 const int* tile_count, int* order, int num_tiles, int grid_x,
                 int tiles_per_view, int mode, float* out, void* stream) {
  switch (mode) {
    case kColor:
      return launch<kColor, WIDE ? 24 : 8>(
          feats, mp, nullptr, tile_start, tile_count, order, num_tiles,
          grid_x, tiles_per_view, 0, 0, out, nullptr, stream);
    case kColorDepth:
      return launch<kColorDepth, 24>(
          feats, mp, nullptr, tile_start, tile_count, order, num_tiles,
          grid_x, tiles_per_view, 0, 0, out, nullptr, stream);
    case kFull:
      return launch<kFull, 24>(
          feats, mp, nullptr, tile_start, tile_count, order, num_tiles,
          grid_x, tiles_per_view, 0, 0, out, nullptr, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes. Each returns the launches' cudaError_t;
// order is num_tiles int32 of scratch (the launch order, written here).
//
// The packed forward (B1): feats is (lanes, mp) row-major f32 with lanes
// >= 9 (color) or 24 (color_depth, full); out is (num_tiles, 256, nl) f32
// with nl = 8 (color) or 24.
extern "C" int igs_blend_fwd_packed(const float* feats, long long mp,
                                    const int* tile_start, const int* tile_count,
                                    int* order, int num_tiles, int grid_x,
                                    int tiles_per_view, int mode, float* out,
                                    void* stream) {
  return launch_blend<false>(feats, mp, tile_start, tile_count, order,
                             num_tiles, grid_x, tiles_per_view, mode, out,
                             stream);
}

// The windowed forward (B5a): the same walk over the pairs of the windowed
// route, tile_count = counts = min(tile_count, max_per_tile); feats is the
// route's (32, mp) pack; out is (num_tiles, 256, 24) f32 in every mode.
extern "C" int igs_blend_fwd_windowed(const float* feats, long long mp,
                                      const int* tile_start, const int* counts,
                                      int* order, int num_tiles, int grid_x,
                                      int tiles_per_view, int mode, float* out,
                                      void* stream) {
  return launch_blend<true>(feats, mp, tile_start, counts, order, num_tiles,
                            grid_x, tiles_per_view, mode, out, stream);
}

// The contribution count (B4): rows is (R, 6) row-major f32 [x y c0 c1 c2
// opacity] per (view, Gaussian) row, 4-byte aligned; gauss_id indexes it
// per pair (-1: padding); tile_start / tile_count delimit each tile's
// segment (num_tiles = views * tiles_per_view); counts is (R,) int32,
// zeroed by the caller, and receives the per-row counts.
extern "C" int igs_count_contributions_packed(
    const float* rows, const int* gauss_id, const int* tile_start,
    const int* tile_count, int* order, int num_tiles, int grid_x,
    int tiles_per_view, int width, int height, int* counts, void* stream) {
  return launch<kCount, 24>(rows, 0, gauss_id, tile_start, tile_count, order,
                           num_tiles, grid_x, tiles_per_view, width, height,
                           nullptr, counts, stream);
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
