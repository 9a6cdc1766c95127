// What the blend forward, the contribution count (both blend_fwd.cu) and
// the blend backward (blend_bwd.cu) share: the candidate box by which a
// warp skips pairs, the order in which tiles are launched, and the
// cp.async staging.
//
// The candidate box of a pair holds every pixel whose candidate test the
// pair can pass. The kernels skip, per warp, the pairs whose box misses
// the warp's 8x4 pixel rectangle. A skipped pair is one the candidate
// test rejects at every pixel of the warp, so no pixel's walk changes: the
// same pairs are taken, in the same order, with the same rounding.
//
// The candidate test (blend_fwd.cu, rounded op by op, C7):
//   dx = mx - px, dy = my - py                         (fp32, rounded)
//   P  = -1/2 (a dx^2 + c dy^2) - b dx dy               (fp32, op by op)
//   candidate iff P <= 0 and min(0.99, o * expf(P)) >= 1/255 (fp32)
// Why the box holds every candidate pixel:
//  1. o * expf(P) >= 1/255 with expf within 2 ulp and the product and
//     the fp32 constant within half an ulp gives -P <= ln(255 o) + 4e-7,
//     and o < 1/255 (times 1 + 1e-6) leaves no candidate at all.
//  2. With q = a dx^2 + 2b dx dy + c dy^2 the exact value at the rounded
//     (dx, dy), the four roundings of P cost at most 4u (a dx^2 + c dy^2)
//     (u = 2^-24), and a dx^2 + c dy^2 <= (1 + k) q for the conic's
//     condition number k = lmax/lmin. So q <= 2 (ln(255 o) + 4e-7) /
//     (1 - 8u (1 + k)); the box takes 32u for 8u, adds 1e-4 to the log
//     and 1e-4 to q, and gives up (the whole plane) once 32u (1 + k)
//     reaches 1/2.
//  3. On the ellipse q <= Q, |dx| <= sqrt(Q c / det) and |dy| <=
//     sqrt(Q a / det), det = ac - b^2: the box is the mean plus or minus
//     those extents, widened by 1e-5 relative and 1e-3 pixel (the
//     rounding of dx against mx - px) and rounded outward to fp32.
// The determinant is computed in double, where a*c and b*b are exact, so
// it keeps its sign where the fp32 products would cancel; the rest in
// fp32, whose few roundings (under 1e-6 relative) the margins above
// cover. A conic that is not positive definite, or any non-finite input,
// gives the whole plane (the test then runs at every pixel, as in the
// unskipped walk).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace igs_blend {
namespace {

constexpr float kU = 0x1p-24f;  // fp32 unit roundoff

// (x_lo, x_hi, y_lo, y_hi) in pixel coordinates; empty (lo > hi) when
// the pair is a candidate nowhere
__device__ __forceinline__ float4 candidate_box(float mx, float my, float a,
                                                float b, float c, float o,
                                                float min_alpha) {
  const float inf = CUDART_INF_F;
  const float4 all = make_float4(-inf, inf, -inf, inf);
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(o)))
    return all;
  if (o * (1.f + 1e-6f) < min_alpha) return make_float4(inf, -inf, inf, -inf);
  const double det_d = static_cast<double>(a) * c - static_cast<double>(b) * b;
  if (!(a > 0.f && c > 0.f && det_d > 0.0)) return all;
  const float det = static_cast<float>(det_d);
  const float tr = a + c;
  const float lmax = 0.5f * (tr + sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  const float eps = 32.f * kU * (1.f + lmax * lmax / det);
  if (!(eps < 0.5f)) return all;
  const float tau = fmaxf(logf(255.f * o), 0.f) + 1e-4f;
  const float q = 2.f * tau * (1.f + 1e-4f) / (1.f - eps);
  const float ex = sqrtf(q * c / det) * (1.f + 1e-5f) + 1e-3f;
  const float ey = sqrtf(q * a / det) * (1.f + 1e-5f) + 1e-3f;
  return make_float4(__fsub_rd(mx, ex), __fadd_ru(mx, ex), __fsub_rd(my, ey),
                     __fadd_ru(my, ey));
}

// bit w set when warp w's 8x4 pixel rectangle of the 16x16 tile at
// (tx0, ty0) (x0 + (w&1)*8 .. +7, y0 + (w>>1)*4 .. +3) meets the pair's
// box: the warps that may hold a pixel where the pair is a candidate
__device__ __forceinline__ unsigned warp_mask(float mx, float my, float a,
                                              float b, float c, float o,
                                              float min_alpha, int tx0,
                                              int ty0) {
  const float4 box = candidate_box(mx, my, a, b, c, o, min_alpha);
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const float x0 = static_cast<float>(tx0 + (w & 1) * 8);
    const float y0 = static_cast<float>(ty0 + (w >> 1) * 4);
    if (!(box.x > x0 + 7.f || box.y < x0 || box.z > y0 + 3.f || box.w < y0))
      m |= 1u << w;
  }
  return m;
}

// Tiles are launched deepest first: block b takes tile order[b]. A launch
// otherwise lasts until its deepest tile, started wherever it lies in the
// image, is done; started first, it runs beside the rest. The key has
// four steps an octave of tile_count (0 for an empty tile); within a key
// the order is that of the atomics, which changes no output: every block
// writes only its own tile's pixels and pairs.
constexpr int kOrderKeys = 128;

__device__ __forceinline__ int depth_key(int count) {
  if (count < 4) return max(count, 0);
  const int e = 31 - __clz(count);
  return 4 * (e - 1) + ((count >> (e - 2)) & 3);
}

// one block: order[0, num_tiles) = the tiles by descending depth_key
__global__ void __launch_bounds__(1024)
tile_order_kernel(const int* __restrict__ tile_count, int num_tiles,
                  int* __restrict__ order) {
  __shared__ int next[kOrderKeys];
  for (int k = threadIdx.x; k < kOrderKeys; k += blockDim.x) next[k] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += blockDim.x)
    atomicAdd(&next[depth_key(tile_count[i])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0;
    for (int k = kOrderKeys - 1; k >= 0; --k) {
      const int n = next[k];
      next[k] = pos;
      pos += n;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += blockDim.x)
    order[atomicAdd(&next[depth_key(tile_count[i])], 1)] = i;
}

// cp.async of one 4-byte word, global → shared (L1-allocating)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
}  // namespace igs_blend
