// Softmax attention for Hopper (sm_90a): the forward (B7) and its VJP
// (B8), on (B, H, L, C) tensors, f32 or bf16, with optional region ids.
//
// Replaces the TPU kernel of jax.experimental.pallas.ops.tpu.flash_attention
// as the JAX package calls it: igs_tpu/models/transformer1d.py:88
// (Attention.__call__, the triplane encoder over 8192 anchor tokens, 8
// heads of 64) and igs_tpu/models/swin.py:150 (window_attention, single
// head, 1024-token windows of 128 channels, the shift mask as SegmentIds),
// and that kernel's dkv and dq backward kernels under jax.grad. It computes
//   o[i]   = sum_j softmax_j(scale * q[i].k[j]) v[j]
//   lse[i] = log sum_j exp(scale * q[i].k[j])
// over the keys j of query i's region (all keys without ids; a region id
// table (H, L) is broadcast over B, the TPU route's SegmentIds), with the
// scores and the softmax in f32 and the P.V product in v's type: P is
// rounded to bf16 before it for bf16 inputs, as the JAX routes'
// .astype(v.dtype) does. The backward recomputes P from the saved lse:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  D[i] = dO[i].o[i],
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// Bound on this card (H100 SXM): operations. The forward does 4 B H L^2 C
// (two products), the backward 10 B H L^2 C (five), against 67 TFLOP/s of
// f32 outside the tensor cores or 989 TFLOP/s of bf16 on them; the bytes
// (each of q, k, v, o read or written once) are ~1/L of that.
//
// Design: FlashAttention-2's split. One block per (query tile, b*h) for the
// forward, with an online softmax over key tiles held in shared memory, so
// no (L, L) score ever reaches device memory. The backward is two kernels,
// as the TPU kernel's dkv and dq: one block per key tile looping over the
// query tiles (dK, dV in registers), and one per query tile looping over
// the key tiles (dQ in registers). No atomics: every gradient element is
// summed by one thread in a fixed order, so the gradients repeat bit for
// bit. D = rowsum(dO * o) is computed by the caller.
//   f32: CUDA-core FMAs, no TF32. A block of BQ*2 threads; a thread owns 4
//   query (or key) rows and every 8th column of the score tile, and 4-wide
//   column groups of the output. Tiles are row-major in shared memory with
//   4 floats of padding, read as float4 without bank conflicts.
//   bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate) in FlashAttention-2's
//   arrangement: a warp owns 16 rows, the score fragments become the A
//   operand of the next product in registers. wgmma and TMA are later work.
// The head dim C (a multiple of 16 up to 128) is padded with zeros in
// shared memory to a bucket CB of 32, 64 or 128; ragged tiles of L are
// zero-filled and masked. The forward's tile (BQ x BK) is a template
// parameter: 64x64, 128x64 or 64x128 (the TPU's BlockSizes counterpart).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef uint16_t bf16_t;  // raw bits of a bf16

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- f32 ----

// Rows [r0, r0 + R) of a (L, C) matrix into a tile of row stride ld,
// CB columns; rows past L and columns past C are zeros.
template <int R, int CB, int NT>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         int r0, int L, int C) {
  constexpr int V = CB / 4;
  for (int idx = threadIdx.x; idx < R * V; idx += NT) {
    const int r = idx / V, c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L && c < C)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * C + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][j] = sum_c A[ty*4 + i][c] * Bm[tx + 8 j][c]
template <int NJ, int CB>
__device__ __forceinline__ void scores_f32(const float* A, int lda,
                                           const float* Bm, int ldb, int ty,
                                           int tx, float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < CB; c += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * lda + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(Bm + (tx + 8 * j) * ldb + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// acc[i][4 g + e] += sum_{j < KD} Z[ty*4 + i][j] * W[j][tx*4 + 32 g + e]
template <int KD, int CB>
__device__ __forceinline__ void accum_f32(const float* Z, int ldz,
                                          const float* W, int ldw, int ty,
                                          int tx, float (&acc)[4][CB / 8]) {
#pragma unroll 2
  for (int j = 0; j < KD; j += 4) {
    float4 z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      z[i] = *reinterpret_cast<const float4*>(Z + (ty * 4 + i) * ldz + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wr = W + (j + u) * ldw + tx * 4;
#pragma unroll
      for (int g = 0; g < CB / 32; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(wr + 32 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float zi = comp(z[i], u);
          acc[i][4 * g + 0] = fmaf(zi, w.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(zi, w.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(zi, w.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(zi, w.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Rows ty*4 + i of a (R, CB) register tile, times mul, to out rows r0 + ...
template <int CB>
__device__ __forceinline__ void store_f32(float* out, const float (&acc)[4][CB / 8],
                                          const float (&mul)[4], int r0, int ty,
                                          int tx, int L, int C) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= L) continue;
#pragma unroll
    for (int g = 0; g < CB / 32; ++g) {
      const int c = tx * 4 + 32 * g;
      if (c < C)
        *reinterpret_cast<float4*>(out + (size_t)r * C + c) = make_float4(
            acc[i][4 * g] * mul[i], acc[i][4 * g + 1] * mul[i],
            acc[i][4 * g + 2] * mul[i], acc[i][4 * g + 3] * mul[i]);
    }
  }
}

template <int BQ, int BK, int CB>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (CB + 4) + BQ * (BK + 4)) +
         sizeof(int) * BK;
}

template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2)
    attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ rid,
                 float* __restrict__ o, float* __restrict__ lse, int H, int L,
                 int C, float scale) {
  constexpr int NT = BQ * 2, NJ = BK / 8, LDC = CB + 4, LDZ = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDC;
  float* Vs = Ks + BK * LDC;
  float* Zs = Vs + BK * LDC;
  int* ridk = reinterpret_cast<int*>(Zs + BQ * LDZ);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, h = bh % H, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * C;
  load_f32<BQ, CB, NT>(Qs, LDC, q + base, q0, L, C);
  int ridq[4];
  float m[4], l[4], acc[4][CB / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    ridq[i] = (rid && r < L) ? rid[(size_t)h * L + r] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CB / 8; ++e) acc[i][e] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the last tile's reads are done
    load_f32<BK, CB, NT>(Ks, LDC, k + base, k0, L, C);
    load_f32<BK, CB, NT>(Vs, LDC, v + base, k0, L, C);
    if (rid)
      for (int j = threadIdx.x; j < BK; j += NT)
        ridk[j] = k0 + j < L ? rid[(size_t)h * L + k0 + j] : -1;
    __syncthreads();
    float s[4][NJ];
    scores_f32<NJ, CB>(Qs, LDC, Ks, LDC, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = tx + 8 * jj;
        const bool ok = k0 + j < L && (!rid || ridk[j] == ridq[i]);
        s[i][jj] = ok ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float mn = fmaxf(m[i], row_max8(mx));
      // a row with no key yet keeps -inf: exp(-inf - 0) = 0, never NaN
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[i] - mu);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        s[i][jj] = expf(s[i][jj] - mu);
        rs += s[i][jj];
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < CB / 8; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        Zs[(ty * 4 + i) * LDZ + tx + 8 * jj] = s[i][jj];
    }
    __syncthreads();
    accum_f32<BK, CB>(Zs, LDZ, Vs, LDC, ty, tx, acc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.f / l[i];
    const int r = q0 + ty * 4 + i;
    if (tx == 0 && r < L) lse[(size_t)bh * L + r] = m[i] + logf(l[i]);
  }
  store_f32<CB>(o + base, acc, inv, q0, ty, tx, L, C);
}

template <int BQ, int BK, int CB>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (CB + 4) + BQ * (BK + 4)) +
         sizeof(int) * BK;
}

template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2)
    attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ rid,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int H,
                int L, int C, float scale) {
  constexpr int NT = BQ * 2, NJ = BK / 8, LDC = CB + 4, LDZ = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LDC;
  float* Ks = dOs + BQ * LDC;
  float* Vs = Ks + BK * LDC;
  float* Zs = Vs + BK * LDC;
  int* ridk = reinterpret_cast<int*>(Zs + BQ * LDZ);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, h = bh % H, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * C;
  load_f32<BQ, CB, NT>(Qs, LDC, q + base, q0, L, C);
  load_f32<BQ, CB, NT>(dOs, LDC, dout + base, q0, L, C);
  int ridq[4];
  float lq[4], dq_[4], acc[4][CB / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const bool in = r < L;
    ridq[i] = (rid && in) ? rid[(size_t)h * L + r] : 0;
    lq[i] = in ? lse[(size_t)bh * L + r] : 0.f;
    dq_[i] = in ? delta[(size_t)bh * L + r] : 0.f;
#pragma unroll
    for (int e = 0; e < CB / 8; ++e) acc[i][e] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_f32<BK, CB, NT>(Ks, LDC, k + base, k0, L, C);
    load_f32<BK, CB, NT>(Vs, LDC, v + base, k0, L, C);
    if (rid)
      for (int j = threadIdx.x; j < BK; j += NT)
        ridk[j] = k0 + j < L ? rid[(size_t)h * L + k0 + j] : -1;
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    scores_f32<NJ, CB>(Qs, LDC, Ks, LDC, ty, tx, s);
    scores_f32<NJ, CB>(dOs, LDC, Vs, LDC, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = tx + 8 * jj;
        const bool ok = k0 + j < L && (!rid || ridk[j] == ridq[i]);
        const float p = ok ? expf(s[i][jj] * scale - lq[i]) : 0.f;
        Zs[(ty * 4 + i) * LDZ + j] = p * (dp[i][jj] - dq_[i]);
      }
    __syncthreads();
    accum_f32<BK, CB>(Zs, LDZ, Ks, LDC, ty, tx, acc);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_f32<CB>(dq + base, acc, mul, q0, ty, tx, L, C);
}

template <int BQ, int BK, int CB>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (CB + 4) + BK * (BQ + 4)) +
         (2 * sizeof(float) + sizeof(int)) * BQ;
}

// one block per key tile: rows of the register tiles are keys, columns
// queries
template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BK * 2)
    attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ rid,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int L, int C, float scale) {
  constexpr int NT = BK * 2, NJ = BQ / 8, LDC = CB + 4, LDZ = BQ + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LDC;
  float* Qs = Vs + BK * LDC;
  float* dOs = Qs + BQ * LDC;
  float* Zs = dOs + BQ * LDC;
  float* lse_s = Zs + BK * LDZ;
  float* del_s = lse_s + BQ;
  int* ridq = reinterpret_cast<int*>(del_s + BQ);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.y, h = bh % H, k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * L * C;
  load_f32<BK, CB, NT>(Ks, LDC, k + base, k0, L, C);
  load_f32<BK, CB, NT>(Vs, LDC, v + base, k0, L, C);
  int ridk[4];
  float gk[4][CB / 8], gv[4][CB / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    ridk[i] = (rid && r < L) ? rid[(size_t)h * L + r] : 0;
#pragma unroll
    for (int e = 0; e < CB / 8; ++e) gk[i][e] = gv[i][e] = 0.f;
  }
  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();
    load_f32<BQ, CB, NT>(Qs, LDC, q + base, q0, L, C);
    load_f32<BQ, CB, NT>(dOs, LDC, dout + base, q0, L, C);
    for (int j = threadIdx.x; j < BQ; j += NT) {
      const bool in = q0 + j < L;
      lse_s[j] = in ? lse[(size_t)bh * L + q0 + j] : 0.f;
      del_s[j] = in ? delta[(size_t)bh * L + q0 + j] : 0.f;
      ridq[j] = (rid && in) ? rid[(size_t)h * L + q0 + j] : -1;
    }
    __syncthreads();
    float p[4][NJ], dp[4][NJ];
    scores_f32<NJ, CB>(Ks, LDC, Qs, LDC, ty, tx, p);
    scores_f32<NJ, CB>(Vs, LDC, dOs, LDC, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = tx + 8 * jj;
        const bool ok = q0 + j < L && (!rid || ridq[j] == ridk[i]);
        p[i][jj] = ok ? expf(p[i][jj] * scale - lse_s[j]) : 0.f;
        Zs[(ty * 4 + i) * LDZ + j] = p[i][jj];
      }
    __syncthreads();
    accum_f32<BQ, CB>(Zs, LDZ, dOs, LDC, ty, tx, gv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = tx + 8 * jj;
        Zs[(ty * 4 + i) * LDZ + j] = p[i][jj] * (dp[i][jj] - del_s[j]);
      }
    __syncthreads();
    accum_f32<BQ, CB>(Zs, LDZ, Qs, LDC, ty, tx, gk);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_f32<CB>(dk + base, gk, mul, k0, ty, tx, L, C);
  store_f32<CB>(dv + base, gv, one, k0, ty, tx, L, C);
}

// --------------------------------------------------------------- bf16 ----

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 in one word: X[r][c] (low half) and X[r + 1][c]
__device__ __forceinline__ uint32_t pack_rows(const bf16_t* X, int ld, int r,
                                              int c) {
  return (uint32_t)X[r * ld + c] | ((uint32_t)X[(r + 1) * ld + c] << 16);
}

// X[r][c], X[r][c + 1] (c even)
__device__ __forceinline__ uint32_t ld32(const bf16_t* X, int ld, int r,
                                         int c) {
  return *reinterpret_cast<const uint32_t*>(X + r * ld + c);
}

// the A fragment (16 x 16, row-major) of rows r0.. and columns c0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16_t* X,
                                       int ld, int r0, int c0, int g, int t) {
  a[0] = ld32(X, ld, r0 + g, c0 + 2 * t);
  a[1] = ld32(X, ld, r0 + g + 8, c0 + 2 * t);
  a[2] = ld32(X, ld, r0 + g, c0 + 2 * t + 8);
  a[3] = ld32(X, ld, r0 + g + 8, c0 + 2 * t + 8);
}

template <int R, int CB, int NT>
__device__ __forceinline__ void load_bf16(bf16_t* dst, int ld,
                                          const bf16_t* src, int r0, int L,
                                          int C) {
  constexpr int V = CB / 8;
  for (int idx = threadIdx.x; idx < R * V; idx += NT) {
    const int r = idx / V, c = (idx % V) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < C)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * C + c);
    // ld is a multiple of 8 halves: 16-byte aligned rows
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// S (16 x 8 NB per warp) = X[rows w*16..] . Y[cols]^T over CB
template <int NB, int CB>
__device__ __forceinline__ void scores_bf16(const bf16_t* X, const bf16_t* Y,
                                            int ld, int r0, int g, int t,
                                            float (&s)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < CB / 16; ++kb) {
    uint32_t a[4];
    frag_a(a, X, ld, r0, kb * 16, g, t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_bf16(s[nb], a, ld32(Y, ld, nb * 8 + g, kb * 16 + 2 * t),
               ld32(Y, ld, nb * 8 + g, kb * 16 + 2 * t + 8));
  }
}

// acc (16 x CB per warp) += P (16 x KD, fragments s) . W[KD][CB]; P is
// rounded to bf16
template <int KD, int CB>
__device__ __forceinline__ void accum_bf16(const float (&s)[KD / 8][4],
                                           const bf16_t* W, int ld, int g,
                                           int t, float (&acc)[CB / 8][4]) {
#pragma unroll
  for (int kb = 0; kb < KD / 16; ++kb) {
    const uint32_t a[4] = {pack_f32(s[2 * kb][0], s[2 * kb][1]),
                           pack_f32(s[2 * kb][2], s[2 * kb][3]),
                           pack_f32(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                           pack_f32(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
    for (int nc = 0; nc < CB / 8; ++nc)
      mma_bf16(acc[nc], a, pack_rows(W, ld, kb * 16 + 2 * t, nc * 8 + g),
               pack_rows(W, ld, kb * 16 + 2 * t + 8, nc * 8 + g));
  }
}

// rows r0 + g (+8) of a warp's (16 x CB) accumulator, times mul[0/1], as
// bf16
template <int CB>
__device__ __forceinline__ void store_bf16(bf16_t* out,
                                           const float (&acc)[CB / 8][4],
                                           const float (&mul)[2], int r0,
                                           int g, int t, int L, int C) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= L) continue;
#pragma unroll
    for (int nc = 0; nc < CB / 8; ++nc) {
      const int c = nc * 8 + 2 * t;
      if (c < C)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * C + c) =
            pack_f32(acc[nc][2 * half] * mul[half],
                     acc[nc][2 * half + 1] * mul[half]);
    }
  }
}

template <int BQ, int BK, int CB>
constexpr size_t fwd_bf16_smem() {
  return sizeof(bf16_t) * (BQ + 2 * BK) * (CB + 8) + sizeof(int) * BK;
}

template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2)
    attn_fwd_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, const int* __restrict__ rid,
                  bf16_t* __restrict__ o, float* __restrict__ lse, int H,
                  int L, int C, float scale) {
  constexpr int NT = BQ * 2, NB = BK / 8, LDH = CB + 8;
  extern __shared__ float4 smem4[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem4);
  bf16_t* Ks = Qs + BQ * LDH;
  bf16_t* Vs = Ks + BK * LDH;
  int* ridk = reinterpret_cast<int*>(Vs + BK * LDH);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, h = bh % H, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * C;
  load_bf16<BQ, CB, NT>(Qs, LDH, q + base, q0, L, C);
  int ridq[2];
  float m[2], l[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + w * 16 + g + 8 * half;
    ridq[half] = (rid && r < L) ? rid[(size_t)h * L + r] : 0;
    m[half] = -INFINITY;
    l[half] = 0.f;
  }
#pragma unroll
  for (int nc = 0; nc < CB / 8; ++nc)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nc][e] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_bf16<BK, CB, NT>(Ks, LDH, k + base, k0, L, C);
    load_bf16<BK, CB, NT>(Vs, LDH, v + base, k0, L, C);
    if (rid)
      for (int j = threadIdx.x; j < BK; j += NT)
        ridk[j] = k0 + j < L ? rid[(size_t)h * L + k0 + j] : -1;
    __syncthreads();
    float s[NB][4];
    scores_bf16<NB, CB>(Qs, Ks, LDH, w * 16, g, t, s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const int j = nb * 8 + 2 * t + (e & 1);
          const bool ok = k0 + j < L && (!rid || ridk[j] == ridq[half]);
          s[nb][e] = ok ? s[nb][e] * scale : -INFINITY;
          mx = fmaxf(mx, s[nb][e]);
        }
      const float mn = fmaxf(m[half], row_max4(mx));
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[half] - mu);
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[nb][e] = expf(s[nb][e] - mu);
          rs += s[nb][e];
        }
      l[half] = l[half] * alpha + row_sum4(rs);
      m[half] = mn;
#pragma unroll
      for (int nc = 0; nc < CB / 8; ++nc) {
        acc[nc][2 * half] *= alpha;
        acc[nc][2 * half + 1] *= alpha;
      }
    }
    accum_bf16<BK, CB>(s, Vs, LDH, g, t, acc);
  }
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    inv[half] = 1.f / l[half];
    const int r = q0 + w * 16 + g + 8 * half;
    if (t == 0 && r < L) lse[(size_t)bh * L + r] = m[half] + logf(l[half]);
  }
  store_bf16<CB>(o + base, acc, inv, q0 + w * 16, g, t, L, C);
}

template <int BQ, int BK, int CB>
constexpr size_t dq_bf16_smem() {
  return sizeof(bf16_t) * (2 * BQ + 2 * BK) * (CB + 8) + sizeof(int) * BK;
}

template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2)
    attn_dq_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                 const bf16_t* __restrict__ v, const int* __restrict__ rid,
                 const bf16_t* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16_t* __restrict__ dq,
                 int H, int L, int C, float scale) {
  constexpr int NT = BQ * 2, NB = BK / 8, LDH = CB + 8;
  extern __shared__ float4 smem4[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem4);
  bf16_t* dOs = Qs + BQ * LDH;
  bf16_t* Ks = dOs + BQ * LDH;
  bf16_t* Vs = Ks + BK * LDH;
  int* ridk = reinterpret_cast<int*>(Vs + BK * LDH);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, h = bh % H, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * C;
  load_bf16<BQ, CB, NT>(Qs, LDH, q + base, q0, L, C);
  load_bf16<BQ, CB, NT>(dOs, LDH, dout + base, q0, L, C);
  int ridq[2];
  float lq[2], dl[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + w * 16 + g + 8 * half;
    const bool in = r < L;
    ridq[half] = (rid && in) ? rid[(size_t)h * L + r] : 0;
    lq[half] = in ? lse[(size_t)bh * L + r] : 0.f;
    dl[half] = in ? delta[(size_t)bh * L + r] : 0.f;
  }
#pragma unroll
  for (int nc = 0; nc < CB / 8; ++nc)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nc][e] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_bf16<BK, CB, NT>(Ks, LDH, k + base, k0, L, C);
    load_bf16<BK, CB, NT>(Vs, LDH, v + base, k0, L, C);
    if (rid)
      for (int j = threadIdx.x; j < BK; j += NT)
        ridk[j] = k0 + j < L ? rid[(size_t)h * L + k0 + j] : -1;
    __syncthreads();
    float s[NB][4], dp[NB][4];
    scores_bf16<NB, CB>(Qs, Ks, LDH, w * 16, g, t, s);
    scores_bf16<NB, CB>(dOs, Vs, LDH, w * 16, g, t, dp);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, j = nb * 8 + 2 * t + (e & 1);
        const bool ok = k0 + j < L && (!rid || ridk[j] == ridq[half]);
        const float p = ok ? expf(s[nb][e] * scale - lq[half]) : 0.f;
        s[nb][e] = p * (dp[nb][e] - dl[half]);
      }
    accum_bf16<BK, CB>(s, Ks, LDH, g, t, acc);
  }
  const float mul[2] = {scale, scale};
  store_bf16<CB>(dq + base, acc, mul, q0 + w * 16, g, t, L, C);
}

template <int BQ, int BK, int CB>
constexpr size_t dkv_bf16_smem() {
  return sizeof(bf16_t) * (2 * BQ + 2 * BK) * (CB + 8) +
         (2 * sizeof(float) + sizeof(int)) * BQ;
}

// one block per key tile; a warp owns 16 keys, the fragments' columns are
// queries
template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BK * 2)
    attn_dkv_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, const int* __restrict__ rid,
                  const bf16_t* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16_t* __restrict__ dk,
                  bf16_t* __restrict__ dv, int H, int L, int C, float scale) {
  constexpr int NT = BK * 2, NB = BQ / 8, LDH = CB + 8;
  extern __shared__ float4 smem4[];
  bf16_t* Ks = reinterpret_cast<bf16_t*>(smem4);
  bf16_t* Vs = Ks + BK * LDH;
  bf16_t* Qs = Vs + BK * LDH;
  bf16_t* dOs = Qs + BQ * LDH;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDH);
  float* del_s = lse_s + BQ;
  int* ridq = reinterpret_cast<int*>(del_s + BQ);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, h = bh % H, k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * L * C;
  load_bf16<BK, CB, NT>(Ks, LDH, k + base, k0, L, C);
  load_bf16<BK, CB, NT>(Vs, LDH, v + base, k0, L, C);
  int ridk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + w * 16 + g + 8 * half;
    ridk[half] = (rid && r < L) ? rid[(size_t)h * L + r] : 0;
  }
  float gk[CB / 8][4], gv[CB / 8][4];
#pragma unroll
  for (int nc = 0; nc < CB / 8; ++nc)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[nc][e] = gv[nc][e] = 0.f;
  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();
    load_bf16<BQ, CB, NT>(Qs, LDH, q + base, q0, L, C);
    load_bf16<BQ, CB, NT>(dOs, LDH, dout + base, q0, L, C);
    for (int j = threadIdx.x; j < BQ; j += NT) {
      const bool in = q0 + j < L;
      lse_s[j] = in ? lse[(size_t)bh * L + q0 + j] : 0.f;
      del_s[j] = in ? delta[(size_t)bh * L + q0 + j] : 0.f;
      ridq[j] = (rid && in) ? rid[(size_t)h * L + q0 + j] : -1;
    }
    __syncthreads();
    float p[NB][4], dp[NB][4];
    scores_bf16<NB, CB>(Ks, Qs, LDH, w * 16, g, t, p);
    scores_bf16<NB, CB>(Vs, dOs, LDH, w * 16, g, t, dp);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, j = nb * 8 + 2 * t + (e & 1);
        const bool ok = q0 + j < L && (!rid || ridq[j] == ridk[half]);
        p[nb][e] = ok ? expf(p[nb][e] * scale - lse_s[j]) : 0.f;
        dp[nb][e] = p[nb][e] * (dp[nb][e] - del_s[j]);
      }
    accum_bf16<BQ, CB>(p, dOs, LDH, g, t, gv);
    accum_bf16<BQ, CB>(dp, Qs, LDH, g, t, gk);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_bf16<CB>(dk + base, gk, mul, k0 + w * 16, g, t, L, C);
  store_bf16<CB>(dv + base, gv, one, k0 + w * 16, g, t, L, C);
}

// ------------------------------------------------------------ launch ----

template <typename Kernel, typename... Args>
int run(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
        Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// the backward's tiles: 64 x 64, or 32 queries x 64 keys at CB = 128 (the
// register tiles of dK and dV)
template <int CB>
struct Bwd {
  static constexpr int BQ = CB == 128 ? 32 : 64, BK = 64;
};

template <int BQ, int BK, int CB>
int fwd(const void* q, const void* k, const void* v, const int* rid, void* o,
        float* lse, int BH, int H, int L, int C, float scale, int bf16,
        cudaStream_t s) {
  const dim3 grid((L + BQ - 1) / BQ, BH);
  if (bf16)
    return run(attn_fwd_bf16<BQ, BK, CB>, grid, BQ * 2,
               fwd_bf16_smem<BQ, BK, CB>(), s, (const bf16_t*)q,
               (const bf16_t*)k, (const bf16_t*)v, rid, (bf16_t*)o, lse, H, L,
               C, scale);
  return run(attn_fwd_f32<BQ, BK, CB>, grid, BQ * 2,
             fwd_f32_smem<BQ, BK, CB>(), s, (const float*)q, (const float*)k,
             (const float*)v, rid, (float*)o, lse, H, L, C, scale);
}

template <int CB>
int fwd_tiles(int tile, const void* q, const void* k, const void* v,
              const int* rid, void* o, float* lse, int BH, int H, int L,
              int C, float scale, int bf16, cudaStream_t s) {
  switch (tile) {
    case 0:
      return fwd<64, 64, CB>(q, k, v, rid, o, lse, BH, H, L, C, scale, bf16, s);
    case 1:
      return fwd<128, 64, CB>(q, k, v, rid, o, lse, BH, H, L, C, scale, bf16,
                              s);
    case 2:
      return fwd<64, 128, CB>(q, k, v, rid, o, lse, BH, H, L, C, scale, bf16,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int CB>
int bwd(const void* q, const void* k, const void* v, const int* rid,
        const void* dout, const float* lse, const float* delta, void* dq,
        void* dk, void* dv, int BH, int H, int L, int C, float scale,
        int bf16, cudaStream_t s) {
  constexpr int BQ = Bwd<CB>::BQ, BK = Bwd<CB>::BK;
  const dim3 gk((L + BK - 1) / BK, BH), gq((L + BQ - 1) / BQ, BH);
  int err;
  if (bf16) {
    err = run(attn_dkv_bf16<BQ, BK, CB>, gk, BK * 2,
              dkv_bf16_smem<BQ, BK, CB>(), s, (const bf16_t*)q,
              (const bf16_t*)k, (const bf16_t*)v, rid, (const bf16_t*)dout,
              lse, delta, (bf16_t*)dk, (bf16_t*)dv, H, L, C, scale);
    if (err) return err;
    return run(attn_dq_bf16<BQ, BK, CB>, gq, BQ * 2,
               dq_bf16_smem<BQ, BK, CB>(), s, (const bf16_t*)q,
               (const bf16_t*)k, (const bf16_t*)v, rid, (const bf16_t*)dout,
               lse, delta, (bf16_t*)dq, H, L, C, scale);
  }
  err = run(attn_dkv_f32<BQ, BK, CB>, gk, BK * 2, dkv_f32_smem<BQ, BK, CB>(),
            s, (const float*)q, (const float*)k, (const float*)v, rid,
            (const float*)dout, lse, delta, (float*)dk, (float*)dv, H, L, C,
            scale);
  if (err) return err;
  return run(attn_dq_f32<BQ, BK, CB>, gq, BQ * 2, dq_f32_smem<BQ, BK, CB>(), s,
             (const float*)q, (const float*)k, (const float*)v, rid,
             (const float*)dout, lse, delta, (float*)dq, H, L, C, scale);
}

}  // namespace

// the bucket a head dim is padded to: 32, 64 or 128; 0 if not taken
extern "C" int igs_attention_bucket(int C) {
  if (C < 16 || C > 128 || C % 16) return 0;
  return C <= 32 ? 32 : C <= 64 ? 64 : 128;
}

// o, lse = attention(q, k, v); (BH, L, C) contiguous, dtype 0 f32 / 1 bf16,
// tile 0: 64x64, 1: 128x64, 2: 64x128 (queries x keys); rid (H, L) or null
extern "C" int igs_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* rid, void* o, float* lse, int BH,
                                 int H, int L, int C, float scale, int dtype,
                                 int tile, void* stream) {
  if (L <= 0 || BH <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (igs_attention_bucket(C)) {
    case 32:
      return fwd_tiles<32>(tile, q, k, v, rid, o, lse, BH, H, L, C, scale,
                           dtype, s);
    case 64:
      return fwd_tiles<64>(tile, q, k, v, rid, o, lse, BH, H, L, C, scale,
                           dtype, s);
    case 128:
      return fwd_tiles<128>(tile, q, k, v, rid, o, lse, BH, H, L, C, scale,
                            dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq, dk, dv from dout, the forward's lse and delta = rowsum(dout * o)
extern "C" int igs_attention_bwd(const void* q, const void* k, const void* v,
                                 const int* rid, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dq, void* dk, void* dv, int BH, int H,
                                 int L, int C, float scale, int dtype,
                                 void* stream) {
  if (L <= 0 || BH <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (igs_attention_bucket(C)) {
    case 32:
      return bwd<32>(q, k, v, rid, dout, lse, delta, dq, dk, dv, BH, H, L, C,
                     scale, dtype, s);
    case 64:
      return bwd<64>(q, k, v, rid, dout, lse, delta, dq, dk, dv, BH, H, L, C,
                     scale, dtype, s);
    case 128:
      return bwd<128>(q, k, v, rid, dout, lse, delta, dq, dk, dv, BH, H, L,
                      C, scale, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
