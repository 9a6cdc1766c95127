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
// (two products), the backward 10 B H L^2 C (five), against 989 TFLOP/s of
// bf16 on the tensor cores, and for f32 against 495/3 TFLOP/s (three TF32
// products a product, below) or 67 TFLOP/s outside the tensor cores; the
// bytes (each of q, k, v, o read or written once) are ~1/L of that.
//
// Design: FlashAttention-2's split. One block per (query tile, b*h) for the
// forward, with an online softmax over key tiles, so no (L, L) score ever
// reaches device memory. The backward is two kernels, as the TPU kernel's
// dkv and dq: one block per key tile looping over the query tiles (dK, dV
// in registers), and one per query tile looping over the key tiles (dQ in
// registers): 7 products where 5 would do, but no atomics, so every
// gradient element is summed by one thread in a fixed order and the
// gradients repeat bit for bit. D = rowsum(dO * o) comes first from its
// own small kernel (attn_delta, one warp a row: each of dO and o read
// once). Tiles come in through a ring of cp.async stages (the next tile
// loads while this one is computed); a cp.async wait cannot hang, where a
// TMA transaction count that never completes an mbarrier would, and each
// thread's 16-byte copies write the swizzled layout that TMA would.
//   bf16: wgmma (sm_90a). A warpgroup owns 64 rows (queries in the forward
//   and dQ, keys in dK/dV). S = Q K^T and dP = dO V^T read both operands
//   from shared memory (K-major); P and dS go to bf16 in registers and are
//   the A operand of the next wgmma against V, K, dO or Q read MN-major
//   (the descriptor's transpose), so no operand is repacked by hand. Tiles
//   sit in shared memory in column blocks of 64 (32) channels, 16-byte
//   chunks swizzled over 8-row atoms of 1024 (512) bytes.
//   f32: 3xTF32 on the tensor cores: each operand is split as hi =
//   tf32(x), lo = tf32(x - hi) (round to nearest, ties away), and a
//   product sums lo.hi + hi.lo + hi.hi in f32, leaving out lo.lo (~2^-22
//   relative). At CB <= 64 (the forward with 64-key tiles, and both
//   backward kernels) it runs on wgmma (attn_*_tf32: TF32 hi/lo tiles
//   split by the loading threads, the B operands of P.V, dS.K, P^T.dO and
//   dS^T.Q stored transposed); at CB = 128 on mma.sync.m16n8k8.tf32 with
//   the split in registers. The tensor cores' f32 sums
//   truncate, and one carried over 8192 keys drifted to 8.5e-5 of the
//   output (against a tolerance of 2e-5), so each tile's P.V (dS.K, P^T.dO,
//   dS^T.Q) is summed from zero and added to the running sum in f32. A
//   warp owns 16 rows; P and dS stay in registers as the A operand of the
//   next product, the keys of an 8-wide step taken in the order the score
//   fragment holds them (2t, 2t + 1 as logical t, t + 4), so the B operand
//   reads rows 2t and 2t + 1. Tiles are row-major in shared memory with 4
//   floats of padding, read without bank conflicts.
// The softmax runs in base 2 (ex2.approx, the scale times log2 e folded
// into one FMA a score); the saved lse is the natural one.
// Region ids: each block lists the tiles it will visit. A tile whose
// region bits (ids < 32 as bits; any other id sets them all) do not meet
// the block's own is skipped, which adds exactly what computing it would
// (exp(-inf) = 0, a rescale by 1); where both tiles hold one and the same
// id, no score is compared. The head dim C (a multiple of 16 up to 128) is
// padded with zeros to a bucket CB of 32, 64 or 128; ragged tiles of L are
// zero-filled and masked. The forward's tile (BQ x BK) is a template
// parameter: 64x64, 128x64 or 128x128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef uint16_t bf16_t;  // raw bits of a bf16

// shared memory a block may take for its tiles, below the card's 227 KB
// less the 1024-byte alignment and the region lists
constexpr int SMEM_TILES = 225 * 1024;
constexpr int UNIFORM = 1 << 30;  // a listed tile needs no region compare

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// 2^x in one MUFU op (exp(-inf) = 0; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------- shared memory ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the block's dynamic shared memory, aligned to 1024 bytes (the 128-byte
// swizzle's atom)
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return smem_raw + pad;
}

// 16 (or 4) bytes from global to shared memory; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cp.async ring: issue(i, stage) starts the loads of the i-th visited
// tile into `stage`, body(i, stage) computes on it. Loads issued before
// the call join the first group. With two or more stages the loads run
// STAGES - 1 tiles ahead and one barrier a tile serves both ends: once
// every thread is past it, tile i has landed and the stage of tile i - 1
// is free for tile i + STAGES - 1. The proxy fence makes the copies
// visible to wgmma's reads.
template <int STAGES, typename Issue, typename Body>
__device__ __forceinline__ void ring(int n, Issue issue, Body body) {
  if constexpr (STAGES == 1) {
    for (int i = 0; i < n; ++i) {
      if (i) __syncthreads();
      issue(i, 0);
      cp_commit();
      cp_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      body(i, 0);
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n) issue(s, s);
      cp_commit();
    }
    for (int i = 0; i < n; ++i) {
      cp_wait<STAGES - 2>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const int next = i + STAGES - 1;
      if (next < n) issue(next, next % STAGES);
      cp_commit();
      body(i, i % STAGES);
    }
  }
  cp_wait<0>();
}

// ------------------------------------------------------------ regions ----

__device__ __forceinline__ uint32_t id_bit(int id) {
  return (unsigned)id < 32u ? 1u << id : 0xffffffffu;
}

// the region bits of rows [r0, r0 + n) below L, by one warp
__device__ __forceinline__ uint32_t region_bits(const int* ids, int r0, int n,
                                                int L) {
  const int end = min(r0 + n, L);
  uint32_t b = 0u;
  for (int r = r0 + (threadIdx.x & 31); r < end; r += 32) b |= id_bit(ids[r]);
  return __reduce_or_sync(0xffffffffu, b);
}

// the kernels whose tile lists are counted: forward, dK/dV, dQ
enum Kind { FWD = 0, DKV = 1, DQ = 2 };

// while tile_count_on is set (igs_attention_count_tiles), every
// live_tiles call adds its listed tiles and all tiles to
// tile_pairs[kind] (a check run's instrumentation, never timed)
__device__ int tile_count_on;
__device__ unsigned long long tile_pairs[3][2];

// The tiles of T rows of [0, L) that hold a row of a region of the block's
// own rows [r0, r0 + R), in order, into list (flagged UNIFORM where both
// hold one and the same id); returns their count. scratch holds
// ceil(L / T) + 1 words.
template <int NT>
__device__ int live_tiles(const int* ids, int L, int r0, int R, int T,
                          Kind kind, int* list, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nt = (L + T - 1) / T;
  uint32_t own = 0u;
  if (w == 0) own = region_bits(ids, r0, R, L);
  for (int i = w; i < nt; i += NT / 32) {
    const uint32_t b = region_bits(ids, i * T, T, L);
    if (lane == 0) scratch[i] = b;
  }
  __syncthreads();
  if (w == 0) {
    const bool single = __popc(own) == 1;
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t b = i < nt ? scratch[i] : 0u;
      const bool live = (b & own) != 0u;
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live)
        list[n + __popc(ballot & ((1u << lane) - 1u))] =
            i | (single && b == own ? UNIFORM : 0);
      n += __popc(ballot);
    }
    if (lane == 0) {
      scratch[nt] = n;
      if (tile_count_on) {
        atomicAdd(&tile_pairs[kind][0], (unsigned long long)n);
        atomicAdd(&tile_pairs[kind][1], (unsigned long long)nt);
      }
    }
  }
  __syncthreads();
  return (int)scratch[nt];
}

// which columns of one score tile a thread's two rows keep: columns past
// L, and (check) columns of another region than the row's
struct Cols {
  int col0, L;
  const int* ids;
  int row_id[2];
  bool bound, check;
  __device__ __forceinline__ bool keep(int j, int half) const {
    if (bound && j >= L) return false;
    return !check || ids[j] == row_id[half];
  }
};

__device__ __forceinline__ Cols tile_cols(int entry, int T, int L,
                                          const int* ids,
                                          const int (&row_id)[2]) {
  const int c0 = (entry & (UNIFORM - 1)) * T;
  return Cols{c0, L, ids, {row_id[0], row_id[1]}, c0 + T > L,
              ids != nullptr && !(entry & UNIFORM)};
}

// ------------------------------------------------------- score helpers ----
// A score tile in registers: s[nb][e] of rows g (e < 2) and g + 8 of the
// warp's 16, columns 8 nb + 2 t + (e & 1) (the mma / wgmma f32 fragment).

// One key tile of the online softmax, in base 2: the raw scores masked,
// their max times scale2 (the scale times log2 e) folded into the running
// max m and sum l of the thread's two rows; s becomes P = 2^(scale2 s - m),
// alpha the factor the output rows are rescaled by.
template <int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale2, const Cols& cols,
                                             int t) {
  const bool masked = cols.bound || cols.check;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        const int j = cols.col0 + nb * 8 + 2 * t + (e & 1);
        if (masked && !cols.keep(j, half)) s[nb][e] = -INFINITY;
        mx = fmaxf(mx, s[nb][e]);
      }
    const float mn = fmaxf(m[half], row_max4(mx) * scale2);
    // a row with no key yet keeps -inf: 2^(-inf - 0) = 0, never NaN
    const float mu = mn == -INFINITY ? 0.f : mn;
    alpha[half] = ex2(m[half] - mu);
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[nb][e] = ex2(fmaf(s[nb][e], scale2, -mu));
        rs += s[nb][e];
      }
    l[half] = l[half] * alpha[half] + row_sum4(rs);
    m[half] = mn;
  }
}

// the natural log-sum-exp of a row from the base-2 max m and sum l
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m + log2f(l)) * LN2;
}

// The backward's P and dS of one tile: s becomes P = exp(scale s - lse)
// (0 where masked; scale2 is the scale times log2 e), d becomes dS =
// P (d - D); lse and D of each column (lse_c, del_c, indexed from the
// tile's first column) or of each row.
template <int NB>
__device__ __forceinline__ void grad_tile(float (&s)[NB][4], float (&d)[NB][4],
                                          float scale2, const Cols& cols,
                                          const float* lse_c,
                                          const float* del_c,
                                          const float (&lse_r)[2],
                                          const float (&del_r)[2], int t) {
  const bool masked = cols.bound || cols.check;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1, jj = nb * 8 + 2 * t + (e & 1);
      const float ls = lse_c ? lse_c[jj] : lse_r[half];
      const float dl = del_c ? del_c[jj] : del_r[half];
      const float p = (!masked || cols.keep(cols.col0 + jj, half))
                          ? ex2(fmaf(s[nb][e], scale2, -ls * LOG2E))
                          : 0.f;
      s[nb][e] = p;
      d[nb][e] = p * (d[nb][e] - dl);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&d)[N][4],
                                           const float (&a)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] *= a[e >> 1];
}

// ---------------------------------------------------------------- f32 ----

// Rows [r0, r0 + R) of a (L, C) matrix into a row-major tile of CB + 4
// floats a row; rows past L and columns past C are zeros.
template <int R, int CB, int NT>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int L, int C) {
  constexpr int V = CB / 4, N = R * V;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    if (N % NT && idx >= N) break;
    const int r = idx / V, c = (idx % V) * 4;
    const bool in = r0 + r < L && c < C;
    cp_async16(smem_u32(dst + r * (CB + 4) + c),
               in ? src + (size_t)(r0 + r) * C + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: lo.hi + hi.lo + hi.hi, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

// s (16 x 8 NB per warp) += A[r0 + 0..15] . B[0 .. 8 NB)^T over CB
template <int NB, int CB>
__device__ __forceinline__ void scores_tf32(const float* A, const float* B,
                                            int r0, int g, int t,
                                            float (&s)[NB][4]) {
  constexpr int LD = CB + 4;
#pragma unroll 2
  for (int kb = 0; kb < CB / 8; ++kb) {
    const float* a = A + (r0 + g) * LD + kb * 8 + t;
    uint32_t ah[4], al[4];
    split(a[0], ah[0], al[0]);
    split(a[8 * LD], ah[1], al[1]);
    split(a[4], ah[2], al[2]);
    split(a[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float* b = B + (nb * 8 + g) * LD + kb * 8 + t;
      mma3(s[nb], ah, al, b[0], b[4]);
    }
  }
}

// part (16 x NC per warp) += P (16 x KD, score fragments p) . W[KD][NC]
// (rows CB + 4 floats apart); the keys of each 8-step in the fragment's
// order (2t, 2t + 1 as t, t + 4)
template <int KD, int CB, int NC>
__device__ __forceinline__ void accum_tf32(const float (&p)[KD / 8][4],
                                           const float* W, int g, int t,
                                           float (&part)[NC / 8][4]) {
  constexpr int LD = CB + 4;
#pragma unroll
  for (int kb = 0; kb < KD / 8; ++kb) {
    uint32_t ah[4], al[4];
    split(p[kb][0], ah[0], al[0]);
    split(p[kb][2], ah[1], al[1]);
    split(p[kb][1], ah[2], al[2]);
    split(p[kb][3], ah[3], al[3]);
    const float* w = W + (kb * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int nc = 0; nc < NC / 8; ++nc)
      mma3(part[nc], ah, al, w[nc * 8], w[LD + nc * 8]);
  }
}

// acc = acc * mul[row] + P . W over all CB columns, 32 or 64 at a time: each
// tile's product is summed from zero on the tensor cores and added to acc
// in f32 (the tensor cores' f32 sums truncate, and one carried over
// thousands of keys drifts past the f32 tolerance)
template <int KD, int CB>
__device__ __forceinline__ void accum_promoted(const float (&p)[KD / 8][4],
                                               const float* W, int g, int t,
                                               float (&acc)[CB / 8][4],
                                               const float (&mul)[2]) {
  constexpr int NC = CB == 128 ? 32 : CB;  // registers at CB = 128
#pragma unroll
  for (int c0 = 0; c0 < CB; c0 += NC) {
    float part[NC / 8][4];
#pragma unroll
    for (int i = 0; i < NC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
    accum_tf32<KD, CB, NC>(p, W + c0, g, t, part);
#pragma unroll
    for (int i = 0; i < NC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c0 / 8 + i][e] = fmaf(acc[c0 / 8 + i][e], mul[e >> 1], part[i][e]);
  }
}

// rows r0 + g (+8) of a warp's (16 x CB) fragments, times mul[half]
template <int CB>
__device__ __forceinline__ void store_f32(float* out,
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
        *reinterpret_cast<float2*>(out + (size_t)r * C + c) =
            make_float2(acc[nc][2 * half] * mul[half],
                        acc[nc][2 * half + 1] * mul[half]);
    }
  }
}

template <int R, int CB>
constexpr int f32_tile() {
  return R * (CB + 4) * 4;
}

// the f32 forward on mma.sync: CB = 128 and 128-key tiles (attn_fwd_tf32,
// on wgmma, takes the rest; its TF32 tiles outgrow shared memory there)
template <int BQ, int BK, int CB>
struct FwdF32 {
  static constexpr int NT = BQ * 2, QB = f32_tile<BQ, CB>(),
                       KB = f32_tile<BK, CB>();
  static constexpr int STAGES = QB + 4 * KB <= SMEM_TILES ? 2 : 1;
  static constexpr int BYTES = QB + 2 * STAGES * KB;
};

template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2, 1)
    attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ rid,
                 float* __restrict__ o, float* __restrict__ lse, int H, int L,
                 int C, float scale) {
  using G = FwdF32<BQ, BK, CB>;
  constexpr int NT = G::NT, LD = CB + 4;
  uint8_t* base = smem_base();
  float* Qs = reinterpret_cast<float*>(base);
  float* KVs = Qs + BQ * LD;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, r0 = q0 + w * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, FWD,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float m[2], l[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
    m[half] = -INFINITY;
    l[half] = 0.f;
  }
  zero(acc);
  load_f32<BQ, CB, NT>(Qs, q + off, q0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
        float* Ks = KVs + st * 2 * BK * LD;
        load_f32<BK, CB, NT>(Ks, k + off, k0, L, C);
        load_f32<BK, CB, NT>(Ks + BK * LD, v + off, k0, L, C);
      },
      [&](int i, int st) {
        const float* Ks = KVs + st * 2 * BK * LD;
        const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
        float s[BK / 8][4], alpha[2];
        zero(s);
        scores_tf32<BK / 8, CB>(Qs, Ks, w * 16, g, t, s);
        softmax_tile(s, m, l, alpha, scale * LOG2E, cols, t);
        accum_promoted<BK, CB>(s, Ks + BK * LD, g, t, acc, alpha);
      });
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    inv[half] = 1.f / l[half];
    const int r = r0 + g + 8 * half;
    if (t == 0 && r < L) lse[(size_t)bh * L + r] = row_lse(m[half], l[half]);
  }
  store_f32<CB>(o + off, acc, inv, r0, g, t, L, C);
}

// the backward on mma.sync, which takes CB = 128 (attn_*_tf32 the rest):
// dQ blocks of 128 queries over 32-key steps, dK/dV blocks of 128 keys
// over 32-query steps, one block of eight warps an SM, as much as shared
// memory holds (measured on the H100: eight warps run the swin backward
// in half the time of four); at CB <= 64, 64-row blocks, three an SM
template <int CB>
struct DqF32 {
  static constexpr int BQ = CB == 128 ? 128 : 64, BK = 32, NT = BQ * 2,
                       QB = f32_tile<BQ, CB>(), KB = f32_tile<BK, CB>();
  static constexpr int STAGES = 2 * QB + 4 * KB <= SMEM_TILES ? 2 : 1;
  static constexpr int BYTES = 2 * QB + 2 * STAGES * KB;
  static constexpr int MINB = CB == 128 ? 1 : 3;
};

template <int CB>
__global__ void __launch_bounds__(DqF32<CB>::NT, DqF32<CB>::MINB)
    attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ rid,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int H,
                int L, int C, float scale) {
  using G = DqF32<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK, LD = CB + 4;
  uint8_t* base = smem_base();
  float* Qs = reinterpret_cast<float*>(base);
  float* dOs = Qs + BQ * LD;
  float* KVs = dOs + BQ * LD;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, r0 = q0 + w * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, DQ,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float lq[2], dl[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const bool in = r < L;
    row_id[half] = (ids && in) ? ids[r] : -1;
    lq[half] = in ? lse[(size_t)bh * L + r] : 0.f;
    dl[half] = in ? delta[(size_t)bh * L + r] : 0.f;
  }
  zero(acc);
  const float one[2] = {1.f, 1.f};
  load_f32<BQ, CB, NT>(Qs, q + off, q0, L, C);
  load_f32<BQ, CB, NT>(dOs, dout + off, q0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
        float* Ks = KVs + st * 2 * BK * LD;
        load_f32<BK, CB, NT>(Ks, k + off, k0, L, C);
        load_f32<BK, CB, NT>(Ks + BK * LD, v + off, k0, L, C);
      },
      [&](int i, int st) {
        const float* Ks = KVs + st * 2 * BK * LD;
        const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
        float s[BK / 8][4], dp[BK / 8][4];
        zero(s);
        zero(dp);
        scores_tf32<BK / 8, CB>(Qs, Ks, w * 16, g, t, s);
        scores_tf32<BK / 8, CB>(dOs, Ks + BK * LD, w * 16, g, t, dp);
        grad_tile(s, dp, scale * LOG2E, cols, nullptr, nullptr, lq, dl, t);
        accum_promoted<BK, CB>(dp, Ks, g, t, acc, one);
      });
  const float mul[2] = {scale, scale};
  store_f32<CB>(dq + off, acc, mul, r0, g, t, L, C);
}

template <int CB>
struct DkvF32 {
  static constexpr int BK = CB == 128 ? 128 : 64, BQ = 32, NT = BK * 2,
                       KB = f32_tile<BK, CB>(), QB = f32_tile<BQ, CB>();
  static constexpr int STAGE = 2 * QB + 8 * BQ;
  static constexpr int STAGES = 2 * KB + 2 * STAGE <= SMEM_TILES ? 2 : 1;
  static constexpr int BYTES = 2 * KB + STAGES * STAGE;
  static constexpr int MINB = CB == 128 ? 1 : 3;
};

// one block per key tile: rows of the register tiles are keys, columns
// queries
template <int CB>
__global__ void __launch_bounds__(DkvF32<CB>::NT, DkvF32<CB>::MINB)
    attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ rid,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int L, int C, float scale) {
  using G = DkvF32<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK, LD = CB + 4;
  uint8_t* base = smem_base();
  float* Ks = reinterpret_cast<float*>(base);
  float* Vs = Ks + BK * LD;
  uint8_t* stages = base + 2 * G::KB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK, r0 = k0 + w * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BQ - 1) / BQ;
  const int n = ids ? live_tiles<NT>(ids, L, k0, BK, BQ, DKV,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
  }
  float gk[CB / 8][4], gv[CB / 8][4];
  zero(gk);
  zero(gv);
  const float none[2] = {0.f, 0.f}, one[2] = {1.f, 1.f};
  load_f32<BK, CB, NT>(Ks, k + off, k0, L, C);
  load_f32<BK, CB, NT>(Vs, v + off, k0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int q0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BQ;
        float* Qs = reinterpret_cast<float*>(stages + st * G::STAGE);
        load_f32<BQ, CB, NT>(Qs, q + off, q0, L, C);
        load_f32<BQ, CB, NT>(Qs + BQ * LD, dout + off, q0, L, C);
        float* rows = Qs + 2 * BQ * LD;
        for (int j = threadIdx.x; j < BQ; j += NT) {
          const bool in = q0 + j < L;
          const size_t at = (size_t)bh * L + (in ? q0 + j : 0);
          cp_async4(smem_u32(rows + j), lse + at, in ? 4 : 0);
          cp_async4(smem_u32(rows + BQ + j), delta + at, in ? 4 : 0);
        }
      },
      [&](int i, int st) {
        const float* Qs =
            reinterpret_cast<const float*>(stages + st * G::STAGE);
        const float* dOs = Qs + BQ * LD;
        const float* rows = dOs + BQ * LD;
        const Cols cols = tile_cols(ids ? list[i] : i, BQ, L, ids, row_id);
        float p[BQ / 8][4], dp[BQ / 8][4];
        zero(p);
        zero(dp);
        scores_tf32<BQ / 8, CB>(Ks, Qs, w * 16, g, t, p);
        scores_tf32<BQ / 8, CB>(Vs, dOs, w * 16, g, t, dp);
        grad_tile(p, dp, scale * LOG2E, cols, rows, rows + BQ, none, none, t);
        accum_promoted<BQ, CB>(p, dOs, g, t, gv, one);
        accum_promoted<BQ, CB>(dp, Qs, g, t, gk, one);
      });
  const float mul[2] = {scale, scale};
  store_f32<CB>(dk + off, gk, mul, r0, g, t, L, C);
  store_f32<CB>(dv + off, gv, one, r0, g, t, L, C);
}

// --------------------------------------------------------------- bf16 ----

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a (16 x KD) score tile as the bf16 A operand of a k16 product per step
template <int KD>
__device__ __forceinline__ void to_a(const float (&s)[KD / 8][4],
                                     uint32_t (&a)[KD / 16][4]) {
#pragma unroll
  for (int kb = 0; kb < KD / 16; ++kb) {
    a[kb][0] = pack_f32(s[2 * kb][0], s[2 * kb][1]);
    a[kb][1] = pack_f32(s[2 * kb][2], s[2 * kb][3]);
    a[kb][2] = pack_f32(s[2 * kb + 1][0], s[2 * kb + 1][1]);
    a[kb][3] = pack_f32(s[2 * kb + 1][2], s[2 * kb + 1][3]);
  }
}

// rows r0 + g (+8) of a warp's (16 x CB) accumulator, times mul[half], as
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

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128B, 2: 64B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) |
         ((uint64_t)((lbo & 0x3ffffu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffffu) >> 4) << 32) | ((uint64_t)mode << 62);
}

// A bf16 tile of R rows and CB columns as wgmma reads it: CB / W column
// blocks of W = min(CB, 64) columns, each R rows of 2W bytes, the 16-byte
// chunks of a row XOR-swizzled by its row within the 8-row atom (128-byte
// swizzle for 64 columns, 64-byte for 32): the layout TMA's
// SWIZZLE_128B / 64B writes.
template <int R, int CB>
struct Tile {
  static constexpr int W = CB < 64 ? CB : 64, RB = 2 * W, BLK = R * RB;
  static constexpr int MODE = RB == 128 ? 1 : 2;
  static constexpr int BYTES = R * CB * 2;
  // the byte offset of element (r, c), c a multiple of 8
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t o = r * RB + (c % W) * 2;
    return (c / W) * BLK + (o ^ (((o >> 7) & (RB / 16 - 1)) << 4));
  }
  // a K-major operand: 64 rows (M) or all R rows (N) from row0, the 16
  // columns of k-step ks
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int row0,
                                                    int ks) {
    const int c = ks * 16;
    return desc(base + (c / W) * BLK + row0 * RB + (c % W) * 2, 16, 8 * RB,
                MODE);
  }
  // an MN-major operand (the B of P.V): rows 16 ks .. (K) by all CB
  // columns (N); the column blocks lie BLK apart
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int ks) {
    return desc(base + ks * 16 * RB, BLK, 8 * RB, MODE);
  }
};

// Rows [r0, r0 + R) of a (L, C) bf16 matrix into a Tile; rows past L and
// columns past C are zeros.
template <int R, int CB, int NT>
__device__ __forceinline__ void load_bf16(uint32_t dst, const bf16_t* src,
                                          int r0, int L, int C) {
  constexpr int V = CB / 8, N = R * V;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    if (N % NT && idx >= N) break;
    const int r = idx / V, c = (idx % V) * 8;
    const bool in = r0 + r < L && c < C;
    cp_async16(dst + Tile<R, CB>::at(r, c),
               in ? src + (size_t)(r0 + r) * C + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching accumulators across wgmma's issue and
// wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (m64 x N, f32) += A (64 x 16) B (16 x N): A and B K-major in shared
// memory (wg_ss), or A in registers and B MN-major (wg_rs)
template <int N>
__device__ void wg_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db);
template <int N>
__device__ void wg_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                      uint64_t db);

#define ACC4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define ACC16 ACC4(0), ACC4(1), ACC4(2), ACC4(3)
#define ACC32 ACC16, ACC4(4), ACC4(5), ACC4(6), ACC4(7)
#define ACC64 \
  ACC32, ACC4(8), ACC4(9), ACC4(10), ACC4(11), ACC4(12), ACC4(13), ACC4(14), \
      ACC4(15)

template <>
__device__ __forceinline__ void wg_ss<32>(float (&d)[4][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs<32>(float (&d)[4][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_ss<64>(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs<64>(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_ss<128>(float (&d)[16][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs<128>(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = A . B^T over CB, both tiles K-major: 64 rows of A from a_row0
template <int RA, int RB_, int CB>
__device__ __forceinline__ void wg_scores(float (&s)[RB_ / 8][4], uint32_t a,
                                          int a_row0, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < CB / 16; ++ks)
    wg_ss<RB_>(s, Tile<RA, CB>::kmajor(a, a_row0, ks),
               Tile<RB_, CB>::kmajor(b, 0, ks));
}

// acc += P (registers, 64 x KD) . W (KD x CB tile, MN-major)
template <int KD, int CB>
__device__ __forceinline__ void wg_accum(float (&acc)[CB / 8][4],
                                         const uint32_t (&p)[KD / 16][4],
                                         uint32_t w) {
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks)
    wg_rs<CB>(acc, p[ks], Tile<KD, CB>::mnmajor(w, ks));
}

// MINB: the blocks an SM should hold, the registers' bound (measured on
// the H100: two for 64-key tiles, one for 128-key tiles, which spill)
template <int BQ, int BK, int CB>
struct FwdBf16 {
  static constexpr int NT = BQ * 2, QB = Tile<BQ, CB>::BYTES,
                       KB = Tile<BK, CB>::BYTES;
  static constexpr int STAGES = QB + 4 * KB <= SMEM_TILES ? 2 : 1;
  static constexpr int BYTES = QB + 2 * STAGES * KB;
  static constexpr int MINB = BK == 128 ? 1 : 2;
};

// a warpgroup owns 64 queries: wg = threadIdx.x / 128
template <int BQ, int BK, int CB>
__global__ void __launch_bounds__(BQ * 2, (FwdBf16<BQ, BK, CB>::MINB))
    attn_fwd_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, const int* __restrict__ rid,
                  bf16_t* __restrict__ o, float* __restrict__ lse, int H,
                  int L, int C, float scale) {
  using G = FwdBf16<BQ, BK, CB>;
  constexpr int NT = G::NT;
  uint8_t* base = smem_base();
  const uint32_t sQ = smem_u32(base), sKV = sQ + G::QB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, FWD,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float m[2], l[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
    m[half] = -INFINITY;
    l[half] = 0.f;
  }
  zero(acc);
  load_bf16<BQ, CB, NT>(sQ, q + off, q0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
        const uint32_t sK = sKV + st * 2 * G::KB;
        load_bf16<BK, CB, NT>(sK, k + off, k0, L, C);
        load_bf16<BK, CB, NT>(sK + G::KB, v + off, k0, L, C);
      },
      [&](int i, int st) {
        const uint32_t sK = sKV + st * 2 * G::KB;
        const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
        float s[BK / 8][4], alpha[2];
        zero(s);
        wg_fence();
        reg_fence(s);
        wg_scores<BQ, BK, CB>(s, sQ, wg * 64, sK);
        wg_commit();
        wg_wait();
        reg_fence(s);
        softmax_tile(s, m, l, alpha, scale * LOG2E, cols, t);
        scale_rows(acc, alpha);
        uint32_t pa[BK / 16][4];
        to_a<BK>(s, pa);
        wg_fence();
        reg_fence(acc);
        wg_accum<BK, CB>(acc, pa, sK + G::KB);
        wg_commit();
        wg_wait();
        reg_fence(acc);
      });
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    inv[half] = 1.f / l[half];
    const int r = r0 + g + 8 * half;
    if (t == 0 && r < L) lse[(size_t)bh * L + r] = row_lse(m[half], l[half]);
  }
  store_bf16<CB>(o + off, acc, inv, r0, g, t, L, C);
}

// the backward's tiles: dQ blocks of 128 queries over 64-key steps; dK/dV
// blocks of 128 keys over 64-query steps, 32 at CB = 128
template <int CB>
struct DqBf16 {
  static constexpr int BQ = 128, BK = 64, NT = 256,
                       QB = Tile<BQ, CB>::BYTES, KB = Tile<BK, CB>::BYTES;
  static constexpr int STAGES = 2 * QB + 4 * KB <= SMEM_TILES ? 2 : 1;
  static constexpr int BYTES = 2 * QB + 2 * STAGES * KB;
};

template <int CB>
__global__ void __launch_bounds__(256, 1)
    attn_dq_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                 const bf16_t* __restrict__ v, const int* __restrict__ rid,
                 const bf16_t* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16_t* __restrict__ dq,
                 int H, int L, int C, float scale) {
  using G = DqBf16<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK;
  uint8_t* base = smem_base();
  const uint32_t sQ = smem_u32(base), sdO = sQ + G::QB,
                 sKV = sdO + G::QB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, DQ,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float lq[2], dl[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const bool in = r < L;
    row_id[half] = (ids && in) ? ids[r] : -1;
    lq[half] = in ? lse[(size_t)bh * L + r] : 0.f;
    dl[half] = in ? delta[(size_t)bh * L + r] : 0.f;
  }
  zero(acc);
  load_bf16<BQ, CB, NT>(sQ, q + off, q0, L, C);
  load_bf16<BQ, CB, NT>(sdO, dout + off, q0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
        const uint32_t sK = sKV + st * 2 * G::KB;
        load_bf16<BK, CB, NT>(sK, k + off, k0, L, C);
        load_bf16<BK, CB, NT>(sK + G::KB, v + off, k0, L, C);
      },
      [&](int i, int st) {
        const uint32_t sK = sKV + st * 2 * G::KB;
        const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
        float s[BK / 8][4], dp[BK / 8][4];
        zero(s);
        zero(dp);
        wg_fence();
        reg_fence(s);
        reg_fence(dp);
        wg_scores<BQ, BK, CB>(s, sQ, wg * 64, sK);
        wg_scores<BQ, BK, CB>(dp, sdO, wg * 64, sK + G::KB);
        wg_commit();
        wg_wait();
        reg_fence(s);
        reg_fence(dp);
        grad_tile(s, dp, scale * LOG2E, cols, nullptr, nullptr, lq, dl, t);
        uint32_t da[BK / 16][4];
        to_a<BK>(dp, da);
        wg_fence();
        reg_fence(acc);
        wg_accum<BK, CB>(acc, da, sK);
        wg_commit();
        wg_wait();
        reg_fence(acc);
      });
  const float mul[2] = {scale, scale};
  store_bf16<CB>(dq + off, acc, mul, r0, g, t, L, C);
}

template <int CB>
struct DkvBf16 {
  static constexpr int BK = 128, BQ = CB == 128 ? 32 : 64, NT = 256,
                       KB = Tile<BK, CB>::BYTES, QB = Tile<BQ, CB>::BYTES;
  static constexpr int STAGES =
      2 * KB + 2 * (2 * QB + 8 * BQ) <= SMEM_TILES ? 2 : 1;
  // the stages' tiles, then their lse and D rows (keeping tiles aligned)
  static constexpr int BYTES = 2 * KB + STAGES * (2 * QB + 8 * BQ);
};

// one block per key tile; a warpgroup owns 64 keys, the fragments' columns
// are queries
template <int CB>
__global__ void __launch_bounds__(256, 1)
    attn_dkv_bf16(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, const int* __restrict__ rid,
                  const bf16_t* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16_t* __restrict__ dk,
                  bf16_t* __restrict__ dv, int H, int L, int C, float scale) {
  using G = DkvBf16<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK;
  uint8_t* base = smem_base();
  const uint32_t sK = smem_u32(base), sV = sK + G::KB, sQD = sV + G::KB;
  float* rows = reinterpret_cast<float*>(base + 2 * G::KB +
                                         G::STAGES * 2 * G::QB);
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int r0 = k0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BQ - 1) / BQ;
  const int n = ids ? live_tiles<NT>(ids, L, k0, BK, BQ, DKV,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
  }
  float gk[CB / 8][4], gv[CB / 8][4];
  zero(gk);
  zero(gv);
  const float none[2] = {0.f, 0.f};
  load_bf16<BK, CB, NT>(sK, k + off, k0, L, C);
  load_bf16<BK, CB, NT>(sV, v + off, k0, L, C);
  ring<G::STAGES>(
      n,
      [&](int i, int st) {
        const int q0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BQ;
        const uint32_t sQ = sQD + st * 2 * G::QB;
        load_bf16<BQ, CB, NT>(sQ, q + off, q0, L, C);
        load_bf16<BQ, CB, NT>(sQ + G::QB, dout + off, q0, L, C);
        float* r = rows + st * 2 * BQ;
        for (int j = threadIdx.x; j < BQ; j += NT) {
          const bool in = q0 + j < L;
          const size_t at = (size_t)bh * L + (in ? q0 + j : 0);
          cp_async4(smem_u32(r + j), lse + at, in ? 4 : 0);
          cp_async4(smem_u32(r + BQ + j), delta + at, in ? 4 : 0);
        }
      },
      [&](int i, int st) {
        const uint32_t sQ = sQD + st * 2 * G::QB, sdO = sQ + G::QB;
        const float* r = rows + st * 2 * BQ;
        const Cols cols = tile_cols(ids ? list[i] : i, BQ, L, ids, row_id);
        float p[BQ / 8][4], dp[BQ / 8][4];
        zero(p);
        zero(dp);
        wg_fence();
        reg_fence(p);
        reg_fence(dp);
        wg_scores<BK, BQ, CB>(p, sK, wg * 64, sQ);
        wg_scores<BK, BQ, CB>(dp, sV, wg * 64, sdO);
        wg_commit();
        wg_wait();
        reg_fence(p);
        reg_fence(dp);
        grad_tile(p, dp, scale * LOG2E, cols, r, r + BQ, none, none, t);
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        to_a<BQ>(p, pa);
        to_a<BQ>(dp, da);
        wg_fence();
        reg_fence(gv);
        reg_fence(gk);
        wg_accum<BQ, CB>(gv, pa, sdO);
        wg_accum<BQ, CB>(gk, da, sQ);
        wg_commit();
        wg_wait();
        reg_fence(gv);
        reg_fence(gk);
      });
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_bf16<CB>(dk + off, gk, mul, r0, g, t, L, C);
  store_bf16<CB>(dv + off, gv, one, r0, g, t, L, C);
}

// ------------------------------------------------- f32 forward, wgmma ----
// B7 in f32 at CB <= 64 and 64-key tiles: 3xTF32 on wgmma. TF32 operands
// must be K-major in shared memory (or A in registers), so the loading
// threads split each tile into hi and lo TF32 tiles: Q and K as they lie
// (rows of channels), V transposed (rows of keys, each 8-key step in the
// order the score fragment holds them, 2t and 2t + 1 as t and t + 4). A
// tile goes global -> registers one tile ahead of the products, and to
// shared memory after them.

// An f32 tile of R rows and CB columns as wgmma reads TF32: CB / 32
// column blocks of 32 floats, each R rows of 128 bytes, 16-byte chunks
// swizzled as Tile's (128-byte swizzle)
template <int R, int CB>
struct Tile4 {
  static constexpr int BLK = R * 128, BYTES = R * CB * 4;
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t o = r * 128 + (c % 32) * 4;
    return (c / 32) * BLK + (o ^ (((o >> 7) & 7) << 4));
  }
  // rows row0.. (64, or all R) by the 8 columns of k-step ks
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int row0,
                                                    int ks) {
    const int c = ks * 8;
    return desc(base + (c / 32) * BLK + row0 * 128 + (c % 32) * 4, 16, 1024,
                1);
  }
};

template <int N>
__device__ void wg_ss_tf32(float (&d)[N / 8][4], uint64_t da, uint64_t db);
template <int N>
__device__ void wg_rs_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4],
                           uint64_t db);

template <>
__device__ __forceinline__ void wg_ss_tf32<32>(float (&d)[4][4],
                                              uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", %16, %17, p, 1, 1;\n}\n"
      : ACC16
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs_tf32<32>(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_ss_tf32<64>(float (&d)[8][4],
                                              uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1;\n}\n"
      : ACC32
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs_tf32<64>(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float4 load4(const float* p, bool in) {
  return in ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// the hi and lo TF32 halves of 4 floats
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// 4 floats of row r, columns c.. of a tile, as its hi and lo TF32 tiles
template <int R, int CB>
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo,
                                     const float4& x, int r, int c) {
  uint4 h, l;
  split4(x, h, l);
  *reinterpret_cast<uint4*>(hi + Tile4<R, CB>::at(r, c)) = h;
  *reinterpret_cast<uint4*>(lo + Tile4<R, CB>::at(r, c)) = l;
}

// the same 4 floats (row r of an (R, CB) tile, columns c..) into the
// transposed tiles (CB, R): rows c.., column r in the score fragment's
// order within its 8-step (2t, 2t + 1 as t, t + 4)
template <int R, int CB>
__device__ __forceinline__ void put4_t(uint8_t* hi, uint8_t* lo,
                                       const float4& x, int r, int c) {
  uint4 h, l;
  split4(x, h, l);
  const int col = (r & ~7) + (r & 1) * 4 + ((r & 7) >> 1);
  const uint32_t h4[4] = {h.x, h.y, h.z, h.w}, l4[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t a = Tile4<CB, R>::at(c + e, col);
    *reinterpret_cast<uint32_t*>(hi + a) = h4[e];
    *reinterpret_cast<uint32_t*>(lo + a) = l4[e];
  }
}

// s (64 x RB) += A . B^T over CB in 3xTF32, both K-major hi/lo tiles; A's
// 64 rows from a_row0
template <int RA, int RB, int CB>
__device__ __forceinline__ void wg_scores_tf32(float (&s)[RB / 8][4],
                                               uint32_t ah, uint32_t al,
                                               int a_row0, uint32_t bh,
                                               uint32_t bl) {
#pragma unroll
  for (int ks = 0; ks < CB / 8; ++ks) {
    const uint64_t xh = Tile4<RA, CB>::kmajor(ah, a_row0, ks),
                   xl = Tile4<RA, CB>::kmajor(al, a_row0, ks),
                   yh = Tile4<RB, CB>::kmajor(bh, 0, ks),
                   yl = Tile4<RB, CB>::kmajor(bl, 0, ks);
    wg_ss_tf32<RB>(s, xl, yh);
    wg_ss_tf32<RB>(s, xh, yl);
    wg_ss_tf32<RB>(s, xh, yh);
  }
}

// a score tile's hi and lo TF32 halves as A operands of 8-wide steps
template <int KD>
__device__ __forceinline__ void to_a_tf32(const float (&s)[KD / 8][4],
                                          uint32_t (&hi)[KD / 8][4],
                                          uint32_t (&lo)[KD / 8][4]) {
#pragma unroll
  for (int j = 0; j < KD / 8; ++j) {
    split(s[j][0], hi[j][0], lo[j][0]);
    split(s[j][2], hi[j][1], lo[j][1]);
    split(s[j][1], hi[j][2], lo[j][2]);
    split(s[j][3], hi[j][3], lo[j][3]);
  }
}

// acc = acc * mul[row] + P . W in 3xTF32: P's hi and lo fragments (64 x
// KD), W the transposed hi/lo tiles (CB, KD); the product summed from
// zero, then added in f32 (see accum_promoted)
template <int KD, int CB>
__device__ __forceinline__ void wg_accum_tf32(float (&acc)[CB / 8][4],
                                              const uint32_t (&ph)[KD / 8][4],
                                              const uint32_t (&pl)[KD / 8][4],
                                              uint32_t wh, uint32_t wl,
                                              const float (&mul)[2]) {
  float part[CB / 8][4];
  zero(part);
  wg_fence();
  reg_fence(part);
#pragma unroll
  for (int j = 0; j < KD / 8; ++j) {
    const uint64_t yh = Tile4<CB, KD>::kmajor(wh, 0, j),
                   yl = Tile4<CB, KD>::kmajor(wl, 0, j);
    wg_rs_tf32<CB>(part, pl[j], yh);
    wg_rs_tf32<CB>(part, ph[j], yl);
    wg_rs_tf32<CB>(part, ph[j], yh);
  }
  wg_commit();
  wg_wait();
  reg_fence(part);
#pragma unroll
  for (int i = 0; i < CB / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[i][e] = fmaf(acc[i][e], mul[e >> 1], part[i][e]);
}

template <int BQ, int CB>
struct FwdTf32 {
  static constexpr int BK = 64, NT = BQ * 2, QB = Tile4<BQ, CB>::BYTES,
                       KB = Tile4<BK, CB>::BYTES, VB = Tile4<CB, BK>::BYTES;
  static constexpr int STAGE = 2 * KB + 2 * VB;  // K hi, K lo, V^T hi, lo
  static constexpr int BYTES = 2 * QB + 2 * STAGE;
  static constexpr int CH = BK * CB / 4 / NT;  // float4 a thread a tensor
};

template <int BQ, int CB>
__global__ void __launch_bounds__(BQ * 2, 1)
    attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ rid,
                  float* __restrict__ o, float* __restrict__ lse, int H,
                  int L, int C, float scale) {
  using G = FwdTf32<BQ, CB>;
  constexpr int NT = G::NT, BK = G::BK, V4 = CB / 4;
  uint8_t* base = smem_base();
  const uint32_t sQh = smem_u32(base), sQl = sQh + G::QB,
                 sS = sQl + G::QB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, FWD,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float m[2], l[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
    m[half] = -INFINITY;
    l[half] = 0.f;
  }
  zero(acc);
  for (int idx = tid; idx < BQ * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    put4<BQ, CB>(base, base + G::QB,
                 load4(q + off + (size_t)(q0 + r) * C + c, q0 + r < L && c < C),
                 r, c);
  }
  // the next tile in registers, a warp's lanes on consecutive keys (so
  // that the transposed stores meet no bank twice)
  float4 kr[G::CH], vr[G::CH];
  auto fetch = [&](int i) {
    const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, kk = idx % BK, c = (idx / BK) * 4;
      const bool in = k0 + kk < L && c < C;
      kr[j] = load4(k + off + (size_t)(k0 + kk) * C + c, in);
      vr[j] = load4(v + off + (size_t)(k0 + kk) * C + c, in);
    }
  };
  auto put = [&](int st) {
    uint8_t* sK = base + 2 * G::QB + st * G::STAGE;
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, kk = idx % BK, c = (idx / BK) * 4;
      put4<BK, CB>(sK, sK + G::KB, kr[j], kk, c);
      put4_t<BK, CB>(sK + 2 * G::KB, sK + 2 * G::KB + G::VB, vr[j], kk, c);
    }
  };
  if (n > 0) {
    fetch(0);
    put(0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) fetch(i + 1);
    const uint32_t sKh = sS + (i & 1) * G::STAGE, sKl = sKh + G::KB,
                   sVh = sKh + 2 * G::KB, sVl = sVh + G::VB;
    const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
    float s[BK / 8][4], alpha[2];
    zero(s);
    wg_fence();
    reg_fence(s);
    wg_scores_tf32<BQ, BK, CB>(s, sQh, sQl, wg * 64, sKh, sKl);
    wg_commit();
    wg_wait();
    reg_fence(s);
    softmax_tile(s, m, l, alpha, scale * LOG2E, cols, t);
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
    to_a_tf32<BK>(s, ph, pl);
    wg_accum_tf32<BK, CB>(acc, ph, pl, sVh, sVl, alpha);
    if (i + 1 < n) put((i + 1) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    inv[half] = 1.f / l[half];
    const int r = r0 + g + 8 * half;
    if (t == 0 && r < L) lse[(size_t)bh * L + r] = row_lse(m[half], l[half]);
  }
  store_f32<CB>(o + off, acc, inv, r0, g, t, L, C);
}

// B8 in f32 at CB <= 64 on wgmma, the same 3xTF32: the dQ kernel keeps
// Q and dO split in shared memory and takes K (as it lies and transposed)
// and V a key tile at a time; the dK/dV kernel keeps K and V and takes Q
// and dO (both ways) a query tile at a time. One stage each (the TF32
// tiles fill shared memory: 224 KB for dQ at CB = 64, leaving room for
// the region lists of L up to ~16K); the next tile waits in registers.
template <int CB>
struct DqTf32 {
  static constexpr int BQ = 128, BK = 64, NT = 256, QB = Tile4<BQ, CB>::BYTES,
                       KB = Tile4<BK, CB>::BYTES, CH = BK * CB / 4 / NT;
  static constexpr int BYTES = 4 * QB + 6 * KB;  // Q, dO; K, V, K^T
};

template <int CB>
__global__ void __launch_bounds__(256, 1)
    attn_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ rid,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int H, int L, int C, float scale) {
  using G = DqTf32<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK, V4 = CB / 4;
  uint8_t* base = smem_base();
  uint8_t* sT = base + 4 * G::QB;  // K hi, lo; V hi, lo; K^T hi, lo
  const uint32_t sQh = smem_u32(base), sQl = sQh + G::QB,
                 sDh = sQl + G::QB, sDl = sDh + G::QB, sKh = smem_u32(sT),
                 sKl = sKh + G::KB, sVh = sKl + G::KB, sVl = sVh + G::KB,
                 sKTh = sVl + G::KB, sKTl = sKTh + G::KB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BK - 1) / BK;
  const int n = ids ? live_tiles<NT>(ids, L, q0, BQ, BK, DQ,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
  float lq[2], dl[2], acc[CB / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const bool in = r < L;
    row_id[half] = (ids && in) ? ids[r] : -1;
    lq[half] = in ? lse[(size_t)bh * L + r] : 0.f;
    dl[half] = in ? delta[(size_t)bh * L + r] : 0.f;
  }
  zero(acc);
  const float one[2] = {1.f, 1.f};
  for (int idx = tid; idx < BQ * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool in = q0 + r < L && c < C;
    put4<BQ, CB>(base, base + G::QB,
                 load4(q + off + (size_t)(q0 + r) * C + c, in), r, c);
    put4<BQ, CB>(base + 2 * G::QB, base + 3 * G::QB,
                 load4(dout + off + (size_t)(q0 + r) * C + c, in), r, c);
  }
  float4 kr[G::CH], vr[G::CH];
  auto fetch = [&](int i) {
    const int k0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BK;
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, kk = idx % BK, c = (idx / BK) * 4;
      const bool in = k0 + kk < L && c < C;
      kr[j] = load4(k + off + (size_t)(k0 + kk) * C + c, in);
      vr[j] = load4(v + off + (size_t)(k0 + kk) * C + c, in);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, kk = idx % BK, c = (idx / BK) * 4;
      put4<BK, CB>(sT, sT + G::KB, kr[j], kk, c);
      put4<BK, CB>(sT + 2 * G::KB, sT + 3 * G::KB, vr[j], kk, c);
      put4_t<BK, CB>(sT + 4 * G::KB, sT + 5 * G::KB, kr[j], kk, c);
    }
  };
  if (n > 0) {
    fetch(0);
    put();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) fetch(i + 1);
    const Cols cols = tile_cols(ids ? list[i] : i, BK, L, ids, row_id);
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    wg_fence();
    reg_fence(s);
    reg_fence(dp);
    wg_scores_tf32<BQ, BK, CB>(s, sQh, sQl, wg * 64, sKh, sKl);
    wg_scores_tf32<BQ, BK, CB>(dp, sDh, sDl, wg * 64, sVh, sVl);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    grad_tile(s, dp, scale * LOG2E, cols, nullptr, nullptr, lq, dl, t);
    uint32_t ah[BK / 8][4], al[BK / 8][4];
    to_a_tf32<BK>(dp, ah, al);
    wg_accum_tf32<BK, CB>(acc, ah, al, sKTh, sKTl, one);
    if (i + 1 < n) {
      __syncthreads();  // every warp is done with this tile
      put();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
  const float mul[2] = {scale, scale};
  store_f32<CB>(dq + off, acc, mul, r0, g, t, L, C);
}

template <int CB>
struct DkvTf32 {
  static constexpr int BK = 128, BQ = 32, NT = 256, KB = Tile4<BK, CB>::BYTES,
                       QB = Tile4<BQ, CB>::BYTES, CH = BQ * CB / 4 / NT;
  // K, V; Q, dO both ways; the query tile's lse and D
  static constexpr int BYTES = 4 * KB + 8 * QB + 8 * BQ;
};

template <int CB>
__global__ void __launch_bounds__(256, 1)
    attn_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ rid,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int L, int C, float scale) {
  using G = DkvTf32<CB>;
  constexpr int NT = G::NT, BQ = G::BQ, BK = G::BK, V4 = CB / 4;
  uint8_t* base = smem_base();
  uint8_t* sT = base + 4 * G::KB;  // Q, dO hi/lo; Q^T, dO^T hi/lo
  float* rows = reinterpret_cast<float*>(sT + 8 * G::QB);  // lse, D
  const uint32_t sKh = smem_u32(base), sKl = sKh + G::KB,
                 sVh = sKl + G::KB, sVl = sVh + G::KB, sQh = smem_u32(sT),
                 sQl = sQh + G::QB, sDh = sQl + G::QB, sDl = sDh + G::QB,
                 sQTh = sDl + G::QB, sQTl = sQTh + G::QB,
                 sDTh = sQTl + G::QB, sDTl = sDTh + G::QB;
  int* list = reinterpret_cast<int*>(base + G::BYTES);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int r0 = k0 + wg * 64 + ((tid >> 5) & 3) * 16;
  const size_t off = (size_t)bh * L * C;
  const int* ids = rid ? rid + (size_t)(bh % H) * L : nullptr;
  const int nt = (L + BQ - 1) / BQ;
  const int n = ids ? live_tiles<NT>(ids, L, k0, BK, BQ, DKV,
                                     list,
                                     reinterpret_cast<uint32_t*>(list + nt))
                    : nt;
  int row_id[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    row_id[half] = (ids && r < L) ? ids[r] : -1;
  }
  float gk[CB / 8][4], gv[CB / 8][4];
  zero(gk);
  zero(gv);
  const float none[2] = {0.f, 0.f}, one[2] = {1.f, 1.f};
  for (int idx = tid; idx < BK * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool in = k0 + r < L && c < C;
    put4<BK, CB>(base, base + G::KB,
                 load4(k + off + (size_t)(k0 + r) * C + c, in), r, c);
    put4<BK, CB>(base + 2 * G::KB, base + 3 * G::KB,
                 load4(v + off + (size_t)(k0 + r) * C + c, in), r, c);
  }
  float4 qr[G::CH], dr[G::CH];
  float ls = 0.f, de = 0.f;
  auto fetch = [&](int i) {
    const int q0 = ((ids ? list[i] : i) & (UNIFORM - 1)) * BQ;
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, qq = idx % BQ, c = (idx / BQ) * 4;
      const bool in = q0 + qq < L && c < C;
      qr[j] = load4(q + off + (size_t)(q0 + qq) * C + c, in);
      dr[j] = load4(dout + off + (size_t)(q0 + qq) * C + c, in);
    }
    if (tid < BQ) {
      const bool in = q0 + tid < L;
      ls = in ? lse[(size_t)bh * L + q0 + tid] : 0.f;
      de = in ? delta[(size_t)bh * L + q0 + tid] : 0.f;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int j = 0; j < G::CH; ++j) {
      const int idx = tid + j * NT, qq = idx % BQ, c = (idx / BQ) * 4;
      put4<BQ, CB>(sT, sT + G::QB, qr[j], qq, c);
      put4<BQ, CB>(sT + 2 * G::QB, sT + 3 * G::QB, dr[j], qq, c);
      put4_t<BQ, CB>(sT + 4 * G::QB, sT + 5 * G::QB, qr[j], qq, c);
      put4_t<BQ, CB>(sT + 6 * G::QB, sT + 7 * G::QB, dr[j], qq, c);
    }
    if (tid < BQ) {
      rows[tid] = ls;
      rows[BQ + tid] = de;
    }
  };
  if (n > 0) {
    fetch(0);
    put();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) fetch(i + 1);
    const Cols cols = tile_cols(ids ? list[i] : i, BQ, L, ids, row_id);
    float p[BQ / 8][4], dp[BQ / 8][4];
    zero(p);
    zero(dp);
    wg_fence();
    reg_fence(p);
    reg_fence(dp);
    wg_scores_tf32<BK, BQ, CB>(p, sKh, sKl, wg * 64, sQh, sQl);
    wg_scores_tf32<BK, BQ, CB>(dp, sVh, sVl, wg * 64, sDh, sDl);
    wg_commit();
    wg_wait();
    reg_fence(p);
    reg_fence(dp);
    grad_tile(p, dp, scale * LOG2E, cols, rows, rows + BQ, none, none, t);
    uint32_t xh[BQ / 8][4], xl[BQ / 8][4];
    to_a_tf32<BQ>(p, xh, xl);
    wg_accum_tf32<BQ, CB>(gv, xh, xl, sDTh, sDTl, one);
    to_a_tf32<BQ>(dp, xh, xl);
    wg_accum_tf32<BQ, CB>(gk, xh, xl, sQTh, sQTl, one);
    if (i + 1 < n) {
      __syncthreads();  // every warp is done with this tile
      put();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
  const float mul[2] = {scale, scale};
  store_f32<CB>(dk + off, gk, mul, r0, g, t, L, C);
  store_f32<CB>(dv + off, gv, one, r0, g, t, L, C);
}

// ------------------------------------------------------------- delta ----

__device__ __forceinline__ void widen(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

__device__ __forceinline__ void widen(const bf16_t* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// delta[r] = sum_c dout[r][c] * out[r][c] in f32, one warp a row of C (a
// multiple of 16), 4 columns a lane a step, summed in a fixed order
template <typename T>
__global__ void __launch_bounds__(256)
    attn_delta(const T* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ delta, int rows, int C) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    float a[4], b[4];
    widen(out + (size_t)r * C + c, a);
    widen(dout + (size_t)r * C + c, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(a[e], b[e], acc);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[r] = acc;
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

// the alignment slack and, with region ids, the list and scratch of the
// tiles of T rows
size_t extra(const int* rid, int L, int T) {
  return 1024 + (rid ? sizeof(int) * (2 * ((L + T - 1) / T) + 1) : 0);
}

template <int BQ, int BK, int CB>
int fwd(const void* q, const void* k, const void* v, const int* rid, void* o,
        float* lse, int BH, int H, int L, int C, float scale, int bf16,
        cudaStream_t s) {
  const dim3 grid((L + BQ - 1) / BQ, BH);
  const size_t ex = extra(rid, L, BK);
  if (bf16)
    return run(attn_fwd_bf16<BQ, BK, CB>, grid, BQ * 2,
               FwdBf16<BQ, BK, CB>::BYTES + ex, s, (const bf16_t*)q,
               (const bf16_t*)k, (const bf16_t*)v, rid, (bf16_t*)o, lse, H, L,
               C, scale);
  if constexpr (CB <= 64 && BK == 64)
    return run(attn_fwd_tf32<BQ, CB>, grid, BQ * 2,
               FwdTf32<BQ, CB>::BYTES + ex, s, (const float*)q,
               (const float*)k, (const float*)v, rid, (float*)o, lse, H, L,
               C, scale);
  else
    return run(attn_fwd_f32<BQ, BK, CB>, grid, BQ * 2,
               FwdF32<BQ, BK, CB>::BYTES + ex, s, (const float*)q,
               (const float*)k, (const float*)v, rid, (float*)o, lse, H, L,
               C, scale);
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
      return fwd<128, 128, CB>(q, k, v, rid, o, lse, BH, H, L, C, scale, bf16,
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
  int err;
  if (bf16) {
    using A = DkvBf16<CB>;
    using B = DqBf16<CB>;
    err = run(attn_dkv_bf16<CB>, dim3((L + A::BK - 1) / A::BK, BH), A::NT,
              A::BYTES + extra(rid, L, A::BQ), s, (const bf16_t*)q,
              (const bf16_t*)k, (const bf16_t*)v, rid, (const bf16_t*)dout,
              lse, delta, (bf16_t*)dk, (bf16_t*)dv, H, L, C, scale);
    if (err) return err;
    return run(attn_dq_bf16<CB>, dim3((L + B::BQ - 1) / B::BQ, BH), B::NT,
               B::BYTES + extra(rid, L, B::BK), s, (const bf16_t*)q,
               (const bf16_t*)k, (const bf16_t*)v, rid, (const bf16_t*)dout,
               lse, delta, (bf16_t*)dq, H, L, C, scale);
  }
  if constexpr (CB <= 64) {
    using A = DkvTf32<CB>;
    using B = DqTf32<CB>;
    err = run(attn_dkv_tf32<CB>, dim3((L + A::BK - 1) / A::BK, BH), A::NT,
              A::BYTES + extra(rid, L, A::BQ), s, (const float*)q,
              (const float*)k, (const float*)v, rid, (const float*)dout, lse,
              delta, (float*)dk, (float*)dv, H, L, C, scale);
    if (err) return err;
    return run(attn_dq_tf32<CB>, dim3((L + B::BQ - 1) / B::BQ, BH), B::NT,
               B::BYTES + extra(rid, L, B::BK), s, (const float*)q,
               (const float*)k, (const float*)v, rid, (const float*)dout,
               lse, delta, (float*)dq, H, L, C, scale);
  } else {
    using A = DkvF32<CB>;
    using B = DqF32<CB>;
    err = run(attn_dkv_f32<CB>, dim3((L + A::BK - 1) / A::BK, BH), A::NT,
              A::BYTES + extra(rid, L, A::BQ), s, (const float*)q,
              (const float*)k, (const float*)v, rid, (const float*)dout, lse,
              delta, (float*)dk, (float*)dv, H, L, C, scale);
    if (err) return err;
    return run(attn_dq_f32<CB>, dim3((L + B::BQ - 1) / B::BQ, BH), B::NT,
               B::BYTES + extra(rid, L, B::BK), s, (const float*)q,
               (const float*)k, (const float*)v, rid, (const float*)dout,
               lse, delta, (float*)dq, H, L, C, scale);
  }
}

}  // namespace

// the bucket a head dim is padded to: 32, 64 or 128; 0 if not taken
extern "C" int igs_attention_bucket(int C) {
  if (C < 16 || C > 128 || C % 16) return 0;
  return C <= 32 ? 32 : C <= 64 ? 64 : 128;
}

// o, lse = attention(q, k, v); (BH, L, C) contiguous, dtype 0 f32 / 1 bf16,
// tile 0: 64x64, 1: 128x64, 2: 128x128 (queries x keys); rid (H, L) or null
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

// delta = rowsum(dout * o) in f32 over rows of C: the backward's D
extern "C" int igs_attention_delta(const void* out, const void* dout,
                                   float* delta, int rows, int C, int dtype,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (igs_attention_bucket(C) == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + 7) / 8);
  if (dtype)
    attn_delta<<<grid, 256, 0, s>>>((const bf16_t*)out, (const bf16_t*)dout,
                                    delta, rows, C);
  else
    attn_delta<<<grid, 256, 0, s>>>((const float*)out, (const float*)dout,
                                    delta, rows, C);
  return (int)cudaGetLastError();
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

// on: zero the tile counters and count every listed tile from now on;
// off: stop counting (the counters keep their values)
extern "C" int igs_attention_count_tiles(int on) {
  if (on) {
    const unsigned long long zero[3][2] = {};
    const cudaError_t e = cudaMemcpyToSymbol(tile_pairs, zero, sizeof zero);
    if (e != cudaSuccess) return (int)e;
  }
  const int flag = on ? 1 : 0;
  return (int)cudaMemcpyToSymbol(tile_count_on, &flag, sizeof flag);
}

// out[2 * kind + 0 | 1]: the tiles listed and all tiles (summed over the
// blocks) of each kind's live_tiles calls since counting was switched on
extern "C" int igs_attention_tile_pairs(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tile_pairs,
                                   6 * sizeof(unsigned long long));
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
