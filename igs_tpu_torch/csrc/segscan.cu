// Segmented inclusive scan for Hopper (sm_90a): per lane row, the prefix
// sum over contiguous runs of equal ids.
//
// Replaces the TPU kernel igs_tpu/ops/segred.py:_segscan_kernel (launched
// by segmented_scan). It computes
//   out[l, i] = sum of x[l, j] over j <= i with ids[j] == ids[i]
// where runs of equal ids are contiguous, on the port's (lanes, pairs)
// layout: each lane row is contiguous along the pairs. Accumulation is
// fp32 throughout; the TPU kernel's bf16 hi/lo split was an MXU artifact.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. Each element is read
// once and written once, and the ids once: 8 L + 4 bytes a pair, a few
// adds each.
//
// Design: one launch, one pass. A block of 256 threads owns a tile of
// TILE pairs (1024 at 16 lanes, 512 at 32) for every lane row: thread t
// holds pairs t*I .. t*I+I-1 (I = 4 or 2) of all L rows in registers,
// loaded as float4 / float2 along the pairs (x streamed, the ids through
// the read-only cache, so the pair before a thread's first is an L1
// hit). It loads the ids once and derives the head flags ("a run starts
// here") once for all rows. Per
// row: a scan within the thread, a segmented warp scan by shuffles whose
// flag steps are computed once, and the 8 warps' totals folded in warp
// order through shared memory. The tile's aggregate per row is the sum
// from its last head to its end (the whole tile if it has no head).
//
// The carry into a tile (the running sum of the run that enters it) comes
// from a chained look-back, decoupled from the scan: the tile publishes
// its aggregate (status AGG) or, if it has a head, its inclusive prefix at
// once (status INCL: the aggregate itself). A tile whose first pair is
// not a head then reads the statuses of its WINDOW predecessors and waits
// until the nearest INCL among them has only AGGs after it. Its carry is
// that prefix plus the AGGs after it, added oldest first; a tile without
// a head publishes carry + aggregate as its INCL. Each element is then
// written once, with its run's sum: there is no second pass over the
// output and no fix-up of the elements before a tile's first head.
//
// Why the result is bitwise repeatable although the INCL that a tile
// stops at depends on timing: let h be the last tile with a head before
// tile b. The carry into b is defined as the chain
//   C_{h+1} = A_h,  C_{t+1} = fl(C_t + A_t)  for headless t in (h, b),
// and every headless tile t publishes INCL_t = fl(C'_t + A_t) from the
// carry C'_t it computed. If tile b stops at INCL_k, every tile in
// (k, b) is headless (status AGG), and k is either h (INCL_h = A_h) or a
// headless tile with INCL_k = C_{k+1} (by induction on the tile index,
// k < b). Adding A_{k+1}, ..., A_{b-1} to it oldest first is the chain's
// own order, so C'_b = C_b whichever k it stopped at. A look-back that
// summed what it found in another order would not be repeatable.
// tests/test_torch_port_segred.py emulates this protocol (statuses, the
// window, random schedules and stale status reads) and holds the carries
// to the chain's bits, and a newest-first sum to failing it.
//
// Tiles are handed out by an atomic ticket, not by blockIdx: a tile only
// waits on tiles with smaller tickets, whose blocks took their tickets
// earlier and so are resident or done, which guarantees progress. The
// status words and the ticket are zeroed by the wrapper before each
// launch. Publishing writes the values, fences, then the status; reading
// sees the status (volatile), fences, then reads the values through L2.
//
// The constants are the fastest of the variants timed against each other
// on the same inputs in one call on an H100 (PERF.md, Findings):
// 0.12 ms at the eval view's 2^21 pairs and 16 lanes, 1.46x the bytes
// bound; the same loads and stores with no scan take 0.10, the scan
// without its look-back 0.104. A look-back window of 32
// tiles lost 15 % there (the 0.89M-slot pad run is one headless chain);
// 128 gained 2 % over 64, 256 nothing. 512-pair tiles at 16 lanes (three
// blocks an SM) lost 25 %; 2048-pair tiles of 512 threads and the ids
// streamed rather than cached moved under 2 %. Persistent blocks that
// stage the next tile with cp.async while scanning this one lost 28 %
// (a tile taken early holds up every look-back that waits on it);
// writing the pairs that need no carry before the look-back lost 3 % at
// 16 lanes; 128-thread blocks (512-pair tiles, four an SM) lost 15 %;
// capping registers for three blocks an SM spilled and lost; acquire /
// release fences in place of __threadfence() moved nothing.
// -Xptxas -v: 128 / 120 registers (16 / 32 lanes), no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 128;  // tiles a look-back reads
constexpr unsigned kFull = 0xffffffffu;

// tile status
constexpr int kNone = 0;  // nothing published yet
constexpr int kAgg = 1;   // agg[tile] holds the tile's aggregate
constexpr int kIncl = 2;  // incl[tile] holds the running sum at its end

template <int L>
struct Shape {
  static_assert(L == 16 || L == 32, "the scan takes 16 or 32 lanes");
  static constexpr int items = 64 / L;  // pairs a thread: 64 floats of x
  static constexpr int tile = kThreads * items;
};

template <int I>
struct Vec;
template <>
struct Vec<4> {
  using F = float4;
  using N = int4;
  __device__ static void unpack(F v, float (&o)[4]) {
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  __device__ static void unpack(N v, int (&o)[4]) {
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  __device__ static F pack(const float (&o)[4]) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Vec<2> {
  using F = float2;
  using N = int2;
  __device__ static void unpack(F v, float (&o)[2]) { o[0] = v.x, o[1] = v.y; }
  __device__ static void unpack(N v, int (&o)[2]) { o[0] = v.x, o[1] = v.y; }
  __device__ static F pack(const float (&o)[2]) { return make_float2(o[0], o[1]); }
};

__device__ __forceinline__ int load_status(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_status(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
segscan_kernel(const float* __restrict__ x, const int* __restrict__ ids,
               long long mp, int vec, float* __restrict__ out,
               int* __restrict__ status, int* __restrict__ ticket,
               float* __restrict__ agg, float* __restrict__ incl) {
  constexpr int I = Shape<L>::items;
  constexpr int TILE = Shape<L>::tile;
  using V = Vec<I>;
  __shared__ int s_tile, s_head0, s_from;
  __shared__ int s_wflag[kWarps];      // warp w holds a head
  __shared__ int s_wpf[kWarps];        // a head before warp w in the tile
  __shared__ float s_wsum[kWarps][L];  // warp w's segmented total
  __shared__ float s_wpre[kWarps][L];  // the tile's prefix entering warp w
  __shared__ float s_look[kWindow][L];
  __shared__ float s_carry[L];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int b = s_tile;
  const long long base = static_cast<long long>(b) * TILE + tid * I;

  // -- load: x once, ids once, head flags once for every row --------------
  float v[L][I];
  int id[I];
  if (vec && base + I <= mp) {
    V::unpack(__ldg(reinterpret_cast<const typename V::N*>(ids + base)), id);
#pragma unroll
    for (int r = 0; r < L; ++r)
      V::unpack(__ldcs(reinterpret_cast<const typename V::F*>(x + r * mp + base)),
                v[r]);
  } else {
#pragma unroll
    for (int k = 0; k < I; ++k) {
      const long long i = base + k;
      id[k] = i < mp ? ids[i] : 0;
#pragma unroll
      for (int r = 0; r < L; ++r) v[r][k] = i < mp ? x[r * mp + i] : 0.f;
    }
  }
  unsigned hb = 0;  // bit k: pair base + k starts a run
  {
    int prev = base > 0 && base - 1 < mp ? ids[base - 1] : 0;
#pragma unroll
    for (int k = 0; k < I; ++k) {
      const long long i = base + k;
      if (i < mp && (i == 0 || id[k] != prev)) hb |= 1u << k;
      prev = id[k];
    }
  }
  if (tid == 0) s_head0 = hb & 1u;

  // -- scan within the thread, then the warp ------------------------------
#pragma unroll
  for (int r = 0; r < L; ++r)
#pragma unroll
    for (int k = 1; k < I; ++k)
      if (!((hb >> k) & 1u)) v[r][k] += v[r][k - 1];
  // the flag steps of the segmented warp scan, shared by every row: at
  // step s this lane adds the value 2^s lanes down iff no head lies
  // between (the scan's (f1, a1) + (f2, a2) = (f1|f2, f2 ? a2 : a1 + a2))
  int f = hb != 0;
  unsigned take = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int of = __shfl_up_sync(kFull, f, 1 << s);
    if (lane >= (1 << s)) {
      if (!f) take |= 1u << s;
      f |= of;
    }
  }
  int xf = __shfl_up_sync(kFull, f, 1);  // a head in lanes below this one
  if (lane == 0) xf = 0;
  if (lane == 31) s_wflag[warp] = f;
  float xa[L];  // the warp's exclusive prefix at this lane, per row
#pragma unroll
  for (int r = 0; r < L; ++r) {
    float a = v[r][I - 1];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const float o = __shfl_up_sync(kFull, a, 1 << s);
      if ((take >> s) & 1u) a = o + a;
    }
    xa[r] = __shfl_up_sync(kFull, a, 1);
    if (lane == 0) xa[r] = 0.f;
    if (lane == 31) s_wsum[warp][r] = a;
  }
  __syncthreads();

  // -- the warps in order; publish the tile ------------------------------
  const bool need_carry = !s_head0;
  float tile_agg = 0.f;  // lane r < L of warp 0: row r's aggregate
  int tile_head = 0;
  if (warp == 0) {
    const int r = lane < L ? lane : 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (lane < L) s_wpre[w][r] = tile_agg;
      if (lane == 0) s_wpf[w] = tile_head;
      const float ws = s_wsum[w][r];
      tile_agg = s_wflag[w] ? ws : tile_agg + ws;
      tile_head |= s_wflag[w];
    }
    if (lane < L) __stcg((tile_head ? incl : agg) + b * L + lane, tile_agg);
    __threadfence();
    __syncwarp();
    if (lane == 0) store_status(status + b, tile_head ? kIncl : kAgg);

    if (need_carry) {
      // wait until the nearest INCL in the window has only AGGs after it
      int from;
      for (;;) {
        int near_incl = kWindow, near_none = kWindow;
#pragma unroll
        for (int j = 0; j < kWindow / 32; ++j) {
          const int t = b - 1 - (j * 32 + lane);
          const int st = t >= 0 ? load_status(status + t) : kIncl;
          const unsigned mi = __ballot_sync(kFull, st == kIncl);
          const unsigned mn = __ballot_sync(kFull, st == kNone);
          if (mi && near_incl == kWindow) near_incl = j * 32 + __ffs(mi) - 1;
          if (mn && near_none == kWindow) near_none = j * 32 + __ffs(mn) - 1;
        }
        if (near_incl < near_none) {
          from = b - 1 - near_incl;
          break;
        }
        __nanosleep(32);
      }
      __threadfence();
      if (lane == 0) s_from = from;
    }
  }
  __syncthreads();

  // -- the carry: INCL_from, then the AGGs after it, oldest first ----------
  if (need_carry) {
    const int from = s_from;
    const int n = b - from;  // INCL_from and n - 1 aggregates
    for (int e = tid; e < n * L; e += kThreads) {
      const int k = e / L, r = e - k * L;
      s_look[k][r] = __ldcg((k == 0 ? incl : agg) + (from + k) * L + r);
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < L) {
        float c = s_look[0][lane];
        for (int k = 1; k < n; ++k) c += s_look[k][lane];
        s_carry[lane] = c;
        if (!tile_head) __stcg(incl + b * L + lane, c + tile_agg);
      }
      if (!tile_head) {
        __threadfence();
        __syncwarp();
        if (lane == 0) store_status(status + b, kIncl);
      }
    }
    __syncthreads();
  }

  // -- each element once, with its run's sum ------------------------------
  const int pf = s_wpf[warp] | xf;  // a head before this thread in the tile
#pragma unroll
  for (int r = 0; r < L; ++r) {
    float e = xf ? xa[r] : s_wpre[warp][r] + xa[r];
    if (!pf && need_carry) e = s_carry[r] + e;
    bool seen = false;
#pragma unroll
    for (int k = 0; k < I; ++k) {
      seen |= (hb >> k) & 1u;
      if (!seen) v[r][k] = e + v[r][k];
    }
  }
  if (vec && base + I <= mp) {
#pragma unroll
    for (int r = 0; r < L; ++r)
      __stcs(reinterpret_cast<typename V::F*>(out + r * mp + base), V::pack(v[r]));
  } else {
#pragma unroll
    for (int k = 0; k < I; ++k)
      if (base + k < mp) {
#pragma unroll
        for (int r = 0; r < L; ++r) out[r * mp + base + k] = v[r][k];
      }
  }
}

template <int L>
int launch(const float* x, const int* ids, long long mp, float* out,
           int* state, float* agg, float* incl, cudaStream_t s) {
  constexpr int I = Shape<L>::items;
  const long long ntiles = (mp + Shape<L>::tile - 1) / Shape<L>::tile;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = mp % I == 0 && aligned(x) && aligned(ids) && aligned(out);
  segscan_kernel<L><<<static_cast<int>(ntiles), kThreads, 0, s>>>(
      x, ids, mp, vec, out, state, state + ntiles, agg, incl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. x and out are (lanes, mp) row-major
// f32, ids (mp,) i32, lanes 16 or 32. With T = igs_segscan_tiles(lanes,
// mp) tiles: state is T + 1 int32, zero on entry (the tiles' statuses and
// the ticket); agg and incl are (T, lanes) f32 scratch. Returns the
// launch's cudaError_t.
extern "C" long long igs_segscan_tiles(int lanes, long long mp) {
  const int tile = lanes == 16 ? Shape<16>::tile
                   : lanes == 32 ? Shape<32>::tile : 0;
  return tile ? (mp + tile - 1) / tile : -1;
}

extern "C" int igs_segmented_scan(const float* x, const int* ids,
                                  long long mp, int lanes, float* out,
                                  int* state, float* agg, float* incl,
                                  void* stream) {
  if (mp <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 16:
      return launch<16>(x, ids, mp, out, state, agg, incl, s);
    case 32:
      return launch<32>(x, ids, mp, out, state, agg, incl, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* igs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
