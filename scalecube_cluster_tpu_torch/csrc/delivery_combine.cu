// Delivery combine of the pview fused gossip phase, for Hopper (sm_90a).
//
// Replaces the TPU kernel `delivery_combine` of the JAX package's
// scalecube_cluster_tpu/ops/pallas_delivery.py — both of its bodies:
// `_delivery_kernel` (1-D grid over row blocks, :128, called at :251) and
// `_delivery_kernel_cols` (:167, called at :282: a split over membership
// words that exists only to fit the payload into a TPU core's VMEM). On the
// H100 the sender planes stay in HBM and are read row by row, so one kernel
// covers both.
//
// What it computes, per receiver row i and fanout slot f, with
// j = inv[f, i] (j < 0: no sender on that slot):
//   m_or[i, w]     |= ym[j, w]                          for w < Wm
//   deliver[r]      = bit r of yu[j, :]
//                     & (from[j, r] != i) & (origin[r] != i)
//   u_or[i, r]     |= deliver[r]
//   src_max[i, r]   = max(src_max[i, r], deliver[r] ? j : -1)
//   *cnt           += popcount(deliver)
// Identities: m_or 0, u_or false, src_max -1; the caller zeroes *cnt.
// The three sender planes are the gossip phase's own tensors, read in place
// through one base pointer and one row stride each: ym [N, Wm] (packed
// forwarding & active membership bits), yu [N, Wu] (packed young user-rumor
// bits), from [N, R] (infected-from lanes). The JAX kernel reads the same
// words from one concatenated [N, Wm + Wu + R] payload, which the port no
// longer builds on the card.
//
// Bound: memory. Bytes that must move: 4*F*N (inv) + 4*(Wm + Wu + R)*S,
// S the number of distinct valid senders in inv (each named row read once,
// however many slots name it) + N*(R + 4R + 4Wm) (outputs: u_or as bytes,
// src_max, m_or). On chip_smoke's 1M inputs (F = 3, R = 8, Wm = 64,
// S ~ 815k of ~ 2.36M valid slots) that is 0.56 GB: 0.167 ms at
// 3.35 TB/s. A pull kernel without reuse reads one sender row per valid
// slot instead: 0.69 GB of rows plus 0.31 GB of outputs, 0.30 ms. Most
// slots name random rows of a 306 MB plane set that the 50 MB L2 cannot
// hold, so the kernel has to keep many random 320-byte reads (a 256-byte
// membership row and one 32-byte sector in each of yu and from) in flight.
//
// Design, against what held the first version (one warp per receiver,
// slots walked one after another) to 21% of the bound:
// * Whole sender rows in flight. A group of G lanes serves one receiver.
//   On the vector path (Wm % 4 == 0, 16-byte aligned ym rows) G = 16 and
//   each lane owns one 16-byte chunk of the 256-byte membership row; the
//   scalar path (any other Wm or alignment) has G = 32 lanes striding words.
//   The group loads its F inv entries (lane f loads slot f) and broadcasts
//   them with a shuffle, then issues every slot's chunk load and rumor-tail
//   loads before it folds any of them: F is a template parameter (1..4) so
//   the loads unroll; a runtime-F instantiation folds slots four at a time.
// * The rumor tail in the same round trip. Lanes r < R of the group load
//   the F yu words and from lanes beside their membership chunks (looping
//   over r when R exceeds the group) and fold u_or and src_max in registers.
// * No per-row count pass. The count is a warp shuffle sum, a block sum in
//   shared memory, then one atomicAdd per block into the caller's zeroed
//   scalar: integer addition in any order gives the same bits.
// * No payload copy. The planes are read where the gossip phase left them,
//   so the 292-byte payload rows (no 16-byte vector load possible) and the
//   copy that built them (292 MB read and written per tick at 1M) are gone.
// * Outputs out of the sender rows' way in L2: m_or, src_max and u_or are
//   written with streaming stores (evict-first).
// Nothing is carried between blocks beyond the count's atomic, and nothing
// is allocated here: the wrapper allocates the outputs.
//
// The scenario axis (the fleet engine, ops/fleet.py): S independent
// clusters folded by ONE launch. Every operand gains a leading [S] — the
// sender planes through a per-scenario base stride each, inv [S, F, n],
// origin [S, R], the outputs [S, n, ...], cnt [S] — and the grid holds
// `bps` = ceil(n / rows-per-block) blocks per scenario, all in x (gridDim.y
// stops at 65,535 and a fleet reaches S = 65,536), so a block never spans
// two scenarios: its count goes to cnt[s] and a sender index j stays inside
// scenario s's own planes. At N = 64 a scenario is 4 blocks of the vector
// path, so a fleet of 1,024 is 4,096 blocks over the 132 SMs. The serial
// launch is the same kernel with S = 1 and zero scenario strides.
//
// Plain C interface, bound from Python with ctypes (ops/delivery.py), which
// also picks the instantiation (vector or scalar path, F template or
// runtime F); the launcher refuses a pick the inputs do not allow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFTemplate = 4;  // F = 1..4 unrolled; larger F is a runtime loop
constexpr int kRuntimeBatch = 4;  // slots folded per round trip when F is runtime

template <bool kVec> struct Chunk;
template <> struct Chunk<true> {
  using T = int4;
  static constexpr int kWords = 4;
  static __device__ T zero() { return make_int4(0, 0, 0, 0); }
  static __device__ T bit_or(T a, T b) {
    return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
};
template <> struct Chunk<false> {
  using T = int;
  static constexpr int kWords = 1;
  static __device__ T zero() { return 0; }
  static __device__ T bit_or(T a, T b) { return a | b; }
};

// G lanes per receiver; kVec: 16-byte membership chunks; kF: the fanout, or 0
// for a runtime F folded kRuntimeBatch slots at a time.
template <int G, bool kVec, int kF>
__global__ void __launch_bounds__(kThreads) delivery_combine_kernel(
    const int* __restrict__ ym, long long ym_stride,      // [S, n, Wm] words
    const int* __restrict__ yu, long long yu_stride,      // [S, n, Wu] words
    const int* __restrict__ from, long long from_stride,  // [S, n, R]
    long long ym_sstride, long long yu_sstride, long long from_sstride,
    const int* __restrict__ inv,                          // [S, F, n]
    const int* __restrict__ origin,                       // [S, R]
    unsigned char* __restrict__ u_or,                     // [S, n, R]
    int* __restrict__ src_max,                            // [S, n, R]
    int* __restrict__ m_or,                               // [S, n, Wm]
    int* __restrict__ cnt,                                // [S], zeroed
    int n, int F, int Wm, int R, int bps) {
  using C = Chunk<kVec>;
  using V = typename C::T;
  constexpr int K = kF > 0 ? kF : kRuntimeBatch;
  static_assert(K <= G, "a group's lanes load its slots' inv entries");
  const int g = threadIdx.x % G;
  // this block's scenario, and its row block within the scenario
  const int sc = blockIdx.x / bps;
  const int row = (blockIdx.x - sc * bps) * (kThreads / G) + threadIdx.x / G;
  ym += sc * ym_sstride;
  yu += sc * yu_sstride;
  from += sc * from_sstride;
  inv += (size_t)sc * F * n;
  origin += (size_t)sc * R;
  u_or += (size_t)sc * n * R;
  src_max += (size_t)sc * n * R;
  m_or += (size_t)sc * n * Wm;
  cnt += sc;
  const bool live = row < n;  // dead lanes still take part in the shuffles
  const int chunks = Wm / C::kWords;
  const int slots = kF > 0 ? kF : F;
  const int iters = max((chunks + G - 1) / G, (R + G - 1) / G);
  int total = 0;

  for (int it = 0; it < iters; ++it) {
    const int c = it * G + g;  // this lane's membership chunk
    const int r = it * G + g;  // and its rumor lane
    const bool do_c = live && c < chunks;
    const bool do_r = live && r < R;
    const int org = do_r ? __ldg(origin + r) : -1;
    V acc = C::zero();
    bool u = false;
    int src = -1;
    for (int f0 = 0; f0 < slots; f0 += K) {
      int mine = -1;
      if (live && g < K && f0 + g < slots) mine = __ldg(inv + (size_t)(f0 + g) * n + row);
      int j[K];
#pragma unroll
      for (int k = 0; k < K; ++k) j[k] = __shfl_sync(0xffffffffu, mine, k, G);
      // every load of the round trip is issued before any is folded
      V v[K];
      unsigned word[K];
      int frm[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool has = j[k] >= 0;
        v[k] = (has && do_c)
                   ? __ldg(reinterpret_cast<const V*>(ym + (size_t)j[k] * ym_stride) + c)
                   : C::zero();
        word[k] = (has && do_r) ? (unsigned)__ldg(yu + (size_t)j[k] * yu_stride + (r >> 5)) : 0u;
        frm[k] = (has && do_r) ? __ldg(from + (size_t)j[k] * from_stride + r) : row;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc = C::bit_or(acc, v[k]);
        const bool d = ((word[k] >> (r & 31)) & 1u) && frm[k] != row && org != row;
        if (d) {
          u = true;
          src = max(src, j[k]);
          ++total;
        }
      }
    }
    if (do_c) __stcs(reinterpret_cast<V*>(m_or + (size_t)row * Wm) + c, acc);
    if (do_r) {
      __stcs(u_or + (size_t)row * R + r, (unsigned char)(u ? 1 : 0));
      __stcs(src_max + (size_t)row * R + r, src);
    }
  }

  __shared__ int part[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += part[w];
    if (sum != 0) atomicAdd(cnt, sum);
  }
}

template <int G, bool kVec, int kF>
cudaError_t launch(const int* ym, long long yms, const int* yu, long long yus,
                   const int* from, long long frs, long long ymss, long long yuss,
                   long long frss, const int* inv, const int* origin,
                   unsigned char* u_or, int* src_max, int* m_or, int* cnt,
                   int S, int n, int F, int Wm, int R, cudaStream_t stream) {
  constexpr int rows_per_block = kThreads / G;
  const int bps = (n + rows_per_block - 1) / rows_per_block;
  const long long blocks = (long long)S * bps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delivery_combine_kernel<G, kVec, kF><<<(unsigned)blocks, kThreads, 0, stream>>>(
      ym, yms, yu, yus, from, frs, ymss, yuss, frss, inv, origin, u_or, src_max, m_or, cnt,
      n, F, Wm, R, bps);
  return cudaGetLastError();
}

template <int G, bool kVec>
cudaError_t launch_f(int f_template, const int* ym, long long yms, const int* yu, long long yus,
                     const int* from, long long frs, long long ymss, long long yuss,
                     long long frss, const int* inv, const int* origin,
                     unsigned char* u_or, int* src_max, int* m_or, int* cnt,
                     int S, int n, int F, int Wm, int R, cudaStream_t stream) {
#define DC_ARGS ym, yms, yu, yus, from, frs, ymss, yuss, frss, inv, origin, u_or, src_max, m_or, \
                cnt, S, n, F, Wm, R, stream
  switch (f_template) {
    case 0: return launch<G, kVec, 0>(DC_ARGS);
    case 1: return launch<G, kVec, 1>(DC_ARGS);
    case 2: return launch<G, kVec, 2>(DC_ARGS);
    case 3: return launch<G, kVec, 3>(DC_ARGS);
    case 4: return launch<G, kVec, 4>(DC_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DC_ARGS
}

cudaError_t launch_any(const void* ym, long long ym_stride, const void* yu, long long yu_stride,
                       const void* from, long long from_stride, long long ym_sstride,
                       long long yu_sstride, long long from_sstride, const void* inv,
                       const void* origin, void* u_or, void* src_max, void* m_or, void* cnt,
                       int S, int n, int F, int Wm, int R, int vec, int f_template, void* stream) {
  if (n <= 0 || S <= 0) return cudaSuccess;
  if (f_template < 0 || f_template > kMaxFTemplate || (f_template != 0 && f_template != F)) {
    return cudaErrorInvalidValue;
  }
  if (vec && (Wm % 4 != 0 || (uintptr_t)ym % 16 != 0 || ym_stride % 4 != 0 ||
              ym_sstride % 4 != 0 || (uintptr_t)m_or % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int* a_ym = (const int*)ym;
  const int* a_yu = (const int*)yu;
  const int* a_from = (const int*)from;
  const int* a_inv = (const int*)inv;
  const int* a_org = (const int*)origin;
  unsigned char* o_u = (unsigned char*)u_or;
  int* o_src = (int*)src_max;
  int* o_m = (int*)m_or;
  int* o_cnt = (int*)cnt;
  return vec ? launch_f<16, true>(f_template, a_ym, ym_stride, a_yu, yu_stride, a_from, from_stride,
                                  ym_sstride, yu_sstride, from_sstride, a_inv, a_org, o_u, o_src,
                                  o_m, o_cnt, S, n, F, Wm, R, s)
             : launch_f<32, false>(f_template, a_ym, ym_stride, a_yu, yu_stride, a_from, from_stride,
                                   ym_sstride, yu_sstride, from_sstride, a_inv, a_org, o_u, o_src,
                                   o_m, o_cnt, S, n, F, Wm, R, s);
}

}  // namespace

// One launch over S clusters (S = 1 for the serial call). *_stride: each
// sender plane's row stride, *_sstride: its stride between scenarios, both
// in words; inv, origin and the outputs are contiguous [S, ...]; cnt holds S
// zeroed counts. vec: 1 for the vector path, 0 for the scalar path.
// f_template: F itself (1..4) or 0 for the runtime-F instantiation.
// Returns a cudaError_t: cudaErrorInvalidValue for a pick the inputs do
// not allow, else the launch's own status.
extern "C" int delivery_combine_launch(
    const void* ym, long long ym_stride, const void* yu, long long yu_stride,
    const void* from, long long from_stride, long long ym_sstride, long long yu_sstride,
    long long from_sstride, const void* inv, const void* origin,
    void* u_or, void* src_max, void* m_or, void* cnt,
    int S, int n, int F, int Wm, int R, int vec, int f_template, void* stream) {
  return (int)launch_any(ym, ym_stride, yu, yu_stride, from, from_stride, ym_sstride, yu_sstride,
                         from_sstride, inv, origin, u_or, src_max, m_or, cnt, S, n, F, Wm, R, vec,
                         f_template, stream);
}
