// Delivery combine of the pview fused gossip phase, for Hopper (sm_90a).
//
// Replaces the TPU kernel `delivery_combine` of the JAX package's
// scalecube_cluster_tpu/ops/pallas_delivery.py — both of its bodies:
// `_delivery_kernel` (1-D grid over row blocks) and `_delivery_kernel_cols`
// (2-D grid whose membership-word tiles exist only to fit the payload into
// a TPU core's VMEM). On the H100 the payload stays in HBM and is read
// row by row, so one kernel covers both.
//
// What it computes, per receiver row i and fanout slot f, with
// j = inv[f, i] (j < 0: no sender on that slot):
//   m_or[i, w]     |= payload[j, w]                       for w < Wm
//   deliver[r]      = bit r of payload[j, Wm:Wm+Wu]
//                     & (payload[j, Wm+Wu+r] != i)  (infected_from lane)
//                     & (origin[r] != i)
//   u_or[i, r]     |= deliver[r]
//   src_max[i, r]   = max(src_max[i, r], deliver[r] ? j : -1)
//   cnt[i]         += popcount(deliver)
// Identities: m_or 0, u_or false, src_max -1, cnt 0. The caller sums cnt.
//
// Design: one warp per receiver row, eight rows per block. The lanes
// stride the Wm membership words of each sender row (coalesced reads of
// one payload row), OR-ing in a register; lanes < R own one user-rumor lane
// each (bit, infected_from compare, src_max). The per-row count is a warp
// shuffle reduction. Nothing is carried between blocks and nothing is
// allocated: the wrapper allocates the outputs.
//
// Bound: memory. Bytes that must move: 4*F*N (inv) + 4*Wt*S, S the number
// of distinct valid senders in inv (each named row read once, however many
// slots name it; S <= #inv >= 0) + N*(R + 4R + 4Wm + 4) (outputs: u_or as
// bytes, src_max, m_or, cnt). At the slice's shape (N = 1,048,576, F = 3,
// R = 8, Wm = 64, Wt = 73) that is at most 0.63 GB (S = N), so >= 0.19 ms
// at 3.35 TB/s; fewer distinct senders lower it. At N = 65,536 the 19 MB
// payload fits the 50 MB L2, so the HBM bound is loose there.
//
// Plain C interface, bound from Python with ctypes (ops/delivery.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void delivery_combine_kernel(
    const int32_t* __restrict__ payload,  // [n, Wt] (uint32 bits)
    const int32_t* __restrict__ inv,      // [F, n]
    const int32_t* __restrict__ origin,   // [R]
    uint8_t* __restrict__ u_or,           // [n, R]
    int32_t* __restrict__ src_max,        // [n, R]
    int32_t* __restrict__ m_or,           // [n, Wm]
    int32_t* __restrict__ cnt,            // [n]
    int n, int F, int Wt, int Wm, int R) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const int Wu = (R + 31) >> 5;

  for (int w = lane; w < Wm; w += 32) {
    uint32_t acc = 0;
    for (int f = 0; f < F; ++f) {
      const int j = __ldg(inv + (size_t)f * n + row);
      if (j >= 0) acc |= (uint32_t)__ldg(payload + (size_t)j * Wt + w);
    }
    m_or[(size_t)row * Wm + w] = (int32_t)acc;
  }

  int total = 0;
  for (int r = lane; r < R; r += 32) {
    const int org = __ldg(origin + r);
    bool u = false;
    int src = -1;
    for (int f = 0; f < F; ++f) {
      const int j = __ldg(inv + (size_t)f * n + row);
      if (j < 0) continue;
      const int32_t* prow = payload + (size_t)j * Wt;
      const uint32_t word = (uint32_t)__ldg(prow + Wm + (r >> 5));
      const int frm = __ldg(prow + Wm + Wu + r);
      const bool d = ((word >> (r & 31)) & 1u) && frm != row && org != row;
      if (d) {
        u = true;
        src = j > src ? j : src;
        ++total;
      }
    }
    u_or[(size_t)row * R + r] = u ? 1 : 0;
    src_max[(size_t)row * R + r] = src;
  }
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_down_sync(0xffffffffu, total, off);
  }
  if (lane == 0) cnt[row] = total;
}

}  // namespace

extern "C" int delivery_combine_launch(
    const void* payload, const void* inv, const void* origin,
    void* u_or, void* src_max, void* m_or, void* cnt,
    int n, int F, int Wt, int Wm, int R, void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  delivery_combine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)payload, (const int32_t*)inv, (const int32_t*)origin,
      (uint8_t*)u_or, (int32_t*)src_max, (int32_t*)m_or, (int32_t*)cnt,
      n, F, Wt, Wm, R);
  return (int)cudaGetLastError();
}
