// K1: level-0 neighbour search of the event graph.
//
// Replaces eventad_tpu/ops/event_graph_pallas.py:_select_kernel (driven by
// build_graph_pallas).  Contract: the XLA formulation
// eventad_tpu/ops/event_graph.build_graph_single and the numpy oracle
// build_graph_numpy.  For every valid destination i, the candidates are the
// older events j = i - d, d = 1..min(lookback, i), that are valid, lie in the
// Chebyshev square |dx|,|dy| <= radius, satisfy t_i - t_j <= delta_t and
// rank_j < Q.  The k_other smallest keys spiral_index(dx, dy) * Q + rank_j
// are kept, the smaller d first at equal key (the first-index argmin of the
// XLA form).  Slot 0 is the self edge; doff is (x_i - x_j, y_i - y_j).
//
// What bounds it on the H100: integer work and L1 traffic, about
// lookback x (5 loads + ~20 integer ops) per destination (98 304
// destinations x 1024 candidates at the operating point).  Design: one
// thread per destination, scanning its candidates from the most recent
// back.  Neighbouring threads read neighbouring candidates at each step, so
// every load is coalesced and the window is served from L1.  The running
// top-k lives in registers (the list length is a template constant, so the
// unrolled insertion uses static indices) with 64-bit keys, so no radius,
// queue depth or lookback can overflow a packed key.  No time-sorted order
// is assumed: the scan applies every filter to every candidate, exactly as
// the XLA contract does, which also keeps buckets whose padding tail has
// t = 0 right (the TPU kernel's chunk bound assumes sorted times).
#include <climits>

#include "common.cuh"

namespace {

__device__ __forceinline__ int spiral_index(int dx, int dy) {
  // rotated-coordinate closed form, eventad_tpu/ops/event_graph.spiral_index
  const int u = dx + dy;
  const int s = dy - dx;
  const int r = (abs(u) + abs(s)) >> 1;
  const int v = s - 2 * r;
  const bool upper = (u > 0) || (u == 0 && s > 0);
  return 4 * r * r + (upper ? v : -v);
}

template <int KO>
__global__ void search_kernel(const int* __restrict__ pos,
                              const uint8_t* __restrict__ valid,
                              const int* __restrict__ rank, int n,
                              int radius, int delta_t, int q_cap,
                              int lookback, int* __restrict__ nbr,
                              uint8_t* __restrict__ mask,
                              int* __restrict__ doff) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const int* p = pos + base * 3;
  const uint8_t* v = valid + base;
  const int* rk = rank + base;

  long long bk[KO];
  int bd[KO];
#pragma unroll
  for (int s = 0; s < KO; ++s) {
    bk[s] = LLONG_MAX;
    bd[s] = 0;
  }
  const bool vi = v[i] != 0;
  const int xi = p[3 * i], yi = p[3 * i + 1], ti = p[3 * i + 2];
  if (vi) {
    const int dmax = min(lookback, i);
    for (int d = 1; d <= dmax; ++d) {
      const int j = i - d;
      if (!v[j]) continue;
      const int dx = p[3 * j] - xi;
      const int dy = p[3 * j + 1] - yi;
      if (abs(dx) > radius || abs(dy) > radius) continue;
      if (ti - p[3 * j + 2] > delta_t) continue;
      const int r = rk[j];
      if (r >= q_cap) continue;
      const long long key =
          static_cast<long long>(spiral_index(dx, dy)) * q_cap + r;
      if (key >= bk[KO - 1]) continue;
      // sorted insertion, top slot first; a key equal to a kept one goes
      // after it (the kept one has the smaller d)
#pragma unroll
      for (int s = KO - 1; s > 0; --s) {
        if (key < bk[s - 1]) {
          bk[s] = bk[s - 1];
          bd[s] = bd[s - 1];
        } else if (key < bk[s]) {
          bk[s] = key;
          bd[s] = d;
        }
      }
      if (key < bk[0]) {
        bk[0] = key;
        bd[0] = d;
      }
    }
  }
  const long long o = (base + i) * (KO + 1);
  nbr[o] = vi ? i : 0;
  mask[o] = vi;
  doff[2 * o] = 0;
  doff[2 * o + 1] = 0;
#pragma unroll
  for (int s = 0; s < KO; ++s) {
    const bool found = bk[s] != LLONG_MAX;
    const int j = i - bd[s];
    nbr[o + 1 + s] = found ? j : 0;
    mask[o + 1 + s] = found;
    doff[2 * (o + 1 + s)] = found ? xi - p[3 * j] : 0;
    doff[2 * (o + 1 + s) + 1] = found ? yi - p[3 * j + 1] : 0;
  }
}

template <int KO>
void launch_search(const int* pos, const uint8_t* valid, const int* rank,
                   int b, int n, int radius, int delta_t, int q_cap,
                   int lookback, int* nbr, uint8_t* mask, int* doff,
                   cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads, b);
  search_kernel<KO><<<grid, threads, 0, stream>>>(
      pos, valid, rank, n, radius, delta_t, q_cap, lookback, nbr, mask,
      doff);
}

}  // namespace

// pos [B, N, 3] int32, valid [B, N] uint8, rank [B, N] int32 ->
// nbr [B, N, k_other + 1] int32 (indices within the item), mask [B, N,
// k_other + 1] uint8, doff [B, N, k_other + 1, 2] int32.
EVENTAD_API int eventad_event_graph_search(
    const void* pos, const void* valid, const void* rank, int b, int n,
    int radius, int delta_t, int k_other, int q_cap, int lookback, void* nbr,
    void* mask, void* doff, void* stream) {
  auto* p = static_cast<const int*>(pos);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* r = static_cast<const int*>(rank);
  auto* o_n = static_cast<int*>(nbr);
  auto* o_m = static_cast<uint8_t*>(mask);
  auto* o_d = static_cast<int*>(doff);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k_other) {
#define EVENTAD_CASE(K)                                                    \
  case K:                                                                  \
    launch_search<K>(p, v, r, b, n, radius, delta_t, q_cap, lookback, o_n, \
                     o_m, o_d, s);                                         \
    break;
    EVENTAD_CASE(1) EVENTAD_CASE(2) EVENTAD_CASE(3) EVENTAD_CASE(4)
    EVENTAD_CASE(5) EVENTAD_CASE(6) EVENTAD_CASE(7) EVENTAD_CASE(8)
    EVENTAD_CASE(9) EVENTAD_CASE(10) EVENTAD_CASE(11) EVENTAD_CASE(12)
    EVENTAD_CASE(13) EVENTAD_CASE(14) EVENTAD_CASE(15) EVENTAD_CASE(16)
#undef EVENTAD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
