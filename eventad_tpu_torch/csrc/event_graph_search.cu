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
// What bounds it on the H100: the output, about 20 MB at the operating point
// (98 304 destinations x 16 slots of nbr, mask and two offsets), and the
// latency of a block's steps; the candidate scan is a few integer
// operations per candidate.  Design, per block of kTile destinations of one
// item (one thread each):
//
// * Time cutoff, exact for any input.  Events arrive sorted by time, so a
//   destination's candidates that pass the time test are the ~delta_t /
//   (time per event) most recent ones (about 164 of 1024 at the operating
//   point).  A scan from the most recent back may stop at the first valid
//   candidate with t_i - t_j > delta_t only if the valid times of the rows
//   below it never exceed t_j.  The block proves that for its whole window
//   [i0 - lookback, i0 + kTile) first: every valid event against the running
//   maximum of the valid times before it (a block-wide max scan; comparing
//   neighbouring rows would miss a decrease hidden behind an invalid event).
//   Proven, the scan cuts and the window starts above the last valid row
//   that is too old for the block's earliest destination.  Not proven, every
//   candidate is examined, as the contract does: unsorted input stays exact
//   and only loses speed.  Invalid rows (the t = 0 padding tail of an
//   under-filled bucket) take no part in the proof and never cut.
// * Candidate window in shared memory, one 16-byte record a row (x, y, t,
//   rank, the rank of an invalid row folded to INT_MIN), loaded once by the
//   block with coalesced reads and read by every destination at one 16-byte
//   shared load a candidate.  A window larger than kChunk rows is streamed
//   in chunks from the top down, so any lookback runs.
// * Keys of 32 bits where (2r+1)^2 Q 2^dbits fits (dbits: the bits of the
//   lookback), the offset d folded into the low bits: unique keys whose
//   order is the contract's order with its tie rule, one register a slot,
//   and the neighbour index comes back out of the key.  64-bit keys
//   otherwise, chosen on the host.
// * Output: the running top-k goes to shared memory, transposed; the tile's
//   nbr and doff rows are written with coalesced 16-byte stores, the mask
//   (a torch.bool tensor, one byte a slot) 16 bytes a thread.  valid is read
//   as its bytes and ranks as given, so the wrapper launches this kernel
//   and nothing else.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 128;              // destinations a block
constexpr int kWarps = kTile / 32;
constexpr int kChunk = 1280;            // window rows staged at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int spiral_index(int dx, int dy) {
  // rotated-coordinate closed form, eventad_tpu/ops/event_graph.spiral_index
  const int u = dx + dy;
  const int s = dy - dx;
  const int r = (abs(u) + abs(s)) >> 1;
  const int v = s - 2 * r;
  const bool upper = (u > 0) || (u == 0 && s > 0);
  return 4 * r * r + (upper ? v : -v);
}

template <int KO, typename Key>
__global__ void __launch_bounds__(kTile)
search_kernel(const int* __restrict__ pos, const uint8_t* __restrict__ valid,
              const int* __restrict__ rank, int n, int radius, int delta_t,
              int q_cap, int lookback, int dbits, int* __restrict__ nbr,
              uint8_t* __restrict__ mask, int* __restrict__ doff) {
  // the window's records, then (after the scan) the keys [KO][kTile + 1]
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_win = reinterpret_cast<int4*>(smem);
  Key* s_key = reinterpret_cast<Key*>(smem);
  __shared__ int4 s_dst[kTile];         // x, y, valid of each destination
  __shared__ int s_wmax[kWarps];
  __shared__ int s_tmin, s_cand;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kTile;
  const long long item = blockIdx.y;
  const int* p = pos + item * n * 3;
  const uint8_t* v = valid + item * n;
  const int* rk = rank + item * n;
  const int i = i0 + tid;
  const int hi = min(n, i0 + kTile);
  const int lo = max(0, i0 - lookback);

  const bool vi = i < n && v[i] != 0;
  int xi = 0, yi = 0, ti = 0;
  if (i < n) {
    xi = p[3 * i];
    yi = p[3 * i + 1];
    ti = p[3 * i + 2];
  }
  s_dst[tid] = make_int4(xi, yi, vi, 0);
  if (tid == 0) {
    s_tmin = INT_MAX;
    s_cand = -1;
  }
  __syncthreads();
  if (vi) atomicMin(&s_tmin, ti);
  const bool any_valid = __syncthreads_or(vi);

  Key bk[KO];
#pragma unroll
  for (int s = 0; s < KO; ++s) bk[s] = ~Key(0);

  if (any_valid) {
    // ---- 1. the proof: valid times never decrease over [lo, hi); and the
    // last valid row too old for every destination of the block ----
    const long long thr_block = static_cast<long long>(s_tmin) - delta_t;
    int carry = INT_MIN;        // max valid time of the rounds before
    int cand = -1;
    bool bad = false;
    for (int base = lo; base < hi; base += 4 * kTile) {
      int tv[4];
      bool vv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {      // four rounds' loads in flight
        const int r = base + q * kTile + tid;
        vv[q] = r < hi && v[r] != 0;
        tv[q] = vv[q] ? p[3 * r + 2] : INT_MIN;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (base + q * kTile >= hi) break;          // the same for all
        int inc = tv[q];                  // inclusive max scan of the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc = max(inc, y);
        }
        if (lane == 31) s_wmax[warp] = inc;
        __syncthreads();
        int excl = carry, round_max = carry;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int m = s_wmax[w];
          if (w < warp) excl = max(excl, m);
          round_max = max(round_max, m);
        }
        const int prev = __shfl_up_sync(kFull, inc, 1);
        if (lane > 0) excl = max(excl, prev);
        if (vv[q]) {
          bad |= tv[q] < excl;
          if (static_cast<long long>(tv[q]) < thr_block)
            cand = base + q * kTile + tid;
        }
        carry = round_max;
        __syncthreads();
      }
    }
    if (cand >= 0) atomicMax(&s_cand, cand);
    const bool sorted = !__syncthreads_or(bad);
    const int jst = sorted ? max(lo, s_cand + 1) : lo;

    // ---- 2. the scan, window chunks from the top down ----
    // j passes the time test iff t_j >= t_i - delta_t (in 64 bits)
    const long long thr64 = static_cast<long long>(ti) - delta_t;
    const int thr = thr64 < INT_MIN ? INT_MIN : static_cast<int>(thr64);
    const int jmin = max(i - min(lookback, i), jst);
    int jnext = i - 1;
    bool active = vi && thr64 <= INT_MAX && jnext >= jmin;
    const unsigned span = 2u * static_cast<unsigned>(radius);
    for (int chi = hi; chi > jst;) {
      const int clo = max(jst, chi - kChunk);
      // also the barrier after the previous chunk's reads
      if (!__syncthreads_or(active)) break;
      for (int r = clo + tid; r < chi; r += kTile) {
        const int* pr = p + 3 * r;
        s_win[r - clo] = make_int4(pr[0], pr[1], pr[2],
                                   v[r] != 0 ? rk[r] : INT_MIN);
      }
      __syncthreads();
      if (active) {
        const int jbot = max(jmin, clo);
        int j = min(jnext, chi - 1);
        for (; j >= jbot; --j) {
          const int4 c = s_win[j - clo];
          if (c.w == INT_MIN) continue;                       // invalid
          if (c.z < thr) {                                    // too old
            if (sorted) break;
            continue;
          }
          const int dx = c.x - xi, dy = c.y - yi;
          if (static_cast<unsigned>(dx + radius) > span ||
              static_cast<unsigned>(dy + radius) > span)
            continue;
          if (static_cast<unsigned>(c.w) >= static_cast<unsigned>(q_cap))
            continue;
          Key key = ((static_cast<Key>(spiral_index(dx, dy)) * q_cap +
                      static_cast<Key>(c.w)) << dbits) |
                    static_cast<Key>(i - j);
          if (key < bk[KO - 1]) {
#pragma unroll
            for (int s = 0; s < KO; ++s) {     // keys are unique
              const Key low = min(bk[s], key);
              key = max(bk[s], key);
              bk[s] = low;
            }
          }
        }
        // stopped by the cutoff, or reached the bottom of its range
        if (j >= jbot || jbot == jmin) active = false;
        jnext = j;
      }
      chi = clo;
    }
  }
  __syncthreads();    // the window is read no more: the keys take its place
#pragma unroll
  for (int s = 0; s < KO; ++s) s_key[s * (kTile + 1) + tid] = bk[s];
  __syncthreads();

  // ---- 3. the output tile: rows [i0, hi) x K slots, coalesced ----
  constexpr int K = KO + 1;
  const Key dmask = (Key(1) << dbits) - 1;
  const long long o0 = (item * n + i0) * K;
  const int cnt = (hi - i0) * K;
  // slot s of tile row t: neighbour, present, offset
  auto slot = [&](int e, int* nb, int* ox, int* oy) -> bool {
    const int t = e / K, s = e - t * K;
    const int4 d = s_dst[t];
    *ox = *oy = 0;
    if (s == 0) {
      *nb = d.z ? i0 + t : 0;
      return d.z != 0;
    }
    const Key key = s_key[(s - 1) * (kTile + 1) + t];
    if (key == ~Key(0)) {
      *nb = 0;
      return false;
    }
    const int j = i0 + t - static_cast<int>(key & dmask);
    *nb = j;
    *ox = d.x - p[3 * j];
    *oy = d.y - p[3 * j + 1];
    return true;
  };
  const bool vec = (o0 & 3) == 0;
  for (int e0 = tid * 4; e0 < cnt; e0 += kTile * 4) {
    int nb[4], ox[4], oy[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      nb[q] = ox[q] = oy[q] = 0;
      if (e0 + q < cnt) slot(e0 + q, nb + q, ox + q, oy + q);
    }
    if (vec && e0 + 4 <= cnt) {
      *reinterpret_cast<int4*>(nbr + o0 + e0) =
          make_int4(nb[0], nb[1], nb[2], nb[3]);
      int4* od = reinterpret_cast<int4*>(doff + 2 * (o0 + e0));
      od[0] = make_int4(ox[0], oy[0], ox[1], oy[1]);
      od[1] = make_int4(ox[2], oy[2], ox[3], oy[3]);
    } else {
      for (int q = 0; q < 4 && e0 + q < cnt; ++q) {
        nbr[o0 + e0 + q] = nb[q];
        doff[2 * (o0 + e0 + q)] = ox[q];
        doff[2 * (o0 + e0 + q) + 1] = oy[q];
      }
    }
  }
  const bool vec16 = (o0 & 15) == 0;
  for (int e0 = tid * 16; e0 < cnt; e0 += kTile * 16) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (e0 + q >= cnt) break;
      const int t = (e0 + q) / K, s = e0 + q - t * K;
      const bool on = s == 0 ? s_dst[t].z != 0
                             : s_key[(s - 1) * (kTile + 1) + t] != ~Key(0);
      w[q >> 2] |= static_cast<uint32_t>(on) << (8 * (q & 3));
    }
    if (vec16 && e0 + 16 <= cnt) {
      *reinterpret_cast<uint4*>(mask + o0 + e0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int q = 0; q < 16 && e0 + q < cnt; ++q)
        mask[o0 + e0 + q] = static_cast<uint8_t>(w[q >> 2] >> (8 * (q & 3)));
    }
  }
}

template <int KO, typename Key>
int launch_search(const int* pos, const uint8_t* valid, const int* rank,
                  int b, int n, int radius, int delta_t, int q_cap,
                  int lookback, int dbits, int* nbr, uint8_t* mask, int* doff,
                  cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, b);
  constexpr size_t smem = sizeof(int4) * kChunk;
  static_assert(smem >= sizeof(Key) * KO * (kTile + 1), "key tile");
  search_kernel<KO, Key><<<grid, kTile, smem, stream>>>(
      pos, valid, rank, n, radius, delta_t, q_cap, lookback, dbits, nbr, mask,
      doff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos [B, N, 3] int32, valid [B, N] one byte each (bool), rank [B, N] int32
// (the queue ranks, non-negative; read only where valid) -> nbr [B, N,
// k_other + 1] int32 (indices within the item), mask [B, N, k_other + 1] one
// byte each (bool), doff [B, N, k_other + 1, 2] int32.  dbits: bits of the
// lookback; wide: 64-bit keys (the host checks that the keys fit).
EVENTAD_API int eventad_event_graph_search(
    const void* pos, const void* valid, const void* rank, int b, int n,
    int radius, int delta_t, int k_other, int q_cap, int lookback, int dbits,
    int wide, void* nbr, void* mask, void* doff, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (radius < 0 || q_cap < 1 || lookback < 0 || dbits < 1 || dbits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<const int*>(pos);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* r = static_cast<const int*>(rank);
  auto* o_n = static_cast<int*>(nbr);
  auto* o_m = static_cast<uint8_t*>(mask);
  auto* o_d = static_cast<int*>(doff);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k_other * 2 + (wide ? 1 : 0)) {
#define EVENTAD_CASE(K)                                                      \
  case 2 * K:                                                                \
    return launch_search<K, unsigned>(p, v, r, b, n, radius, delta_t, q_cap, \
                                      lookback, dbits, o_n, o_m, o_d, s);    \
  case 2 * K + 1:                                                            \
    return launch_search<K, unsigned long long>(p, v, r, b, n, radius,       \
                                                delta_t, q_cap, lookback,    \
                                                dbits, o_n, o_m, o_d, s);
    EVENTAD_CASE(1) EVENTAD_CASE(2) EVENTAD_CASE(3) EVENTAD_CASE(4)
    EVENTAD_CASE(5) EVENTAD_CASE(6) EVENTAD_CASE(7) EVENTAD_CASE(8)
    EVENTAD_CASE(9) EVENTAD_CASE(10) EVENTAD_CASE(11) EVENTAD_CASE(12)
    EVENTAD_CASE(13) EVENTAD_CASE(14) EVENTAD_CASE(15) EVENTAD_CASE(16)
#undef EVENTAD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
