// K6a / K6b: the windowed neighbour-row gather of the level-0 layer and its
// transpose, the masked row scatter-add (the gather's backward).
//
// Replaces eventad_tpu/ops/gather_window.py:_gather_kernel (driven by
// gather_window_rows) and :_scatter_kernel (driven by scatter_window_rows).
// The TPU kernels turn both into one-hot matmuls over a DMA'd window and
// rebuild f32 from bf16 hi/lo parts, because a gather there costs a memory
// tile per index.  None of that carries over: an indexed copy is exact for
// f32 and bf16 alike, so there are no `parts` here.
//
//   gather : out[i, k, :] = mask[i, k] ? src[nbr[i, k], :] : 0
//   scatter: out[s, :]    = sum over (i, k) with mask[i, k] and
//                           nbr[i, k] == s of g[i, k, :]
//
// A masked slot never has its index read as an address: masked entries of
// nbr may hold -1 or anything else.
//
// What bounds them on the H100: bytes.  The gather writes N x K x C values
// (112 MB at 98 304 x 15 x 19 f32) and reads at most as many; the scatter
// reads the unmasked edge rows of g and writes N_src x C.
//
// Gather design: one thread per output element over the flat [N*K*C]
// output, channel fastest, so a warp writes contiguous values and reads
// runs of C contiguous values of one source row.  C is arbitrary (19 and 16
// on the f32 path): no vector width is assumed.  The element is moved as a
// 2- or 4-byte word, so f32 and bf16 share one kernel and the result equals
// the indexed copy bit for bit.
//
// Scatter design: deterministic, no atomics.  The graph contract
// i - lookback <= nbr[i, k] <= i means that only destinations
// [s, s + lookback] can reference source s.  A block owns a tile of
// kTile source rows and walks that bounded range of destinations in flat
// edge order, kThreads edges at a time: an ordered compaction (warp ballots
// plus a scan of the warp counts) lists the edges that point into the tile,
// then each (row, channel) accumulator adds its edges in list order, in f32
// in shared memory.  Every sum is taken in ascending edge order, the order
// of a sequential index_add, so two runs give the same bits.  The scan reads
// (kTile + lookback) x K masks per block; g is read only where an edge
// points into the tile, so a sparse graph reads little of it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ src,
                                   const int* __restrict__ nbr,
                                   const uint8_t* __restrict__ mask,
                                   long long total, int c,
                                   W* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx / c;
  const int ch = static_cast<int>(idx - e * c);
  W v = 0;
  if (mask[e]) v = src[static_cast<long long>(nbr[e]) * c + ch];
  out[idx] = v;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return eventad::bf(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Dynamic shared memory: kTile * c f32 accumulators.
template <typename G, typename O>
__global__ void scatter_rows_kernel(const G* __restrict__ g,
                                    const int* __restrict__ nbr,
                                    const uint8_t* __restrict__ mask,
                                    int n_dst, int k, int c, int n_src,
                                    int lookback, O* __restrict__ out) {
  extern __shared__ float acc[];
  __shared__ int list_edge[kThreads];
  __shared__ int list_row[kThreads];
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * kTile;
  const int rows = min(kTile, n_src - s0);
  const int n_acc = rows * c;
  for (int a = tid; a < n_acc; a += kThreads) acc[a] = 0.f;

  // destinations that can reference this tile: [s0, s0 + rows + lookback)
  const long long d_end =
      min(static_cast<long long>(n_dst),
          static_cast<long long>(s0) + rows + lookback);
  const long long e0 = static_cast<long long>(s0) * k;
  const long long e_end = d_end * k;
  __syncthreads();

  for (long long base = e0; base < e_end; base += kThreads) {
    const long long e = base + tid;
    int row = -1;
    if (e < e_end && mask[e]) {
      const int s = nbr[e];
      if (s >= s0 && s < s0 + rows) row = s - s0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, row >= 0);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, found = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_count[w];
      if (w < warp) before += n;
      found += n;
    }
    if (row >= 0) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      list_edge[slot] = static_cast<int>(e - e0);
      list_row[slot] = row;
    }
    __syncthreads();
    if (found > 0) {
      for (int a = tid; a < n_acc; a += kThreads) {
        const int r = a / c;
        const int ch = a - r * c;
        float sum = acc[a];
        for (int j = 0; j < found; ++j) {
          if (list_row[j] == r)
            sum += load_f(g + (e0 + list_edge[j]) * c + ch);
        }
        acc[a] = sum;
      }
    }
    __syncthreads();
  }

  O* dst = out + static_cast<long long>(s0) * c;
  for (int a = tid; a < n_acc; a += kThreads) store_f(dst + a, acc[a]);
}

template <typename G, typename O>
int launch_scatter(const void* g, const void* nbr, const void* mask,
                   int n_dst, int k, int c, int n_src, int lookback,
                   void* out, cudaStream_t stream) {
  const int blocks = (n_src + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kTile) * c * sizeof(float);
  scatter_rows_kernel<G, O><<<blocks, kThreads, smem, stream>>>(
      static_cast<const G*>(g), static_cast<const int*>(nbr),
      static_cast<const uint8_t*>(mask), n_dst, k, c, n_src, lookback,
      static_cast<O*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [n_src, c] of elem_size-byte values (4: f32, 2: bf16), nbr [n_dst, k]
// int32, mask [n_dst, k] bool (one byte each) -> out [n_dst, k, c] of the
// same element type.
EVENTAD_API int eventad_gather_window_rows(const void* src, const void* nbr,
                                           const void* mask, int n_dst, int k,
                                           int c, int elem_size, void* out,
                                           void* stream) {
  const long long total = static_cast<long long>(n_dst) * k * c;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    gather_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   st>>>(
        static_cast<const uint32_t*>(src), static_cast<const int*>(nbr),
        static_cast<const uint8_t*>(mask), total, c,
        static_cast<uint32_t*>(out));
  } else if (elem_size == 2) {
    gather_rows_kernel<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   st>>>(
        static_cast<const uint16_t*>(src), static_cast<const int*>(nbr),
        static_cast<const uint8_t*>(mask), total, c,
        static_cast<uint16_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [n_dst, k, c] f32 or bf16 (g_bf16), nbr / mask [n_dst, k], every
// unmasked nbr[i, k] in [i - lookback, i] -> out [n_src, c] f32 or bf16
// (out_bf16; a bf16 output needs a bf16 g).  kTile * c * 4 bytes of shared
// memory must fit the 48 KB static limit: c <= 128.
EVENTAD_API int eventad_scatter_window_rows(const void* g, const void* nbr,
                                            const void* mask, int n_dst,
                                            int k, int c, int n_src,
                                            int lookback, int g_bf16,
                                            int out_bf16, void* out,
                                            void* stream) {
  if (n_src == 0 || c == 0) return 0;
  if (c > 128 || (out_bf16 && !g_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!g_bf16)
    return launch_scatter<float, float>(g, nbr, mask, n_dst, k, c, n_src,
                                        lookback, out, st);
  if (out_bf16)
    return launch_scatter<__nv_bfloat16, __nv_bfloat16>(
        g, nbr, mask, n_dst, k, c, n_src, lookback, out, st);
  return launch_scatter<__nv_bfloat16, float>(g, nbr, mask, n_dst, k, c,
                                              n_src, lookback, out, st);
}
