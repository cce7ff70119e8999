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
// Gather design: the gather's time is its write, N x K x C values in a
// flat [N*K*C] output, channel fastest; the masked slots, almost all of
// them at the operating point (0.15 edges a row of 15 slots), are zeros.  Each
// thread writes one 16-byte word of the flat output (4 f32 or 8 bf16), so a
// warp stores 512 contiguous bytes.  The word's first (edge, channel) comes
// from one division of its flat index by C, a multiply by a magic
// reciprocal of C (div_magic on the host: (idx * m) >> s, exact for every
// idx < 2^31); the thread then walks its 4 or 8 elements, stepping to the
// next edge where the channel reaches C (rows of 19 values are not 16-byte
// aligned, so a word may span two edges, or more where C < 8).  An edge's
// mask byte is read first and its nbr only where it is set; each source
// element is read as the aligned 2- or 4-byte word it is.  The tail of the
// flat array (the element count need not divide by the word) is stored
// element by element.  C is arbitrary; f32 and bf16 share the kernel, which
// moves bits, so the result equals the indexed copy bit for bit.  An output
// of 2^31 elements or more goes, by an explicit rule, to a 64-bit
// instantiation of the same kernel that divides in 64 bits.
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

// idx / c for idx < 2^31 by a multiply (div_magic); a 64-bit index
// divides as it is
struct Div32 {
  unsigned m; int s;
  __device__ __forceinline__ unsigned operator()(unsigned idx) const {
    return static_cast<unsigned>(
        (static_cast<unsigned long long>(idx) * m) >> s);
  }
};
struct Div64 {
  long long c;
  __device__ __forceinline__ long long operator()(long long idx) const {
    return idx / c;
  }
};

template <typename W, typename I, typename D>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const W* __restrict__ src, const int* __restrict__ nbr,
                   const uint8_t* __restrict__ mask, I total, int c, D div,
                   W* __restrict__ out) {
  constexpr int kV = 16 / sizeof(W);           // elements a 16-byte word
  const I i0 = (static_cast<I>(blockIdx.x) * kThreads + threadIdx.x) * kV;
  if (i0 >= total) return;
  I e = div(i0);                               // edge of the first element
  int ch = static_cast<int>(i0 - e * c);
  const int n = total - i0 < kV ? static_cast<int>(total - i0) : kV;
  const W* row = nullptr;                      // the edge's source row
  if (mask[e]) row = src + static_cast<long long>(nbr[e]) * c;
  union {
    uint4 word;
    W el[kV];
  } v;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (j < n) {
      if (ch == c) {                           // the next edge's first
        ++e;
        ch = 0;
        row = mask[e] ? src + static_cast<long long>(nbr[e]) * c : nullptr;
      }
      v.el[j] = row != nullptr ? row[ch] : W(0);
      ++ch;
    } else {
      v.el[j] = W(0);
    }
  }
  if (n == kV) {
    *reinterpret_cast<uint4*>(out + i0) = v.word;
  } else {
    for (int j = 0; j < n; ++j) out[i0 + j] = v.el[j];
  }
}

template <typename W>
int launch_gather(const void* src, const void* nbr, const void* mask,
                  long long total, int c, unsigned magic, int shift,
                  void* out, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(W);
  const long long blocks = (total + kThreads * kV - 1) / (kThreads * kV);
  const W* s = static_cast<const W*>(src);
  const int* nb = static_cast<const int*>(nbr);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  W* o = static_cast<W*>(out);
  if (total < (1ll << 31)) {
    gather_rows_kernel<W, unsigned, Div32>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            s, nb, m, static_cast<unsigned>(total), c, Div32{magic, shift},
            o);
  } else {
    gather_rows_kernel<W, long long, Div64>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            s, nb, m, total, c, Div64{c}, o);
  }
  return static_cast<int>(cudaGetLastError());
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
// same element type, 16-byte aligned.  (magic, shift) = div_magic(c): idx /
// c == (idx * magic) >> shift for idx < 2^31; unused for a larger output.
EVENTAD_API int eventad_gather_window_rows(const void* src, const void* nbr,
                                           const void* mask, int n_dst, int k,
                                           int c, int elem_size,
                                           unsigned magic, int shift,
                                           void* out, void* stream) {
  const long long total = static_cast<long long>(n_dst) * k * c;
  if (total == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return launch_gather<uint32_t>(src, nbr, mask, total, c, magic, shift,
                                   out, st);
  if (elem_size == 2)
    return launch_gather<uint16_t>(src, nbr, mask, total, c, magic, shift,
                                   out, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
