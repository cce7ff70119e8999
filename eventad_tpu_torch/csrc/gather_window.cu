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
// Scatter design: deterministic, no atomics on values, two launches.  The
// work is the unmasked edges, 0.15 a row at the operating point, and the
// bound is the mask, those edges' rows of g and the output; what costs is
// finding the edges.  The graph contract i - lookback <= nbr[i, k] <= i
// means that only destinations [s, s + lookback] can reference source s.
//   1. list_edges: one pass over the [n_dst * k] mask, 16 bytes a thread,
//      4096 edges a block: each block lists its unmasked edges in edge
//      order (e, nbr[e]) at its own place in a scratch list, by a scan of
//      the threads' counts, and writes its count.  Every mask byte is read
//      once, and nbr only where the mask is set.
//   2. sum_edges: a block owns a tile of T source rows (T by C: 256, 128
//      or 64, the f32 accumulators T x C in shared memory) and reads the
//      lists of the blocks that hold destinations [s0, s0 + T + lookback)
//      as one sequence, 256 entries at a time.  The entries that point into
//      the tile are bucketed by row, stably: a warp's lanes of one row are
//      ranked by __match_any_sync, a row's count in each warp goes to a
//      histogram, and a prefix over the warps and a scan over the rows place
//      each entry behind every earlier one of its row.  Then each (row,
//      channel) accumulator of a touched row adds the rows of g of its own
//      bucket, in order.
// Every sum is thus taken in f32 in ascending flat edge order, the order
// of a sequential index_add, from 0, so two runs give the same bits.  An
// edge outside the contract's window may be left out.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListEdges = 16 * kThreads;   // edges a list_edges block reads

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

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int x = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += x;
  }
  return v;
}

// exclusive prefix of each thread's v over the block (kThreads threads);
// *total gets the sum.  `warp_sums` holds kWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_sums[w];
    if (w < warp) before += x;
    all += x;
  }
  __syncthreads();     // warp_sums may be written again
  *total = all;
  return before + incl - v;
}

// 1. the unmasked edges of each block of kListEdges, in edge order
__global__ void __launch_bounds__(kThreads)
list_edges_kernel(const uint8_t* __restrict__ mask,
                  const int* __restrict__ nbr, int total,
                  int2* __restrict__ list, int* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  const int e0 = blockIdx.x * kListEdges + threadIdx.x * 16;
  unsigned bits = 0u;
  if (e0 + 16 <= total &&
      (reinterpret_cast<uintptr_t>(mask + e0) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(mask + e0));
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if ((x[i / 4] >> (8 * (i % 4))) & 0xffu) bits |= 1u << i;
  } else {
    for (int i = 0; i < 16 && e0 + i < total; ++i)
      if (mask[e0 + i]) bits |= 1u << i;
  }
  int found;
  int at = block_exclusive_scan(__popc(bits), warp_sums, &found);
  int2* dst = list + static_cast<size_t>(blockIdx.x) * kListEdges;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if ((bits >> i) & 1u) {
      dst[at] = make_int2(e0 + i, __ldg(nbr + e0 + i));
      ++at;
    }
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = found;
}

// 2. per tile of `tile` source rows, the listed edges that point into it,
// bucketed by row, summed in edge order.  Dynamic shared memory: tile * c
// f32 accumulators, then (kWarps + 2) * tile ints.
template <typename G, typename O>
__global__ void __launch_bounds__(kThreads)
sum_edges_kernel(const G* __restrict__ g, const int2* __restrict__ list,
                 const int* __restrict__ counts, int n_lists, int n_dst,
                 int k, int c, int n_src, int lookback, int tile,
                 O* __restrict__ out) {
  extern __shared__ float acc[];
  __shared__ int bucket[kThreads];
  __shared__ int list_first[kThreads];   // first entry of each list read
  __shared__ int touched[kThreads];      // rows of this window's entries
  __shared__ int warp_sums[kWarps];
  int* hist = reinterpret_cast<int*>(acc + tile * c);   // [kWarps][tile]
  int* row_count = hist + kWarps * tile;
  int* row_start = row_count + tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * tile;
  const int rows = min(tile, n_src - s0);
  const int n_acc = rows * c;
  for (int a = tid; a < n_acc; a += kThreads) acc[a] = 0.f;
  for (int a = tid; a < kWarps * tile; a += kThreads) hist[a] = 0;

  // the edges of destinations [s0, s0 + rows + lookback), and the lists
  // that hold them
  const long long d_end = min(static_cast<long long>(n_dst),
                              static_cast<long long>(s0) + rows + lookback);
  const long long e_lo = static_cast<long long>(s0) * k, e_hi = d_end * k;
  const int l0 = static_cast<int>(e_lo / kListEdges);
  const int l1 = min(n_lists,
                     static_cast<int>((e_hi + kListEdges - 1) / kListEdges));

  // up to kThreads lists at a time, read as one sequence of entries
  for (int lc = l0; lc < l1; lc += kThreads) {
    const int nl = min(kThreads, l1 - lc);
    int n_in;
    const int first = block_exclusive_scan(tid < nl ? counts[lc + tid] : 0,
                                           warp_sums, &n_in);
    if (tid < nl) list_first[tid] = first;
    __syncthreads();
    for (int w0 = 0; w0 < n_in; w0 += kThreads) {
      int e = -1, r = -1;
      const int at = w0 + tid;
      if (at < n_in) {
        // the last list whose first entry is at or before `at` (an empty
        // list shares its first with the next one)
        int lo = 0, hi = nl - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (list_first[mid] <= at) lo = mid;
          else hi = mid - 1;
        }
        const int2 ent = __ldg(list + static_cast<size_t>(lc + lo) *
                                          kListEdges + at - list_first[lo]);
        if (ent.y >= s0 && ent.y < s0 + rows && ent.x >= e_lo &&
            ent.x < e_hi) {
          e = ent.x;
          r = ent.y - s0;
        }
      }
      if (!__syncthreads_or(r >= 0)) continue;
      // this warp's lanes of row r, and this lane's rank among them
      const unsigned peers =
          __match_any_sync(0xffffffffu, r >= 0 ? r : -1 - lane);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (r >= 0 && rank == 0) hist[warp * tile + r] = __popc(peers);
      __syncthreads();
      // per row: the counts of the warps before, the row's count; one scan
      // gives each row its bucket's start (low 16 bits) and each touched
      // row its place in the list of touched rows (high bits)
      int count = 0;
      if (tid < tile) {
        for (int w = 0; w < kWarps; ++w) {
          const int h = hist[w * tile + tid];
          hist[w * tile + tid] = count;
          count += h;
        }
      }
      int both;
      const int starts = block_exclusive_scan(
          tid < tile && count > 0 ? count | (1 << 16) : 0, warp_sums,
          &both);
      if (tid < tile) {
        row_count[tid] = count;
        row_start[tid] = starts & 0xffff;
        if (count > 0) touched[starts >> 16] = tid;
      }
      __syncthreads();
      if (r >= 0) bucket[row_start[r] + hist[warp * tile + r] + rank] = e;
      __syncthreads();
      if (tid < tile)
        for (int w = 0; w < kWarps; ++w) hist[w * tile + tid] = 0;
      // each accumulator of a touched row adds the rows of g of its own
      // bucket, in order
      for (int a = tid; a < (both >> 16) * c; a += kThreads) {
        const int ti = a / c;
        const int ra = touched[ti], ch = a - ti * c;
        const int* b = bucket + row_start[ra];
        float* dst = acc + ra * c + ch;
        float sum = *dst;
        for (int q = 0; q < row_count[ra]; ++q)
          sum += load_f(g + static_cast<size_t>(b[q]) * c + ch);
        *dst = sum;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  O* dst = out + static_cast<long long>(s0) * c;
  for (int a = tid; a < n_acc; a += kThreads) store_f(dst + a, acc[a]);
}

template <typename G, typename O>
int launch_scatter(const void* g, const void* nbr, const void* mask,
                   int n_dst, int k, int c, int n_src, int lookback,
                   int tile, void* list, void* counts, void* out,
                   cudaStream_t stream) {
  const int total = n_dst * k;
  const int n_lists = (total + kListEdges - 1) / kListEdges;
  if (n_lists > 0) {
    list_edges_kernel<<<n_lists, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(mask), static_cast<const int*>(nbr),
        total, static_cast<int2*>(list), static_cast<int*>(counts));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = static_cast<size_t>(tile) * c * sizeof(float) +
                      static_cast<size_t>(kWarps + 2) * tile * sizeof(int);
  sum_edges_kernel<G, O><<<(n_src + tile - 1) / tile, kThreads, smem,
                           stream>>>(
      static_cast<const G*>(g), static_cast<const int2*>(list),
      static_cast<const int*>(counts), n_lists, n_dst, k, c, n_src, lookback,
      tile, static_cast<O*>(out));
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
// (out_bf16; a bf16 output needs a bf16 g).  tile: source rows a block of
// the second launch owns (tile * c * 4 + 40 * tile bytes of shared memory
// must fit 48 KB; at most kThreads); list [ceil(n_dst * k / 4096) * 4096]
// int2 and counts [ceil(n_dst * k / 4096)] int32: scratch.  n_dst * k
// below 2^31 - 4096.  Launches list_edges (where n_dst * k > 0), then
// sum_edges.
EVENTAD_API int eventad_scatter_window_rows(const void* g, const void* nbr,
                                            const void* mask, int n_dst,
                                            int k, int c, int n_src,
                                            int lookback, int g_bf16,
                                            int out_bf16, int tile,
                                            void* list, void* counts,
                                            void* out, void* stream) {
  if (n_src == 0 || c == 0) return 0;
  if (tile < 1 || tile > kThreads || n_dst < 0 || k < 0 || lookback < 0 ||
      static_cast<long long>(n_dst) * k >= (1ll << 31) - kListEdges ||
      static_cast<size_t>(tile) * c * 4 + (kWarps + 2) * tile * 4 >
          48 * 1024 ||
      (out_bf16 && !g_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!g_bf16)
    return launch_scatter<float, float>(g, nbr, mask, n_dst, k, c, n_src,
                                        lookback, tile, list, counts, out,
                                        st);
  if (out_bf16)
    return launch_scatter<__nv_bfloat16, __nv_bfloat16>(
        g, nbr, mask, n_dst, k, c, n_src, lookback, tile, list, counts, out,
        st);
  return launch_scatter<__nv_bfloat16, float>(g, nbr, mask, n_dst, k, c,
                                              n_src, lookback, tile, list,
                                              counts, out, st);
}
