// K5: one generic spline-conv block over a neighbour table, any window
// (level 0: lookahead 0; pooled levels: neighbours before and after the
// destination), any tap sub-rectangle.
//
// Replaces eventad_tpu/ops/spline_fused.py:_fused_kernel (driven by
// fused_spline_conv_prepared).  Per destination n and output channel o:
//
//   z[n, m, :] = sum_k coeff[n, k, m] * src[nbr[n, k], :]        (f32)
//   out[n, o]  = sum_m bf16(z[n, m, :]) . W_sub[m][:, o]          (f32)
//
// with coeff the degree-1 spline weights of edge k on tap m (at most 2 x 2
// taps per edge).  src and W are bf16, z is summed in f32 in slot order and
// rounded to bf16 once before the tap product, the product sums in f32 and
// the output is f32: the rounding points of the TPU kernel.  Root product,
// bias, BN, activation and mask stay with the caller.
//
// The TPU kernel gathers through one-hot products over a chunked, transposed
// window of the source because a TPU gather costs a memory tile per index;
// none of that is carried.  The source is complete before the launch, so a
// neighbour after its destination is an indexed load like any other.
//
// What bounds it on the H100.  The least time is set by bytes at every
// level: the index table, the coordinates of the edges, the rows they read,
// the taps' weights and the output (16 MB for level 0's first block, 52 MB
// and 0.016 ms for the ten calls of a base forward).  The tap products are
// operations (13 440 x 25 x 82 x 64 multiply-adds for block 1 at level 1):
// 0.5 ms of a forward on the CUDA cores in f32, under 0.001 ms on the
// tensor cores.  What the time goes to is what a tile does in sequence: its
// edges' loads, then one step per tap its rows touch, each a z build and a
// product, and at the pooled levels the weights of each tap from L2.
// What the design does about each:
//
// * The tap product on the tensor cores: mma.sync.m16n8k16 (bf16 in, f32
//   out) with A by ldmatrix from z and B by ldmatrix from the weights, which
//   the host packs once per layer as [tap][O padded to 8][C padded]
//   (ops/spline_fused.pack_fused_weights: k contiguous, transposed, pads
//   zero); the accumulators stay in registers across the taps and the
//   epilogue writes f32 from them.  Row strides are C padded to 16 plus 8,
//   an odd number of 16-byte units, so the eight rows of an ldmatrix fall
//   into eight bank groups.
// * Per (row, slot) of a tile once, all loads of a thread in flight
//   together: the index, and only where it holds an edge its coordinates;
//   the floor taps and fractions go to an edge record; each edge sets its
//   bit in the mask of the (up to four) taps of the sub-rectangle it weighs
//   on (per (row, tap) a bit mask over the slots) and the tap in its 16-row
//   slab's mask.  An empty slot (nbr < 0 or >= N) costs one load and is
//   never used as an address.  A tile without an edge writes zeros and ends.
// * The rows the edges read are staged in shared memory once, up to `cap`
//   of them (the rest are read from device memory where z needs them), by
//   16-byte loads of 8 channels whatever the row's alignment
//   (eventad::load8_bf16: rows of C 19, 82 and 130 are not 16-byte
//   aligned), the channels beyond C zero.
// * z of a tap: (row, 8-channel vector) items walk the set bits of their
//   row's mask, so only the edges that weigh on the tap are summed, f32 in
//   slot order, rounded to bf16, stored as 16 bytes in the ldmatrix layout.
// * Two kernels, the launch's plan (plan_tiles) picks one:
//   - the slab kernel where the table fills the card with 128-row blocks
//     and every tap's weights fit beside them (level 0: 0.15 edges a row,
//     about 20 a tile): 8 warps, each owns a 16-row slab and walks only the
//     taps its own rows touch (about 6 of 15), with its own z rows and no
//     barrier of the block; a z row is rewritten only where it changes.
//     64 staged rows let three blocks share an SM.
//   - the block kernel otherwise (the pooled levels): a tile of 128, 64, 32
//     or 16 rows by N and 16 warps walk the taps the tile touches in step,
//     one barrier a tap; the next tap's weights arrive by cp.async into the
//     second of two stages meanwhile; the z items are taken from the last
//     thread down, so the warps without a share of the product build the
//     next z; a warp whose 16 rows have no edge on the tap skips its
//     product.  Where the tiles leave more than half the SMs idle (840 and
//     210 rows), a cluster of 2, 4 or 8 blocks shares each tile, every
//     block taking every n-th touched tap, and the cluster's first block
//     adds their partial products in block order from distributed shared
//     memory: one launch, and the same bits on every run.
//
// Widths: any O (padded to 8 in the pack and walked in column groups of 64
// or 128 by grid.y; only the first O columns are stored) and any C whose
// 16-row tile fits in shared memory with an 8-column group and no staged
// rows (C up to about 2 200); at most 32 slots and 64 taps (the bit
// masks).  A shape that does not fit is refused, never run another way.
//
// Shared memory per block, bytes (CS = pad16(C) + 8; M taps, K slots):
//   z (2 TM, slab TM) CS 2 | weights (2, slab M) og CS 2 | edges 16 TM K |
//   masks 4 TM M | staged rows cap (2 CS + 4) | tables 4 M + TM / 2 + 16 |
//   partials 4 TM og (clusters)
// Where a block kernel's tile does not fit in 227 KB, the staged rows, the
// tile and the column group shrink, in that order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;     // 227 KB, what a block may ask for
constexpr int kTwoPerSm = 115712;    // 113 KB: two blocks on an SM
constexpr int kLoads = 4;            // loads a thread keeps in flight
constexpr int kSlabRows = 128;       // rows of a slab launch's block

struct Params {
  const bf16* src; int c;
  const int* nbr; int k; const float* u;
  const bf16* wpack;             // [m, o_pad, cstride]
  int n; int o; int o_pad; int og;
  int ks; int mx0; int nxs; int my0; int nys;
  int cstride; int cap;
  int groups;                    // blocks (a cluster) that share a tile
  float* out;
};

using eventad::align16;
using eventad::cp_async_commit;
using eventad::cp_async_wait_all;
using eventad::load8_bf16;
using eventad::load_weights;
using eventad::mma_tile;
using eventad::pad_stride;
using eventad::sm_count;
using eventad::tap_weight;

// The carve-up of dynamic shared memory, the same on both sides: z_rows
// rows of z, w_tiles tiles of weights (og x CS each), the edge records and
// bit masks of tm rows, cap staged rows, the tap table, the touched taps of
// each 16-row slab and the staged-row count, then (groups > 1) the f32
// partial sums of the tile
struct Layout {
  size_t z, w, edge, nz, rows, rows_j, mxy, slab, count, red, total;
};
__host__ __device__ inline Layout make_layout(int tm, int z_rows,
                                              int w_tiles, int cstride,
                                              int og, int k, int m, int cap,
                                              int groups) {
  Layout l;
  size_t at = 0;
  l.z = at; at += align16(static_cast<size_t>(z_rows) * cstride * 2);
  l.w = at; at += align16(static_cast<size_t>(w_tiles) * og * cstride * 2);
  l.edge = at; at += static_cast<size_t>(tm) * k * 16;
  l.nz = at; at += align16(static_cast<size_t>(tm) * m * 4);
  l.rows = at; at += static_cast<size_t>(cap) * cstride * 2;
  l.rows_j = at; at += align16(static_cast<size_t>(cap) * 4);
  l.mxy = at; at += align16(static_cast<size_t>(m) * 4);
  l.slab = at; at += static_cast<size_t>(tm / 16) * 8;
  l.count = at; at += 16;
  l.red = at; at += groups > 1 ? static_cast<size_t>(tm) * og * 4 : 0;
  l.total = at;
  return l;
}

// The block's shared arrays, carved by make_layout
struct Smem {
  bf16* z; bf16* w;
  // per (row, slot): x = ix | iy << 8 as bits (-1: no edge), y = fx,
  // z = fy, w = the staged row of its source as bits, or ~(source row)
  float4* edge;
  // per (row, tap): bit s set where slot s weighs on the tap
  unsigned* nz;
  bf16* rows; int* rows_j;
  int* mxy;                       // per tap: mx | my << 8 (kernel taps)
  unsigned long long* slab;       // per 16-row slab: the taps it touches
  int* count;                     // edges that weigh on a tap
  float* red;                     // [TM][og] partial sums (groups > 1)
};
__device__ inline Smem carve(unsigned char* smem, const Layout& l) {
  Smem s;
  s.z = reinterpret_cast<bf16*>(smem + l.z);
  s.w = reinterpret_cast<bf16*>(smem + l.w);
  s.edge = reinterpret_cast<float4*>(smem + l.edge);
  s.nz = reinterpret_cast<unsigned*>(smem + l.nz);
  s.rows = reinterpret_cast<bf16*>(smem + l.rows);
  s.rows_j = reinterpret_cast<int*>(smem + l.rows_j);
  s.mxy = reinterpret_cast<int*>(smem + l.mxy);
  s.slab = reinterpret_cast<unsigned long long*>(smem + l.slab);
  s.count = reinterpret_cast<int*>(smem + l.count);
  s.red = reinterpret_cast<float*>(smem + l.red);
  return s;
}

// Zeroes the masks and the count and fills the tap table; the caller
// synchronises
template <int TM, int NT>
__device__ void clear_tables(const Params& p, const Smem& s, int tid) {
  const int m_sub = p.nxs * p.nys;
  for (int i = tid; i < TM * m_sub; i += NT) s.nz[i] = 0u;
  for (int i = tid; i < m_sub; i += NT)
    s.mxy[i] = (p.mx0 + i % p.nxs) | ((p.my0 + i / p.nxs) << 8);
  if (tid < TM / 16) s.slab[tid] = 0ull;
  if (tid == 0) *s.count = 0;
}

// Per (row, slot) of the tile once, kLoads indices of a thread and then the
// coordinates of those that hold an edge all in flight together: the edge
// records, the (row, tap) bit masks, each slab's touched taps and the list
// of staged source rows (`cap` of them; an edge beyond keeps its row as
// ~row).  The caller synchronises.
template <int TM, int NT>
__device__ void list_edges(const Params& p, const Smem& s, int n0, int tid) {
  const int K = p.k, m_sub = p.nxs * p.nys;
  const float2* u2 = reinterpret_cast<const float2*>(p.u);
  for (int i0 = tid; i0 < TM * K; i0 += NT * kLoads) {
    int j[kLoads];
    float2 uv[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * NT;
      const int row = n0 + i / K;
      j[q] = i < TM * K && row < p.n
                 ? __ldg(p.nbr + static_cast<long long>(n0) * K + i) : -1;
      if (j[q] >= p.n) j[q] = -1;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      uv[q] = j[q] >= 0 ? __ldg(u2 + static_cast<long long>(n0) * K + i0 +
                                q * NT)
                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * NT;
      if (i >= TM * K) break;
      const int t = i / K, sl = i - t * K;
      int code = -1, where = 0;
      float fx = 0.f, fy = 0.f;
      if (j[q] >= 0) {
        int ix, iy;
        eventad::spline_taps(uv[q].x, p.ks, &ix, &fx);
        eventad::spline_taps(uv[q].y, p.ks, &iy, &fy);
        unsigned long long taps = 0ull;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int dx = c4 & 1, dy = c4 >> 1;
          const int mx = ix + dx - p.mx0, my = iy + dy - p.my0;
          if (mx < 0 || mx >= p.nxs || my < 0 || my >= p.nys ||
              (dx ? fx : 1.f - fx) == 0.f || (dy ? fy : 1.f - fy) == 0.f)
            continue;
          const int m = my * p.nxs + mx;
          atomicOr(s.nz + t * m_sub + m, 1u << sl);
          taps |= 1ull << m;
        }
        if (taps) {
          atomicOr(s.slab + t / 16, taps);
          code = ix | (iy << 8);
          const int at = atomicAdd(s.count, 1);
          if (at < p.cap) {
            s.rows_j[at] = j[q];
            where = at;
          } else {
            where = ~j[q];
          }
        }
      }
      s.edge[i] = make_float4(__int_as_float(code), fx, fy,
                              __int_as_float(where));
    }
  }
}

// The staged rows, 16 bytes of 8 channels a load, kLoads a thread in
// flight; the pad channels zero.  The caller synchronises.
template <int NT>
__device__ void stage_rows(const Params& p, const Smem& s, int vecs,
                           int tid) {
  const int staged = min(*s.count, p.cap), cstr = p.cstride;
  for (int i0 = tid; i0 < staged * vecs; i0 += NT * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * NT;
      if (i < staged * vecs) {
        const int r = i / vecs, c8 = (i - r * vecs) * 8;
        v[q] = load8_bf16(p.src + static_cast<size_t>(s.rows_j[r]) * p.c, c8,
                          p.c);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * NT;
      if (i < staged * vecs) {
        const int r = i / vecs, c8 = (i - r * vecs) * 8;
        *reinterpret_cast<uint4*>(s.rows + static_cast<size_t>(r) * cstr +
                                  c8) = v[q];
      }
    }
  }
}

// z of one (row, 8-channel vector) on kernel tap (mx, my): the edges of
// `bits` (slots of the row), f32 in slot order, rounded to bf16
__device__ __forceinline__ uint4 z_vector(const Params& p, const Smem& s,
                                          unsigned bits, const float4* erow,
                                          int c8, int mx, int my) {
  float z[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) z[q] = 0.f;
  for (; bits; bits &= bits - 1) {
    const float4 e = erow[__ffs(bits) - 1];
    const float cm = tap_weight(e, mx, my);
    const int where = __float_as_int(e.w);
    const uint4 raw =
        where >= 0 ? *reinterpret_cast<const uint4*>(
                         s.rows + static_cast<size_t>(where) * p.cstride + c8)
                   : load8_bf16(p.src + static_cast<size_t>(~where) * p.c, c8,
                                p.c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      z[2 * q] += cm * f.x;
      z[2 * q + 1] += cm * f.y;
    }
  }
  uint4 packed;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o2[q] = __floats2bfloat162_rn(z[2 * q], z[2 * q + 1]);
  return packed;
}

// The tile's rows [n0, n0 + rows), columns [og0, og0 + cols): zeros
__device__ void write_zeros(const Params& p, int n0, int rows, int og0,
                            int cols, int tid, int nt) {
  for (int i = tid; i < rows * cols; i += nt) {
    const int r = i / cols, col = og0 + i - r * cols;
    if (n0 + r < p.n && col < p.o)
      p.out[static_cast<long long>(n0 + r) * p.o + col] = 0.f;
  }
}

// The epilogue from a warp's accumulator fragments: rows g and g + 8 of
// its 16 from row0, columns 2 (lane % 4) and the next of each of its NBW
// blocks of 8 from col0; the pad columns (O and beyond) are not written
template <int NBW>
__device__ __forceinline__ void store_tile(const Params& p, int row0,
                                           int col0, int n_blocks, int lane,
                                           const float (&acc)[NBW][4]) {
#pragma unroll
  for (int j = 0; j < NBW; ++j) {
    const int col = col0 + j * 8 + 2 * (lane & 3);
    if (j >= n_blocks || col >= p.o) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      if (row >= p.n) continue;
      float* dst = p.out + static_cast<long long>(row) * p.o + col;
      if (col + 1 < p.o && (p.o & 1) == 0) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        dst[0] = acc[j][2 * h];
        if (col + 1 < p.o) dst[1] = acc[j][2 * h + 1];
      }
    }
  }
}

// The block kernel: TM rows a tile, 16 warps as (TM / 16) x WN, a warp
// owns 16 rows and up to NBW blocks of 8 output columns of its block's
// column group; one step per tap the tile touches, one barrier a step.
// With groups > 1 a cluster of that many blocks shares the tile: block g
// takes every groups-th of its touched taps from the g-th on, and the
// cluster's first block sums their partial products in block order from
// distributed shared memory
template <int TM, int WN, int NBW>
__global__ void __launch_bounds__(512, 2) fused_conv_kernel(const Params p) {
  constexpr int kThreads = 512;
  constexpr int kWarpsM = TM / 16;
  static_assert(kWarpsM * WN * 32 == kThreads, "16 warps a block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_sub = p.nxs * p.nys, cstr = p.cstride;
  const Smem s = carve(smem, make_layout(TM, 2 * TM, 2, cstr, p.og, p.k,
                                         m_sub, p.cap, p.groups));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int group = blockIdx.x % p.groups;
  const int n0 = blockIdx.x / p.groups * TM;
  const int og0 = blockIdx.y * p.og;
  const int cols = min(p.og, p.o_pad - og0);

  clear_tables<TM, kThreads>(p, s, tid);
  __syncthreads();
  list_edges<TM, kThreads>(p, s, n0, tid);
  __syncthreads();
  unsigned long long left = 0ull;
#pragma unroll
  for (int q = 0; q < TM / 16; ++q) left |= s.slab[q];
  if (left == 0ull) {          // no edge of the tile weighs on a tap
    if (group == 0) write_zeros(p, n0, TM, og0, cols, tid, kThreads);
    return;                    // (the whole cluster)
  }
  if (p.groups > 1) {          // this block's share of the taps
    unsigned long long mine = 0ull;
    for (int r = 0; left; left &= left - 1, ++r)
      if (r % p.groups == group) mine |= left & (~left + 1);
    left = mine;
  }
  // the touched taps' weights, two stages: the next tap's arrive while
  // this one multiplies
  unsigned long long ahead = left;
  auto fetch_next = [&](int stage) {
    if (!ahead) return;
    const int m = __ffsll(static_cast<long long>(ahead)) - 1;
    ahead &= ahead - 1;
    load_weights(s.w + static_cast<size_t>(stage) * p.og * cstr,
                 p.wpack + (static_cast<size_t>(m) * p.o_pad + og0) * cstr,
                 cols * cstr, tid, kThreads);
    cp_async_commit();
  };
  fetch_next(0);
  const int vecs = (cstr - 8) / 8;        // 8-channel vectors of a z row
  stage_rows<kThreads>(p, s, vecs, tid);

  const int k_blocks = (cstr - 8) / 16;
  const int n_blocks = cols / 8;
  float acc[NBW][4];
#pragma unroll
  for (int j = 0; j < NBW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  // this thread's first (row, vector) item, from the last thread down, so
  // the warps without a share of the product build the next z; the next
  // items kThreads further on
  const int first = kThreads - 1 - tid;
  const int t0 = first / vecs, v0 = first - t0 * vecs;
  const int dt = kThreads / vecs, dv = kThreads - dt * vecs;
  __syncthreads();          // the staged rows

  for (int it = 0; left; ++it) {
    const int cur = __ffsll(static_cast<long long>(left)) - 1;
    left &= left - 1;
    bf16* zb = s.z + static_cast<size_t>(it & 1) * TM * cstr;
    const int mx = s.mxy[cur] & 0xff, my = s.mxy[cur] >> 8;
    for (int t = t0, v = v0; t < TM;) {
      const int c8 = v * 8;
      const unsigned bits = c8 < p.c ? s.nz[t * m_sub + cur] : 0u;
      *reinterpret_cast<uint4*>(zb + static_cast<size_t>(t) * cstr + c8) =
          bits ? z_vector(p, s, bits, s.edge + t * p.k, c8, mx, my)
               : make_uint4(0u, 0u, 0u, 0u);
      t += dt;
      v += dv;
      if (v >= vecs) {
        v -= vecs;
        ++t;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // the next tap's weights into the stage the previous tap has left
    fetch_next((it + 1) & 1);
    // a warp whose 16 rows have no edge on the tap has a zero A: it skips
    // the product
    const unsigned slab = lane < 16 ? s.nz[(wm * 16 + lane) * m_sub + cur]
                                    : 0u;
    if (__any_sync(0xffffffffu, slab != 0u))
      mma_tile<NBW>(zb, cstr, s.w + static_cast<size_t>(it & 1) * p.og * cstr,
                    cstr, k_blocks, n_blocks, wm, wn, lane, acc);
  }
  if (p.groups == 1) {
    store_tile<NBW>(p, n0 + wm * 16, og0 + wn * NBW * 8,
                    n_blocks - wn * NBW, lane, acc);
    return;
  }
  // the partial sums into shared memory, then the first block of the
  // cluster adds them up in block order
#pragma unroll
  for (int j = 0; j < NBW; ++j) {
    const int nb = wn * NBW + j;
    if (nb >= n_blocks) continue;
    const int col = nb * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + (lane >> 2) + 8 * h;
      s.red[r * p.og + col] = acc[j][2 * h];
      s.red[r * p.og + col + 1] = acc[j][2 * h + 1];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (group == 0) {
    for (int i = tid; i < TM * cols; i += kThreads) {
      const int r = i / cols, cc = i - r * cols;
      const int row = n0 + r, col = og0 + cc;
      float sum = 0.f;
      for (int g = 0; g < p.groups; ++g)
        sum += cluster.map_shared_rank(s.red, g)[r * p.og + cc];
      if (row < p.n && col < p.o)
        p.out[static_cast<long long>(row) * p.o + col] = sum;
    }
  }
  cluster.sync();              // the partials stay until they are read
}

// The slab kernel, where every tap's weights fit beside the tile: 128 rows
// a block, 8 warps, a warp owns a 16-row slab and every column of the
// group (og <= 8 NBW).  After the shared setup each warp walks only the
// taps its own rows touch, with its own z rows and no barrier of the block
template <int NBW>
__global__ void __launch_bounds__(256, 2) fused_slab_kernel(const Params p) {
  constexpr int kThreads = 256, TM = kSlabRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_sub = p.nxs * p.nys, cstr = p.cstride;
  const Smem s = carve(smem, make_layout(TM, TM, m_sub, cstr, p.og, p.k,
                                         m_sub, p.cap, 1));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TM;
  const int og0 = blockIdx.y * p.og;
  const int cols = min(p.og, p.o_pad - og0);

  clear_tables<TM, kThreads>(p, s, tid);
  __syncthreads();
  list_edges<TM, kThreads>(p, s, n0, tid);
  __syncthreads();
  unsigned long long taps = 0ull;
#pragma unroll
  for (int q = 0; q < TM / 16; ++q) taps |= s.slab[q];
  if (taps == 0ull) {
    write_zeros(p, n0, TM, og0, cols, tid, kThreads);
    return;
  }
  // every touched tap's weights, tap m at tile m
  for (unsigned long long left = taps; left; left &= left - 1) {
    const int m = __ffsll(static_cast<long long>(left)) - 1;
    load_weights(s.w + static_cast<size_t>(m) * p.og * cstr,
                 p.wpack + (static_cast<size_t>(m) * p.o_pad + og0) * cstr,
                 cols * cstr, tid, kThreads);
  }
  cp_async_commit();
  const int vecs = (cstr - 8) / 8;
  stage_rows<kThreads>(p, s, vecs, tid);
  bf16* zw = s.z + static_cast<size_t>(warp) * 16 * cstr;
  for (int i = lane; i < 16 * cstr / 8; i += 32)
    reinterpret_cast<uint4*>(zw)[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait_all();
  __syncthreads();

  const int k_blocks = (cstr - 8) / 16;
  const int n_blocks = cols / 8;
  float acc[NBW][4];
#pragma unroll
  for (int j = 0; j < NBW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  const int row0 = warp * 16;
  // this lane's (row, vector) items of the slab, 32 apart; of the first 32
  // the ones that hold a nonzero z row (the others are zero)
  const int t0 = lane / vecs, v0 = lane - t0 * vecs;
  const int dt = 32 / vecs, dv = 32 - dt * vecs;
  unsigned dirty = 0u;
  for (unsigned long long left = s.slab[warp]; left; left &= left - 1) {
    const int cur = __ffsll(static_cast<long long>(left)) - 1;
    const int mx = s.mxy[cur] & 0xff, my = s.mxy[cur] >> 8;
    int j = 0;
    for (int t = t0, v = v0; t < 16; ++j) {
      const int c8 = v * 8;
      const unsigned bits = c8 < p.c ? s.nz[(row0 + t) * m_sub + cur] : 0u;
      const unsigned bit = j < 32 ? 1u << j : 0u;
      if (bits != 0u || bit == 0u || (dirty & bit) != 0u) {
        *reinterpret_cast<uint4*>(zw + static_cast<size_t>(t) * cstr + c8) =
            bits ? z_vector(p, s, bits, s.edge + (row0 + t) * p.k, c8, mx, my)
                 : make_uint4(0u, 0u, 0u, 0u);
        dirty = bits ? dirty | bit : dirty & ~bit;
      }
      t += dt;
      v += dv;
      if (v >= vecs) {
        v -= vecs;
        ++t;
      }
    }
    __syncwarp();
    mma_tile<NBW>(zw, cstr, s.w + static_cast<size_t>(cur) * p.og * cstr,
                  cstr, k_blocks, n_blocks, 0, 0, lane, acc);
    __syncwarp();
  }
  store_tile<NBW>(p, n0 + row0, og0, n_blocks, lane, acc);
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int tm, int threads, size_t smem,
           cudaStream_t stream) {
  // the kernel may take up to kMaxSmem of dynamic shared memory, set on
  // every launch, so on whichever device is current
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + tm - 1) / tm * p.groups,
                     (p.o_pad + p.og - 1) / p.og);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.groups;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

struct Plan {
  int tm;         // rows a block (0: the shape does not fit)
  bool slab;      // the slab kernel
  size_t smem;
};

// The launch for p's n, c, k, taps and o_pad; sets p->og, p->cap and
// p->groups.  The slab kernel where the table fills the SMs with 128-row
// blocks and every tap's weights of a 64-column group (or the whole O) fit
// beside them in half an SM; else the block kernel with its row tile by N:
// 128 rows where that gives a block per SM, else 64 where that does, else
// 32 where that gives a block per two SMs, else 16; 64 output columns a
// group at 128 rows, else 128.  Staged rows: max(TM, 64), at most TM K;
// where the block does not fit, the staged rows, the tile and the group
// shrink, in that order.  Where the tiles leave more than half the SMs
// idle, 2, 4 or 8 blocks (a cluster) share each tile's taps
Plan plan_tiles(Params* p, int n_sms) {
  const int n = p->n, k = p->k, m = p->nxs * p->nys;
  p->groups = 1;
  if ((n + kSlabRows - 1) / kSlabRows >= n_sms) {
    p->og = min(p->o_pad, 64);
    p->cap = min(kSlabRows * k, 64);
    const size_t smem = make_layout(kSlabRows, kSlabRows, m, p->cstride,
                                    p->og, k, m, p->cap, 1).total;
    if (smem <= static_cast<size_t>(kTwoPerSm))
      return Plan{kSlabRows, true, smem};
  }
  int tm = (n + 127) / 128 >= n_sms ? 128
           : (n + 63) / 64 >= n_sms ? 64
           : 2 * ((n + 31) / 32) >= n_sms ? 32 : 16;
  p->og = min(p->o_pad, tm == 128 ? 64 : 128);
  int cap = min(tm * k, max(tm, 64)), groups = 1;
  auto smem_of = [&]() {
    return make_layout(tm, 2 * tm, 2, p->cstride, p->og, k, m, cap,
                       groups).total;
  };
  while (smem_of() > static_cast<size_t>(kMaxSmem)) {
    if (cap > 16) cap /= 2;
    else if (cap > 0) cap = 0;
    else if (tm > 16) tm /= 2;
    else if (p->og > 8) p->og = max(8, p->og / 2 / 8 * 8);
    else return Plan{0, false, 0};
  }
  const long long blocks = static_cast<long long>((n + tm - 1) / tm) *
                           ((p->o_pad + p->og - 1) / p->og);
  while (groups < 8 && 2 * groups <= m && blocks * 2 * groups <= n_sms) {
    groups *= 2;
    if (smem_of() > static_cast<size_t>(kMaxSmem)) {
      groups /= 2;
      break;
    }
  }
  p->cap = cap;
  p->groups = groups;
  return Plan{tm, false, smem_of()};
}

bool valid_shape(int n, int c, int k, int o_ch, int m) {
  return n >= 0 && c >= 1 && k >= 1 && k <= 32 && o_ch >= 1 && m >= 1 &&
         m <= 64;
}

}  // namespace

// src [N, C] bf16, nbr [N, K] int32 (absolute rows of src; < 0 or >= N: no
// edge), u [N, K, 2] f32, wpack [nxs*nys, OP, CS] bf16 (the taps of the
// sub-rectangle, x fastest, each transposed: OP = O padded to 8 rows, CS =
// pad16(C) + 8 columns, pads zero) -> out [N, O] f32.  K at most 32, at
// most 64 taps; C and O as the note at the top says.
EVENTAD_API int eventad_fused_spline_conv(
    const void* src, int c, const void* nbr, int k, const void* u,
    const void* wpack, int n, int o_ch, int ks, int mx0, int nxs, int my0,
    int nys, void* out, void* stream) {
  if (!valid_shape(n, c, k, o_ch, nxs * nys) || ks < 2 || ks > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Params p;
  p.src = static_cast<const bf16*>(src); p.c = c;
  p.nbr = static_cast<const int*>(nbr); p.k = k;
  p.u = static_cast<const float*>(u);
  p.wpack = static_cast<const bf16*>(wpack);
  p.n = n; p.o = o_ch; p.o_pad = (o_ch + 7) / 8 * 8;
  p.ks = ks; p.mx0 = mx0; p.nxs = nxs; p.my0 = my0; p.nys = nys;
  p.cstride = pad_stride(c);
  p.out = static_cast<float*>(out);
  int n_sms = 0;
  const cudaError_t e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan plan = plan_tiles(&p, n_sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.tm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (plan.slab) {
    if (p.og <= 16)
      return launch(fused_slab_kernel<2>, p, plan.tm, 256, plan.smem, s);
    return launch(fused_slab_kernel<8>, p, plan.tm, 256, plan.smem, s);
  }
  if (plan.tm == 128)
    return launch(fused_conv_kernel<128, 2, 4>, p, 128, 512, plan.smem, s);
  if (plan.tm == 64)
    return launch(fused_conv_kernel<64, 4, 4>, p, 64, 512, plan.smem, s);
  if (plan.tm == 32)
    return launch(fused_conv_kernel<32, 8, 2>, p, 32, 512, plan.smem, s);
  return launch(fused_conv_kernel<16, 16, 1>, p, 16, 512, plan.smem, s);
}

// The row tile, output column group, staged rows, kernel (1: slab, 0:
// block) and blocks a tile that eventad_fused_spline_conv picks for these
// sizes, into plan[0..4] (host memory; a row tile of 0: the shape does not
// fit).
EVENTAD_API int eventad_fused_plan(int n, int c, int k, int o_ch, int m,
                                   void* plan, void* stream) {
  (void)stream;
  if (!valid_shape(n, c, k, o_ch, m))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n = n; p.c = c; p.k = k; p.nxs = m; p.nys = 1;
  p.o_pad = (o_ch + 7) / 8 * 8;
  p.cstride = pad_stride(c);
  int n_sms = 0;
  const cudaError_t e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan chosen = plan_tiles(&p, n_sms);
  int* out = static_cast<int*>(plan);
  out[0] = chosen.tm;
  out[1] = p.og;
  out[2] = p.cap;
  out[3] = chosen.slab;
  out[4] = p.groups;
  return 0;
}
