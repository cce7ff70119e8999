// K2: one conv block of the level-0 layer (spline conv over the event
// graph, root, eval-BN affine, optional linear skip with its BN, activation,
// node mask), launched twice per layer.
//
// Replaces eventad_tpu/ops/spline_fused.py:_fused2_kernel (driven by
// fused_two_block_prepared).  The TPU kernel runs both blocks in one grid
// and relies on its grid running in order: block 2 reads h rows that earlier
// grid steps wrote to HBM.  CUDA blocks run in no order, so the layer is two
// launches of this kernel: launch 1 (block 1, no skip) writes h as bf16, the
// rounding the TPU applies to hh_bf; launch 2 (block 2 with the skip
// epilogue) gathers h.  Per destination n and output channel o:
//
//   z_m[n, :] = sum_{edges k of n} cy[my] cx[mx] src[nbr[n, k], :]
//   acc       = sum_m bf16(z_m[n, :]) . W[m][:, o] + src[n] . root[:, o]
//   pre       = a[o] acc + b[o]  (+ a_s[o] (xs[n] . skip[:, o]) + b_s[o])
//   out[n, o] = bf16(act(pre) * node_mask[n])
//
// over the taps m of the static sub-rectangle of tap_ranges(
// level0_attr_range) (3 x 5 of the 5 x 5 kernel at 360 x 240), the self
// edge folded into root by the pack (ops/spline_fused.pack_level0_block).
// Rounding points, those of the TPU kernel: src, xs and the weights are
// bf16, z_m is summed in f32 and rounded to bf16 once, every product sums in
// f32, the affine, activation and mask run in f32 and the output is rounded
// to bf16 once.
//
// What bounds it on the H100: by bytes, 16 MB for the two launches at the
// operating point (a 38-byte source row and a 60-byte neighbour row of
// every destination in, a 32-byte row out), 0.005 ms; by tensor-core
// operations much less.  In fact the instructions a 16-row tile issues: the
// level-0 graph holds ~0.15 edges a row (0.85 on the dense batch), so per
// row the work is the root (and on block 2 the skip) product, and for the
// few rows with an edge a sparse, data-dependent build of z.  Design:
//
// * The operands are packed once per layer on the host (taps and root
//   transposed and padded for the B fragments, root with the centre tap,
//   skip likewise, affines [O][4]; kept by models/backbone.
//   whole_layer_operands), so a call casts, slices and uploads nothing.
// * Persistent blocks of 8 warps, as many as fit on the SMs; each loads
//   the packed weights (~25 KB) into shared memory once and its warps then
//   walk 16-row tiles on their own (no block barrier in the loop).  A warp's
//   next tile (its source rows, skip rows and neighbour rows, each one
//   contiguous run of the table) arrives by cp.async into the second of two
//   buffers while it works on the current one.
// * Root and skip products of a tile are mma.sync.m16n8k16: A fragments
//   from the tile's rows as they lie in the table (any C, zero beyond it),
//   B fragments straight from the packed weights.
// * The edges: a ballot per row finds them; the tile's edges (in groups of
//   whole rows, at most 32) are listed, one lane an edge: its row (binary
//   search over the rows' first edges), slot, coordinates, taps and their
//   weights (a [edge][tap] table) and its neighbour row (eight edges' rows
//   loaded before any is stored, so the loads are in flight together).
//   Then per tap that an edge touches, its product is one more
//   mma.sync.m16n8k16 into the root's accumulators: each lane builds its A
//   fragment in registers, z of its two rows and four channels summed in
//   f32 over the row's edges in slot order and rounded to bf16, zero for a
//   row with no edge on the tap.
// * The epilogue runs from the accumulator registers: the affines, the
//   activation and the node mask (read as its bytes), a bf16 pair a lane.
//
// Measured on the way (PERF.md, section 6): one edge row at a time on the
// CUDA cores, z per tap through shared memory, and 4 warps a block were
// slower, most of all on the dense batch; 16 warps a block were 1-5 %
// faster but leave the larger shapes (C 33, O 32, all 25 taps) no room.
//
// Any width the Pallas kernel takes (it pads C and O to 8; VMEM is its only
// limit): O from 1 to 256 is padded to a multiple of 8 in the pack (zero
// rows; the epilogue writes only the first O columns, pairs where O is
// even, else one value at a time) and walked in column groups of 64, each
// with its own accumulators: the root, skip and tap products and the
// epilogue of a tile run once per group.  Any C and Cs: the neighbour rows
// are staged 64 channels at a time.  Where the packed weights and eight
// warps' buffers do not fit in shared memory (C 67 and O 64 with 15 taps
// need 180 KB of weights alone), the weights stay in device memory and the
// B fragments are read from there (L1 and L2 hold them: every warp reads
// the same ones), and the block has as many warps as fit.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using eventad::align16;
using eventad::cp_async;
using eventad::cp_async_commit;
using eventad::cp_async_wait;
using eventad::cp_async_wait_all;
using eventad::mma_bf16;
using eventad::pad_stride;
using eventad::sm_count;

constexpr int kWarps = 8;
constexpr int kGroup = 32;          // edges a group of rows holds at most
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;     // 227 KB, what a block may ask for
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const bf16* src; int c;               // [N, C]
  const int* nbr; int k;                // [N, K], -1 = no edge
  const float* u;                       // [N, K, 2]
  const uint8_t* node_mask;             // [N]
  const bf16* taps;                     // [M, O, CS]
  const bf16* root;                     // [O, CS]
  const bf16* xs; int cs;               // [N, Cs] or NULL
  const bf16* skip;                     // [O, CSS]
  const float* ab;                      // [O, 4]
  int n, o, ks, mx0, nxs, my0, nys, act;
  bf16* out;                            // [N, O]
  int cstride, csstride;                // CS, CSS
  int o_pad;                            // OP: O padded to 8, the packs' rows
  int warps;                            // warps a block
  int wsmem;                            // the weights in shared memory
};

// the carve-up of dynamic shared memory, the same on both sides: the
// weights (where they are held there), then per warp two tile buffers
// (source rows, skip rows, neighbour rows), the edge records of a group of
// rows, their neighbour rows, the taps each row of the group touches
struct Layout {
  size_t taps, root, skip, warps, src, xs, nbr, tile, wt, et, x, rowmask,
      warp, total;
};
__host__ __device__ inline Layout make_layout(const Params& p) {
  Layout l;
  const int m = p.nxs * p.nys;
  size_t at = 0;
  l.taps = at;
  l.root = l.skip = 0;
  if (p.wsmem) {
    at += align16(static_cast<size_t>(m) * p.o_pad * p.cstride * 2);
    l.root = at; at += align16(static_cast<size_t>(p.o_pad) * p.cstride * 2);
    l.skip = at;
    at += p.xs != nullptr
              ? align16(static_cast<size_t>(p.o_pad) * p.csstride * 2)
              : 0;
  }
  l.warps = at;
  size_t w = 0;
  l.src = w; w += align16(static_cast<size_t>(16) * p.c * 2);
  l.xs = w; w += p.xs != nullptr ? align16(static_cast<size_t>(16) * p.cs * 2)
                                 : 0;
  l.nbr = w; w += align16(static_cast<size_t>(16) * p.k * 4);
  l.tile = w;                                  // one buffer of the three
  w *= 2;
  l.wt = w; w += align16(static_cast<size_t>(kGroup) * m * 4);
  l.et = w; w += kGroup * 16;
  l.x = w; w += align16(static_cast<size_t>(kGroup) * p.c * 2);
  l.rowmask = w; w += 16 * 8;
  l.warp = w;
  l.total = at + static_cast<size_t>(p.warps) * w;
  return l;
}

// `bytes` (even) from global `g` to shared `s` (16-byte aligned), by the
// lanes of one warp: 16-byte cp.async where `g` is 16-byte aligned, the
// rest by 2-byte loads
__device__ __forceinline__ void copy_run(unsigned char* s,
                                         const unsigned char* g, int bytes,
                                         int lane) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    done = bytes / 16 * 16;
    for (int q = lane * 16; q < done; q += 32 * 16) cp_async<16>(s + q, g + q);
  }
  for (int q = done + lane * 2; q < bytes; q += 32 * 2)
    *reinterpret_cast<uint16_t*>(s + q) =
        *reinterpret_cast<const uint16_t*>(g + q);
}

// channels q, q + 1 of row r of a [rows, c] tile, zero beyond it
__device__ __forceinline__ uint32_t pair(const bf16* t, int c, int rows,
                                         int r, int q) {
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 lo = r < rows && q < c ? t[r * c + q] : zero;
  const bf16 hi = r < rows && q + 1 < c ? t[r * c + q + 1] : zero;
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// acc[j] += tile[16 rows, :c] . w[8 j + (0..7), :c] for the first nb blocks
// of 8 output channels; w [O][stride] (k contiguous) in shared or device
// memory
template <int NB>
__device__ __forceinline__ void tile_product(const bf16* t, int c, int rows,
                                             const bf16* w, int stride,
                                             int nb, int lane,
                                             float (&acc)[NB][4]) {
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  for (int k0 = 0; k0 < c; k0 += 16) {
    uint32_t a[4];
    a[0] = pair(t, c, rows, g, k0 + q2);
    a[1] = pair(t, c, rows, g + 8, k0 + q2);
    a[2] = pair(t, c, rows, g, k0 + 8 + q2);
    a[3] = pair(t, c, rows, g + 8, k0 + 8 + q2);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        const bf16* wr = w + static_cast<size_t>(8 * j + g) * stride + k0 + q2;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(wr);
        b[1] = *reinterpret_cast<const uint32_t*>(wr + 8);
        mma_bf16(acc[j], a, b);
      }
    }
  }
}

// kSmemW: the packed weights in shared memory (p.wsmem), an instantiation
// of its own so that their reads compile to shared-memory loads
template <int NB, bool kSmemW>
__global__ void __launch_bounds__(kThreads)
level0_block_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_skip = p.xs != nullptr;
  const int m_taps = p.nxs * p.nys;
  // the packed weights, [M][OP][CS], [OP][CS] and [OP][CSS]
  const bf16* s_taps =
      kSmemW ? reinterpret_cast<const bf16*>(smem + l.taps) : p.taps;
  const bf16* s_root =
      kSmemW ? reinterpret_cast<const bf16*>(smem + l.root) : p.root;
  const bf16* s_skip =
      kSmemW ? reinterpret_cast<const bf16*>(smem + l.skip) : p.skip;
  unsigned char* wb = smem + l.warps + static_cast<size_t>(warp) * l.warp;
  // per edge of a group: its weight on each tap [kGroup][M]; its row,
  // four tap indices and neighbour
  float* s_wt = reinterpret_cast<float*>(wb + l.wt);
  int4* s_et = reinterpret_cast<int4*>(wb + l.et);
  bf16* s_x = reinterpret_cast<bf16*>(wb + l.x);       // [kGroup][C]
  // per row of the tile: the taps its edges touch
  unsigned long long* s_rowmask =
      reinterpret_cast<unsigned long long*>(wb + l.rowmask);

  // the packed weights, once per block, where they are held in shared
  // memory
  if (kSmemW) {
    const int sizes[3] = {m_taps * p.o_pad * p.cstride * 2,
                          p.o_pad * p.cstride * 2,
                          has_skip ? p.o_pad * p.csstride * 2 : 0};
    const unsigned char* from[3] = {
        reinterpret_cast<const unsigned char*>(p.taps),
        reinterpret_cast<const unsigned char*>(p.root),
        reinterpret_cast<const unsigned char*>(p.skip)};
    unsigned char* to[3] = {smem + l.taps, smem + l.root, smem + l.skip};
    for (int a = 0; a < 3; ++a)
      for (int q = tid * 16; q < sizes[a]; q += kThreads * 16)
        cp_async<16>(to[a] + q, from[a] + q);
  }
  cp_async_commit();

  // eight warps where the weights are in shared memory, else p.warps
  const int n_warps = kSmemW ? kWarps : p.warps;
  const int n_tiles = (p.n + 15) / 16;
  const int stride = gridDim.x * n_warps;
  auto fetch = [&](int tile, int buf) {
    const long long n0 = static_cast<long long>(tile) * 16;
    const int rows = min(16, p.n - static_cast<int>(n0));
    unsigned char* b = wb + buf * l.tile;
    copy_run(b + l.src,
             reinterpret_cast<const unsigned char*>(p.src + n0 * p.c),
             rows * p.c * 2, lane);
    if (has_skip)
      copy_run(b + l.xs,
               reinterpret_cast<const unsigned char*>(p.xs + n0 * p.cs),
               rows * p.cs * 2, lane);
    copy_run(b + l.nbr,
             reinterpret_cast<const unsigned char*>(p.nbr + n0 * p.k),
             rows * p.k * 4, lane);
  };

  int tile = blockIdx.x * n_warps + warp;
  if (tile < n_tiles) fetch(tile, 0);
  cp_async_commit();
  cp_async_wait<1>();      // the weights (this thread's share)
  __syncthreads();         // everyone's share

  const int g = lane >> 2, q2 = 2 * (lane & 3);
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const int buf = it & 1;
    if (tile + stride < n_tiles) fetch(tile + stride, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();    // this tile's rows
    __syncwarp();
    const unsigned char* b = wb + buf * l.tile;
    const bf16* t_src = reinterpret_cast<const bf16*>(b + l.src);
    const bf16* t_xs = reinterpret_cast<const bf16*>(b + l.xs);
    const int* t_nbr = reinterpret_cast<const int*>(b + l.nbr);
    const int n0 = tile * 16;
    const int rows = min(16, p.n - n0);

    // per group of 8 NB output columns: its products and epilogue
    for (int og = 0; og < p.o_pad; og += 8 * NB) {
      const int nb = min(NB, (p.o_pad - og) / 8);
      const bf16* g_taps = s_taps + static_cast<size_t>(og) * p.cstride;
      const bf16* g_root = s_root + static_cast<size_t>(og) * p.cstride;
      const bf16* g_skip = s_skip + static_cast<size_t>(og) * p.csstride;

      float acc[NB][4], sk[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = sk[j][q] = 0.f;

      // ---- root and skip products on the tensor cores ----
      tile_product<NB>(t_src, p.c, rows, g_root, p.cstride, nb, lane, acc);
      if (has_skip)
        tile_product<NB>(t_xs, p.cs, rows, g_skip, p.csstride, nb, lane, sk);

      // ---- the edges: lane r < 16 holds row r's slots that hold an edge,
      // their count and the place of its first edge in the tile's list
      // (row-major, slots in order) ----
      unsigned myb = 0u;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r < rows) {
          const unsigned bits =
              __ballot_sync(kFull, lane < p.k && t_nbr[r * p.k + lane] >= 0);
          if (lane == r) myb = bits;
        }
      }
      const int cnt = __popc(myb);
      int first = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, first, o);
        if (lane >= o) first += y;
      }
      first -= cnt;
      const int total = __shfl_sync(kFull, first + cnt, 15);

      // groups of whole rows with at most kGroup edges (a row has at most
      // K <= kGroup)
      for (int r0 = 0; r0 < rows;) {
        const int e0 = __shfl_sync(kFull, first, r0);
        int r1 = rows, n_e = total - e0;        // the rest, where it fits
        if (n_e > kGroup) {
          r1 = r0;
          n_e = 0;
          while (r1 < rows) {
            const int c_r = __shfl_sync(kFull, cnt, r1);
            if (n_e + c_r > kGroup) break;
            n_e += c_r;
            ++r1;
          }
        }
        r0 = r1;
        if (n_e == 0) continue;
        // lane e < n_e: edge e0 + e, its row and slot, its taps and weights
        // its row: the last whose first edge is not after it (binary search
        // over the rows' first edges); its slot: the row's set bit of that
        // rank
        const int e = e0 + lane;
        int row = 0;
#pragma unroll
        for (int step = 8; step > 0; step >>= 1)
          if (__shfl_sync(kFull, first, row + step) <= e) row += step;
        const int slot = static_cast<int>(__fns(
            __shfl_sync(kFull, myb, row), 0,
            e - __shfl_sync(kFull, first, row) + 1));
        unsigned long long touched = 0ull;      // this lane's edge's taps
        uint32_t taps = 0xffffffffu;             // its four, 0xff none
        float wt[4] = {0.f, 0.f, 0.f, 0.f};     // and their weights
        int jn = -1;
        if (lane < n_e) {
          jn = t_nbr[row * p.k + slot];
          const float2 uv = __ldg(reinterpret_cast<const float2*>(p.u) +
                                  (static_cast<long long>(n0 + row) * p.k +
                                   slot));
          int ix0, iy0;
          float fx, fy;
          eventad::spline_taps(uv.x, p.ks, &ix0, &fx);
          eventad::spline_taps(uv.y, p.ks, &iy0, &fy);
          taps = 0u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int bx = q & 1, by = q >> 1;
            const int mx = ix0 + bx - p.mx0, my = iy0 + by - p.my0;
            const bool in = mx >= 0 && mx < p.nxs && my >= 0 && my < p.nys;
            const int m = in ? my * p.nxs + mx : 0xff;
            taps |= static_cast<uint32_t>(m) << (8 * q);
            wt[q] = (by ? fy : 1.f - fy) * (bx ? fx : 1.f - fx);
            if (in) touched |= 1ull << m;
          }
          s_et[lane] = make_int4(row, static_cast<int>(taps), jn, 0);
        }
        // the group's weights, [edge][tap], zero where an edge has no weight
        for (int i = lane; i < n_e * m_taps; i += 32) s_wt[i] = 0.f;
        __syncwarp();
        if (lane < n_e) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = (taps >> (8 * q)) & 0xff;
            if (m != 0xff) s_wt[lane * m_taps + m] = wt[q];
          }
        }
        // the taps each row of the group touches, and any edge
        if (lane < 16) s_rowmask[lane] = 0ull;
        __syncwarp();
        if (lane < n_e) atomicOr(s_rowmask + row, touched);
        const unsigned long long tmask =
            (static_cast<unsigned long long>(__reduce_or_sync(
                 kFull, static_cast<unsigned>(touched >> 32))) << 32) |
            __reduce_or_sync(kFull, static_cast<unsigned>(touched));
        // the group's neighbour rows, [edge][channel], lanes over channels
        // c0 + lane and c0 + lane + 32, eight edges at a time: every load of
        // a lane issued before its stores
        for (int b0 = 0; b0 < n_e; b0 += 8) {
          for (int c0 = 0; c0 < p.c; c0 += 64) {
            const int ca = c0 + lane, cb = c0 + lane + 32;
            bf16 v[8][2];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int j = __shfl_sync(kFull, jn, (b0 + q) & 31);
              const bf16* xj = p.src + static_cast<long long>(j) * p.c;
              const bool on = b0 + q < n_e;
              v[q][0] = on && ca < p.c ? __ldg(xj + ca) : __float2bfloat16(0.f);
              v[q][1] = on && cb < p.c ? __ldg(xj + cb) : __float2bfloat16(0.f);
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if (b0 + q >= n_e) break;
              if (ca < p.c) s_x[(b0 + q) * p.c + ca] = v[q][0];
              if (cb < p.c) s_x[(b0 + q) * p.c + cb] = v[q][1];
            }
          }
        }
        __syncwarp();
        // per touched tap, its product on the tensor cores, the A fragment
        // computed in registers: each lane's z values (rows g and g + 8,
        // four channels) summed in f32 over its row's edges in slot order
        // and rounded to bf16; a row without an edge on the tap gives zeros
        const unsigned long long mask_a = s_rowmask[g],
                                 mask_b = s_rowmask[g + 8];
        const int fa = __shfl_sync(kFull, first, g) - e0;
        const int ca = __shfl_sync(kFull, cnt, g);
        const int fb = __shfl_sync(kFull, first, g + 8) - e0;
        const int cb = __shfl_sync(kFull, cnt, g + 8);
        // channels q, q + 1 of z of tap m, row with edges [f, f + n)
        auto zpair = [&](unsigned long long rmask, int f, int n, int m,
                         int q) -> uint32_t {
          float z0 = 0.f, z1 = 0.f;
          if ((rmask >> m) & 1ull) {
            for (int e = f; e < f + n; ++e) {
              const float w = s_wt[e * m_taps + m];
              const bf16* xe = s_x + e * p.c;
              if (q < p.c) z0 += w * eventad::bf(xe[q]);
              if (q + 1 < p.c) z1 += w * eventad::bf(xe[q + 1]);
            }
          }
          return static_cast<uint32_t>(
                     __bfloat16_as_ushort(__float2bfloat16(z0))) |
                 (static_cast<uint32_t>(
                      __bfloat16_as_ushort(__float2bfloat16(z1))) << 16);
        };
        for (unsigned long long tb = tmask; tb; tb &= tb - 1) {
          const int m = __ffsll(static_cast<long long>(tb)) - 1;
          const bf16* wm =
              g_taps + static_cast<size_t>(m) * p.o_pad * p.cstride;
          for (int k0 = 0; k0 < p.c; k0 += 16) {
            uint32_t a[4];
            a[0] = zpair(mask_a, fa, ca, m, k0 + q2);
            a[1] = zpair(mask_b, fb, cb, m, k0 + q2);
            a[2] = zpair(mask_a, fa, ca, m, k0 + 8 + q2);
            a[3] = zpair(mask_b, fb, cb, m, k0 + 8 + q2);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              if (j < nb) {
                const bf16* wr =
                    wm + static_cast<size_t>(8 * j + g) * p.cstride + k0 + q2;
                uint32_t bb[2];
                bb[0] = *reinterpret_cast<const uint32_t*>(wr);
                bb[1] = *reinterpret_cast<const uint32_t*>(wr + 8);
                mma_bf16(acc[j], a, bb);
              }
            }
          }
        }
        __syncwarp();        // the group's records are the next group's
      }

      // ---- epilogue from the accumulators: rows g and g + 8, columns
      // og + 8 j + 2 (lane % 4) and the next; the pad columns (O and beyond)
      // are not written ----
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= nb) continue;
        const int col = og + 8 * j + q2;
        if (col >= p.o) continue;
        const float4 ab0 = __ldg(reinterpret_cast<const float4*>(p.ab) + col);
        const float4 ab1 =
            __ldg(reinterpret_cast<const float4*>(p.ab) + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          if (r >= rows) continue;
          float y0 = ab0.x * acc[j][2 * h] + ab0.y;
          float y1 = ab1.x * acc[j][2 * h + 1] + ab1.y;
          if (has_skip) {
            y0 += ab0.z * sk[j][2 * h] + ab0.w;
            y1 += ab1.z * sk[j][2 * h + 1] + ab1.w;
          }
          const long long row = n0 + r;
          const bool on = p.node_mask[row] != 0;
          y0 = on ? eventad::apply_act(y0, p.act) : 0.f;
          y1 = on ? eventad::apply_act(y1, p.act) : 0.f;
          bf16* dst = p.out + row * p.o + col;
          if (col + 1 < p.o && (p.o & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(y0, y1);
          } else {
            dst[0] = __float2bfloat16(y0);
            if (col + 1 < p.o) dst[1] = __float2bfloat16(y1);
          }
        }
      }
    }
    __syncwarp();          // the buffers are the tile after next's
  }
  cp_async_wait_all();
}

template <int NB, bool kSmemW>
int launch_block(const Params& p, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        level0_block_kernel<NB, kSmemW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // as many blocks as the SMs hold at this shared memory size
  const int threads = p.warps * 32;
  int per_sm = 0, n_sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level0_block_kernel<NB, kSmemW>, threads, smem);
  if (e == cudaSuccess) e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (p.n + 15) / 16;
  const int blocks = min((n_tiles + p.warps - 1) / p.warps, per_sm * n_sms);
  level0_block_kernel<NB, kSmemW><<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int run(const Params& p, size_t smem, cudaStream_t stream) {
  return p.wsmem ? launch_block<NB, true>(p, smem, stream)
                 : launch_block<NB, false>(p, smem, stream);
}

}  // namespace

// src [N, C] bf16, nbr [N, K] int32 (absolute rows, -1 = no edge), u [N, K,
// 2] f32, node_mask [N] one byte each (bool), taps [nxs*nys, OP, CS] and
// root [OP, CS] bf16 (transposed, CS = pad16(C) + 8, OP = O padded to 8,
// pads zero), ab [OP, 4] f32 (a, b, a_s, b_s), xs [N, Cs] bf16 and skip
// [OP, CSS] bf16 (both NULL without skip) -> out [N, O] bf16.  O from 1 to
// 256, K at most 32, at most 64 taps, one warp's buffers within 227 KB of
// shared memory (any C and Cs up to ~500); the packed weights 16-byte
// aligned.
EVENTAD_API int eventad_level0_block(
    const void* src, int c, const void* nbr, int k, const void* u,
    const void* node_mask, const void* taps, const void* root,
    const void* ab, const void* xs, int cs, const void* skip, int n,
    int o_ch, int ks, int mx0, int nxs, int my0, int nys, int act, void* out,
    void* stream) {
  if (n == 0) return 0;
  if (o_ch < 1 || o_ch > 256 || c < 1 || k < 1 || k > 32 ||
      nxs < 1 || nys < 1 || nxs * nys > 64 || ks < 2 ||
      (xs != nullptr && (cs < 1 || skip == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.src = static_cast<const bf16*>(src); p.c = c;
  p.nbr = static_cast<const int*>(nbr); p.k = k;
  p.u = static_cast<const float*>(u);
  p.node_mask = static_cast<const uint8_t*>(node_mask);
  p.taps = static_cast<const bf16*>(taps);
  p.root = static_cast<const bf16*>(root);
  p.xs = static_cast<const bf16*>(xs); p.cs = xs != nullptr ? cs : 0;
  p.skip = static_cast<const bf16*>(skip);
  p.ab = static_cast<const float*>(ab);
  p.n = n; p.o = o_ch; p.ks = ks; p.mx0 = mx0; p.nxs = nxs; p.my0 = my0;
  p.nys = nys; p.act = act;
  p.out = static_cast<bf16*>(out);
  p.cstride = pad_stride(c);
  p.csstride = xs != nullptr ? pad_stride(cs) : 8;
  if (((reinterpret_cast<uintptr_t>(taps) | reinterpret_cast<uintptr_t>(root) |
        reinterpret_cast<uintptr_t>(skip)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  p.o_pad = (o_ch + 7) / 8 * 8;
  // the weights in shared memory beside eight warps where they fit, else
  // in device memory beside as many warps as fit
  p.wsmem = 1;
  p.warps = kWarps;
  size_t smem = make_layout(p).total;
  if (smem > static_cast<size_t>(kMaxSmem)) {
    p.wsmem = 0;
    p.warps = 1;
    p.warps = min(kWarps, static_cast<int>(kMaxSmem / make_layout(p).warp));
    if (p.warps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    smem = make_layout(p).total;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.o_pad <= 8) return run<1>(p, smem, s);
  if (p.o_pad <= 16) return run<2>(p, smem, s);
  if (p.o_pad <= 32) return run<4>(p, smem, s);
  return run<8>(p, smem, s);
}
