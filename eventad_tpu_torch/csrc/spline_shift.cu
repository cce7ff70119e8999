// K3: one pooled-level conv block (spline conv over the cell grid, root,
// eval-BN affine, optional linear skip with its BN, activation, node mask).
//
// Replaces eventad_tpu/ops/spline_shift.py:_shift_kernel (driven by
// shift_spline_conv, operands from prepare_shift / tap_windows).  At pooled
// levels slot s of cell n is cell n + d_off[s] of the same table, and an
// edge exists only where the edge mask mq[n, s] is set; shifted reads that
// cross a grid row or an item boundary are always masked.  Per slot, the
// static tap window of tap_windows bounds the taps its attrs can reach, so
// each tap m has a static list of contributing slots (built once per
// geometry on the host).  Per destination n and output channel o:
//
//   z_m[n, :] = sum_{s in slots(m), mq[n,s]} cy[my] cx[mx] * src[n + d_off[s]]
//   acc       = sum_m bf16(z_m[n, :]) . W[m][:, o] + src[n] . root[:, o]
//   out[n, o] = bf16(act(a acc + b (+ a_s (xs[n] . skip[:, o]) + b_s)) mask)
//
// Rounding points, those of the TPU kernel: src, xs and the weights are
// bf16; z_m is summed in f32 and rounded to bf16 once; every product sums in
// f32 on the tensor cores; the affine, the activation and the mask run in
// f32 and the output is rounded to bf16 once.
//
// What bounds it on the H100.  By bytes the eight launches of a forward
// need 0.005 ms and their tap products, dense, 0.01 ms of the tensor cores:
// neither is the limit.  The limits are (a) the z build, a data-dependent
// sum of shifted rows per (row, tap) that only the CUDA cores can do, (b)
// the weights, 13-19 KB per tap that every block needs, and (c) at the
// small levels (840 and 210 rows) the latency of up to 27 steps in
// sequence on a handful of blocks.  What the design does about each, as
// the TPU kernel does with its VMEM window:
//
// * Per (row, slot) once: the floor taps and fractions of the edge.  Each
//   edge sets its bit in the mask of the (up to four) taps it weighs on,
//   per (row, tap) a bit mask over the tap's slot list, and marks the
//   window row it reads; per block a bit mask of the taps any row touches.
//   The cost follows the edges, which are few (0.6 to 2.6 of 25 slots per
//   row at the operating point).  An untouched tap is skipped whole: no
//   weights, no z, no product.  A block without an edge does only root,
//   skip and epilogue.
// * The source window in shared memory: of rows [n0 - halo, n0 + TM +
//   halo) of src, halo = max |d_off|, the tile's own rows and the rows an
//   edge reads, with cp.async (16 bytes where C and the address allow, else
//   4, else plain 2-byte loads), rows outside the table and the pad columns
//   zero.  Every later read of a neighbour row is a 16-byte shared-memory
//   read at a static row offset.  A dense graph loads the whole window, a
//   sparse one a fifth of it.
// * z_m for a touched tap: threads over (row, 8-channel vector) walk the
//   set bits of their row's mask, so an entry without weight costs nothing,
//   sum in f32 from the window, round to bf16 and store 16 bytes into one of
//   two z buffers in the ldmatrix layout.  This sum is where a level-1
//   launch spends its instructions.
// * The products are mma.sync.aligned.m16n8k16 (bf16 in, f32 out) with A
//   by ldmatrix from the z buffer (the window's own rows for the root, the
//   xs tile for the skip) and B by ldmatrix from the weights, which the
//   host packs once as [tap][O][C padded] (k contiguous, i.e. transposed,
//   so that the B fragment is an untransposed ldmatrix), taps first, root
//   last, the skip apart.  Accumulators stay in registers across all taps;
//   the skip has its own (it has its own affine).  Row strides are C padded
//   to 16 plus 8 elements, an odd number of 16-byte units, so that the
//   eight rows of an ldmatrix fall into eight different bank groups.
// * The weights of the next step arrive by cp.async into the other of two
//   stages while this tap multiplies and the next z is built: one
//   __syncthreads() per touched tap.
// * The row tile follows the level: 128 rows where that still fills three
//   quarters of the SMs (level 1: 105 blocks), else 32 where that gives a
//   block per SM, else 16 (levels 2-4: 210, 53 and 14 blocks), so that the
//   small levels spread.  Every block fetches the weights of every tap it
//   touches from L2, and with few edges a block touches most taps whatever
//   its size: a level-1 launch moves 150 MB of weights at 32 rows and 38 MB
//   at 128, and runs a tenth faster there; below level 1 the larger tiles
//   leave SMs idle and measured slower.
// * A block has 16 warps at every tile size: the z build is what takes the
//   time and wants the threads (one (row, vector) item each at 16 rows),
//   and a step is a chain of dependent shared-memory reads that only more
//   warps hide.  For the products they split the tile 8 x 2, 2 x 8 or
//   1 x 16 (rows x column groups of 8, 2 or 1 blocks of 8 channels);
//   the column groups beyond O / 8 blocks sit a product out and, taking
//   their z items first, build the next z meanwhile.
//
// mma.sync is enough here: the products are ~9 GFLOP per forward, 1 % of
// what the z build and the latency cost; wgmma would want 64-row tiles at
// every level and buys nothing at this size.
//
// Shared memory per block, bytes (CS = pad16(C) + 8, CSS likewise for Cs):
//   window (TM + 2 halo) CS 2 | xs tile TM CSS 2 | z 2 TM CS 2 |
//   weights 2 O max(CS, CSS) 2 | edges 16 TM S | masks 4 TM T |
//   lists 8 nnz + 8 T | tables S T + ks^2 + TM + 2 halo
// With S 25, T 25, nnz 323, O 64, in KB for block 1 / block 2 of a layer:
//   level 1 (halo 114, C 82):  TM 32 110 / 97 (two blocks fit an SM's 228),
//                              TM 16 93 / 79, TM 128 216 / 203
//   level 2 (halo 58, C 130):  TM 16 97 / 76, TM 32 119 / 96
//   level 3 (halo 30, C 130):  TM 16 81 / 69
//   level 4 (halo 16, C 130):  TM 16 72 / 65
// A tile that does not fit in 227 KB gives way to the next smaller one (128
// rows at C 130 with a skip of 130 take 32).  A 64-row tile was measured and
// paid at no level.
//
// Any width the Pallas kernel takes (it pads C and O to 8; VMEM is its only
// limit): O is padded to a multiple of 8 in the pack (zero rows; the
// epilogue writes only the first O columns, pairs where O is even, else one
// value at a time).  The tiles hold 128 output columns; a wider O, or a
// stage of weights that does not fit, is walked in column groups: the
// steps (z build and products) run once per group of og columns, each group
// with its own accumulators, weights and epilogue.  og is 128 where that
// fits, else halved down to 8 at the 16-row tile; only if that does not fit
// either the entry refuses the call.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;     // 227 KB, what a block may ask for
constexpr uint8_t kNone = 0xff;

struct Params {
  const bf16* src; int c;
  const float* u; const uint8_t* mq; const uint8_t* node_mask;
  const int* d_offs; int s_slots; int halo;
  const int* tap_mxy; const int* tap_ptr; const int* tap_slots;
  int n_taps; int nnz;
  const bf16* wpack; const float* ab;
  const bf16* xs; int cs; const bf16* skpack;
  int n; int o; int ks; int act;
  bf16* out;
  int cstride; int csstride;     // CS, CSS
  int o_pad; int og;             // O padded to 8; columns of a group
  int src_vw; int xs_vw;         // elements per copy: 8, 2 or 1
};

using eventad::align16;
using eventad::pad_stride;

// the carve-up of dynamic shared memory, the same on both sides
struct Layout {
  size_t win, xs, z, w, edge, list, ptr, mxy, nz, pos, tapof, need, mask,
      total;
  int stage;      // elements of one weight stage
};
__host__ __device__ inline Layout make_layout(int tm, int c_stride,
                                              int cs_stride, bool has_skip,
                                              int og, int halo, int s_slots,
                                              int nnz, int n_taps, int ks) {
  Layout l;
  size_t at = 0;
  l.win = at; at += align16(static_cast<size_t>(tm + 2 * halo) * c_stride * 2);
  l.xs = at; at += has_skip ? align16(static_cast<size_t>(tm) * cs_stride * 2)
                            : 0;
  l.z = at; at += align16(static_cast<size_t>(2) * tm * c_stride * 2);
  l.stage = og * (has_skip && cs_stride > c_stride ? cs_stride : c_stride);
  l.w = at; at += align16(static_cast<size_t>(2) * l.stage * 2);
  l.edge = at; at += static_cast<size_t>(tm) * s_slots * 16;
  l.list = at; at += align16(static_cast<size_t>(nnz) * 8);
  l.ptr = at; at += align16(static_cast<size_t>(n_taps + 1) * 4);
  l.mxy = at; at += align16(static_cast<size_t>(n_taps) * 4);
  l.nz = at; at += align16(static_cast<size_t>(tm) * n_taps * 4);
  l.pos = at; at += align16(static_cast<size_t>(s_slots) * n_taps);
  l.tapof = at; at += align16(static_cast<size_t>(ks) * ks);
  l.need = at; at += align16(static_cast<size_t>(tm + 2 * halo));
  l.mask = at; at += 16;
  l.total = at;
  return l;
}

using eventad::cp_async;
using eventad::cp_async_commit;
using eventad::cp_async_wait_all;
using eventad::load_weights;
using eventad::mma_tile;
using eventad::sm_count;
using eventad::tap_weight;

// Rows [first, first + count) of the [n, c] table `src` into shared rows of
// `stride` elements; rows outside [0, n) and the columns [c, stride) are
// zero.  vw elements per copy: 8 and 2 need c and the table's address to
// divide by them.  With `need`, only the rows it marks are loaded, the others
// are left as they are.  A warp per row, lanes over the row.
__device__ void load_rows(bf16* dst, int stride, const bf16* src, int c,
                          long long first, int n, int count, int vw,
                          const uint8_t* need, int warp, int lane,
                          int n_warps) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int r = warp; r < count; r += n_warps) {
    if (need != nullptr && !need[r]) continue;
    const long long g = first + r;
    const bool ok = g >= 0 && g < n;
    bf16* d = dst + static_cast<size_t>(r) * stride;
    const bf16* s = src + (ok ? g : 0) * c;
    if (vw == 8) {
      for (int q = lane * 8; q < stride; q += 32 * 8) {
        if (ok && q < c) cp_async<16>(d + q, s + q);
        else *reinterpret_cast<uint4*>(d + q) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else if (vw == 2) {
      for (int q = lane * 2; q < stride; q += 32 * 2) {
        if (ok && q < c) cp_async<4>(d + q, s + q);
        else *reinterpret_cast<uint32_t*>(d + q) = 0u;
      }
    } else {
      for (int q = lane; q < stride; q += 32) d[q] = ok && q < c ? s[q] : zero;
    }
  }
}

// TM rows per block; (TM / 16) x WN warps; a warp owns 16 rows and up to
// NBW blocks of 8 output channels; registers held to what MINB blocks on an
// SM leave each
template <int TM, int WN, int NBW, int MINB>
__global__ void __launch_bounds__((TM / 16) * WN * 32, MINB)
shift_block_kernel(const Params p) {
  constexpr int kWarpsM = TM / 16;
  constexpr int kWarps = kWarpsM * WN;
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool has_skip = p.xs != nullptr;
  const int cstr = p.cstride, csstr = p.csstride;
  const Layout l = make_layout(TM, cstr, csstr, has_skip, p.og, p.halo,
                               p.s_slots, p.nnz, p.n_taps, p.ks);
  bf16* s_win = reinterpret_cast<bf16*>(smem + l.win);
  bf16* s_xs = reinterpret_cast<bf16*>(smem + l.xs);
  bf16* s_z = reinterpret_cast<bf16*>(smem + l.z);
  bf16* s_w = reinterpret_cast<bf16*>(smem + l.w);
  // per (row, slot): x = ix | iy << 8 as bits (-1: no edge), y = fx, z = fy
  float4* s_edge = reinterpret_cast<float4*>(smem + l.edge);
  // per entry of the tap -> slots lists: x = slot, y = its row offset
  int2* s_list = reinterpret_cast<int2*>(smem + l.list);
  int* s_ptr = reinterpret_cast<int*>(smem + l.ptr);
  int* s_mxy = reinterpret_cast<int*>(smem + l.mxy);      // mx | my << 8
  // per (row, tap): bit j set where entry j of the tap's list has a weight
  unsigned* s_nz = reinterpret_cast<unsigned*>(smem + l.nz);
  // per (slot, tap): the slot's place in the tap's list, kNone outside it;
  // per kernel tap: its index among the T used ones, kNone unused; per
  // window row: whether any row of the tile reads it
  uint8_t* s_pos = smem + l.pos;
  uint8_t* s_tapof = smem + l.tapof;
  uint8_t* s_need = smem + l.need;
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(smem + l.mask);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int n0 = blockIdx.x * TM;
  const int S = p.s_slots, T = p.n_taps, ks = p.ks;

  // the static lists and tables
  if (tid == 0) *s_mask = 0ull;
  for (int i = tid; i < p.nnz; i += kThreads) {
    const int s = p.tap_slots[i];
    s_list[i] = make_int2(s, p.d_offs[s]);
  }
  for (int i = tid; i <= T; i += kThreads) s_ptr[i] = p.tap_ptr[i];
  for (int i = tid; i < T; i += kThreads)
    s_mxy[i] = p.tap_mxy[2 * i] | (p.tap_mxy[2 * i + 1] << 8);
  for (int i = tid; i < S * T; i += kThreads) {
    const int s = i / T, m = i - s * T;
    const int p0 = p.tap_ptr[m], p1 = p.tap_ptr[m + 1];
    uint8_t at = kNone;
    for (int q = p0; q < p1; ++q)
      if (p.tap_slots[q] == s) at = static_cast<uint8_t>(q - p0);
    s_pos[i] = at;
  }
  for (int i = tid; i < ks * ks; i += kThreads) {
    uint8_t m_of = kNone;
    for (int m = 0; m < T; ++m)
      if (p.tap_mxy[2 * m + 1] * ks + p.tap_mxy[2 * m] == i)
        m_of = static_cast<uint8_t>(m);
    s_tapof[i] = m_of;
  }
  for (int i = tid; i < TM * T; i += kThreads) s_nz[i] = 0u;
  for (int i = tid; i < TM + 2 * p.halo; i += kThreads)
    s_need[i] = i >= p.halo && i < p.halo + TM;      // the tile's own rows
  __syncthreads();

  // per edge once: floor taps and fractions; its bit in the mask of each
  // tap it weighs on; the window row it reads; per block the touched taps
  unsigned long long touched = 0ull;
  for (int i = tid; i < TM * S; i += kThreads) {
    const int t = i / S, s = i - t * S, row = n0 + t;
    int code = -1;
    float fx = 0.f, fy = 0.f;
    // both loads leave together: the coordinates do not wait for the mask
    const long long e = static_cast<long long>(row < p.n ? row : 0) * S + s;
    const float2 uv = __ldg(reinterpret_cast<const float2*>(p.u) + e);
    if (row < p.n && __ldg(p.mq + e)) {
      int ix, iy;
      eventad::spline_taps(uv.x, ks, &ix, &fx);
      eventad::spline_taps(uv.y, ks, &iy, &fy);
      code = ix | (iy << 8);
      s_need[p.halo + t + __ldg(p.d_offs + s)] = 1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dx = k & 1, dy = k >> 1;
        const float w = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy);
        const int m = s_tapof[(iy + dy) * ks + ix + dx];
        if (w == 0.f || m == kNone) continue;
        const int at = s_pos[s * T + m];      // kNone: outside the window
        if (at == kNone) continue;
        atomicOr(s_nz + t * T + m, 1u << at);
        touched |= 1ull << m;
      }
    }
    s_edge[i] = make_float4(__int_as_float(code), fx, fy, 0.f);
  }
  const unsigned lo = __reduce_or_sync(0xffffffffu,
                                       static_cast<unsigned>(touched));
  const unsigned hi = __reduce_or_sync(0xffffffffu,
                                       static_cast<unsigned>(touched >> 32));
  if (lane == 0 && (lo | hi))
    atomicOr(s_mask, (static_cast<unsigned long long>(hi) << 32) | lo);
  __syncthreads();

  // the window rows that are read, and the skip tile; the first weights
  // follow below and land with them
  load_rows(s_win, cstr, p.src, p.c, static_cast<long long>(n0) - p.halo,
            p.n, TM + 2 * p.halo, p.src_vw, s_need, warp, lane, kWarps);
  if (has_skip)
    load_rows(s_xs, csstr, p.xs, p.cs, n0, p.n, TM, p.xs_vw, nullptr, warp,
              lane, kWarps);

  // steps: the touched taps in order, then the root (T), then the skip
  // (T + 1); -1 ends.  Per column group [og0, og0 + cols) the steps run
  // once, from the weights of those columns
  unsigned long long left = 0ull;
  auto next_step = [&](int cur) {
    if (cur < T) {
      if (left) {
        const int m = __ffsll(static_cast<long long>(left)) - 1;
        left &= left - 1;
        return m;
      }
      return T;
    }
    return cur == T && has_skip ? T + 1 : -1;
  };
  auto weights_of = [&](int step, int og0, int cols, int* elems) {
    if (step <= T) {
      *elems = cols * cstr;
      return p.wpack + (static_cast<size_t>(step) * p.o_pad + og0) * cstr;
    }
    *elems = cols * csstr;
    return p.skpack + static_cast<size_t>(og0) * csstr;
  };

  const int k_blocks = (cstr - 8) / 16, ks_blocks = (csstr - 8) / 16;
  const int vecs = (cstr - 8) / 8;         // 8-channel vectors of a z row

  for (int og0 = 0; og0 < p.o_pad; og0 += p.og) {
    const int cols = min(p.og, p.o_pad - og0);
    const int n_blocks = cols / 8;
    float acc[NBW][4], sk[NBW][4];
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = sk[j][k] = 0.f;
    left = *s_mask;
    // the last group's weight stages and z buffers are free
    if (og0 > 0) __syncthreads();

    auto fetch_weights = [&](int step, int stage) {
      int elems;
      const bf16* w = weights_of(step, og0, cols, &elems);
      load_weights(s_w + static_cast<size_t>(stage) * l.stage, w, elems, tid,
                   kThreads);
      cp_async_commit();
    };
    int cur = next_step(-1);
    fetch_weights(cur, 0);
    cp_async_wait_all();   // the window, before the first z reads it
    __syncthreads();
    for (int it = 0; cur >= 0; ++it) {
      bf16* zb = s_z + static_cast<size_t>(it & 1) * TM * cstr;
      if (cur < T) {
        // z of tap cur: (row, vector) items over the threads, from the last
        // thread down, so that the warps without a share of the products
        // (the last ones) build the next z while the first ones multiply
        const int mx = s_mxy[cur] & 0xff, my = s_mxy[cur] >> 8;
        const int p0 = s_ptr[cur];
        for (int i = kThreads - 1 - tid; i < TM * vecs; i += kThreads) {
          const int t = i / vecs, v = i - t * vecs;
          const bf16* wrow =
              s_win + static_cast<size_t>(p.halo + t) * cstr + v * 8;
          const float4* erow = s_edge + t * S;
          float z[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) z[k] = 0.f;
          // only the list entries that weigh in, in list order
          for (unsigned bits = s_nz[t * T + cur]; bits; bits &= bits - 1) {
            const int2 le = s_list[p0 + __ffs(bits) - 1];
            const float cm = tap_weight(erow[le.x], mx, my);
            const uint4 raw = *reinterpret_cast<const uint4*>(
                wrow + static_cast<ptrdiff_t>(le.y) * cstr);
            const __nv_bfloat162* h =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(h[k]);
              z[2 * k] += cm * f.x;
              z[2 * k + 1] += cm * f.y;
            }
          }
          uint4 packed;
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            o2[k] = __floats2bfloat162_rn(z[2 * k], z[2 * k + 1]);
          *reinterpret_cast<uint4*>(zb + static_cast<size_t>(t) * cstr +
                                    v * 8) = packed;
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // the next step's weights into the stage that the previous step has
      // left: they land while this step multiplies and the next z is built
      const int nxt = next_step(cur);
      if (nxt >= 0) fetch_weights(nxt, (it + 1) & 1);
      const bf16* wst = s_w + static_cast<size_t>(it & 1) * l.stage;
      if (cur < T)
        mma_tile<NBW>(zb, cstr, wst, cstr, k_blocks, n_blocks, wm, wn, lane,
                      acc);
      else if (cur == T)
        mma_tile<NBW>(s_win + static_cast<size_t>(p.halo) * cstr, cstr, wst,
                      cstr, k_blocks, n_blocks, wm, wn, lane, acc);
      else
        mma_tile<NBW>(s_xs, csstr, wst, csstr, ks_blocks, n_blocks, wm, wn,
                      lane, sk);
      cur = nxt;
    }

    // epilogue from the accumulator fragments: rows g and g + 8 of the
    // warp's 16, columns 2 (lane % 4) and the next of each block of 8; the
    // pad columns (O and beyond) are not written
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      const int nb = wn * NBW + j;
      if (nb >= n_blocks) continue;
      const int col = og0 + nb * 8 + 2 * (lane & 3);
      if (col >= p.o) continue;
      const float4 ab0 = __ldg(reinterpret_cast<const float4*>(p.ab) + col);
      const float4 ab1 =
          __ldg(reinterpret_cast<const float4*>(p.ab) + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = n0 + wm * 16 + (lane >> 2) + 8 * h;
        if (row >= p.n) continue;
        float y0 = ab0.x * acc[j][2 * h] + ab0.y;
        float y1 = ab1.x * acc[j][2 * h + 1] + ab1.y;
        if (has_skip) {
          y0 += ab0.z * sk[j][2 * h] + ab0.w;
          y1 += ab1.z * sk[j][2 * h + 1] + ab1.w;
        }
        const bool on = p.node_mask[row] != 0;
        y0 = on ? eventad::apply_act(y0, p.act) : 0.f;
        y1 = on ? eventad::apply_act(y1, p.act) : 0.f;
        bf16* dst = p.out + static_cast<long long>(row) * p.o + col;
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
}

template <int TM, int WN, int NBW, int MINB>
int run(const Params& p, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        shift_block_kernel<TM, WN, NBW, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int blocks = (p.n + TM - 1) / TM;
  shift_block_kernel<TM, WN, NBW, MINB>
      <<<blocks, (TM / 16) * WN * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int copy_width(const void* table, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table);
  if (c % 8 == 0 && a % 16 == 0) return 8;
  if (c % 2 == 0 && a % 4 == 0) return 2;
  return 1;
}

// The launch's row tile (returned) and output column group (p->og) for
// p's n, strides, o_pad and tables: by N, 128 rows where that still fills
// three quarters of the SMs, else 32 where that gives a block per SM, else
// 16; a tile that does not fit in shared memory gives way to the next
// smaller one.  128 output columns a group where they fit; the groups of a
// wider O, or of a stage too large for the 16-row tile, are narrower (and
// the launch refuses a layout that still does not fit)
int plan_tiles(Params* p, bool has_skip, int n_sms) {
  const int n = p->n;
  int tm = 4 * ((n + 127) / 128) >= 3 * n_sms ? 128
           : ((n + 31) / 32 >= n_sms ? 32 : 16);
  p->og = min(p->o_pad, 128);
  auto smem_of = [&](int rows) {
    return make_layout(rows, p->cstride, p->csstride, has_skip, p->og,
                       p->halo, p->s_slots, p->nnz, p->n_taps, p->ks).total;
  };
  const size_t limit = static_cast<size_t>(kMaxSmem);
  if (tm == 128 && smem_of(128) > limit) tm = 32;
  if (tm == 32 && smem_of(32) > limit) tm = 16;
  while (tm == 16 && p->og > 8 && smem_of(16) > limit)
    p->og = max(8, p->og / 2 / 8 * 8);
  return tm;
}

}  // namespace

// src [N, C] bf16, u [N, S, 2] f32, mq [N, S] and node_mask [N] of one byte
// each (uint8 or bool), d_offs [S] int32 with halo = max |d_off|, tap_mxy
// [T, 2] / tap_ptr [T+1] / tap_slots [nnz] int32 (the static tap -> slots
// lists), wpack [T+1, OP, CS] bf16 (the used taps of W then root, each
// transposed, CS = pad16(C) + 8, pads zero), ab [OP, 4] f32 (a, b, a_s, b_s),
// xs [N, Cs] bf16 and skpack [OP, CSS] bf16 (NULL without skip) -> out [N,
// O] bf16; OP = O padded to 8 is the packs' row count (wpack [T+1, OP, CS],
// ab [OP, 4], pad rows zero).  O from 1 to 256, T at most 64, ks at most
// 16, S at most 32.
EVENTAD_API int eventad_shift_block(
    const void* src, int c, const void* u, const void* mq,
    const void* node_mask, const void* d_offs, int s_slots, int halo,
    const void* tap_mxy, const void* tap_ptr, const void* tap_slots,
    int n_taps, int nnz, const void* wpack, const void* ab, const void* xs,
    int cs, const void* skpack, int n, int o_ch, int ks, int act,
    void* out, void* stream) {
  if (n == 0) return 0;
  if (o_ch < 1 || o_ch > 256 || n_taps < 0 || n_taps > 64 ||
      ks < 2 || ks > 16 || c < 1 || halo < 0 || s_slots < 1 || s_slots > 32 ||
      (xs != nullptr && cs < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.src = static_cast<const bf16*>(src); p.c = c;
  p.u = static_cast<const float*>(u);
  p.mq = static_cast<const uint8_t*>(mq);
  p.node_mask = static_cast<const uint8_t*>(node_mask);
  p.d_offs = static_cast<const int*>(d_offs);
  p.s_slots = s_slots; p.halo = halo;
  p.tap_mxy = static_cast<const int*>(tap_mxy);
  p.tap_ptr = static_cast<const int*>(tap_ptr);
  p.tap_slots = static_cast<const int*>(tap_slots);
  p.n_taps = n_taps; p.nnz = nnz;
  p.wpack = static_cast<const bf16*>(wpack);
  p.ab = static_cast<const float*>(ab);
  p.xs = static_cast<const bf16*>(xs); p.cs = xs != nullptr ? cs : 0;
  p.skpack = static_cast<const bf16*>(skpack);
  p.n = n; p.o = o_ch; p.ks = ks; p.act = act;
  p.o_pad = (o_ch + 7) / 8 * 8;
  p.out = static_cast<bf16*>(out);
  p.cstride = pad_stride(c);
  p.csstride = xs != nullptr ? pad_stride(cs) : 8;
  p.src_vw = copy_width(src, c);
  p.xs_vw = xs != nullptr ? copy_width(xs, cs) : 1;

  int n_sms = 0;
  const cudaError_t e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tm = plan_tiles(&p, xs != nullptr, n_sms);
  const size_t smem = make_layout(tm, p.cstride, p.csstride, xs != nullptr,
                                  p.og, halo, s_slots, nnz, n_taps,
                                  ks).total;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm == 128) return run<128, 2, 8, 1>(p, smem, s);
  if (tm == 32) return run<32, 8, 2, 2>(p, smem, s);
  return run<16, 16, 1, 2>(p, smem, s);
}

// The row tile and output column group eventad_shift_block picks for these
// sizes (cs 0: no skip), into plan[0] and plan[1] (host memory).
EVENTAD_API int eventad_shift_plan(int n, int c, int cs, int o_ch, int halo,
                                   int s_slots, int nnz, int n_taps, int ks,
                                   void* plan, void* stream) {
  (void)stream;
  if (o_ch < 1 || o_ch > 256 || c < 1 || cs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n = n; p.halo = halo; p.s_slots = s_slots; p.nnz = nnz;
  p.n_taps = n_taps; p.ks = ks;
  p.o_pad = (o_ch + 7) / 8 * 8;
  p.cstride = pad_stride(c);
  p.csstride = cs > 0 ? pad_stride(cs) : 8;
  int n_sms = 0;
  const cudaError_t e = sm_count(&n_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* out = static_cast<int*>(plan);
  out[0] = plan_tiles(&p, cs > 0, n_sms);
  out[1] = p.og;
  return 0;
}
