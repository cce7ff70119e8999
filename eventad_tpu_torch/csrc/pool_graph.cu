// K8: graph pooling into the voxel-cell grid, ops/pooling.pool_graph.
//
// Replaces no TPU kernel: the JAX package's pool_graph
// (eventad_tpu/ops/pooling.py) is jnp code that XLA lowers and fuses into a
// few scatters.  PyTorch runs the same formulation eagerly as about 115
// small operations a call (elementwise ops, index_add_, scatter_reduce_,
// arange, stack, pad), and on the H100 their host dispatch, not the card,
// is the cost.  Every output depends only on per-cell sums, counts, maxima
// and an OR of offset bits, and on grid arithmetic that needs no table, so
// one fill and two passes compute all of it:
//
//   fill   one cudaMemsetAsync zeroes the workspace: a record of kCellWords
//          words per cell (the position sums x, y, t in f32, the node count,
//          the bitmap of source-cell offsets, the temporal max) and C words
//          of channel max (an order-preserving uint32, 0 = empty) or f32
//          channel sum (aggr 'mean');
//   nodes  a warp per node works out its cell as _cells does (clamp, then
//          floor(p * n) in f32); where the node is valid its lanes read its
//          K' edges' source cells (from pos_src, or through nbr with the
//          same-batch test), OR their offset bits across the warp, and
//          lane 0 adds its position and a count and ORs the bits into the
//          cell's record; each lane takes every 32nd channel into the
//          cell's max (atomicMax, only where a read shows it would grow) or
//          sum (f32 atomicAdd, as index_add_ on the card adds);
//   cells  a warp per cell writes the pooled position (_round_to_pixel of
//          the mean: IEEE division, no contraction, each rounding where the
//          plain formulation rounds on the card), `active`, the channels
//          (decoded, non-finite to 0, 0 where inactive, in x's type) and
//          the batch column; lane
//          s < 25 the slot's field-of-view test, the neighbour cell, its
//          activity and temporal max from the workspace, the edge mask and
//          index, and with pos_nbr the neighbour's pooled position,
//          recomputed from its record by the same expression (0 outside the
//          grid), which is neighbor_rows' pad, slices and stack.
//
// Max, count and OR do not depend on the order of the atomics, so the
// features, masks and indices equal the plain version's; the sums are f32
// atomics, as the plain version's index_add_ on the card.
//
// What bounds it on the H100: bytes, inputs once and outputs once (x and
// the edge tables of the node pass dominate), a few MB a call; the atomics
// go to distinct words unless nodes crowd a cell, where the read before
// atomicMax leaves few of them.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellWords = 8;     // keep equal to ops/pooling.CELL_WORDS
constexpr int kMaxSpan = 2;       // (2 span + 1)^2 offsets fit 32 bits

// torch.clamp(p, 0.0, 0.9999999) and the 1e-5 of _round_to_pixel: the
// Python constants rounded to f32, as PyTorch rounds a scalar for an f32
// tensor
__device__ __forceinline__ float clamp_cell(float p) {
  return fminf(fmaxf(p, 0.f), __uint_as_float(0x3f7ffffeu));
}
__device__ __forceinline__ float round_eps() {
  return __uint_as_float(0x3727c5acu);
}

// the column (or row) of a coordinate in a grid of n: floor(clamp(p) * n)
__device__ __forceinline__ int cell_of(float p, int n) {
  return static_cast<int>(floorf(__fmul_rn(clamp_cell(p),
                                           static_cast<float>(n))));
}

// _round_to_pixel(sum / cnt, size): floor((mean + 1e-5) * size) / size,
// each step rounded on its own, the last as PyTorch divides a tensor by a
// scalar on the card: times the scalar's f32 reciprocal (on the CPU it
// divides; the two may differ in the last place)
__device__ __forceinline__ float pixel_mean(float sum, float cnt, int size) {
  const float s = static_cast<float>(size);
  return __fmul_rn(floorf(__fmul_rn(__fadd_rn(__fdiv_rn(sum, cnt),
                                              round_eps()), s)),
                   __fdiv_rn(1.f, s));
}

// f32 <-> uint32 whose unsigned order is the floats' order (+0 above -0);
// 0 is the word 0xffffffff (a NaN), so a zeroed word means "empty"
__device__ __forceinline__ uint32_t order_enc(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_dec(uint32_t e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

__device__ __forceinline__ void max_into(uint32_t* word, float v) {
  const uint32_t e = order_enc(v);
  if (e > __ldcg(word)) atomicMax(word, e);
}

struct Params {
  const void* x;              // [n, c] f32 or bf16
  const float* pos;           // [n, 3]
  const int* nbr;             // [n, k], rows nbr_stride apart
  const uint8_t* nbr_mask;    // [n, k], rows mask_stride apart
  const uint8_t* node_mask;   // [n]
  const int* batch;           // [n]
  const float* pos_src;       // [n, k, 2] (rows ps_row, slots ps_slot
                              // apart) or null: read through nbr
  int n, c, k, nbr_stride, mask_stride, ps_row, ps_slot;
  int nx, ny, batch_size, width, height, mean, temporal, span, x_bf16;
  uint32_t* rec;              // [m, kCellWords]
  uint32_t* feat;             // [m, c]
  void* out_x;                // [m, c] in x's type
  float* out_pos;             // [m, 3]
  int* out_nbr;               // [m, S]
  uint8_t* out_mask;          // [m, S]
  uint8_t* out_active;        // [m]
  int* out_batch;             // [m]
  float* out_pos_nbr;         // [m, S, 2] or null
};

__global__ void __launch_bounds__(kThreads) pool_nodes_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long node =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  // uniform over the warp: one node a warp
  if (node >= p.n || !p.node_mask[node]) return;
  const int b = p.batch[node];
  if (b < 0 || b >= p.batch_size) return;
  const int ix = cell_of(p.pos[3 * node], p.nx);
  const int iy = cell_of(p.pos[3 * node + 1], p.ny);
  const int side = 2 * p.span + 1;

  uint32_t bits = 0;
  for (int s = lane; s < p.k; s += 32) {
    if (!p.nbr_mask[node * p.mask_stride + s]) continue;
    int rx, ry;
    if (p.pos_src != nullptr) {
      const float* q = p.pos_src + node * p.ps_row +
                       static_cast<long long>(s) * p.ps_slot;
      rx = cell_of(q[0], p.nx) - ix;
      ry = cell_of(q[1], p.ny) - iy;
    } else {
      const int j = p.nbr[node * p.nbr_stride + s];
      if (j < 0 || j >= p.n || !p.node_mask[j] || p.batch[j] != b) continue;
      rx = cell_of(p.pos[3LL * j], p.nx) - ix;
      ry = cell_of(p.pos[3LL * j + 1], p.ny) - iy;
    }
    if ((rx == 0 && ry == 0) || abs(rx) > p.span || abs(ry) > p.span)
      continue;
    bits |= 1u << ((ry + p.span) * side + rx + p.span);
  }
  bits = __reduce_or_sync(0xffffffffu, bits);

  const long long cell = (static_cast<long long>(b) * p.ny + iy) * p.nx + ix;
  uint32_t* rec = p.rec + cell * kCellWords;
  if (lane == 0) {
    float* sum = reinterpret_cast<float*>(rec);
    atomicAdd(sum, p.pos[3 * node]);
    atomicAdd(sum + 1, p.pos[3 * node + 1]);
    atomicAdd(sum + 2, p.pos[3 * node + 2]);
    atomicAdd(rec + 3, 1u);
    if (bits) atomicOr(rec + 4, bits);
    if (p.temporal) max_into(rec + 5, p.pos[3 * node + 2]);
  }
  uint32_t* feat = p.feat + cell * p.c;
  const long long row = node * p.c;
  for (int ch = lane; ch < p.c; ch += 32) {
    const float v =
        p.x_bf16 ? eventad::bf(static_cast<const __nv_bfloat16*>(p.x)[row + ch])
                 : static_cast<const float*>(p.x)[row + ch];
    if (p.mean)
      atomicAdd(reinterpret_cast<float*>(feat + ch), v);
    else
      max_into(feat + ch, v);
  }
}

__global__ void __launch_bounds__(kThreads)
pool_cells_kernel(const Params p, long long m) {
  const int lane = threadIdx.x & 31;
  const long long cell =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (cell >= m) return;
  const uint32_t* rec = p.rec + cell * kCellWords;
  const uint32_t count = rec[3];
  const bool active = count > 0;
  const float cnt = fmaxf(static_cast<float>(count), 1.f);
  const long long ncells = static_cast<long long>(p.nx) * p.ny;
  const int cx = static_cast<int>(cell % p.nx);
  const int cy = static_cast<int>((cell / p.nx) % p.ny);
  const long long cb = cell / ncells;

  const uint32_t* feat = p.feat + cell * p.c;
  for (int ch = lane; ch < p.c; ch += 32) {
    const uint32_t w = feat[ch];
    float v;
    if (p.mean) {
      v = __fdiv_rn(__uint_as_float(w), cnt);
    } else {
      v = w ? order_dec(w) : 0.f;
      if (!isfinite(v)) v = 0.f;
    }
    if (!active) v = 0.f;
    if (p.x_bf16)
      static_cast<__nv_bfloat16*>(p.out_x)[cell * p.c + ch] =
          __float2bfloat16_rn(v);
    else
      static_cast<float*>(p.out_x)[cell * p.c + ch] = v;
  }
  if (lane == 0) {
    const float* sum = reinterpret_cast<const float*>(rec);
    p.out_pos[3 * cell] = pixel_mean(sum[0], cnt, p.width);
    p.out_pos[3 * cell + 1] = pixel_mean(sum[1], cnt, p.height);
    p.out_pos[3 * cell + 2] = __fdiv_rn(sum[2], cnt);
    p.out_active[cell] = active;
    p.out_batch[cell] = static_cast<int>(cb);
  }

  const int side = 2 * p.span + 1, slots = side * side;
  if (lane >= slots) return;
  const int sx = cx + lane % side - p.span;
  const int sy = cy + lane / side - p.span;
  const bool in_fov = sx >= 0 && sx < p.nx && sy >= 0 && sy < p.ny;
  const long long ncell = cb * ncells +
                          static_cast<long long>(min(max(sy, 0), p.ny - 1)) *
                              p.nx +
                          min(max(sx, 0), p.nx - 1);
  const uint32_t* nrec = p.rec + ncell * kCellWords;
  bool on = active && in_fov && ((rec[4] >> lane) & 1u);
  if (on) {
    on = nrec[3] > 0;
    if (on && p.temporal) on = order_dec(rec[5]) > order_dec(nrec[5]);
  }
  const long long o = cell * slots + lane;
  p.out_mask[o] = on;
  p.out_nbr[o] = on ? static_cast<int>(ncell) : 0;
  if (p.out_pos_nbr != nullptr) {
    float qx = 0.f, qy = 0.f;
    if (in_fov) {
      const float* nsum = reinterpret_cast<const float*>(nrec);
      const float ncnt = fmaxf(static_cast<float>(nrec[3]), 1.f);
      qx = pixel_mean(nsum[0], ncnt, p.width);
      qy = pixel_mean(nsum[1], ncnt, p.height);
    }
    p.out_pos_nbr[2 * o] = qx;
    p.out_pos_nbr[2 * o + 1] = qy;
  }
}

}  // namespace

// x [n, c] f32 or bf16 (x_bf16), pos [n, 3] f32, nbr [n, k] int32 and
// nbr_mask [n, k] bool with rows nbr_stride / mask_stride elements apart,
// node_mask [n] bool, batch [n] int32, pos_src [n, k, 2] f32 (rows ps_row,
// slots ps_slot elements apart) or null; dims = (n, c, k, nbr_stride,
// mask_stride, ps_row, ps_slot, nx, ny, batch_size, width, height, mean,
// temporal, span, x_bf16); work: m (kCellWords + c) 32-bit words, m =
// batch_size nx ny below 2^31 -> out_x [m, c] in x's type, out_pos [m, 3]
// f32, out_nbr [m, S] int32, out_mask [m, S] bool, out_active [m] bool,
// out_batch [m] int32, out_pos_nbr [m, S, 2] f32 or null; S = (2 span +
// 1)^2.  One memset and two launches.
EVENTAD_API int eventad_pool_graph(const void* x, const void* pos,
                                   const void* nbr, const void* nbr_mask,
                                   const void* node_mask, const void* batch,
                                   const void* pos_src, const int* dims,
                                   void* work, void* out_x, void* out_pos,
                                   void* out_nbr, void* out_mask,
                                   void* out_active, void* out_batch,
                                   void* out_pos_nbr, void* stream) {
  Params p;
  p.n = dims[0];
  p.c = dims[1];
  p.k = dims[2];
  p.nbr_stride = dims[3];
  p.mask_stride = dims[4];
  p.ps_row = dims[5];
  p.ps_slot = dims[6];
  p.nx = dims[7];
  p.ny = dims[8];
  p.batch_size = dims[9];
  p.width = dims[10];
  p.height = dims[11];
  p.mean = dims[12];
  p.temporal = dims[13];
  p.span = dims[14];
  p.x_bf16 = dims[15];
  const long long m = static_cast<long long>(p.batch_size) * p.nx * p.ny;
  if (p.n < 0 || p.c < 1 || p.k < 0 || p.nx < 1 || p.ny < 1 ||
      p.batch_size < 1 || p.width < 1 || p.height < 1 || p.span < 0 ||
      p.span > kMaxSpan || m >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = x;
  p.pos = static_cast<const float*>(pos);
  p.nbr = static_cast<const int*>(nbr);
  p.nbr_mask = static_cast<const uint8_t*>(nbr_mask);
  p.node_mask = static_cast<const uint8_t*>(node_mask);
  p.batch = static_cast<const int*>(batch);
  p.pos_src = static_cast<const float*>(pos_src);
  p.rec = static_cast<uint32_t*>(work);
  p.feat = p.rec + m * kCellWords;
  p.out_x = out_x;
  p.out_pos = static_cast<float*>(out_pos);
  p.out_nbr = static_cast<int*>(out_nbr);
  p.out_mask = static_cast<uint8_t*>(out_mask);
  p.out_active = static_cast<uint8_t*>(out_active);
  p.out_batch = static_cast<int*>(out_batch);
  p.out_pos_nbr = static_cast<float*>(out_pos_nbr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      work, 0, static_cast<size_t>(m) * (kCellWords + p.c) * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = kThreads / 32;
  if (p.n > 0) {
    pool_nodes_kernel<<<static_cast<unsigned>((p.n + per_block - 1) /
                                              per_block),
                        kThreads, 0, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pool_cells_kernel<<<static_cast<unsigned>((m + per_block - 1) / per_block),
                      kThreads, 0, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}
