// K3: one pooled-level conv block (spline conv over the cell grid, root,
// eval-BN affine, optional linear skip with its BN, activation, node mask).
//
// Replaces eventad_tpu/ops/spline_shift.py:_shift_kernel (driven by
// shift_spline_conv, operands from prepare_shift / tap_windows).  At pooled
// levels slot s of cell n is cell n + d_off[s] of the same table, and an
// edge exists only where the edge mask mq[n, s] is set; shifted reads that
// cross a grid row or an item boundary are always masked.  Per slot, the
// static tap window of tap_windows bounds the taps its attrs can reach, so
// each tap m has a static list of contributing slots (the host builds it
// once per geometry).  Per destination n and output channel o:
//
//   z_m[n, :] = sum_{s in slots(m), mq[n,s]} cy[my] cx[mx] * src[n + d_off[s]]
//   acc       = sum_m z_m[n, :] . W[m][:, o] + src[n] . root[:, o]
//   out[n, o] = bf16(act(a acc + b (+ a_s (xs[n] . skip[:, o]) + b_s)) mask)
//
// What bounds it on the H100: latency more than operations.  At level 1
// (13 440 cells, 82 or 64 input channels, 64 outputs, 25 taps) the tap
// products are ~2 GFLOP per launch against a few MB of traffic, but levels
// 3 and 4 have only 840 and 210 cells, and every block walks all 25 taps
// one after the other.  Design: a block owns max(8, 256 / O) destinations
// (8 at O = 64), so even level 4 spreads over 27 blocks.  Per tap it builds
// z_m for its rows in shared memory (threads over (row, channel), direct
// loads of the shifted rows, edges with mq = 0 skipped so a masked source
// row is never read), then every thread adds z_m . W[m][:, o] for a fixed o
// and rows * O / 256 rows, reusing each weight it loads across those rows.
// f32 FMAs on the CUDA cores; the tap products on tensor cores are later
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 4;       // rows per thread: rows * O / kThreads

// destinations per block: at least 8, and enough that every thread owns
// one (row, output channel) pair
inline int block_rows(int o_ch) { return o_ch >= 32 ? 8 : kThreads / o_ch; }

__global__ void __launch_bounds__(kThreads) shift_block_kernel(
    const __nv_bfloat16* __restrict__ src, int c,
    const float* __restrict__ u, const uint8_t* __restrict__ mq,
    const uint8_t* __restrict__ node_mask, const int* __restrict__ d_offs,
    int s_slots, const int* __restrict__ tap_mxy,
    const int* __restrict__ tap_ptr, const int* __restrict__ tap_slots,
    int n_taps, const float* __restrict__ w_sel,
    const float* __restrict__ root, const float* __restrict__ ab,
    const __nv_bfloat16* __restrict__ xs, int cs,
    const float* __restrict__ skip_lin, int n, int o_ch, int ks, int act,
    int rows, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_z = smem;                                   // [rows, c]
  float* s_fx = s_z + rows * c;                        // [rows, S]
  float* s_fy = s_fx + rows * s_slots;
  int* s_ix = reinterpret_cast<int*>(s_fy + rows * s_slots);
  int* s_iy = s_ix + rows * s_slots;                   // -1: no edge

  const int n0 = blockIdx.x * rows;
  for (int i = threadIdx.x; i < rows * s_slots; i += blockDim.x) {
    const int t = i / s_slots, s = i % s_slots, row = n0 + t;
    int ix = -1, iy = -1;
    float fx = 0.f, fy = 0.f;
    if (row < n && mq[static_cast<long long>(row) * s_slots + s]) {
      const long long e = static_cast<long long>(row) * s_slots + s;
      eventad::spline_taps(u[2 * e], ks, &ix, &fx);
      eventad::spline_taps(u[2 * e + 1], ks, &iy, &fy);
    }
    s_ix[i] = ix;
    s_iy[i] = iy;
    s_fx[i] = fx;
    s_fy[i] = fy;
  }

  const int groups = kThreads / o_ch;        // row groups of the o threads
  const int q_rows = rows / groups;          // rows per thread
  const int o = threadIdx.x % o_ch;
  const int t0 = threadIdx.x / o_ch;
  float acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
  __syncthreads();

  for (int m = 0; m < n_taps; ++m) {
    const int mx = tap_mxy[2 * m], my = tap_mxy[2 * m + 1];
    const int p0 = tap_ptr[m], p1 = tap_ptr[m + 1];
    for (int i = threadIdx.x; i < rows * c; i += blockDim.x) {
      const int t = i / c, ci = i % c, row = n0 + t;
      float z = 0.f;
      if (row < n) {
        for (int p = p0; p < p1; ++p) {
          const int s = tap_slots[p];
          const int ce = t * s_slots + s;
          const int ix = s_ix[ce];
          if (ix < 0) continue;
          const int iy = s_iy[ce];
          const float wx = ix == mx ? 1.f - s_fx[ce]
                                    : (ix + 1 == mx ? s_fx[ce] : 0.f);
          const float wy = iy == my ? 1.f - s_fy[ce]
                                    : (iy + 1 == my ? s_fy[ce] : 0.f);
          const float cm = wx * wy;
          const int j = row + d_offs[s];
          if (cm != 0.f && j >= 0 && j < n)
            z += cm * eventad::bf(src[static_cast<long long>(j) * c + ci]);
        }
      }
      s_z[i] = z;
    }
    __syncthreads();
    const float* wm = w_sel + static_cast<long long>(m) * c * o_ch + o;
    for (int ci = 0; ci < c; ++ci) {
      const float w = __ldg(wm + ci * o_ch);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < q_rows) acc[q] += s_z[(t0 + q * groups) * c + ci] * w;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    if (q >= q_rows) continue;
    const int row = n0 + t0 + q * groups;
    if (row >= n) continue;
    const __nv_bfloat16* xo = src + static_cast<long long>(row) * c;
    float a = acc[q];
    for (int ci = 0; ci < c; ++ci)
      a += eventad::bf(xo[ci]) * __ldg(root + ci * o_ch + o);
    float pre = ab[4 * o] * a + ab[4 * o + 1];
    if (xs != nullptr) {
      const __nv_bfloat16* xr = xs + static_cast<long long>(row) * cs;
      float sk = 0.f;
      for (int ci = 0; ci < cs; ++ci)
        sk += eventad::bf(xr[ci]) * __ldg(skip_lin + ci * o_ch + o);
      pre += ab[4 * o + 2] * sk + ab[4 * o + 3];
    }
    const float y = node_mask[row] ? eventad::apply_act(pre, act) : 0.f;
    out[static_cast<long long>(row) * o_ch + o] = __float2bfloat16(y);
  }
}

}  // namespace

// src [N, C] bf16, u [N, S, 2] f32, mq [N, S] uint8, node_mask [N] uint8,
// d_offs [S] int32, tap_mxy [T, 2] / tap_ptr [T+1] / tap_slots [nnz] int32
// (the static tap -> slots lists), w_sel [T, C, O] f32, root [C, O] f32, ab
// [O, 4] f32, xs [N, Cs] bf16 and skip_lin [Cs, O] f32 (NULL without skip)
// -> out [N, O] bf16.  O must divide 256 and lie in [8, 128].
EVENTAD_API int eventad_shift_block(
    const void* src, int c, const void* u, const void* mq,
    const void* node_mask, const void* d_offs, int s_slots,
    const void* tap_mxy, const void* tap_ptr, const void* tap_slots,
    int n_taps, const void* w_sel, const void* root, const void* ab,
    const void* xs, int cs, const void* skip_lin, int n, int o_ch, int ks,
    int act, void* out, void* stream) {
  if (n == 0) return 0;
  if (o_ch < 8 || o_ch > 128 || kThreads % o_ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = block_rows(o_ch);
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) *
                      (c + 4 * static_cast<size_t>(s_slots));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shift_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + rows - 1) / rows;
  shift_block_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), c, static_cast<const float*>(u),
      static_cast<const uint8_t*>(mq), static_cast<const uint8_t*>(node_mask),
      static_cast<const int*>(d_offs), s_slots,
      static_cast<const int*>(tap_mxy), static_cast<const int*>(tap_ptr),
      static_cast<const int*>(tap_slots), n_taps,
      static_cast<const float*>(w_sel), static_cast<const float*>(root),
      static_cast<const float*>(ab), static_cast<const __nv_bfloat16*>(xs), cs,
      static_cast<const float*>(skip_lin), n, o_ch, ks, act, rows,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
