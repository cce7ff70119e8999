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
//   acc = sum_k sum_{taps (mx,my) of edge k in the sub-rectangle}
//           cy[my] cx[mx] * (src[nbr[n,k]] . W[my*nxs+mx][:, o])
//         + src[n] . root[:, o]
//   pre = a[o] acc + b[o]  (+ a_s[o] (xs[n] . skip[:, o]) + b_s[o])
//   out[n, o] = bf16(act(pre) * node_mask[n])
//
// The self edge is folded into root by the caller (slot 0 is dropped), and
// the taps are the static sub-rectangle of tap_ranges(level0_attr_range)
// (3 x 5 of the 5 x 5 kernel at 360 x 240).  f32 accumulation.
//
// What bounds it on the H100: bytes.  The level-0 graph is sparse in time
// (about 0.15 edges per event at the operating point), so per row the work
// is the root product (19 x 16 FMAs) and the traffic a 38 B source row in and
// a 32 B row out.  Design: one thread per (row, output channel); the tap and
// root weights sit in shared memory as f32; the edge loop skips empty slots,
// and each present edge touches only its 2 x 2 taps (degree-1 spline) with a
// direct indexed load of the source row.  The TPU's one-hot-on-MXU gather is
// a TPU workaround and is not carried.
#include "common.cuh"

namespace {

__global__ void level0_block_kernel(
    const __nv_bfloat16* __restrict__ src, int c,
    const int* __restrict__ nbr, int k, const float* __restrict__ u,
    const float* __restrict__ w_sub, const float* __restrict__ root,
    const float* __restrict__ ab, const __nv_bfloat16* __restrict__ xs,
    int cs, const float* __restrict__ skip_lin,
    const uint8_t* __restrict__ node_mask, int n, int o_ch, int ks, int mx0,
    int nxs, int my0, int nys, int act, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  const int m_sub = nxs * nys;
  float* s_w = smem;                         // [m_sub, c, o]
  float* s_root = s_w + m_sub * c * o_ch;    // [c, o]
  float* s_skip = s_root + c * o_ch;         // [cs, o]
  const int n_w = m_sub * c * o_ch;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) s_w[i] = w_sub[i];
  for (int i = threadIdx.x; i < c * o_ch; i += blockDim.x) s_root[i] = root[i];
  if (xs != nullptr)
    for (int i = threadIdx.x; i < cs * o_ch; i += blockDim.x)
      s_skip[i] = skip_lin[i];
  __syncthreads();

  const int rows_per_block = blockDim.x / o_ch;
  const int o = threadIdx.x % o_ch;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / o_ch;
  if (threadIdx.x >= rows_per_block * o_ch || row >= n) return;

  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const long long e = static_cast<long long>(row) * k + kk;
    const int j = nbr[e];
    if (j < 0) continue;
    int ix0, iy0;
    float frx, fry;
    eventad::spline_taps(u[2 * e], ks, &ix0, &frx);
    eventad::spline_taps(u[2 * e + 1], ks, &iy0, &fry);
    const __nv_bfloat16* xj = src + static_cast<long long>(j) * c;
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      const int my = iy0 + by - my0;
      if (my < 0 || my >= nys) continue;
      const float wy = by ? fry : 1.f - fry;
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        const int mx = ix0 + bx - mx0;
        if (mx < 0 || mx >= nxs) continue;
        const float wx = bx ? frx : 1.f - frx;
        const float* wm = s_w + (my * nxs + mx) * c * o_ch + o;
        float dot = 0.f;
        for (int ci = 0; ci < c; ++ci)
          dot += eventad::bf(xj[ci]) * wm[ci * o_ch];
        acc += wy * wx * dot;
      }
    }
  }
  const __nv_bfloat16* xo = src + static_cast<long long>(row) * c;
  for (int ci = 0; ci < c; ++ci)
    acc += eventad::bf(xo[ci]) * s_root[ci * o_ch + o];
  float pre = ab[4 * o] * acc + ab[4 * o + 1];
  if (xs != nullptr) {
    const __nv_bfloat16* xr = xs + static_cast<long long>(row) * cs;
    float sk = 0.f;
    for (int ci = 0; ci < cs; ++ci)
      sk += eventad::bf(xr[ci]) * s_skip[ci * o_ch + o];
    pre += ab[4 * o + 2] * sk + ab[4 * o + 3];
  }
  const float y = node_mask[row] ? eventad::apply_act(pre, act) : 0.f;
  out[static_cast<long long>(row) * o_ch + o] = __float2bfloat16(y);
}

}  // namespace

// src [N, C] bf16, nbr [N, K] int32 (absolute rows, -1 = no edge), u [N, K,
// 2] f32, w_sub [nxs*nys, C, O] f32, root [C, O] f32, ab [O, 4] f32 (a, b,
// a_s, b_s), xs [N, Cs] bf16 and skip_lin [Cs, O] f32 (both NULL without
// skip), node_mask [N] uint8 -> out [N, O] bf16.
EVENTAD_API int eventad_level0_block(
    const void* src, int c, const void* nbr, int k, const void* u,
    const void* w_sub, const void* root, const void* ab, const void* xs,
    int cs, const void* skip_lin, const void* node_mask, int n, int o_ch,
    int ks, int mx0, int nxs, int my0, int nys, int act, void* out,
    void* stream) {
  if (n == 0) return 0;
  if (o_ch < 1 || o_ch > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = 256 / o_ch;
  const int threads = rows_per_block * o_ch;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(nxs) * nys * c * o_ch +
                       static_cast<size_t>(c) * o_ch +
                       (xs != nullptr ? static_cast<size_t>(cs) * o_ch : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        level0_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  level0_block_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), c, static_cast<const int*>(nbr),
      k, static_cast<const float*>(u), static_cast<const float*>(w_sub),
      static_cast<const float*>(root), static_cast<const float*>(ab),
      static_cast<const __nv_bfloat16*>(xs), cs,
      static_cast<const float*>(skip_lin),
      static_cast<const uint8_t*>(node_mask), n, o_ch, ks, mx0, nxs, my0, nys,
      act, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
