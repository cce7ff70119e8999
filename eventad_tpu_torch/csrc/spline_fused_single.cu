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
// taps per edge).  src and W are bf16, z is rounded to bf16 before the tap
// product, sums and the output are f32: the rounding points of the TPU
// kernel.  Root product, bias, BN, activation and mask stay with the caller.
//
// The TPU kernel gathers through one-hot products over a chunked, transposed
// window of the source because a TPU gather costs a memory tile per index;
// none of that is carried.  The source is complete before the launch, so a
// neighbour after its destination is an indexed load like any other.
//
// What bounds it on the H100: operations on the pooled levels (25 taps of
// C x O per row, e.g. 13 440 x 25 x 82 x 64 multiply-adds at level 1), bytes
// at level 0, where most rows have no edge at all.  Design: a block owns R
// destinations (8, or 4 or 2 where the table is small, so that levels of a
// few hundred rows still fill the card).
//   1. Every slot's index, taps and fractions go to shared memory once; an
//      empty slot (-1) costs one load and is never used as an address.  A
//      block without any edge writes zeros and ends.
//   2. z for all taps is accumulated in shared memory, one thread per
//      (row, channel) walking its row's edges in slot order, then rounded to
//      bf16 in place.  Layout [tap][channel / 4][row][channel % 4]: a warp of
//      4 channels x 8 rows touches 32 consecutive words, and step 3 reads
//      four channels of one row as one 16-byte word.
//   3. The tap product on the CUDA cores: thread (g, o) walks every G-th
//      (tap, channel quad) of the taps that some edge of the block touched,
//      loads four W values (a warp reads consecutive o) and the R z quads (a
//      broadcast), and keeps R sums in registers; the G partial sums meet in
//      shared memory.  W is read once per block.
#include "common.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(512) fused_conv_kernel(
    const __nv_bfloat16* __restrict__ src, int c,
    const int* __restrict__ nbr, int k, const float* __restrict__ u,
    const __nv_bfloat16* __restrict__ w_sub, int n, int o_ch, int ks, int mx0,
    int nxs, int my0, int nys, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m_sub = nxs * nys;
  const int cq = (c + 3) / 4;
  const int zs = cq * R * 4;                     // one tap's z
  float* s_z = reinterpret_cast<float*>(smem4);  // [m_sub][cq][R][4]
  float* s_red = s_z + m_sub * zs;               // [G][R][o_ch]
  int* s_j = reinterpret_cast<int*>(s_red + nt * R);   // [R][k]
  int* s_lx = s_j + R * k;                       // floor tap - mx0
  int* s_ly = s_lx + R * k;
  float* s_fx = reinterpret_cast<float*>(s_ly + R * k);
  float* s_fy = s_fx + R * k;
  int* s_used = reinterpret_cast<int*>(s_fy + R * k);  // [m_sub]
  int* s_taps = s_used + m_sub;   // the used taps, then their count
  const int row0 = blockIdx.x * R;

  for (int i = tid; i < m_sub * zs; i += nt) s_z[i] = 0.f;
  for (int i = tid; i < m_sub; i += nt) s_used[i] = 0;
  __syncthreads();

  // 1. the block's slots
  int any = 0;
  for (int e = tid; e < R * k; e += nt) {
    const int row = row0 + e / k;
    int j = -1;
    if (row < n) {
      const long long ge = static_cast<long long>(row) * k + e % k;
      j = nbr[ge];
      if (j >= n) j = -1;
      if (j >= 0) {
        int ix0, iy0;
        float frx, fry;
        eventad::spline_taps(u[2 * ge], ks, &ix0, &frx);
        eventad::spline_taps(u[2 * ge + 1], ks, &iy0, &fry);
        s_lx[e] = ix0 - mx0;
        s_ly[e] = iy0 - my0;
        s_fx[e] = frx;
        s_fy[e] = fry;
        for (int by = 0; by < 2; ++by) {
          const int my = iy0 - my0 + by;
          if (my < 0 || my >= nys || (by ? fry : 1.f - fry) == 0.f) continue;
          for (int bx = 0; bx < 2; ++bx) {
            const int mx = ix0 - mx0 + bx;
            if (mx < 0 || mx >= nxs || (bx ? frx : 1.f - frx) == 0.f) continue;
            s_used[my * nxs + mx] = 1;
          }
        }
        any = 1;
      }
    }
    s_j[e] = j;
  }
  any = __syncthreads_or(any);
  if (!any) {
    for (int i = tid; i < R * o_ch; i += nt) {
      const int row = row0 + i / o_ch;
      if (row < n) out[static_cast<long long>(row) * o_ch + i % o_ch] = 0.f;
    }
    return;
  }
  if (tid == 0) {
    int cnt = 0;
    for (int m = 0; m < m_sub; ++m)
      if (s_used[m]) s_taps[cnt++] = m;
    s_taps[m_sub] = cnt;
  }

  // 2. z, f32 sums in slot order, then one bf16 rounding
  for (int idx = tid; idx < zs; idx += nt) {
    const int c4 = idx & 3, r = (idx >> 2) % R, q = idx / (4 * R);
    const int ch = q * 4 + c4;
    if (ch >= c) continue;
    float* zc = s_z + (q * R + r) * 4 + c4;
    for (int kk = 0; kk < k; ++kk) {
      const int e = r * k + kk;
      const int j = s_j[e];
      if (j < 0) continue;
      const float x = eventad::bf(src[static_cast<long long>(j) * c + ch]);
      const int lx = s_lx[e], ly = s_ly[e];
      const float fx = s_fx[e], fy = s_fy[e];
#pragma unroll
      for (int by = 0; by < 2; ++by) {
        const int my = ly + by;
        if (my < 0 || my >= nys) continue;
        const float wy = by ? fy : 1.f - fy;
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
          const int mx = lx + bx;
          if (mx < 0 || mx >= nxs) continue;
          const float wx = bx ? fx : 1.f - fx;
          zc[(my * nxs + mx) * zs] += wy * wx * x;
        }
      }
    }
    for (int m = 0; m < m_sub; ++m)
      if (s_used[m])
        zc[m * zs] = eventad::bf(__float2bfloat16(zc[m * zs]));
  }
  __syncthreads();

  // 3. the tap product
  const int o = tid % o_ch, g = tid / o_ch, n_g = nt / o_ch;
  if (g < n_g) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float4* z4 = reinterpret_cast<const float4*>(s_z);
    const int n_q = s_taps[m_sub] * cq;
#pragma unroll 4
    for (int i = g; i < n_q; i += n_g) {
      const int t = i / cq;
      const int m = s_taps[t];
      const int c0 = (i - t * cq) * 4;
      const int q = m * cq + (i - t * cq);
      const __nv_bfloat16* wq =
          w_sub + (static_cast<long long>(m) * c + c0) * o_ch + o;
      const float w0 = eventad::bf(wq[0]);
      const float w1 = c0 + 1 < c ? eventad::bf(wq[o_ch]) : 0.f;
      const float w2 = c0 + 2 < c ? eventad::bf(wq[2 * o_ch]) : 0.f;
      const float w3 = c0 + 3 < c ? eventad::bf(wq[3 * o_ch]) : 0.f;
      const float4* zq = z4 + q * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 z = zq[r];
        acc[r] += z.x * w0 + z.y * w1 + z.z * w2 + z.w * w3;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_red[(g * R + r) * o_ch + o] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < R * o_ch; i += nt) {
    const int r = i / o_ch, oo = i % o_ch;
    const int row = row0 + r;
    if (row >= n) continue;
    float s = 0.f;
    for (int gg = 0; gg < n_g; ++gg) s += s_red[(gg * R + r) * o_ch + oo];
    out[static_cast<long long>(row) * o_ch + oo] = s;
  }
}

template <int R>
int launch_fused_conv(const void* src, int c, const void* nbr, int k,
                      const void* u, const void* w_sub, int n, int o_ch,
                      int ks, int mx0, int nxs, int my0, int nys, void* out,
                      int threads, cudaStream_t stream) {
  const int cq = (c + 3) / 4;
  const size_t smem =
      4 * (static_cast<size_t>(nxs) * nys * cq * R * 4 +
           static_cast<size_t>(threads) * R + 5 * static_cast<size_t>(R) * k +
           2 * static_cast<size_t>(nxs) * nys + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_conv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_conv_kernel<R><<<(n + R - 1) / R, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(src), c, static_cast<const int*>(nbr),
      k, static_cast<const float*>(u),
      static_cast<const __nv_bfloat16*>(w_sub), n, o_ch, ks, mx0, nxs, my0,
      nys, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [N, C] bf16, nbr [N, K] int32 (absolute rows of src, -1 = no edge),
// u [N, K, 2] f32, w_sub [nxs*nys, C, O] bf16 -> out [N, O] f32.
EVENTAD_API int eventad_fused_spline_conv(
    const void* src, int c, const void* nbr, int k, const void* u,
    const void* w_sub, int n, int o_ch, int ks, int mx0, int nxs, int my0,
    int nys, void* out, void* stream) {
  if (n == 0) return 0;
  if (o_ch < 1 || o_ch > 512 || c < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      (o_ch > 256 || static_cast<long long>(c) * o_ch >= 4096) ? 512 : 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // fewer destinations per block where the table is small: two blocks for
  // each of the 132 SMs before a block takes more rows
  const int min_blocks = 2 * 132;
  if ((n + 7) / 8 >= min_blocks)
    return launch_fused_conv<8>(src, c, nbr, k, u, w_sub, n, o_ch, ks, mx0,
                                nxs, my0, nys, out, threads, s);
  if ((n + 3) / 4 >= min_blocks)
    return launch_fused_conv<4>(src, c, nbr, k, u, w_sub, n, o_ch, ks, mx0,
                                nxs, my0, nys, out, threads, s);
  return launch_fused_conv<2>(src, c, nbr, k, u, w_sub, n, o_ch, ks, mx0, nxs,
                              my0, nys, out, threads, s);
}
