// K4: level-0/1 image rows, the align-corners bilinear upsample of a CNN map
// read at each event's pixel.
//
// Replaces eventad_tpu/ops/upsample_flat.py:_writer_kernel (driven by
// upsample_flat_table / upsample_flat_lookup).  The TPU kernel writes the
// whole full-resolution table [B*H*W, C] and then gathers one row per event;
// the table exists only for the TPU's gather layout.  Here each event's row
// is computed directly from the four align-corners taps of the coarse map:
//
//   xi = clip(round_half_even(pos_x * W), 0, W-1)  (same for y),
//   fx = xi * (wp-1) / (W-1), x0 = floor(fx), tx = fx - x0, x1 = min(x0+1,
//   wp-1)  (models/graph._interp_matrix, in double as numpy computes it),
//   out = (1-ty)((1-tx) f[y0,x0] + tx f[y0,x1]) + ty((1-tx) f[y1,x0] + tx
//   f[y1,x1]),
//
// in f32 with one bf16 rounding at the end (the XLA chain rounds after each
// of its two contractions; the TPU kernel after H, then after W).
//
// What bounds it on the H100: bytes.  It writes N x C bf16 (15.7 MB at the
// operating point, where the TPU table writes 83 MB) and reads four taps per
// element from maps of 4 MB each, which stay in the 50 MB L2.  Design: one
// thread per output element, channel fastest, so a warp writes contiguous
// bf16 and reads contiguous channels of each tap.  One launch per map; the
// map's columns go to [col0, col0 + C) of the output row.
#include "common.cuh"

namespace {

__device__ __forceinline__ void align_corners(int d, int dst, int src,
                                              int* i0, int* i1, float* t) {
  const double f = static_cast<double>(static_cast<long long>(d) * (src - 1)) /
                   static_cast<double>(dst > 1 ? dst - 1 : 1);
  const int i = static_cast<int>(floor(f));
  *i0 = i;
  *i1 = min(i + 1, src - 1);
  *t = static_cast<float>(f - i);
}

__global__ void upsample_rows_kernel(const __nv_bfloat16* __restrict__ feat,
                                     int hp, int wp, int c,
                                     const float* __restrict__ pos,
                                     const int* __restrict__ batch, int rows,
                                     int full_w, int full_h, int out_cols,
                                     int col0,
                                     __nv_bfloat16* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * c) return;
  const int r = static_cast<int>(idx / c);
  const int ch = static_cast<int>(idx % c);
  const float px = pos[3 * r] * static_cast<float>(full_w);
  const float py = pos[3 * r + 1] * static_cast<float>(full_h);
  const int xi = min(max(static_cast<int>(rintf(px)), 0), full_w - 1);
  const int yi = min(max(static_cast<int>(rintf(py)), 0), full_h - 1);
  int x0, x1, y0, y1;
  float tx, ty;
  align_corners(xi, full_w, wp, &x0, &x1, &tx);
  align_corners(yi, full_h, hp, &y0, &y1, &ty);
  const long long base = static_cast<long long>(batch[r]) * hp;
  const __nv_bfloat16* r0 = feat + ((base + y0) * wp) * c + ch;
  const __nv_bfloat16* r1 = feat + ((base + y1) * wp) * c + ch;
  const float v00 = eventad::bf(r0[static_cast<long long>(x0) * c]);
  const float v01 = eventad::bf(r0[static_cast<long long>(x1) * c]);
  const float v10 = eventad::bf(r1[static_cast<long long>(x0) * c]);
  const float v11 = eventad::bf(r1[static_cast<long long>(x1) * c]);
  const float top = (1.f - tx) * v00 + tx * v01;
  const float bot = (1.f - tx) * v10 + tx * v11;
  out[static_cast<long long>(r) * out_cols + col0 + ch] =
      __float2bfloat16((1.f - ty) * top + ty * bot);
}

}  // namespace

// feat [B, hp, wp, c] bf16 (NHWC), pos [rows, 3] f32 normalized, batch
// [rows] int32 -> out[:, col0:col0+c] of a [rows, out_cols] bf16 table.
EVENTAD_API int eventad_upsample_rows(const void* feat, int b, int hp, int wp,
                                      int c, const void* pos,
                                      const void* batch, int rows, int full_w,
                                      int full_h, int out_cols, int col0,
                                      void* out, void* stream) {
  (void)b;
  const long long total = static_cast<long long>(rows) * c;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  upsample_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat), hp, wp, c,
      static_cast<const float*>(pos), static_cast<const int*>(batch), rows,
      full_w, full_h, out_cols, col0, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
