// K4: level-0/1 image rows, the align-corners bilinear upsample of CNN maps
// read at each event's pixel.
//
// Replaces eventad_tpu/ops/upsample_flat.py:_writer_kernel (driven by
// upsample_flat_table / upsample_flat_lookup).  The TPU kernel writes the
// whole full-resolution table [B*H*W, C] and then gathers one row per event;
// the table exists only for the TPU's gather layout.  Here each event's row
// is computed directly from the four align-corners taps of each coarse map:
//
//   xi = clip(round_half_even(pos_x * W), 0, W-1)  (same for y),
//   (x0, x1, tx) = taps_W[xi], (y0, y1, ty) = taps_H[yi],
//   out = (1-ty)((1-tx) f[y0,x0] + tx f[y0,x1]) + ty((1-tx) f[y1,x0] + tx
//   f[y1,x1]),
//
// in f32, each product and sum rounded on its own as the plain version's
// tensor operations round them (no fused multiply-add), with one bf16
// rounding at the end (the XLA chain rounds after each of its two
// contractions; the TPU kernel after H, then after W).  The per-axis tap
// tables (i0, i1, t) are built on the host exactly as models/graph.
// _interp_matrix builds its entries (ops/upsample_flat.tap_tables, float64
// coordinates, t cast to f32) and kept on the device once per geometry, so
// the kernel divides nothing and its taps equal the plain version's.
//
// What bounds it on the H100: bytes.  It writes N x C bf16 (15.7 MB at the
// operating point, where the TPU table writes 83 MB) and reads four taps per
// element from maps of 4 MB each, which stay in the 50 MB L2.  Design: one
// launch for all maps (both column ranges of the [N, sum C] table); a block
// of rows first finds, once per (row, map), the pixel, the four tap pixels
// and the two fractions (into shared memory), then its threads move 16
// bytes each: 8 channels of each of the four taps and of the output, the
// threads of a row side by side, so a block stores one contiguous run of
// the table.  A map whose C is not a multiple of 8, or a map or table not
// 16-byte aligned, takes by that explicit rule the scalar instantiation of
// the same kernel (one channel a thread).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxMaps = 4;
constexpr int kThreads = 256;

struct Map {
  const bf16* feat;           // [B, hp, wp, c] NHWC
  int hp, wp, c, col0;
};

struct Params {
  Map maps[kMaxMaps];
  int n_maps;
  const int4* taps;           // [n_maps][full_w + full_h] (i0, i1, t, 0)
  const float* pos;           // [rows, 3] normalised
  const int* batch;           // [rows]
  int rows, full_w, full_h, out_cols;
  bf16* out;                  // [rows, out_cols]
};

// VW channels of one tap row from `p` into f32
template <int VW>
__device__ __forceinline__ void load_taps(const bf16* p, float (&v)[VW]) {
  if constexpr (VW == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = eventad::bf(p[k]);
  }
}

// (1 - t) a + t b, each step rounded on its own
__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(1.f - t, a), __fmul_rn(t, b));
}

// block (bx, by): by rows, bx threads over each row's VW-channel vectors
template <int VW>
__global__ void __launch_bounds__(kThreads)
upsample_rows_kernel(const Params p) {
  __shared__ int4 s_pix[kThreads * kMaxMaps];     // p00, p01, p10, p11
  __shared__ float2 s_t[kThreads * kMaxMaps];     // tx, ty
  const int bx = blockDim.x, by = blockDim.y;
  const int tid = threadIdx.y * bx + threadIdx.x;
  const int r0 = blockIdx.x * by;
  const int stride = p.full_w + p.full_h;

  // once per (row, map): the pixel, its taps and fractions
  for (int i = tid; i < by * p.n_maps; i += bx * by) {
    const int rr = i / p.n_maps, m = i - rr * p.n_maps;
    const int r = r0 + rr;
    if (r >= p.rows) continue;
    const float px = p.pos[3 * r] * static_cast<float>(p.full_w);
    const float py = p.pos[3 * r + 1] * static_cast<float>(p.full_h);
    const int xi = min(max(static_cast<int>(rintf(px)), 0), p.full_w - 1);
    const int yi = min(max(static_cast<int>(rintf(py)), 0), p.full_h - 1);
    const int4 tx = __ldg(p.taps + m * stride + xi);
    const int4 ty = __ldg(p.taps + m * stride + p.full_w + yi);
    const Map mp = p.maps[m];
    const int b = p.batch[r];
    const int row0 = (b * mp.hp + ty.x) * mp.wp, row1 = (b * mp.hp + ty.y) *
                                                         mp.wp;
    s_pix[i] = make_int4(row0 + tx.x, row0 + tx.y, row1 + tx.x, row1 + tx.y);
    s_t[i] = make_float2(__int_as_float(tx.z), __int_as_float(ty.z));
  }
  __syncthreads();

  const int rr = threadIdx.y, r = r0 + rr;
  if (r >= p.rows) return;
  const int vecs = p.out_cols / VW;
  for (int v = threadIdx.x; v < vecs; v += bx) {
    const int col = v * VW;
    int m = 0;
    while (m + 1 < p.n_maps && col >= p.maps[m + 1].col0) ++m;
    const Map mp = p.maps[m];
    const int ch = col - mp.col0;
    const int4 pix = s_pix[rr * p.n_maps + m];
    const float2 t = s_t[rr * p.n_maps + m];
    float v00[VW], v01[VW], v10[VW], v11[VW];
    load_taps<VW>(mp.feat + static_cast<long long>(pix.x) * mp.c + ch, v00);
    load_taps<VW>(mp.feat + static_cast<long long>(pix.y) * mp.c + ch, v01);
    load_taps<VW>(mp.feat + static_cast<long long>(pix.z) * mp.c + ch, v10);
    load_taps<VW>(mp.feat + static_cast<long long>(pix.w) * mp.c + ch, v11);
    bf16* dst = p.out + static_cast<long long>(r) * p.out_cols + col;
    if constexpr (VW == 8) {
      uint4 packed;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = lerp_rn(lerp_rn(v00[2 * k], v01[2 * k], t.x),
                                lerp_rn(v10[2 * k], v11[2 * k], t.x), t.y);
        const float b =
            lerp_rn(lerp_rn(v00[2 * k + 1], v01[2 * k + 1], t.x),
                    lerp_rn(v10[2 * k + 1], v11[2 * k + 1], t.x), t.y);
        o2[k] = __floats2bfloat162_rn(a, b);
      }
      *reinterpret_cast<uint4*>(dst) = packed;
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k)
        dst[k] = __float2bfloat16(lerp_rn(lerp_rn(v00[k], v01[k], t.x),
                                          lerp_rn(v10[k], v11[k], t.x), t.y));
    }
  }
}

template <int VW>
int run(const Params& p, cudaStream_t stream) {
  const int vecs = p.out_cols / VW;
  const int bx = min(vecs, kThreads), by = kThreads / bx;
  const int blocks = (p.rows + by - 1) / by;
  upsample_rows_kernel<VW><<<blocks, dim3(bx, by), 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats: a host array of n_maps (1 to 4) device pointers to [B, hp, wp, c]
// bf16 maps (NHWC); dims: a host array of (hp, wp, c) per map; taps
// [n_maps, full_w + full_h] int4 (i0, i1, t as bits, 0) per map and axis, x
// then y (ops/upsample_flat.tap_tables); pos [rows, 3] f32 normalised,
// batch [rows] int32 -> out [rows, sum c] bf16, map m in its column range.
// B * hp * wp below 2^31 for every map.
EVENTAD_API int eventad_upsample_rows(const void* const* feats,
                                      const int* dims, int n_maps,
                                      const void* taps, const void* pos,
                                      const void* batch, int rows, int full_w,
                                      int full_h, void* out, void* stream) {
  if (n_maps < 1 || n_maps > kMaxMaps || full_w < 1 || full_h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n_maps = n_maps;
  bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int col = 0;
  for (int m = 0; m < n_maps; ++m) {
    Map& mp = p.maps[m];
    mp.feat = static_cast<const bf16*>(feats[m]);
    mp.hp = dims[3 * m];
    mp.wp = dims[3 * m + 1];
    mp.c = dims[3 * m + 2];
    if (mp.hp < 1 || mp.wp < 1 || mp.c < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    mp.col0 = col;
    col += mp.c;
    vec = vec && mp.c % 8 == 0 &&
          (reinterpret_cast<uintptr_t>(mp.feat) & 15) == 0;
  }
  if (rows == 0) return 0;
  p.taps = static_cast<const int4*>(taps);
  p.pos = static_cast<const float*>(pos);
  p.batch = static_cast<const int*>(batch);
  p.rows = rows;
  p.full_w = full_w;
  p.full_h = full_h;
  p.out_cols = col;
  p.out = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? run<8>(p, s) : run<1>(p, s);
}
