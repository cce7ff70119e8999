// K7: bilinear sample of one CNN map at continuous node positions.
//
// Replaces eventad_tpu/ops/bilinear_sample.py:_kernel (driven by
// sample_bilinear_mxu).  For feat [B, hp, wp, C] and normalized positions:
//
//   fx = x * W * (wp-1) / (W-1), fy likewise; x0 = floor(fx), tx = fx - x0;
//   out = (1-ty)((1-tx) f[y0,x0] + tx f[y0,x0+1])
//       +   ty ((1-tx) f[y0+1,x0] + tx f[y0+1,x0+1]),
//
// a tap outside the map counts as zero (grid_sample, align_corners, zero
// padding) and a masked row is zero.  The blend runs in f32 with one rounding
// to the map's type at the end (the TPU kernel rounds the y weights to bf16
// first; both stay inside the same band of the f32 result).
//
// The TPU kernel applies the two axes as a product with a [hp, 128] weight
// matrix and a broadcast-reduce over wp, because a per-event gather is what
// a TPU cannot do; here the four taps are indexed loads.  Unlike K4
// (upsample_rows.cu) the positions are continuous, taps may fall outside the
// map, rows are masked, and f32 maps are taken as well as bf16.
//
// What bounds it on the H100: bytes.  It writes N x C values and reads four
// taps per value from a map that stays in the 50 MB L2.  Design: one thread
// per output value, channel fastest, so a warp writes consecutive values and
// reads consecutive channels of each tap.  Any N and any C.
#include "common.cuh"

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// floor tap and fraction of one axis; ok0 / ok1: the taps lie in the map
__device__ __forceinline__ void axis_taps(float p, int full, int size,
                                          int* i0, float* t, bool* ok0,
                                          bool* ok1) {
  const float f = __fdiv_rn(
      __fmul_rn(__fmul_rn(p, static_cast<float>(full)),
                static_cast<float>(size - 1)),
      static_cast<float>(full > 1 ? full - 1 : 1));
  const float fl = floorf(f);
  *t = f - fl;
  // compared as floats: a far-off position must not wrap as an integer
  *ok0 = fl >= 0.f && fl < static_cast<float>(size);
  *ok1 = fl >= -1.f && fl < static_cast<float>(size - 1);
  *i0 = (*ok0 || *ok1) ? static_cast<int>(fl) : 0;
}

template <typename T>
__global__ void bilinear_sample_kernel(
    const T* __restrict__ feat, int b, int hp, int wp, int c,
    const float* __restrict__ pos, int pos_stride,
    const int* __restrict__ batch, int rows_per_item,
    const uint8_t* __restrict__ mask, int rows, int full_w, int full_h,
    T* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * c) return;
  const int r = static_cast<int>(idx / c);
  const int ch = static_cast<int>(idx % c);
  const int item = batch != nullptr ? batch[r] : r / rows_per_item;
  float v = 0.f;
  if (mask[r] && item >= 0 && item < b) {
    int x0, y0;
    float tx, ty;
    bool okx0, okx1, oky0, oky1;
    axis_taps(pos[static_cast<long long>(r) * pos_stride], full_w, wp, &x0,
              &tx, &okx0, &okx1);
    axis_taps(pos[static_cast<long long>(r) * pos_stride + 1], full_h, hp,
              &y0, &ty, &oky0, &oky1);
    const T* base = feat + static_cast<long long>(item) * hp * wp * c + ch;
    auto tap = [&](int yy, int xx, bool ok) {
      return ok ? load_f(base + (static_cast<long long>(yy) * wp + xx) * c)
                : 0.f;
    };
    const float v00 = tap(y0, x0, oky0 && okx0);
    const float v01 = tap(y0, x0 + 1, oky0 && okx1);
    const float v10 = tap(y0 + 1, x0, oky1 && okx0);
    const float v11 = tap(y0 + 1, x0 + 1, oky1 && okx1);
    v = (1.f - ty) * ((1.f - tx) * v00 + tx * v01) +
        ty * ((1.f - tx) * v10 + tx * v11);
  }
  store_f(out + idx, v);
}

template <typename T>
int launch_bilinear(const void* feat, int b, int hp, int wp, int c,
                    const void* pos, int pos_stride, const void* batch,
                    int rows_per_item, const void* mask, int rows, int full_w,
                    int full_h, void* out, cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * c;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(
      static_cast<const T*>(feat), b, hp, wp, c,
      static_cast<const float*>(pos), pos_stride,
      static_cast<const int*>(batch), rows_per_item,
      static_cast<const uint8_t*>(mask), rows, full_w, full_h,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat [B, hp, wp, C] (elem_size 4: f32, 2: bf16; NHWC), pos [rows,
// pos_stride] f32 normalized (x, y first), batch [rows] int32 or NULL (then
// row r belongs to item r / rows_per_item), mask [rows] uint8 -> out [rows,
// C] in feat's type.
EVENTAD_API int eventad_bilinear_sample(
    const void* feat, int b, int hp, int wp, int c, int elem_size,
    const void* pos, int pos_stride, const void* batch, int rows_per_item,
    const void* mask, int rows, int full_w, int full_h, void* out,
    void* stream) {
  if (static_cast<long long>(rows) * c == 0) return 0;
  if (hp < 1 || wp < 1 || pos_stride < 2 ||
      (batch == nullptr && rows_per_item < 1) ||
      (elem_size != 2 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    return launch_bilinear<float>(feat, b, hp, wp, c, pos, pos_stride, batch,
                                  rows_per_item, mask, rows, full_w, full_h,
                                  out, s);
  return launch_bilinear<__nv_bfloat16>(feat, b, hp, wp, c, pos, pos_stride,
                                        batch, rows_per_item, mask, rows,
                                        full_w, full_h, out, s);
}
