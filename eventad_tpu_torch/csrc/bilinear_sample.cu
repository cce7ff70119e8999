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
// padding) and a masked row is zero.  Rounding points: the position scales
// with two products and one IEEE division (__fdiv_rn, so that it equals the
// plain version's division by a tensor), the blend runs in f32, and the
// result is rounded once to the map's type (the TPU kernel rounds the y
// weights to bf16 first; both stay inside the same band of the f32 result).
//
// The TPU kernel applies the two axes as a product with a [hp, 128] weight
// matrix and a broadcast-reduce over wp, because a per-event gather is what
// a TPU cannot do; here the four taps are indexed loads.
//
// What bounds it on the H100: bytes.  It writes N x C values once and reads
// four taps per value from maps of a few MB that stay in the 50 MB L2, so
// the output stream to device memory is the floor and the number of memory
// instructions per byte is what a design can waste.  Design: a thread owns V
// consecutive channels of one row, V x sizeof(T) = 16 bytes where the
// shapes allow (8 bf16 or 4 f32 channels), so a row of C channels belongs to
// a group of C / V neighbouring threads; each tap is one 16-byte load and
// the result one 16-byte store.  The row's work (position, item, mask, two
// divisions, the flags) is done once per V values; the lanes of a group read
// the same position words, which the hardware serves as one broadcast, so
// nothing is exchanged between lanes.  V falls to 4, 2 or 1 when C, the
// map's address, the output's address or its row stride do not divide by
// the wider vector: any N and any C run, a C of 1 or 3 as one thread per
// value.  The output may be a column range of a wider tensor (out_stride
// elements between rows), so two maps can fill one table with no copy.  No
// shared memory is used.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int kBytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
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

// V channels of one tap as floats; zeros where the tap lies outside the map
template <typename T, int V>
__device__ __forceinline__ void load_tap(const T* p, bool ok, float* v) {
  using R = typename Raw<V * sizeof(T)>::type;
  if (ok) {
    const R raw = __ldg(reinterpret_cast<const R*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bilinear_sample_kernel(
    const T* __restrict__ feat, int b, int hp, int wp, int c,
    const float* __restrict__ pos, int pos_stride,
    const int* __restrict__ batch, int rows_per_item,
    const uint8_t* __restrict__ mask, int rows, int full_w, int full_h,
    T* __restrict__ out, long long out_stride) {
  using R = typename Raw<V * sizeof(T)>::type;
  const int nvec = c / V;
  const long long total = static_cast<long long>(rows) * nvec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int r, vec;
  if (total <= 0x7fffffffLL) {     // the usual case: one 32-bit division
    r = static_cast<int>(static_cast<unsigned>(idx) /
                         static_cast<unsigned>(nvec));
    vec = static_cast<int>(idx) - r * nvec;
  } else {
    r = static_cast<int>(idx / nvec);
    vec = static_cast<int>(idx - static_cast<long long>(r) * nvec);
  }
  const int ch = vec * V;
  const int item = batch != nullptr ? __ldg(batch + r) : r / rows_per_item;
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.f;
  if (mask[r] && item >= 0 && item < b) {
    int x0, y0;
    float tx, ty;
    bool okx0, okx1, oky0, oky1;
    const float* p = pos + static_cast<long long>(r) * pos_stride;
    axis_taps(__ldg(p), full_w, wp, &x0, &tx, &okx0, &okx1);
    axis_taps(__ldg(p + 1), full_h, hp, &y0, &ty, &oky0, &oky1);
    const T* base = feat + static_cast<long long>(item) * hp * wp * c + ch;
    const long long row0 = static_cast<long long>(y0) * wp + x0;
    float v00[V], v01[V], v10[V], v11[V];
    load_tap<T, V>(base + row0 * c, oky0 && okx0, v00);
    load_tap<T, V>(base + (row0 + 1) * c, oky0 && okx1, v01);
    load_tap<T, V>(base + (row0 + wp) * c, oky1 && okx0, v10);
    load_tap<T, V>(base + (row0 + wp + 1) * c, oky1 && okx1, v11);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = (1.f - ty) * ((1.f - tx) * v00[i] + tx * v01[i]) +
             ty * ((1.f - tx) * v10[i] + tx * v11[i]);
  }
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(e + i, v[i]);
  *reinterpret_cast<R*>(out + static_cast<long long>(r) * out_stride + ch) =
      raw;
}

struct Args {
  const void* feat;
  int b, hp, wp, c;
  const void* pos;
  int pos_stride;
  const void* batch;
  int rows_per_item;
  const void* mask;
  int rows, full_w, full_h;
  void* out;
  long long out_stride;
  cudaStream_t stream;
};

template <typename T, int V>
int launch_v(const Args& a) {
  const long long total = static_cast<long long>(a.rows) * (a.c / V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bilinear_sample_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 a.stream>>>(
      static_cast<const T*>(a.feat), a.b, a.hp, a.wp, a.c,
      static_cast<const float*>(a.pos), a.pos_stride,
      static_cast<const int*>(a.batch), a.rows_per_item,
      static_cast<const uint8_t*>(a.mask), a.rows, a.full_w, a.full_h,
      static_cast<T*>(a.out), a.out_stride);
  return static_cast<int>(cudaGetLastError());
}

// the widest vector of at most 16 bytes that C, both addresses and the
// output's row stride divide by
template <typename T>
int launch_bilinear(const Args& a) {
  auto fits = [&](int v) {
    const uintptr_t bytes = static_cast<uintptr_t>(v) * sizeof(T);
    return a.c % v == 0 && a.out_stride % v == 0 &&
           reinterpret_cast<uintptr_t>(a.feat) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(a.out) % bytes == 0;
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_v<T, 8>(a);
  }
  if (fits(4)) return launch_v<T, 4>(a);
  if (fits(2)) return launch_v<T, 2>(a);
  return launch_v<T, 1>(a);
}

}  // namespace

// feat [B, hp, wp, C] (elem_size 4: f32, 2: bf16; NHWC), pos [rows,
// pos_stride] f32 normalized (x, y first), batch [rows] int32 or NULL (then
// row r belongs to item r / rows_per_item), mask [rows] of one byte each
// (uint8 or bool) -> out [rows, C] in feat's type, row r at out + r *
// out_stride elements (out_stride >= C; C for a dense output).
EVENTAD_API int eventad_bilinear_sample(
    const void* feat, int b, int hp, int wp, int c, int elem_size,
    const void* pos, int pos_stride, const void* batch, int rows_per_item,
    const void* mask, int rows, int full_w, int full_h, void* out,
    int out_stride, void* stream) {
  if (static_cast<long long>(rows) * c == 0) return 0;
  if (hp < 1 || wp < 1 || pos_stride < 2 || out_stride < c ||
      (batch == nullptr && rows_per_item < 1) ||
      (elem_size != 2 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{feat, b, hp, wp, c, pos, pos_stride, batch, rows_per_item,
               mask, rows, full_w, full_h, out, out_stride,
               static_cast<cudaStream_t>(stream)};
  if (elem_size == 4) return launch_bilinear<float>(a);
  return launch_bilinear<__nv_bfloat16>(a);
}
