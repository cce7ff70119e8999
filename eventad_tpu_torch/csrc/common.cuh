// Shared helpers of the EventAD Hopper kernels (plain C interface, loaded
// with ctypes by eventad_tpu_torch/ops/kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EVENTAD_API extern "C" __attribute__((visibility("default")))

namespace eventad {

// Activation codes, the same table as eventad_tpu/ops/spline_basis.ACTS
// (eventad_tpu_torch/ops/spline_basis.ACT_CODES on the Python side).
enum Act { kActNone = 0, kActRelu = 1, kActElu = 2, kActHardtanh = 3,
           kActSilu = 4 };

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case kActRelu: return fmaxf(x, 0.f);
    case kActElu: return x > 0.f ? x : expm1f(x);
    case kActHardtanh: return fminf(fmaxf(x, -1.f), 1.f);
    case kActSilu: return x / (1.f + expf(-x));
    default: return x;
  }
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Degree-1 spline taps of one pre-scaled coordinate u = clip(attr,0,1)*(ks-1):
// weight 1-fr on tap i0 and fr on tap i0+1 (ops/spline_basis.axis_weights).
__device__ __forceinline__ void spline_taps(float u, int ks, int* i0,
                                            float* fr) {
  int i = static_cast<int>(floorf(u));
  i = i < 0 ? 0 : (i > ks - 2 ? ks - 2 : i);
  *i0 = i;
  *fr = u - static_cast<float>(i);
}

// Row stride of an operand the tensor cores read from shared memory: c
// padded to the MMA depth of 16, plus 8, an odd number of 16-byte units, so
// that eight consecutive rows fall into eight different bank groups.
__host__ __device__ inline int pad_stride(int c) {
  return (c + 15) / 16 * 16 + 8;
}
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The current device's SM count into *n_sms, read on every call; an error
// where it cannot be read (the launchers then refuse, never guess).
inline cudaError_t sm_count(int* n_sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && *n_sms < 1) e = cudaErrorInvalidDevice;
  return e;
}

// ---- cp.async, ldmatrix and mma.sync (bf16 in, f32 out), K2, K3, K5 ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most kPending of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// d += a . b, one m16n8k16 tile: a the 16 x 16 A fragment (rows g and g + 8,
// columns 2 (lane % 4) + {0, 1} and + 8), b the 16 x 8 B fragment (rows
// 2 (lane % 4) + {0, 1} and + 8, column g), d rows g and g + 8, columns
// 2 (lane % 4) + {0, 1}; g = lane / 4
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// `elems` bf16 (a multiple of 8, both addresses 16-byte aligned) into shared
// memory by cp.async, all threads of the block
__device__ __forceinline__ void load_weights(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int elems, int tid,
                                             int n_threads) {
  for (int q = tid * 8; q < elems; q += n_threads * 8)
    cp_async<16>(dst + q, src + q);
}

// acc[j] += A[16 rows of this warp, :] . B[:, n-block wn * NBW + j] over
// k_blocks blocks of 16 channels; A [rows][a_stride] and B [O][b_stride],
// both k contiguous, in shared memory (K3, K5)
template <int NBW>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* a, int a_stride,
                                         const __nv_bfloat16* b, int b_stride,
                                         int k_blocks, int n_blocks, int wm,
                                         int wn, int lane,
                                         float (&acc)[NBW][4]) {
  if (wn * NBW >= n_blocks) return;
  const uint32_t a_addr = smem_u32(
      a + static_cast<size_t>(wm * 16 + (lane & 15)) * a_stride +
      (lane >> 4) * 8);
  const uint32_t b_addr = smem_u32(
      b + static_cast<size_t>(wn * NBW * 8 + (lane & 7)) * b_stride +
      ((lane >> 3) & 1) * 8);
#pragma unroll 2
  for (int kb = 0; kb < k_blocks; ++kb) {
    uint32_t af[4];
    ldmatrix_x4(af, a_addr + kb * 32);
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      if (wn * NBW + j < n_blocks) {
        uint32_t bfr[2];
        ldmatrix_x2(bfr, b_addr + static_cast<uint32_t>(j * 8 * b_stride * 2) +
                             kb * 32);
        mma_bf16(acc[j], af, bfr);
      }
    }
  }
}

// The weight of an edge record (x: ix | iy << 8 as bits, -1 none; y: fx;
// z: fy) on kernel tap (mx, my): (1 - f) on its floor tap and f on the
// next, per axis (K3, K5)
__device__ __forceinline__ float tap_weight(const float4& e, int mx, int my) {
  const int code = __float_as_int(e.x);
  if (code < 0) return 0.f;
  const int ix = code & 0xff, iy = code >> 8;
  const float wx = ix == mx ? 1.f - e.y : (ix + 1 == mx ? e.y : 0.f);
  const float wy = iy == my ? 1.f - e.z : (iy + 1 == my ? e.z : 0.f);
  return wx * wy;
}

// Channels [ch0, ch0 + 8) of a bf16 row of c values (zero from c on), by
// 16-byte loads whatever the row's alignment: the aligned word that holds
// channel ch0 and, only where the channels reach into it, the next one,
// funnel-shifted by the offset.  Each word read holds a byte of the row, so
// no read leaves the row's allocation.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* row, int ch0,
                                            int c) {
  const int n = c - ch0 < 8 ? c - ch0 : 8;
  if (n <= 0) return make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + ch0);
  const uintptr_t base = a & ~static_cast<uintptr_t>(15);
  const int sh = static_cast<int>(a - base);          // even, 0 to 14 bytes
  const uint4 w0 = __ldg(reinterpret_cast<const uint4*>(base));
  uint4 w1 = make_uint4(0u, 0u, 0u, 0u);
  if (sh + 2 * n > 16) w1 = __ldg(reinterpret_cast<const uint4*>(base + 16));
  const uint32_t x[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int q = sh >> 2, bits = (sh & 3) * 8;
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = q == 0 ? x[i] : q == 1 ? x[i + 1]
                        : q == 2 ? x[i + 2] : x[i + 3];
    const uint32_t hi = q == 0 ? x[i + 1] : q == 1 ? x[i + 2]
                        : q == 2 ? x[i + 3] : x[i + 4];
    r[i] = __funnelshift_r(lo, hi, bits);
  }
  if (n < 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (2 * i >= n) r[i] = 0u;
      else if (2 * i + 1 >= n) r[i] &= 0xffffu;
    }
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

}  // namespace eventad
