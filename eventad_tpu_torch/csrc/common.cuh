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

// ---- cp.async, ldmatrix and mma.sync (bf16 in, f32 out), K2 and K3 ----
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

}  // namespace eventad
