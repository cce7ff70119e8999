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

}  // namespace eventad
