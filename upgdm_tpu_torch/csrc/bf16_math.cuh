// Scalar helpers both denoiser trunks use (denoiser_trunk.cuh on the CUDA
// cores, trunk_mma.cuh on the tensor cores): the special-function unit's
// base-2 exponential and logarithm, and a float32 value rounded to bf16
// (round to nearest even) and back.
#pragma once

#include <cuda_bf16.h>

namespace upgdm {

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace upgdm
