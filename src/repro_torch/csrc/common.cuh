// Shared helpers for the port's CUDA kernels: dtype codes of the plain C
// interface and float conversions. Every kernel reads fp32 or bf16
// activations, weights in those or in int8, and does its arithmetic in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// dtype codes passed through the C interface (see kernels/build.py)
// (kInt8 is a weight type only: dispatch_dtype below never yields it)
enum DTypeCode : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Calls fn with a null T* whose T is the element type of a dtype code
// (the callee takes T from the pointer's type); returns -1 for a code the
// kernels do not take.
template <typename Fn>
int dispatch_dtype(int code, Fn&& fn) {
  switch (code) {
    case kFloat32: return fn(static_cast<float*>(nullptr));
    case kBFloat16: return fn(static_cast<__nv_bfloat16*>(nullptr));
    default: return -1;
  }
}
