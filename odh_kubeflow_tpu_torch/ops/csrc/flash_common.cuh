// Helpers shared by the port's flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the rule that chooses between their tensor-core and scalar
// kernels, conversions between the storage type (float or bf16) and the f32
// the kernels compute in, and two-element loads and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace odh_flash {

constexpr float NEG_INF = -1e30f;  // masked scores, as in the reference

// The one rule by which the forward and the backward choose their kernels,
// by (dtype, d) alone (dtype 0 = float32, 1 = bfloat16): 1 = the tensor-core
// kernels (bf16, d 64 or 128), 0 = the scalar ones (f32 at d 16/32/64/128,
// bf16 at d 16 or 32: the tensor cores have no f32 product, and TF32 would
// break the f32 gates), -1 = unsupported. attention._on_tensor_cores
// mirrors it in Python.
inline int kernel_choice(int dtype, int d) {
  const bool known_d = d == 16 || d == 32 || d == 64 || d == 128;
  if (!known_d || (dtype != 0 && dtype != 1)) return -1;
  return (dtype == 1 && (d == 64 || d == 128)) ? 1 : 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp astype
}

// x rounded to T and back: the rounding point of an `astype(T)` in the
// reference before a product that accumulates in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace odh_flash
