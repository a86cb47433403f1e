// The element types of the kernels' activations: fp32, and bf16 for the
// serving kernels' bf16 variants (K4, K5), which keep their arithmetic in
// fp32. to_f / from_f convert one value (from_f rounds to nearest even).
#pragma once

#include <cuda_bf16.h>

namespace vml {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

}  // namespace vml
