// Device helpers shared by the SIMT flash kernels, the generic ones
// (flash_generic.cu: fp32 at any head dim up to 256) and the chunked ones
// (flash_chunked.cu: bf16 and fp32 above 256): tensor strides, the widening
// and narrowing of an element, the reductions over a row group's lanes and
// over a warp, and the dtype dispatch of the C entry points.
#pragma once

#include "flash_common.cuh"

namespace bpx_flash {

constexpr int kGroupLanes = 16;   // the lanes of a row group

// A (B, H, T, D) tensor's strides in elements (the last dim contiguous).
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the plain version's casts of P and dS
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

template <typename T>
__device__ __forceinline__ const T* head_of(const void* base, const Strides& s,
                                            int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kGroupLanes / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kGroupLanes / 2; o > 0; o /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>()) for dtype 0 (bf16, where Bf16 builds it) or 1 (fp32);
// cudaErrorInvalidValue for any other code
template <bool Bf16, typename F>
cudaError_t with_dtype(int dtype, F&& f) {
  if constexpr (Bf16) {
    if (dtype == 0) return f(Type<__nv_bfloat16>());
  }
  if (dtype == 1) return f(Type<float>());
  return cudaErrorInvalidValue;
}

}  // namespace bpx_flash
