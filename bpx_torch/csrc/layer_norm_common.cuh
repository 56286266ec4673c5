// Helpers shared by the LayerNorm forward (layer_norm.cu) and backward
// (layer_norm_bwd.cu): element conversions, the warp sum, 4-element vector
// accesses, and a grid sized to the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ln {

constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 4 consecutive elements in one access: 16 bytes of fp32, 8 bytes of bf16.
// The vector paths take E % 4 == 0 and every pointer 16-byte aligned, so
// each access is aligned to its size.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    f[0] = __low2float(lo); f[1] = __high2float(lo);
    f[2] = __low2float(hi); f[3] = __high2float(hi);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    uint2 r;
    r.x = *reinterpret_cast<const uint32_t*>(&lo);
    r.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// 4-element chunks per lane that a vector path instantiates for width e:
// 3 (E <= 384: the mmtrvat presets' 300), 6 (E <= 768: moviescope) or 8
// (E <= 1024); 0 for a wider row, which takes the scalar path.
inline int vec_chunks(int e) {
  return e <= 384 ? 3 : e <= 768 ? 6 : e <= 1024 ? 8 : 0;
}

// The backward's vector plan for width e: 4-element chunks per lane and
// warps per row.  Up to 1024 the forward's, a warp a row; above, up to 1536
// (mmtrvpa's 2E-wide memory encoders at moviescope's widths), a warp pair a
// row at 6 chunks a lane, the register budget of the 768-wide path; {0, 0}
// for a wider row, which takes the scalar path.
struct BwdPlan {
  int chunks;
  int warps;
};
inline BwdPlan bwd_plan(int e) {
  if (e <= 1024) return {vec_chunks(e), 1};
  return e <= 1536 ? BwdPlan{6, 2} : BwdPlan{0, 0};
}

// The grid for n rows of `kernel` (kThreads threads, `smem` dynamic bytes)
// into *grid: one block per `rows` rows (a block's rows in flight at once),
// but no more blocks than the current device holds at once (SMs x blocks
// per SM, from the occupancy calculator, taken once per device into
// `cache`: one cache per kernel).
inline cudaError_t grid_for(const void* kernel, int smem, int* cache, int n,
                            int* grid, int rows = kWarps) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    if (per_sm * sms == 0) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  const int want = (n + rows - 1) / rows;
  *grid = want < cache[dev] ? want : cache[dev];
  return cudaSuccess;
}

}  // namespace ln
