// LayerNorm forward for Hopper: y = (x - mu) * rstd * w + b over the last axis.
//
// Replaces the TPU kernel bpx/ops/norm.py::_ln_fwd_kernel (launched from
// _ln_fwd through layer_norm).  Same arithmetic: fp32 statistics over the
// whole row, two-pass variance mean((x - mu)^2), rstd = rsqrt(var + eps),
// fp32 weight and bias, y cast to the output type.  mu and rstd are written
// too (one fp32 each per row) for the backward of the training slice.
//
// Design.  One warp owns one row; 8 warps per block.  A row of the model's
// widths (E = 768 in bf16: 1.5 KB) fits the warp's registers, so the vector
// path loads it once with 16-byte loads, keeps it in registers for both
// statistics passes (shuffle reductions, no shared memory) and writes y with
// 16-byte stores.  Any other width (E % (16 / sizeof(x)) != 0, or wider than
// the registers hold) takes the scalar path, which re-reads the row from
// L1/L2 in each pass; the TPU kernel's E % 128 == 0 gate was a TPU lane rule
// and does not apply here.
//
// Bound on an H100: memory.  It reads x once and writes y once (plus 8 bytes
// of statistics per row) and does ~8 flops per element, far below the card's
// flop/byte balance point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxChunks = 4;   // 16-byte chunks per lane on the vector path

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

// Stores N consecutive outputs with 16-byte stores (one 8-byte store when
// the N outputs are only 8 bytes: fp32 in, bf16 out).
template <typename Tout, int N>
__device__ __forceinline__ void store_vec(Tout* dst, const float* vals) {
  alignas(16) Tout t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = from_float<Tout>(vals[i]);
  constexpr int kBytes = N * sizeof(Tout);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int s = 0; s < kBytes / 16; ++s) {
      reinterpret_cast<uint4*>(dst)[s] = reinterpret_cast<const uint4*>(t)[s];
    }
  } else {
    static_assert(kBytes == 8, "unexpected chunk size");
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(t);
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_vec_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, Tout* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int n, int e, float eps) {
  constexpr int kEpc = 16 / sizeof(Tin);   // elements per 16-byte chunk
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const int chunks = e / kEpc;
  const Tin* xr = x + (long long)row * e;

  float v[kMaxChunks][kEpc];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int idx = lane + c * 32;
    if (idx < chunks) {
      alignas(16) Tin t[kEpc];
      *reinterpret_cast<uint4*>(t) = reinterpret_cast<const uint4*>(xr)[idx];
#pragma unroll
      for (int i = 0; i < kEpc; ++i) {
        v[c][i] = to_float(t[i]);
        sum += v[c][i];
      }
    }
  }
  const float mu = warp_sum(sum) / e;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (lane + c * 32 < chunks) {
#pragma unroll
      for (int i = 0; i < kEpc; ++i) {
        const float d = v[c][i] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / e + eps);

  Tout* yr = y + (long long)row * e;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int idx = lane + c * 32;
    if (idx < chunks) {
      const float4* w4 = reinterpret_cast<const float4*>(w + idx * kEpc);
      const float4* b4 = reinterpret_cast<const float4*>(b + idx * kEpc);
      float out[kEpc];
#pragma unroll
      for (int q = 0; q < kEpc / 4; ++q) {
        const float4 wq = w4[q];
        const float4 bq = b4[q];
        out[4 * q + 0] = (v[c][4 * q + 0] - mu) * rstd * wq.x + bq.x;
        out[4 * q + 1] = (v[c][4 * q + 1] - mu) * rstd * wq.y + bq.y;
        out[4 * q + 2] = (v[c][4 * q + 2] - mu) * rstd * wq.z + bq.z;
        out[4 * q + 3] = (v[c][4 * q + 3] - mu) * rstd * wq.w + bq.w;
      }
      store_vec<Tout, kEpc>(yr + idx * kEpc, out);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_scalar_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, Tout* __restrict__ y,
                         float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, int n, int e,
                         float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const Tin* xr = x + (long long)row * e;
  float sum = 0.f;
  for (int i = lane; i < e; i += 32) sum += to_float(xr[i]);
  const float mu = warp_sum(sum) / e;
  float sq = 0.f;
  for (int i = lane; i < e; i += 32) {
    const float d = to_float(xr[i]) - mu;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / e + eps);
  Tout* yr = y + (long long)row * e;
  for (int i = lane; i < e; i += 32) {
    yr[i] = from_float<Tout>((to_float(xr[i]) - mu) * rstd * w[i] + b[i]);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* w, const float* b, void* y,
                   float* mu, float* rstd, int n, int e, float eps,
                   int vector_ok, cudaStream_t s) {
  const dim3 grid((n + kWarps - 1) / kWarps);
  const dim3 block(32 * kWarps);
  constexpr int kEpc = 16 / sizeof(Tin);
  const bool vec = vector_ok && e % kEpc == 0 && e / kEpc <= 32 * kMaxChunks;
  if (vec) {
    layer_norm_vec_kernel<Tin, Tout><<<grid, block, 0, s>>>(
        static_cast<const Tin*>(x), w, b, static_cast<Tout*>(y), mu, rstd, n,
        e, eps);
  } else {
    layer_norm_scalar_kernel<Tin, Tout><<<grid, block, 0, s>>>(
        static_cast<const Tin*>(x), w, b, static_cast<Tout*>(y), mu, rstd, n,
        e, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, e) contiguous, bf16 or fp32; w, b (e,) fp32; y (n, e) bf16 or fp32;
// mu, rstd (n,) fp32.  vector_ok says every pointer is 16-byte aligned (the
// wrapper checks), which the 16-byte loads and stores need.  Returns a
// cudaError_t (0 on success).
int bpx_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mu, void* rstd, int n, int e, float eps,
                       int x_bf16, int y_bf16, int vector_ok, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rsf = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && y_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, wf, bf, y, muf, rsf, n, e,
                                               eps, vector_ok, s);
  } else if (x_bf16) {
    err = launch<__nv_bfloat16, float>(x, wf, bf, y, muf, rsf, n, e, eps,
                                       vector_ok, s);
  } else if (y_bf16) {
    err = launch<float, __nv_bfloat16>(x, wf, bf, y, muf, rsf, n, e, eps,
                                       vector_ok, s);
  } else {
    err = launch<float, float>(x, wf, bf, y, muf, rsf, n, e, eps, vector_ok,
                               s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
