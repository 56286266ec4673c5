// LayerNorm forward for Hopper: y = (x - mu) * rstd * w + b over the last axis.
//
// Replaces the TPU kernel bpx/ops/norm.py::_ln_fwd_kernel (launched from
// _ln_fwd through layer_norm).  Same arithmetic: fp32 statistics over the
// whole row, two-pass variance mean((x - mu)^2), rstd = rsqrt(var + eps),
// fp32 weight and bias, y cast to the output type.  mu and rstd are written
// too (one fp32 each per row) for the backward.
//
// Design.  The grid is sized to the card (the blocks it holds at once, from
// the occupancy calculator, and no more than one per 8 rows); each warp
// walks rows strided by the grid.  On the vector path (E % 4 == 0, E <=
// 1024, every pointer 16-byte aligned: the model's E = 768 in bf16 or fp32,
// and 300) a lane holds its columns of the row in registers (8- or 16-byte
// loads), so both statistics passes are shuffle reductions with no second
// read; the next row's loads are issued before the current row is reduced,
// and w and b are loaded once per warp, into registers, alongside the first
// row.  Any other width or alignment takes the scalar path, which re-reads
// the row from L1/L2 in each pass.  The TPU kernel's E % 128 == 0 gate was
// a TPU lane rule and does not apply here.
//
// Bound on an H100: memory.  It reads x once and writes y once (plus 8 bytes
// of statistics per row) and does ~8 flops per element, far below the card's
// flop/byte balance point.

#include "layer_norm_common.cuh"

namespace {

using namespace ln;

template <typename Tin, typename Tout, int K>
__global__ void __launch_bounds__(kThreads)
layer_norm_vec_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, Tout* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int n, int e, float eps) {
  using In = Vec4<Tin>;
  const int lane = threadIdx.x % 32;
  const int chunks = e / 4;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + threadIdx.x / 32;

  typename In::Raw cur[K], nxt[K];
  float4 wr[K], br[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int idx = lane + c * 32;
    if (idx < chunks) {
      if (row < n) cur[c] = In::load(x + (long long)row * e + idx * 4);
      wr[c] = reinterpret_cast<const float4*>(w)[idx];
      br[c] = reinterpret_cast<const float4*>(b)[idx];
    }
  }

  for (; row < n; row += stride) {
    const int next = row + stride;
    if (next < n) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int idx = lane + c * 32;
        if (idx < chunks) nxt[c] = In::load(x + (long long)next * e + idx * 4);
      }
    }
    float v[K][4];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (lane + c * 32 < chunks) {
        In::unpack(cur[c], v[c]);
        sum += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
      }
    }
    const float mu = warp_sum(sum) / e;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (lane + c * 32 < chunks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = v[c][i] - mu;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / e + eps);

    Tout* yr = y + (long long)row * e;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int idx = lane + c * 32;
      if (idx < chunks) {
        float out[4];
        out[0] = (v[c][0] - mu) * rstd * wr[c].x + br[c].x;
        out[1] = (v[c][1] - mu) * rstd * wr[c].y + br[c].y;
        out[2] = (v[c][2] - mu) * rstd * wr[c].z + br[c].z;
        out[3] = (v[c][3] - mu) * rstd * wr[c].w + br[c].w;
        Vec4<Tout>::store(yr + idx * 4, out);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int c = 0; c < K; ++c) cur[c] = nxt[c];
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
layer_norm_scalar_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, Tout* __restrict__ y,
                         float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, int n, int e,
                         float eps) {
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < n;
       row += stride) {
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
}

struct Args {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  float* mu;
  float* rstd;
  int n, e;
  float eps;
};

template <typename Tin, typename Tout, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int* cache, const Args& a,
                          cudaStream_t s) {
  int grid = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(kernel), 0,
                                   cache, a.n, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const Tin*>(a.x), a.w, a.b,
                                   static_cast<Tout*>(a.y), a.mu, a.rstd, a.n,
                                   a.e, a.eps);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int K>
cudaError_t launch_vec(const Args& a, cudaStream_t s) {
  static int cache[kMaxDevices];
  return launch_kernel<Tin, Tout>(layer_norm_vec_kernel<Tin, Tout, K>, cache,
                                  a, s);
}

template <typename Tin, typename Tout>
cudaError_t launch(const Args& a, int vector_ok, cudaStream_t s) {
  switch (vector_ok && a.e % 4 == 0 ? vec_chunks(a.e) : 0) {
    case 3: return launch_vec<Tin, Tout, 3>(a, s);
    case 6: return launch_vec<Tin, Tout, 6>(a, s);
    case 8: return launch_vec<Tin, Tout, 8>(a, s);
    default: {
      static int cache[kMaxDevices];
      return launch_kernel<Tin, Tout>(layer_norm_scalar_kernel<Tin, Tout>,
                                      cache, a, s);
    }
  }
}

}  // namespace

extern "C" {

// x (n, e) contiguous, bf16 or fp32; w, b (e,) fp32; y (n, e) bf16 or fp32;
// mu, rstd (n,) fp32.  vector_ok says every pointer is 16-byte aligned (the
// wrapper checks), which the vector loads and stores need.  Returns a
// cudaError_t (0 on success).
int bpx_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mu, void* rstd, int n, int e, float eps,
                       int x_bf16, int y_bf16, int vector_ok, void* stream) {
  const Args a{x, static_cast<const float*>(w), static_cast<const float*>(b),
               y, static_cast<float*>(mu), static_cast<float*>(rstd), n, e,
               eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && y_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, vector_ok, s);
  } else if (x_bf16) {
    err = launch<__nv_bfloat16, float>(a, vector_ok, s);
  } else if (y_bf16) {
    err = launch<float, __nv_bfloat16>(a, vector_ok, s);
  } else {
    err = launch<float, float>(a, vector_ok, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
