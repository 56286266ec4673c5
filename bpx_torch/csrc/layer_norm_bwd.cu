// LayerNorm backward for Hopper: dx, and the weight and bias gradients.
//
// Replaces the TPU kernel bpx/ops/norm.py::_ln_bwd_kernel (launched from
// _layer_norm_bwd).  Same arithmetic, from the forward's saved fp32 mu and
// rstd:
//   xhat = (x - mu) * rstd,  a = dy * w
//   dx   = rstd * (a - mean(a) - xhat * mean(a * xhat))   (fp32, stored in
//          x's dtype)
//   dw   = sum_rows dy * xhat,  db = sum_rows dy            (fp32)
//
// Design.  The TPU kernel sums dw and db across its grid in VMEM scratch,
// which works because a TPU runs the grid in order; blocks on the card run
// in no order.  Here each block writes fp32 partial sums of its rows to a
// (parts, E) workspace and a second small kernel reduces them in a fixed
// order: deterministic, no atomics.  One warp per row, 8 warps per block,
// 2 rows per warp.  The vector path (E a multiple of 8, at most 1024, every
// pointer 16-byte aligned: the model's E = 768) keeps a row of x and dy in
// registers (16-byte loads), reduces the two row means by shuffles, and
// keeps each lane's columns of dw/db in registers across the warp's rows;
// the warps' partials are combined through shared memory in warp order, one
// partial row per block.  Other widths take a scalar path that re-reads the
// row from L1/L2 and writes one partial row per warp.
//
// Bound on an H100: memory.  It reads x and dy once and writes dx once (plus
// 8 bytes of statistics per row and the E-wide partials) at ~12 flops per
// element, far below the card's flop/byte balance point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxChunks = 4;   // 8-element chunks per lane on the vector path

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

// 8 consecutive elements <-> floats, with 16-byte accesses
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  alignas(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename Tx, typename Tdy>
__global__ void __launch_bounds__(32 * kWarps)
ln_bwd_vec_kernel(const Tx* __restrict__ x, const Tdy* __restrict__ dy,
                  const float* __restrict__ w, const float* __restrict__ mu,
                  const float* __restrict__ rstd, Tx* __restrict__ dx,
                  float* __restrict__ part_w, float* __restrict__ part_b,
                  int n, int e) {
  extern __shared__ float red[];   // (kWarps, e)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = e / 8;
  float aw[kMaxChunks][8], ab[kMaxChunks][8];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[c][i] = ab[c][i] = 0.f;
  }

  const int first = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  for (int row = first; row < min(first + kRowsPerWarp, n); ++row) {
    const Tx* xr = x + (long long)row * e;
    const Tdy* dyr = dy + (long long)row * e;
    const float m = mu[row], rs = rstd[row];
    float xh[kMaxChunks][8], a[kMaxChunks][8];
    float s_a = 0.f, s_ax = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int idx = lane + c * 32;
      if (idx < chunks) {
        float xv[8], gv[8], wv[8];
        load8(xr + idx * 8, xv);
        load8(dyr + idx * 8, gv);
        load8(w + idx * 8, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xh[c][i] = (xv[i] - m) * rs;
          a[c][i] = gv[i] * wv[i];
          s_a += a[c][i];
          s_ax += a[c][i] * xh[c][i];
          aw[c][i] += gv[i] * xh[c][i];
          ab[c][i] += gv[i];
        }
      }
    }
    const float m1 = warp_sum(s_a) / e;
    const float m2 = warp_sum(s_ax) / e;
    Tx* dxr = dx + (long long)row * e;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int idx = lane + c * 32;
      if (idx < chunks) {
        float out[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          out[i] = rs * (a[c][i] - m1 - xh[c][i] * m2);
        }
        store8(dxr + idx * 8, out);
      }
    }
  }

  // the block's partial: the warps' sums added in warp order
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int idx = lane + c * 32;
      if (idx < chunks) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          red[warp * e + idx * 8 + i] = pass == 0 ? aw[c][i] : ab[c][i];
        }
      }
    }
    __syncthreads();
    float* part = (pass == 0 ? part_w : part_b) + (long long)blockIdx.x * e;
    for (int col = threadIdx.x; col < e; col += blockDim.x) {
      float s = 0.f;
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * e + col];
      part[col] = s;
    }
    __syncthreads();
  }
}

template <typename Tx, typename Tdy>
__global__ void __launch_bounds__(32 * kWarps)
ln_bwd_scalar_kernel(const Tx* __restrict__ x, const Tdy* __restrict__ dy,
                     const float* __restrict__ w, const float* __restrict__ mu,
                     const float* __restrict__ rstd, Tx* __restrict__ dx,
                     float* __restrict__ part_w, float* __restrict__ part_b,
                     int n, int e) {
  const int gw = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* pw = part_w + (long long)gw * e;   // this warp's partial rows
  float* pb = part_b + (long long)gw * e;
  for (int i = lane; i < e; i += 32) pw[i] = pb[i] = 0.f;
  const int first = gw * kRowsPerWarp;
  for (int row = first; row < min(first + kRowsPerWarp, n); ++row) {
    const Tx* xr = x + (long long)row * e;
    const Tdy* dyr = dy + (long long)row * e;
    const float m = mu[row], rs = rstd[row];
    float s_a = 0.f, s_ax = 0.f;
    for (int i = lane; i < e; i += 32) {
      const float xh = (to_float(xr[i]) - m) * rs;
      const float g = to_float(dyr[i]);
      const float a = g * w[i];
      s_a += a;
      s_ax += a * xh;
      pw[i] += g * xh;
      pb[i] += g;
    }
    const float m1 = warp_sum(s_a) / e;
    const float m2 = warp_sum(s_ax) / e;
    Tx* dxr = dx + (long long)row * e;
    for (int i = lane; i < e; i += 32) {
      const float xh = (to_float(xr[i]) - m) * rs;
      const float a = to_float(dyr[i]) * w[i];
      dxr[i] = from_float<Tx>(rs * (a - m1 - xh * m2));
    }
  }
}

// dw[col] (blockIdx.y 0) or db[col] (1) = sum over the partial rows in
// order: 8 groups of threads each sum every 8th row, then one thread adds
// the 8 group sums in group order.
constexpr int kRedCols = 32;
constexpr int kRedGroups = 8;

__global__ void __launch_bounds__(kRedCols * kRedGroups)
ln_bwd_reduce_kernel(const float* __restrict__ part_w,
                     const float* __restrict__ part_b, int parts, int e,
                     float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float sums[kRedGroups][kRedCols];
  const int c = threadIdx.x % kRedCols;
  const int grp = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;
  const float* part = blockIdx.y == 0 ? part_w : part_b;
  float s = 0.f;
  if (col < e) {
    for (int r = grp; r < parts; r += kRedGroups) {
      s += part[(long long)r * e + col];
    }
  }
  sums[grp][c] = s;
  __syncthreads();
  if (grp == 0 && col < e) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRedGroups; ++i) t += sums[i][c];
    (blockIdx.y == 0 ? dw : db)[col] = t;
  }
}

bool use_vector(int e, int vector_ok) {
  return vector_ok && e % 8 == 0 && e / 8 <= 32 * kMaxChunks;
}

int blocks_for(int n) { return (n + kRowsPerBlock - 1) / kRowsPerBlock; }

template <typename Tx, typename Tdy>
cudaError_t launch(const void* x, const void* dy, const float* w,
                   const float* mu, const float* rstd, void* dx, float* dw,
                   float* db, float* work, int n, int e, int vector_ok,
                   cudaStream_t s) {
  const int blocks = blocks_for(n);
  const bool vec = use_vector(e, vector_ok);
  const int parts = vec ? blocks : blocks * kWarps;
  float* part_w = work;
  float* part_b = work + (long long)parts * e;
  const dim3 block(32 * kWarps);
  if (vec) {
    ln_bwd_vec_kernel<Tx, Tdy><<<blocks, block, kWarps * e * sizeof(float),
                                 s>>>(
        static_cast<const Tx*>(x), static_cast<const Tdy*>(dy), w, mu, rstd,
        static_cast<Tx*>(dx), part_w, part_b, n, e);
  } else {
    ln_bwd_scalar_kernel<Tx, Tdy><<<blocks, block, 0, s>>>(
        static_cast<const Tx*>(x), static_cast<const Tdy*>(dy), w, mu, rstd,
        static_cast<Tx*>(dx), part_w, part_b, n, e);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((e + kRedCols - 1) / kRedCols, 2);
  ln_bwd_reduce_kernel<<<rgrid, kRedCols * kRedGroups, 0, s>>>(
      part_w, part_b, parts, e, dw, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 elements of workspace that bpx_layer_norm_bwd needs for (n, e).
long long bpx_layer_norm_bwd_workspace(int n, int e) {
  return 2LL * blocks_for(n) * kWarps * e;
}

// x, dy, dx (n, e) contiguous (x and dx one type, dy bf16 or fp32); w (e,)
// fp32; mu, rstd (n,) fp32 from the forward; dw, db (e,) fp32; work as
// sized by bpx_layer_norm_bwd_workspace.  vector_ok says every pointer is
// 16-byte aligned.  Returns a cudaError_t (0 on success).
int bpx_layer_norm_bwd(const void* x, const void* dy, const void* w,
                       const void* mu, const void* rstd, void* dx, void* dw,
                       void* db, void* work, int n, int e, int x_bf16,
                       int dy_bf16, int vector_ok, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* muf = static_cast<const float*>(mu);
  const float* rsf = static_cast<const float*>(rstd);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && dy_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, dy, wf, muf, rsf, dx, dwf,
                                               dbf, wk, n, e, vector_ok, s);
  } else if (x_bf16) {
    err = launch<__nv_bfloat16, float>(x, dy, wf, muf, rsf, dx, dwf, dbf, wk,
                                       n, e, vector_ok, s);
  } else if (dy_bf16) {
    err = launch<float, __nv_bfloat16>(x, dy, wf, muf, rsf, dx, dwf, dbf, wk,
                                       n, e, vector_ok, s);
  } else {
    err = launch<float, float>(x, dy, wf, muf, rsf, dx, dwf, dbf, wk, n, e,
                               vector_ok, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
