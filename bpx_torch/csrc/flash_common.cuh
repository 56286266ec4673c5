// Device helpers shared by the flash-attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels: tensor-core fragments, tile loads, and the
// in-kernel dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bpx_flash {

constexpr float kMaskFill = -1e30f;   // the TPU kernels' NEG_INF

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy rows [t0, t0 + rows) of one (batch, head) slice into shared memory
// with 16-byte vector loads; rows past T are zero-filled.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride_t, int t0, int T,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (t0 + r) * stride_t + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

// A fragment (16 x 16, row-major) of rows [r16, r16 + 16) and columns
// [16 c, 16 c + 16) of a bf16 tile in shared memory with row pitch LDS.
template <int LDS>
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile,
                                            int r16, int c, int lane) {
  const __nv_bfloat16* r0 = tile + (r16 + lane / 4) * LDS + 2 * (lane % 4);
  const __nv_bfloat16* r1 = r0 + 8 * LDS;
  a[0] = *reinterpret_cast<const uint32_t*>(r0 + c * 16);
  a[1] = *reinterpret_cast<const uint32_t*>(r1 + c * 16);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + c * 16 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + c * 16 + 8);
}

// B fragment (16 x 8, "col") whose n index runs over tile rows
// [8 j, 8 j + 8) and whose k index runs over columns [16 c, 16 c + 16):
// the operand of X . tile^T.
template <int LDS>
__device__ __forceinline__ void load_b_frag(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int j,
                                            int c, int lane) {
  const __nv_bfloat16* r = tile + (j * 8 + lane / 4) * LDS + 2 * (lane % 4);
  b0 = *reinterpret_cast<const uint32_t*>(r + c * 16);
  b1 = *reinterpret_cast<const uint32_t*>(r + c * 16 + 8);
}

// acc[0 .. DT) += P . tile, where P is a 16 x 64 fp32 accumulator set
// (eight 16x8 n-tiles, the layout mma leaves them in) cast to bf16, and tile
// is 64 x (8 DT) bf16 in shared memory: the k index runs over tile rows.
// The accumulator layout of two adjacent n-tiles is the A fragment of one
// 16-deep k-step, so P never touches shared memory.
template <int DT, int LDS>
__device__ __forceinline__ void mma_p_tile(float acc[][4], const float p[8][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16x2(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const int vrow = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vcol = (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      uint32_t vb4[4];
      ldmatrix_x4_trans(vb4, tile + vrow * LDS + n * 8 + vcol);
      mma_16816(acc[n], pa, vb4[0], vb4[1]);
      mma_16816(acc[n + 1], pa, vb4[2], vb4[3]);
    }
  }
}

// Dropout parameters of one call.  keep() is the TPU kernels' _keep_mask
// (bpx/ops/pallas_attention.py:102): the global element index
// bh * 0x85EBCA6B + row * tk_p + col in uint32 with wrap, then a 2-round
// xorshift-multiply mixer with the seed, kept when >= threshold.
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;   // min(int(rate * 2**32), 2**32 - 1)
  float inv_keep;       // float32(1 / (1 - rate))
  uint32_t tk_p;        // the key length the TPU kernels index with

  __device__ __forceinline__ bool keep(int bh, int row, int col) const {
    const uint32_t idx = static_cast<uint32_t>(bh) * 0x85EBCA6Bu +
                         static_cast<uint32_t>(row) * tk_p +
                         static_cast<uint32_t>(col);
    uint32_t x = idx * 0x9E3779B9u + seed;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    return x >= threshold;
  }
};

// Set a kernel's dynamic shared-memory limit once per process.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace bpx_flash
