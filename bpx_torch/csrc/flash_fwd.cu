// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 lse.
//
// Replaces the single-pass branch of the TPU kernel
// bpx/ops/pallas_attention.py::_fwd_kernel (launched from _fwd through
// flash_attention) at dropout rate 0.  The function it computes, per
// (batch*head, query row):
//   s     = q . k^T in fp32 (q arrives pre-scaled by head_dim**-0.5)
//   s     = -1e30 where col >= kv_len[b] or (masked and col > row + offset)
//   m     = max_col s,  p = exp(s - m),  l = sum_col p  (fp32, unnormalised)
//   o     = (bf16(p) . v) / l     (l == 0 -> 1)
//   lse   = m + log(l)
// The -1e30 fill (not -inf) is part of the contract: a row whose every key is
// masked attends uniformly over all Tk keys, as the TPU kernel does.
//
// Design.  The TPU kernel holds a whole-Tk fp32 score tile (up to 512 x 1024)
// in VMEM; an SM cannot.  Here one block of 4 warps owns 64 query rows (16 per
// warp) of one (batch, head) and walks the keys in tiles of 64 with the online
// softmax of FlashAttention-2: the running max m and the per-thread partial
// row sums l are rescaled by exp(m_old - m_new) whenever the max grows, and the
// fp32 output accumulator with them.  Products run on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, fp32 accumulation); the score accumulator
// of S = Q K^T is re-packed in registers as the A operand of P V, so P never
// touches shared memory.  V's B operand comes from ldmatrix.trans.  Tiles whose
// every entry is masked (above the band, or past kv_len) are skipped, which is
// exact whenever some key of the row is visible (kv_len > 0); with kv_len <= 0
// every tile is visited so the uniform-attention result above is kept.
//
// Bound on an H100: the forward moves q, k, v and o once (bf16) and does
// 4*Tq*Tk*D flops per (batch, head); at the model's shapes (T <= 512, D 64/96)
// the arithmetic intensity is below the card's ~295 flop/byte balance point,
// so the bound is the bytes, and what matters is streaming K/V through
// shared memory once per 64-row query tile.  Loads are synchronous 16-byte
// vector loads here; a cp.async/TMA pipeline and wgmma are later work.
//
// Inputs are (B, H, T, D) tensors addressed by strides (the last dim
// contiguous, every stride a multiple of 8 elements, pointers 16-byte
// aligned), so the q/k/v views of a fused projection need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;   // query rows per block
constexpr int kBlockK = 64;            // keys per tile
constexpr float kMaskFill = -1e30f;    // the TPU kernel's NEG_INF

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;              // (B*H, Tq)
  const int* kv_lens;      // (B,) or nullptr
  int B, H, Tq, Tk;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int masked;
  int offset;
};

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

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_kernel(const FlashParams p) {
  // three (64 x (D+8)) bf16 tiles must fit the 48 KB of static shared memory
  static_assert(D % 16 == 0 && D <= 96, "head_dim must be 16*k, at most 96");
  // +8 bf16 of padding per row keeps the fragment loads and ldmatrix rows on
  // distinct banks
  constexpr int LDS = D + 8;
  constexpr int kDChunks = D / 16;   // k-steps of Q K^T
  constexpr int kDTiles = D / 8;     // n-tiles of P V
  constexpr int kKTiles = kBlockK / 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK * LDS];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row within the warp's 16 (and g + 8)
  const int t4 = lane % 4;    // column pair within an 8-wide n-tile

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;

  load_tile<D, LDS>(q_s, qb, p.q_st, q0, p.Tq, kBlockQ);
  __syncthreads();

  // this warp's Q rows as A fragments, kept in registers for the whole loop
  uint32_t qf[kDChunks][4];
  {
    const __nv_bfloat16* r0 = q_s + (warp * 16 + g) * LDS + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * LDS;
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      qf[c][0] = *reinterpret_cast<const uint32_t*>(r0 + c * 16);
      qf[c][1] = *reinterpret_cast<const uint32_t*>(r1 + c * 16);
      qf[c][2] = *reinterpret_cast<const uint32_t*>(r0 + c * 16 + 8);
      qf[c][3] = *reinterpret_cast<const uint32_t*>(r1 + c * 16 + 8);
    }
  }

  const int row0 = q0 + warp * 16 + g;   // global query rows of this thread
  const int row1 = row0 + 8;

  // key tiles to visit
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (kv_len > 0) {
    n_tiles = min(n_tiles, (kv_len + kBlockK - 1) / kBlockK);
    if (p.masked) {
      const int last_col = q0 + kBlockQ - 1 + p.offset;
      n_tiles = min(n_tiles, last_col / kBlockK + 1);
    }
  }

  float m0 = kMaskFill, m1 = kMaskFill;   // running row max
  float l0 = 0.f, l1 = 0.f;               // per-thread partial row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // every warp is done with the previous tile
    load_tile<D, LDS>(k_s, kb, p.k_st, k0, Tk, kBlockK);
    load_tile<D, LDS>(v_s, vb, p.v_st, k0, Tk, kBlockK);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp
    float s[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (j * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + c * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + c * 16 + 8);
        mma_16816(s[j], qf[c], b0, b1);
      }
    }

    // masks: -inf past Tk (not a key at all), -1e30 for masked keys
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        if (col >= Tk) {
          s[j][e] = -INFINITY;
        } else if (col >= kv_len || (p.masked && col > row + p.offset)) {
          s[j][e] = kMaskFill;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += bf16(P) V: the S accumulator layout of two adjacent n-tiles is the
    // A fragment of one 16-key k-step
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int vrow = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vcol = (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kDTiles; n += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, v_s + vrow * LDS + n * 8 + vcol);
        mma_16816(acc[n], pa, vb4[0], vb4[1]);
        mma_16816(acc[n + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if (row0 < p.Tq) {
    __nv_bfloat16* orow = ob + row0 * p.o_st + 2 * t4;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(acc[n][0] / ls0, acc[n][1] / ls0);
    }
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Tq) {
    __nv_bfloat16* orow = ob + row1 * p.o_st + 2 * t4;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(acc[n][2] / ls1, acc[n][3] / ls1);
    }
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row1] = m1 + logf(ls1);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a head_dim
// without an instantiation.
int bpx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* kv_lens, int B, int H, int Tq, int Tk,
                  int D, long long q_sb, long long q_sh, long long q_st,
                  long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st,
                  long long o_sb, long long o_sh, long long o_st, int masked,
                  int offset, void* stream) {
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.masked = masked;
  p.offset = offset;
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  const dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      flash_fwd_kernel<64><<<grid, block, 0, s>>>(p);
      break;
    case 96:
      flash_fwd_kernel<96><<<grid, block, 0, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
