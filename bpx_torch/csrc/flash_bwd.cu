// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV in bf16.
//
// Replaces the TPU kernel bpx/ops/pallas_attention.py::_bwd_fused_kernel
// (launched from _bwd), and with it the split pair _bwd_dq_kernel /
// _bwd_dkv_kernel that _bwd takes for long sequences: it computes what they
// compute, not their structure.  Per (batch*head), with P recomputed from
// the forward's saved log-sum-exp and delta = rowsum(dO * O) precomputed in
// fp32 by the caller:
//   s   = q . k^T (fp32), ok = col < kv_len && (!masked || col <= row + off)
//   p   = ok ? exp(s - lse[row]) : 0      (masked entries get P = 0, so a
//                                          row with no visible key gets zero
//                                          gradients, as on the TPU)
//   dp  = dO . v^T
//   with dropout: pd = keep ? p * inv_keep : 0, dp = keep ? dp * inv_keep : 0
//   dV  = bf16(pd)^T . dO,  ds = bf16(p * (dp - delta[row]))
//   dK  = ds^T . q,         dQ = ds . k
// The keep bit is the forward's (flash_common.cuh), regenerated from the
// seed; the band is dropped by the caller when it is vacuous, as in the
// forward.
//
// Design.  The TPU kernel holds the whole Tq x Tk tile of one (batch, head)
// in VMEM and emits dQ, dK and dV from it in one program; an SM cannot hold
// it.  Two kernels instead, both deterministic and without atomics:
//   * dK/dV: one block of 4 warps per (batch*head, 64-key tile), 16 keys per
//     warp, looping over 64-query tiles.  It works on the transposed scores
//     S^T = K Q^T, so P^T and dS^T come out of the tensor cores in the A
//     fragment layout of dV += P^T dO and dK += dS^T Q.
//   * dQ: one block per (batch*head, 64-query tile), looping over 64-key
//     tiles; dQ += dS K.
// Tiles wholly above the band or past kv_len have P = 0 everywhere and are
// skipped, which is exact here (unlike in the forward) for every kv_len.
// Products use mma.sync m16n8k16 (bf16 operands, fp32 accumulation), as in
// the forward; the recomputed S and dP are each computed twice (once per
// kernel), the price of dropping the cross-block reduction of dQ.
//
// Bound on an H100: 5 products of 2 * D flops per visible score entry
// against q, k, v, dO read and dq, dk, dv written once; at the model's
// shapes (T <= 512, D 64/96) the bytes bound it.  Loads are synchronous
// 16-byte vector loads; a cp.async/TMA pipeline and wgmma are later work.
//
// Inputs and outputs are (B, H, T, D) tensors addressed by strides (last dim
// contiguous, strides multiples of 8 elements, 16-byte aligned pointers);
// lse and delta are (B*H, Tq) fp32.

#include "flash_common.cuh"

namespace {

using namespace bpx_flash;

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;   // rows of the block's own tile
constexpr int kSpan = 64;            // rows of the tile it loops over

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;        // (B*H, Tq)
  const float* delta;      // (B*H, Tq)
  const int* kv_lens;      // (B,) or nullptr
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, H, Tq, Tk;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;     // dO
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  int masked;
  int offset;
  Dropout drop;
};

template <int D>
constexpr int smem_bytes() {
  return 4 * kSpan * (D + 8) * 2 + 2 * kSpan * 4;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
}

// Write a warp's 16 x D fp32 accumulator as bf16 rows r0 and r0 + 8.
template <int DT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st,
                                           int r0, int T, const float acc[][4],
                                           int t4) {
  if (r0 < T) {
    __nv_bfloat16* row = base + r0 * st + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16x2(acc[n][0], acc[n][1]);
    }
  }
  if (r0 + 8 < T) {
    __nv_bfloat16* row = base + (r0 + 8) * st + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16x2(acc[n][2], acc[n][3]);
    }
  }
}

// One (batch*head, 64-key tile): dK and dV.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LDS = D + 8;
  constexpr int kDChunks = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kTile * LDS;
  __nv_bfloat16* q_s = v_s + kTile * LDS;
  __nv_bfloat16* o_s = q_s + kSpan * LDS;          // dO
  float* lse_s = reinterpret_cast<float*>(o_s + kSpan * LDS);
  float* dl_s = lse_s + kSpan;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;

  float dk[kDTiles][4], dv[kDTiles][4];
  zero_acc(dk);
  zero_acc(dv);

  // query tiles that see a key of this tile: none past kv_len; with the
  // band, only rows with row + offset >= k0
  int q_begin = 0;
  int q_end = (Tq + kSpan - 1) / kSpan;
  if (k0 >= kv_len) q_end = 0;
  if (p.masked) q_begin = max(0, k0 - p.offset) / kSpan;

  if (q_begin < q_end) {
    load_tile<D, LDS>(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_st, k0, Tk,
                      kTile);
    load_tile<D, LDS>(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_st, k0, Tk,
                      kTile);
  }
  for (int qt = q_begin; qt < q_end; ++qt) {
    const int q0 = qt * kSpan;
    __syncthreads();   // every warp is done with the previous tile
    load_tile<D, LDS>(q_s, qb, p.q_st, q0, Tq, kSpan);
    load_tile<D, LDS>(o_s, ob, p.o_st, q0, Tq, kSpan);
    for (int i = threadIdx.x; i < kSpan; i += blockDim.x) {
      const bool in = q0 + i < Tq;
      lse_s[i] = in ? lse_b[q0 + i] : 0.f;
      dl_s[i] = in ? dl_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float st[8][4], dpt[8][4];
    zero_acc(st);
    zero_acc(dpt);
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      uint32_t ka[4], va[4];
      load_a_frag<LDS>(ka, k_s, warp * 16, c, lane);
      load_a_frag<LDS>(va, v_s, warp * 16, c, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b_frag<LDS>(b0, b1, q_s, j, c, lane);
        mma_16816(st[j], ka, b0, b1);
        load_b_frag<LDS>(b0, b1, o_s, j, c, lane);
        mma_16816(dpt[j], va, b0, b1);
      }
    }

    // P^T (masked entries 0), dropout, dS^T; pdt reuses the S^T registers
    // once dS^T is formed
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t4 + (e & 1);    // query within the tile
        const int row = q0 + qi;
        const int col = (e < 2) ? key0 : key0 + 8;
        const bool ok = row < Tq && col < Tk && col < kv_len &&
                        (!p.masked || col <= row + p.offset);
        const float pr = ok ? expf(st[j][e] - lse_s[qi]) : 0.f;
        float dpr = dpt[j][e];
        float pdr = pr;
        if (p.drop.on) {
          const bool kept = p.drop.keep(bh, row, col);
          pdr = kept ? pr * p.drop.inv_keep : 0.f;
          dpr = kept ? dpr * p.drop.inv_keep : 0.f;
        }
        dpt[j][e] = pr * (dpr - dl_s[qi]);   // dS^T
        st[j][e] = pdr;                      // dropped P^T
      }
    }
    mma_p_tile<kDTiles, LDS>(dv, st, o_s, lane);    // dV += P^T dO
    mma_p_tile<kDTiles, LDS>(dk, dpt, q_s, lane);   // dK += dS^T Q
  }

  store_rows<kDTiles>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st,
                      k0 + warp * 16 + g, Tk, dk, t4);
  store_rows<kDTiles>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st,
                      k0 + warp * 16 + g, Tk, dv, t4);
}

// One (batch*head, 64-query tile): dQ.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LDS = D + 8;
  constexpr int kDChunks = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* o_s = q_s + kTile * LDS;          // dO
  __nv_bfloat16* k_s = o_s + kTile * LDS;
  __nv_bfloat16* v_s = k_s + kSpan * LDS;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;
  const float lse0 = row0 < Tq ? lse_b[row0] : 0.f;
  const float lse1 = row0 + 8 < Tq ? lse_b[row0 + 8] : 0.f;
  const float dl0 = row0 < Tq ? dl_b[row0] : 0.f;
  const float dl1 = row0 + 8 < Tq ? dl_b[row0 + 8] : 0.f;

  float dq[kDTiles][4];
  zero_acc(dq);

  // key tiles with a visible key: none past kv_len, none above the band
  int n_tiles = (min(Tk, max(kv_len, 0)) + kSpan - 1) / kSpan;
  if (p.masked) {
    n_tiles = min(n_tiles, (q0 + kTile - 1 + p.offset) / kSpan + 1);
  }

  if (n_tiles > 0) {
    load_tile<D, LDS>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, Tq,
                      kTile);
    load_tile<D, LDS>(o_s, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, q0, Tq,
                      kTile);
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kSpan;
    __syncthreads();
    load_tile<D, LDS>(k_s, kb, p.k_st, k0, Tk, kSpan);
    load_tile<D, LDS>(v_s, vb, p.v_st, k0, Tk, kSpan);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      uint32_t qa[4], oa[4];
      load_a_frag<LDS>(qa, q_s, warp * 16, c, lane);
      load_a_frag<LDS>(oa, o_s, warp * 16, c, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b_frag<LDS>(b0, b1, k_s, j, c, lane);
        mma_16816(s[j], qa, b0, b1);
        load_b_frag<LDS>(b0, b1, v_s, j, c, lane);
        mma_16816(dp[j], oa, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? row0 : row0 + 8;
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool ok = row < Tq && col < Tk && col < kv_len &&
                        (!p.masked || col <= row + p.offset);
        const float pr =
            ok ? expf(s[j][e] - ((e < 2) ? lse0 : lse1)) : 0.f;
        float dpr = dp[j][e];
        if (p.drop.on) {
          dpr = p.drop.keep(bh, row, col) ? dpr * p.drop.inv_keep : 0.f;
        }
        s[j][e] = pr * (dpr - ((e < 2) ? dl0 : dl1));   // dS
      }
    }
    mma_p_tile<kDTiles, LDS>(dq, s, k_s, lane);   // dQ += dS K
  }

  store_rows<kDTiles>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st, row0, Tq,
                      dq, t4);
}

template <int D>
cudaError_t launch(const BwdParams& p, cudaStream_t s) {
  static bool smem_dkdv = false, smem_dq = false;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, bytes, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<D>, bytes, smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 block(32 * kWarps);
  const dim3 grid_kv((p.Tk + kTile - 1) / kTile, p.B * p.H);
  flash_bwd_dkdv_kernel<D><<<grid_kv, block, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Tq + kTile - 1) / kTile, p.B * p.H);
  flash_bwd_dq_kernel<D><<<grid_q, block, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dO, dq, dk, dv: (B, H, T, D) bf16 by strides (b, h, t); lse and
// delta (B*H, Tq) fp32; kv_lens (B,) int32 or null.  Launches the dK/dV
// kernel, then the dQ kernel, on the stream.  Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for a head_dim without an instantiation.
int bpx_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* kv_lens, void* dq, void* dk, void* dv, int B,
                  int H, int Tq, int Tk, int D, long long q_sb,
                  long long q_sh, long long q_st, long long k_sb,
                  long long k_sh, long long k_st, long long v_sb,
                  long long v_sh, long long v_st, long long o_sb,
                  long long o_sh, long long o_st, long long dq_sb,
                  long long dq_sh, long long dq_st, long long dk_sb,
                  long long dk_sh, long long dk_st, long long dv_sb,
                  long long dv_sh, long long dv_st, int masked, int offset,
                  int dropout, unsigned int seed, unsigned int threshold,
                  float inv_keep, int tk_p, void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.masked = masked;
  p.offset = offset;
  p.drop.on = dropout;
  p.drop.seed = seed;
  p.drop.threshold = threshold;
  p.drop.inv_keep = inv_keep;
  p.drop.tk_p = static_cast<uint32_t>(tk_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(p, s));
    case 96:
      return static_cast<int>(launch<96>(p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
