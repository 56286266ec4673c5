// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV in bf16.
//
// Replaces the TPU kernel bpx/ops/pallas_attention.py::_bwd_fused_kernel
// (launched from _bwd), and with it the split pair _bwd_dq_kernel /
// _bwd_dkv_kernel that _bwd takes for long sequences: it computes what they
// compute, not their structure.  Per (batch*head), with P recomputed from
// the forward's saved log-sum-exp:
//   delta = rowsum(dO * O) in fp32      (the TPU kernels' in-kernel delta,
//                                        BPX_XLA_DELTA=0, :484-488)
//   s   = q . k^T (fp32), ok = col < kv_len && (!masked || col <= row + off)
//   p   = ok ? exp(s - lse[row]) : 0      (masked entries get P = 0, so a
//                                          row with no visible key gets zero
//                                          gradients, as on the TPU)
//   dp  = dO . v^T
//   with dropout: pd = keep ? p * inv_keep : 0, dp = keep ? dp * inv_keep : 0
//   dV  = bf16(pd)^T . dO,  ds = bf16(p * (dp - delta[row]))
//   dK  = ds^T . q,         dQ = ds . k
// The keep bit is the forward's (flash_common.cuh), regenerated from the
// block's seed; the band is dropped by the caller when it is vacuous, as in the
// forward.
//
// Design.  The TPU kernel holds the whole Tq x Tk tile of one (batch, head)
// in VMEM and emits dQ, dK and dV from it in one program; an SM cannot hold
// it.  At D = 64 and 96, three launches on the stream, deterministic and
// without atomics (the other head dims' two are below):
//   * delta: two rows per warp, dO and O read once, a fixed-order sum;
//   * dK/dV: one warpgroup per (batch*head, 64-key tile) with K and V
//     resident, looping over 64-query tiles of Q, dO, lse and delta that
//     stream through a 3-stage cp.async ring.  It
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T with
//     wgmma (K, V, Q, dO all K-major in shared memory), so P^T and dS^T
//     come out of the accumulator in the register A-fragment layout of
//     dV += P^T dO and dK += dS^T Q, whose B operands (dO, Q) are read
//     MN-major from the same tiles;
//   * dQ: one warpgroup per (batch*head, 64-query tile) with Q and dO
//     resident, K and V streaming; S = Q K^T, dP = dO V^T, dQ += dS K.
// S and dP are computed in both the dK/dV and the dQ kernel: the price of
// no cross-block reduction of dQ (a fused kernel would need atomics, or a
// cluster reducing dQ in a fixed order through distributed shared memory).
// Tiles wholly above the band or past kv_len have P = 0 everywhere and are
// skipped, which is exact here (unlike in the forward) for every kv_len; only
// edge tiles (the band's diagonal, kv_len, Tk) test each entry.  Queries
// past Tq need no test on interior tiles: their Q and dO rows, lse and
// delta are zero-filled, so they add nothing.
// Registers bound the occupancy: the dK/dV kernel holds dK, dV, S^T and
// dP^T (D + 64 fp32 per thread): 2 blocks per SM at both head dims (100 KB
// of shared memory each at D = 96); at D = 64 a cap of 168 registers for a
// third block spills and measured slower.
//
// Narrow heads (D = 25, 30: iemocap, cmu-mosei, counseling, cmu-mosi) run
// at DP = 32 as the forward does (flash_common.cuh): S^T, dP^T, S and dP in
// 2 k-steps, dV, dK and dQ as m64n32k16.  Their kernels are their own
// (flash_bwd_narrow_*), two launches a backward:
//   * dQ first, one warpgroup per (batch*head, 64-query tile) as above,
//     which also loads its 64 rows of O beside the resident dO, computes
//     delta for them in fp32 (a fixed order: two threads a row, then their
//     sum) and writes it to the workspace; rows past Tq, zero-filled,
//     give 0 and are not written;
//   * dK/dV second, as above, reading delta from the workspace.  It is
//     launched as the dQ kernel's programmatic dependent: its blocks may
//     start, and load K and V, while the dQ kernel's last blocks run, and
//     wait (griddepcontrol.wait) for the whole dQ grid before they read
//     delta.  Nothing else it reads is written by the dQ kernel.
// The grids put batch*head along x and the tiles along y, in the order
// that starts the blocks with the most tiles of a causal band first (key
// tile 0 for dK/dV, the last query tile for dQ), so that the short blocks
// fill the tail.  At D = 25 the rows are 2-byte aligned and cp.async
// cannot copy them: each streamed tile's 4-byte words are loaded into
// registers before the products of the tile before and written to shared
// memory after them (NarrowTile, flash_common.cuh); D = 30 streams 4-byte
// cp.async words through a 3-stage ring.  The dK/dV kernel takes 167-168
// registers a thread, no spills, 3 blocks per SM; the dQ kernel is held to
// 128 for a fourth block (at most 64 bytes of spills), which measured
// faster than 3 blocks at 143-159.  Measured on an H100 (PERF.md,
// scripts/torch_flash_bwd_narrow.py), one step at a time: delta folded in,
// then the tiles' order, then the dependent launch, then the dQ kernel's
// fourth block each made it faster; the loads off the chain gained about
// 1%; two consumer warpgroups a block (sharing the streamed tiles, 128
// registers a thread, 2 blocks per SM), the softmax and dS overlapping
// in-flight wgmmas inside one warpgroup, and a dK/dV kernel that streams
// O to compute delta itself (waiting for nothing) measured slower and are
// not kept.
// Bound: the bytes, 8 x B*H*T*D*2 at the model's shapes (q, k, v, dO, O
// read, dq, dk, dv written); these kernels reach about a tenth of it: each
// 64 x 64 tile step is a serial chain (wait, products, softmax and dS,
// products, wait) of a few microseconds, and three chains an SM do not
// hide it.
//
// D = 128 (mmimdb: 768 / 6) has kernels of its own (flash_bwd_wide_*),
// two launches a backward as at the narrow heads, both grids longest
// blocks first:
//   * dQ first, one warpgroup per (batch*head, 64-query tile) as above,
//     which also computes delta for its rows; O is staged in the ring stage
//     that the 2-stage prologue leaves empty, so the block keeps 97 KB of
//     shared memory and two blocks fit an SM (223 registers, no spills);
//   * dK/dV second, its programmatic dependent, two consumer warpgroups in
//     a 256-thread block per (batch*head, 64-key tile): K and V resident,
//     Q, dO, lse and delta through a 3-stage ring (132 KB, one block per
//     SM).  Warpgroup w takes queries 32 w .. 32 w + 31 of each query
//     tile: S^T and dP^T for them (m64n32k16, 8 k-steps each), then dV and
//     dK over all 128 columns from them (m64n128k16, 2 k-steps each, A from
//     registers).  So S^T and dP^T are computed once per (key tile, query
//     tile), no product is repeated, and nothing is exchanged inside a
//     tile step; a thread holds dK and dV (64 + 64 fp32) beside S^T and
//     dP^T (16 + 16): 230 registers, no spills.  Each warpgroup loads
//     and waits for (a named barrier) only its own rows of each stage, so
//     the two drift apart and one's softmax overlaps the other's products.
//     The two warpgroups' dK and dV are added once, at the end, through
//     shared memory: dK = dK_0 + dK_1 and dV = dV_0 + dV_1, a fixed order.
// Measured on an H100 (PERF.md, scripts/torch_flash_bwd_narrow.py), one
// step at a time, each faster than the one before: the order, delta in the
// dQ kernel with dK/dV its dependent, the two warpgroups, a third stage,
// the decoupled warpgroups.  Splitting the warpgroups by product instead
// (S^T and P^T in one, dP^T in the other, P and dS exchanged through
// shared memory every tile step), two warpgroups in the dQ kernel (each
// half the keys of a tile, at one or two blocks per SM) and a third dQ
// stage (one block per SM) measured slower and are not kept.  The
// backward reaches about a fifth of its bound: a tile step is still a
// serial chain per warpgroup, and one dK/dV block an SM holds two.
//
// D = 50 and 60 (mmtrvpa's memory encoders at iemocap's and at cmu-mosei's,
// counseling's and cmu-mosi's widths: 600 / 12, 600 / 10) run the D 128
// kernels at DP = 64, two launches, both grids longest blocks first: the
// loads write columns D..63 as zeros (4- or 8-byte cp.async words on one
// running row pointer, load_tile_by and load_rows_by), and dQ, dK and dV
// are stored up to column D, since the next head's values sit past it.
//   * dQ first, one warpgroup per (batch*head, 64-query tile), last query
//     tile first, delta for its rows from O staged in the ring stage the
//     prologue leaves empty; 2 stages of 8 KB K and V tiles (49 KB), three
//     blocks an SM at a cap of 168 registers (at D 50 16 bytes of spills);
//   * dK/dV second, its programmatic dependent, key tile 0 first: one
//     warpgroup per (batch*head, 64-key tile), K and V resident, 2 stages of
//     Q, dO, lse and delta (51 KB), three blocks an SM at a cap of 168
//     registers (52-104 bytes of spills).
// Measured on an H100 at iemocap's (8, 12, 512, 512) and cmu-mosei's (8,
// 10, 512, 512) causal classes (PERF.md, scripts/torch_flash_bwd_narrow.py),
// rate 0 / 0.1, each step against the one before in one call: the D 64
// kernels' three launches at DP = 64 (delta; dK/dV on (key tile,
// batch*head) grids, 187 registers, 2 blocks an SM; dQ) 0.1018 / 0.1305
// and 0.0801 / 0.1034 ms; these two launches with D 128's two-warpgroup
// dK/dV (one 256-thread block an SM, 161 registers) 0.0925 / 0.1048 and
// 0.0775 / 0.0880; one
// warpgroup at three blocks 0.0761 / 0.0917 and 0.0663 / 0.0788, where the
// two warpgroups at two blocks (a cap of 128 registers) read 0.0800 /
// 0.0950 and 0.0671 / 0.0783; the dQ ring at 2 stages 0.0742 / 0.0892 and
// 0.0622 / 0.0721, where four dQ blocks (a cap of 128, 84 bytes of spills
// at D 50) and two uncapped (250 registers at D 50) lost; the dK/dV ring
// at 2 stages 0.0730 / 0.0876 and 0.0582 / 0.0699.  A smaller block is
// what paid: the blocks of both kernels share the SMs while the dependent
// launch overlaps them, and a tile step's serial chain hides behind more
// blocks, not behind wider ones.
//
// D = 192 and 256 (mmtrvpa's 2E-wide memory encoders at moviescope's and
// at mmimdb's widths: 1536 / 8, 1536 / 6) have kernels of their own, two
// launches a backward as at D 128, both grids longest blocks first, two
// warpgroups a block that split each tile step's scores, so that no
// product is computed twice:
//   * dQ first (flash_bwd_keysplit_dq_kernel), one block per (batch*head,
//     64-query tile) with Q and dO resident, K and V through 2 stages at
//     256 (a 64 x 256 tile is 32 KB; 217 KB in all) and 3 at 192 (24 KB;
//     201 KB), delta for its rows from O staged in the stage the prologue
//     leaves empty; warpgroup w takes keys 32 w .. 32 w + 31 of each key
//     tile: S, dP, P, dropout and dS for them, its half of a bf16 dS tile
//     in shared memory, then dQ += dS K over its DP / 2 columns (A and B
//     from shared memory, m64n128k16 or m64n96k16); 156 registers at 256,
//     144 at 192;
//   * dK/dV second (flash_bwd_rowsplit_dkdv_kernel), its programmatic
//     dependent, one block per (batch*head, 64-key tile): K and V resident,
//     2 stages of Q, dO, lse and delta at 256 (211 KB), 3 at 192 (212 KB);
//     warpgroup w takes queries 32 w .. 32 w + 31 of each query tile: S^T,
//     dP^T, P^T and dS^T for them, its halves of bf16 P^T and dS^T tiles,
//     then dV += P^T dO and dK += dS^T Q over its DP / 2 columns; 209
//     registers at 256, 185 at 192.
// Per (key tile, query tile) the tensor cores run S, dP, dQ, S^T, dP^T, dV
// and dK once each (7 products of 64 x 64 x D) where the first designs ran
// 13 at 256 (four launches: delta; dV, dK and dQ, each warpgroup over half
// the columns; 0.2360 / 0.2701 ms below) and 11 at 192 (three: delta;
// dK/dV and dQ, each warpgroup all of S^T and dP^T (S and dP) and half the
// columns).
// Measured on an H100 at moviescope's (8, 8, 512, 512) and (8, 8, 200,
// 200) causal classes (PERF.md, scripts/torch_flash_bwd_narrow.py), rate 0
// / 0.1, in one call: these kernels at 192, 3 stages, 0.1320 / 0.1423 and
// 0.0490 / 0.0523 ms (cuDNN's 0.1395 / 0.1502 and 0.0571 / 0.0614); with 2
// stages (177 registers in dK/dV) 0.1325 / 0.1430 and 0.0493 / 0.0526; the
// first design 0.1845 / 0.2093 and 0.0669 / 0.0763.
// At 256, mmimdb's (8, 6, 512, 512) causal class, all in one call: these
// kernels 0.1278 / 0.1365 ms.  The warpgroups split by product instead
// (one computing S and P and handing P through shared memory with its
// keep bit in the sign, the other dP and dS; in dK/dV one S^T, P^T and
// dV, the other dP^T, dS^T and dK, P^T through a slot on named barriers,
// the stages on mbarriers; 169 / 236 registers) read 0.1313 / 0.1532, and
// that dQ kernel beside this dK/dV kernel 0.1325 / 0.1476: split by
// product, one warpgroup waits every step on the other's softmax and
// dropout hash, which the split by keys or rows shares out.
//
// Bound on an H100: 5 products of 2 * D flops per visible score entry
// against q, k, v, dO, o read and dq, dk, dv written once; at the model's
// shapes (T <= 512, D <= 256) the bytes bound it.
//
// Inputs and outputs are (B, H, T, D) tensors addressed by strides (last dim
// contiguous; D = 64, 96, 128, 192, 256: strides multiples of 8 elements,
// 16-byte aligned pointers; D = 60: strides multiples of 4, 8-byte
// aligned; D = 30, 50: even strides, 4-byte aligned; D = 25: any strides);
// lse and the delta workspace are (B*H, Tq) fp32.

#include "flash_common.cuh"

namespace {

using namespace bpx_flash;

// Streamed tiles in flight in the D = 64 and 96 kernels.
constexpr int kBwdStages = 3;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;        // (B*H, Tq)
  const float* delta;      // (B*H, Tq), written by flash_delta_kernel at
                           // D = 64, 96, by the dQ kernel at the others
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
  SeedGroups seed_groups;   // read by the kernels of several groups only
};

// dK/dV stage: Q tile, dO tile, lse[64] and delta[64] (1 KB keeps the next
// stage aligned).  dQ stage: K tile, V tile.
template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * tile_bytes<D>() + 1024;
}

// K and V resident, kBwdStages x (Q, dO, lse, delta); +1 KB for alignment.
template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 2 * tile_bytes<D>() + kBwdStages * dkdv_stage_bytes<D>() + 1024;
}

// Q and dO resident, kBwdStages x (K, V); +1 KB for alignment.
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 + 2 * kBwdStages) * tile_bytes<D>() + 1024;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// Write a warpgroup's 64 x DP fp32 accumulator (this thread: rows r0 and
// r0 + 8) as bf16 rows below T, columns below D.
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* base, long long st, int r0, int T,
    const float (&acc)[padded_dim<D>() / 2], int t4) {
  if (r0 < T) store_row<D, 0>(base + r0 * st, acc, t4, 1.f);
  if (r0 + 8 < T) store_row<D, 2>(base + (r0 + 8) * st, acc, t4, 1.f);
}

// delta[bh, t] = sum_d dO[b, h, t, d] * O[b, h, t, d] in fp32: half a warp
// per row, lanes summed in a fixed order.  D = 64, 96, 128, 192, 256: 16
// bytes of each per lane (at D 192 lanes 0-7 take a second chunk, 16 on; at
// 256 every lane two); a head whose rows are not 16-byte aligned (25, 30,
// 50, 60): columns lane, lane + 16, ..., in 2-byte loads.
template <int D>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                   float* delta, int H, int T, int rows, long long o_sb,
                   long long o_sh, long long o_st, long long do_sb,
                   long long do_sh, long long do_st) {
  static_assert(D % 32 == 0 || D < 64,
                "16-byte chunks or at most four columns per lane");
  const int row = blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  float sum = 0.f;
  if (row < rows) {
    const int bh = row / T, t = row % T;
    const int b = bh / H, h = bh % H;
    const __nv_bfloat16* x = o + b * o_sb + h * o_sh + t * o_st;
    const __nv_bfloat16* y = dout + b * do_sb + h * do_sh + t * do_st;
    if constexpr (D % 32 == 0) {
#pragma unroll
      for (int c = lane; c < D / 8; c += 16) {
        const uint4 xc = *reinterpret_cast<const uint4*>(x + c * 8);
        const uint4 yc = *reinterpret_cast<const uint4*>(y + c * 8);
        const __nv_bfloat162* xv =
            reinterpret_cast<const __nv_bfloat162*>(&xc);
        const __nv_bfloat162* yv =
            reinterpret_cast<const __nv_bfloat162*>(&yc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(xv[i]);
          const float2 c = __bfloat1622float2(yv[i]);
          sum += a.x * c.x + a.y * c.y;
        }
      }
    } else {
#pragma unroll
      for (int c = lane; c < D; c += 16) {
        sum += __bfloat162float(x[c]) * __bfloat162float(y[c]);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (row < rows && lane == 0) delta[row] = sum;
}

// One (batch*head, 64-key tile): dK and dV.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int kTile = tile_bytes<D>();
  constexpr int kStage = dkdv_stage_bytes<D>();
  constexpr int kKSteps = DP / 16;
  constexpr int kStages = kBwdStages;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kTile;
  const uint32_t stage0 = v_s + kTile;   // stage s: Q, dO, lse, delta

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;

  float dk[DP / 2], dv[DP / 2], st[32], dpt[32];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);

  // query tiles that see a key of this tile: none past kv_len; with the
  // band, only rows with row + offset >= k0
  const int q_begin = p.masked ? max(0, k0 - p.offset) / kRows : 0;
  const int q_end = k0 >= kv_len ? 0 : (Tq + kRows - 1) / kRows;
  const int n_tiles = max(0, q_end - q_begin);

  // query tile q_begin + i goes to ring stage i mod kStages
  auto load_stage = [&](int i) {
    const int q0 = (q_begin + i) * kRows;
    const uint32_t dst = stage0 + (i % kStages) * kStage;
    load_tile<D>(dst, qb, p.q_st, q0, Tq);
    load_tile<D>(dst + kTile, ob, p.o_st, q0, Tq);
    const int r = threadIdx.x % kRows;
    const bool ok = q0 + r < Tq;
    const float* src = threadIdx.x < kRows ? lse_b : dl_b;
    cp_async_4(dst + 2 * kTile + threadIdx.x * 4, ok ? src + q0 + r : src,
               ok);
  };

  if (n_tiles > 0) {
    load_tile<D>(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_st, k0, Tk);
    load_tile<D>(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_st, k0, Tk);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    cp_async_commit();

    const int q0 = (q_begin + i) * kRows;
    const uint32_t q_s = stage0 + (i % kStages) * kStage;
    const uint32_t o_s = q_s + kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (q_s + 2 * kTile - raw));
    const float* dl_s = lse_s + kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(st, desc_k_major(k_s, kk), desc_k_major(q_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(dpt, desc_k_major(v_s, kk), desc_k_major(o_s, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T (masked entries 0), dropout, dS^T; the dropped P^T replaces S^T
    // and dS^T replaces dP^T in place
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int qi = (i2 / 4) * 8 + 2 * t4 + (i2 & 1);   // query in tile
      st[i2] = ex2(fmaf(st[i2], kLog2e, -lse_s[qi] * kLog2e));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const int row = q0 + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
        const int col = (i2 & 2) ? key0 + 8 : key0;
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          st[i2] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int qi = (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      const int row = q0 + qi;
      const int col = (i2 & 2) ? key0 + 8 : key0;
      const float pr = st[i2];
      float dpr = dpt[i2];
      float pdr = pr;
      if (p.drop.on) {
        const bool kept = p.drop.keep<Groups>(dblk, row, col);
        pdr = kept ? pr * p.drop.inv_keep : 0.f;
        dpr = kept ? dpr * p.drop.inv_keep : 0.f;
      }
      dpt[i2] = pr * (dpr - dl_s[qi]);
      st[i2] = pdr;
    }

    // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major
    uint32_t pa[4][4], da[4][4];
    p_frags(pa, st);
    p_frags(da, dpt);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(dv, pa[kc], desc_mn_major(o_s, kc));
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(dk, da[kc], desc_mn_major(q_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st, key0, Tk, dk, t4);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st, key0, Tk, dv, t4);
}

// One (batch*head, 64-query tile): dQ.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int kStages = kBwdStages;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t o_s = q_s + kTile;        // dO
  const uint32_t kv_s = o_s + kTile;   // stage s: K at + 2 s kTile, V after

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;
  const float lsel0 = (row0 < Tq ? lse_b[row0] : 0.f) * kLog2e;
  const float lsel1 = (row0 + 8 < Tq ? lse_b[row0 + 8] : 0.f) * kLog2e;
  const float dl0 = row0 < Tq ? dl_b[row0] : 0.f;
  const float dl1 = row0 + 8 < Tq ? dl_b[row0 + 8] : 0.f;

  float dq[DP / 2], s[32], dp[32];
  zero(dq);
  zero(s);
  zero(dp);

  // key tiles with a visible key: none past kv_len, none above the band
  int n_tiles = (max(kv_end, 0) + kRows - 1) / kRows;
  if (p.masked) {
    n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // key tile t goes to ring stage t mod kStages
  auto load_kv = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kStages) * kTile;
    load_tile<D>(dst, kb, p.k_st, t * kRows, Tk);
    load_tile<D>(dst + kTile, vb, p.v_st, t * kRows, Tk);
  };
  if (n_tiles > 0) {
    load_tile<D>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, Tq);
    load_tile<D>(o_s, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, q0, Tq);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kStages) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(dp, desc_k_major(o_s, kk), desc_k_major(v_s, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? lsel1 : lsel0)));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row0 + 8 : row0;
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          s[i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = i & 2;
      const int row = hi ? row0 + 8 : row0;
      const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const float pr = s[i];
      float dpr = dp[i];
      if (p.drop.on) {
        dpr = p.drop.keep<Groups>(dblk, row, col) ? dpr * p.drop.inv_keep : 0.f;
      }
      s[i] = pr * (dpr - (hi ? dl1 : dl0));   // dS
    }

    // dQ += dS K, dS from registers, K MN-major
    uint32_t da[4][4];
    p_frags(da, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(dq, da[kc], desc_mn_major(k_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st, row0, Tq, dq, t4);
}

// ---------------------------------------------------------------------------
// narrow heads (D = 25, 30): dQ with delta, then dK/dV (the header)
// ---------------------------------------------------------------------------

// Streamed tiles in flight: 3 at D = 30 (cp.async, two tiles ahead), 2 at
// D = 25, whose loads wait in registers for the end of the tile before (a
// third stage would not start them earlier).
template <int D>
__host__ __device__ constexpr int narrow_stages() {
  return D % 2 ? 2 : 3;
}

// K and V, then stages x (Q, dO, lse[64], delta[64]); +1 KB for alignment.
template <int D>
__host__ __device__ constexpr int narrow_dkdv_smem_bytes() {
  return 2 * kPanelBytes + narrow_stages<D>() * (2 * kPanelBytes + 1024) +
         1024;
}

// Q, dO and O, then stages x (K, V); +1 KB.
template <int D>
__host__ __device__ constexpr int narrow_dq_smem_bytes() {
  return (3 + 2 * narrow_stages<D>()) * kPanelBytes + 1024;
}

// One (batch*head, 64-key tile): dK and dV, batch*head along x and key
// tiles along y, so the blocks of the first key tiles (the most query
// tiles of a causal band) start first.  Launched dependent on the dQ
// kernel: K and V load before it ends, delta after.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_narrow_dkdv_kernel(const BwdParams p) {
  constexpr int kStages = narrow_stages<D>();
  constexpr int kTile = kPanelBytes;
  constexpr int kStage = 2 * kTile + 1024;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kTile;
  const uint32_t stage0 = v_s + kTile;   // stage s: Q, dO, lse, delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8

  // query tiles that see a key of this tile: none past kv_len; with the
  // band, only rows with row + offset >= k0
  const int q_begin = p.masked ? max(0, k0 - p.offset) / kRows : 0;
  const int q_end = k0 >= kv_len ? 0 : (Tq + kRows - 1) / kRows;
  const int n_tiles = max(0, q_end - q_begin);

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;

  // query tile q_begin + i goes to ring stage i mod kStages, started by
  // fetch(i), written by store(i) (D = 25)
  NarrowTile<D> q_next, o_next;
  auto fetch = [&](int i) {
    const int q0 = (q_begin + i) * kRows;
    const uint32_t dst = stage0 + (i % kStages) * kStage;
    q_next.fetch(dst, qb, p.q_st, q0, Tq);
    o_next.fetch(dst + kTile, ob, p.o_st, q0, Tq);
    const int r = threadIdx.x % kRows;
    const bool ok = q0 + r < Tq;
    const float* src = threadIdx.x < kRows ? lse_b : dl_b;
    cp_async_4(dst + 2 * kTile + threadIdx.x * 4, ok ? src + q0 + r : src,
               ok);
  };
  auto store = [&](int i) {
    const uint32_t dst = stage0 + (i % kStages) * kStage;
    q_next.store(dst);
    o_next.store(dst + kTile);
  };

  if (n_tiles > 0) {
    NarrowTile<D> kt, vt;
    kt.fetch(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_st, k0, Tk);
    vt.fetch(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_st, k0, Tk);
    // delta: written by the dQ kernel, which this launch may overlap
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    fetch(0);
    kt.store(k_s);
    vt.store(v_s);
    store(0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      fetch(i);
      store(i);
    }
    cp_async_commit();
  }

  float dk[16], dv[16], st[32], dpt[32];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const bool more = i + kStages - 1 < n_tiles;
    if (more) fetch(i + kStages - 1);
    cp_async_commit();

    const int q0 = (q_begin + i) * kRows;
    const uint32_t q_s = stage0 + (i % kStages) * kStage;
    const uint32_t o_s = q_s + kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (q_s + 2 * kTile - raw));
    const float* dl_s = lse_s + kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, 2 k-steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<64>(st, desc_k_major(k_s, kk), desc_k_major(q_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<64>(dpt, desc_k_major(v_s, kk), desc_k_major(o_s, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T (masked entries 0), its dropout keep bits, the dropped P^T's A
    // fragments; then dS^T = P^T (dP^T - delta), dropout on dP^T
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int qi = (i2 / 4) * 8 + 2 * t4 + (i2 & 1);   // query in tile
      st[i2] = ex2(fmaf(st[i2], kLog2e, -lse_s[qi] * kLog2e));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const int row = q0 + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
        const int col = (i2 & 2) ? key0 + 8 : key0;
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          st[i2] = 0.f;
        }
      }
    }
    uint32_t kept = ~0u;
    if (p.drop.on) {
      kept = 0;
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const int row = q0 + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
        const int col = (i2 & 2) ? key0 + 8 : key0;
        kept |= static_cast<uint32_t>(p.drop.keep<Groups>(dblk, row, col))
                << i2;
      }
    }
    auto dropped = [&](int i2) {
      return !p.drop.on ? st[i2]
             : (kept >> i2) & 1 ? st[i2] * p.drop.inv_keep : 0.f;
    };
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kc][j] = pack_bf16x2(dropped(8 * kc + 2 * j),
                                dropped(8 * kc + 2 * j + 1));
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int qi = (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      float dpr = dpt[i2];
      if (p.drop.on) dpr = (kept >> i2) & 1 ? dpr * p.drop.inv_keep : 0.f;
      dpt[i2] = st[i2] * (dpr - dl_s[qi]);
    }
    p_frags(da, dpt);

    // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<32>(dv, pa[kc], desc_mn_major(o_s, kc));
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<32>(dk, da[kc], desc_mn_major(q_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (more) store(i + kStages - 1);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st, key0, Tk, dk, t4);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st, key0, Tk, dv, t4);
}

// One (batch*head, 64-query tile): delta = rowsum(dO * O) of its rows into
// the workspace, and dQ.  Batch*head along x; query tiles along y, last
// first, so the blocks with the most key tiles of a causal band start
// first.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads, 4)
flash_bwd_narrow_dq_kernel(const BwdParams p, const __nv_bfloat16* o,
                           long long o_sb, long long o_sh, long long o_st,
                           float* delta) {
  constexpr int kStages = narrow_stages<D>();
  constexpr int kTile = kPanelBytes;
  extern __shared__ unsigned char smem[];
  __shared__ float dl_s[kRows];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kTile;
  const uint32_t o_s = do_s + kTile;
  const uint32_t kv_s = o_s + kTile;   // stage s: K at + 2 s kTile, V after

  // the dK/dV kernel after this one may start its blocks while the last of
  // these run: it waits for all of them before it reads delta
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  // key tiles with a visible key: none past kv_len, none above the band
  int n_tiles = (max(kv_end, 0) + kRows - 1) / kRows;
  if (p.masked) {
    n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // key tile t goes to ring stage t mod kStages
  NarrowTile<D> k_next, v_next;
  auto fetch = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kStages) * kTile;
    k_next.fetch(dst, kb, p.k_st, t * kRows, Tk);
    v_next.fetch(dst + kTile, vb, p.v_st, t * kRows, Tk);
  };
  auto store = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kStages) * kTile;
    k_next.store(dst);
    v_next.store(dst + kTile);
  };

  // Q, dO and O (for delta, even where no key is visible), key tile 0
  {
    NarrowTile<D> qt, dt, ot;
    qt.fetch(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, Tq);
    dt.fetch(do_s, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, q0, Tq);
    ot.fetch(o_s, o + b * o_sb + h * o_sh, o_st, q0, Tq);
    if (n_tiles > 0) fetch(0);
    qt.store(q_s);
    dt.store(do_s);
    ot.store(o_s);
    if (n_tiles > 0) store(0);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      fetch(t);
      store(t);
    }
    cp_async_commit();
  }

  // delta: thread 2 r + c sums columns 16 c .. 16 c + 15 of row r in fp32,
  // the pair of threads adds its two halves; rows past Tq (zero-filled)
  // give 0 and are not written
  cp_async_wait<kStages - 2>();
  __syncthreads();
  {
    const int r = threadIdx.x / 2;
    const int c = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const uint32_t off = tile_offset(r, 0, 2 * c + cc);
      const uint4 x = ld_shared_v4(do_s + off);
      const uint4 y = ld_shared_v4(o_s + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // a bf16 is a float's high half
        sum = fmaf(__uint_as_float(xs[j] << 16), __uint_as_float(ys[j] << 16),
                   sum);
        sum = fmaf(__uint_as_float(xs[j] & 0xFFFF0000u),
                   __uint_as_float(ys[j] & 0xFFFF0000u), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (c == 0) {
      dl_s[r] = sum;
      if (q0 + r < Tq) delta[(long long)bh * Tq + q0 + r] = sum;
    }
  }
  __syncthreads();

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float lsel0 = (row0 < Tq ? lse_b[row0] : 0.f) * kLog2e;
  const float lsel1 = (row0 + 8 < Tq ? lse_b[row0 + 8] : 0.f) * kLog2e;
  const float dl0 = dl_s[warp * 16 + g];
  const float dl1 = dl_s[warp * 16 + g + 8];

  float dq[16], s[32], dp[32];
  zero(dq);
  zero(s);
  zero(dp);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const bool more = kt + kStages - 1 < n_tiles;
    if (more) fetch(kt + kStages - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kStages) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, 2 k-steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<64>(dp, desc_k_major(do_s, kk), desc_k_major(v_s, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? lsel1 : lsel0)));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row0 + 8 : row0;
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          s[i] = 0.f;
        }
      }
    }
    uint32_t kept = ~0u;
    if (p.drop.on) {
      kept = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row0 + 8 : row0;
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        kept |= static_cast<uint32_t>(p.drop.keep<Groups>(dblk, row, col)) << i;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float dpr = dp[i];
      if (p.drop.on) dpr = (kept >> i) & 1 ? dpr * p.drop.inv_keep : 0.f;
      s[i] = s[i] * (dpr - ((i & 2) ? dl1 : dl0));   // dS
    }

    // dQ += dS K, dS from registers, K MN-major
    uint32_t da[4][4];
    p_frags(da, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<32>(dq, da[kc], desc_mn_major(k_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (more) store(kt + kStages - 1);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st, row0, Tq, dq, t4);
}

// ---------------------------------------------------------------------------
// D = 128, 50 and 60: dQ with delta, then dK/dV (the header)
// ---------------------------------------------------------------------------

// runs_wide (flash_common.cuh) picks the head dims whose backward takes
// these kernels: 128, and 50 and 60 at DP = 64 (D 64 and 96 keep the three
// launches above).

// The dK/dV kernel's shape, each as measured fastest on an H100 (the
// header): at D = 128 two warpgroups a block, each over 32 queries of
// every tile, one block an SM, a ring of 3 stages; at DP = 64 one
// warpgroup, three blocks an SM (a cap of 168 registers), 2 stages.
template <int D>
__host__ __device__ constexpr int wide_dkdv_warpgroups() {
  return padded_dim<D>() == 128 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int wide_dkdv_threads() {
  return wide_dkdv_warpgroups<D>() * kThreads;
}

template <int D>
__host__ __device__ constexpr int wide_dkdv_blocks() {
  return padded_dim<D>() == 128 ? 1 : 3;
}

template <int D>
__host__ __device__ constexpr int wide_dkdv_stages() {
  return padded_dim<D>() == 128 ? 3 : 2;
}

// K and V resident, wide_dkdv_stages x (Q, dO, lse, delta); +1 KB.
template <int D>
__host__ __device__ constexpr int wide_dkdv_smem_bytes() {
  return 2 * tile_bytes<D>() + wide_dkdv_stages<D>() * dkdv_stage_bytes<D>() +
         1024;
}

// The dQ kernel: a ring of 2 stages of K and V, and the blocks an SM it is
// built for (a register cap: 255 at D = 128, 168 at DP = 64; the header).
constexpr int kWideDqStages = 2;

template <int D>
__host__ __device__ constexpr int wide_dq_blocks() {
  return padded_dim<D>() == 128 ? 2 : 3;
}

// Q and dO resident, kWideDqStages x (K, V); +1 KB.  O, for delta, goes
// into the last stage before the loop loads it.
template <int D>
__host__ __device__ constexpr int wide_dq_smem_bytes() {
  return (2 + 2 * kWideDqStages) * tile_bytes<D>() + 1024;
}

// Rows [r0, r0 + n) of the 64-row tile at dst, from rows t0 + r0 .. of
// the slice, by the 128 threads of one warpgroup, as load_tile_by copies
// them: 16-byte cp.async chunks at D = 128; at D = 50 and 60 4- and 8-byte
// words on one running row pointer, columns D..63 zero-filled; rows at or
// past T zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_by(int tid, int r0, int n,
                                             uint32_t dst,
                                             const __nv_bfloat16* src,
                                             long long stride_t, int t0,
                                             int T) {
  if constexpr (D % 32 == 0) {
    const int chunks = n * D / 8;
    for (int i = tid; i < chunks; i += kThreads) {
      const int c = i & 3;
      const int r = r0 + (i >> 2) % n;
      const int panel = (i >> 2) / n;
      const bool ok = t0 + r < T;
      const __nv_bfloat16* g =
          ok ? src + (long long)(t0 + r) * stride_t + panel * 32 + c * 8
             : src;
      cp_async_16(dst + tile_offset(r, panel, c), g, ok);
    }
  } else {
    static_assert(D % 2 == 0, "cp.async words");
    constexpr int kW = word_bytes<D>();
    constexpr int kPerRow = padded_dim<D>() * 2 / kW;   // words of a row
    constexpr int kStep = kThreads / kPerRow;           // rows a step
    const int col = (tid % kPerRow) * (kW / 2);   // the words' first column
    const int rt = r0 + tid / kPerRow;
    const uint32_t d0 = dst + (col % 8) * 2;
    const long long step = kStep * stride_t;
    const __nv_bfloat16* g = src + (long long)(t0 + rt) * stride_t + col;
#pragma unroll
    for (int j = 0; j < n / kStep; ++j, g += step) {
      const int r = rt + j * kStep;
      const bool ok = t0 + r < T && col < D;
      const uint32_t d = d0 + tile_offset(r, col / 32, (col % 32) / 8);
      if constexpr (kW == 8) {
        cp_async_8(d, ok ? g : src, ok);
      } else {
        cp_async_4(d, ok ? g : src, ok);
      }
    }
  }
}

// The barrier of one warpgroup (named barrier id, 128 threads).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// One (batch*head, 64-key tile): dK and dV.  With two warpgroups (W = 2),
// warpgroup w takes queries 32 w .. 32 w + 31 of every streamed tile: it
// loads those rows of Q and dO (and their lse and delta) into its half of
// each ring stage, computes S^T and dP^T for them (m64n32k16), then dV and
// dK over all DP columns from them (m64nDPk16, A from registers).  After K
// and V, each warpgroup waits at its own barrier for its own rows only, so
// the two drift apart and one's softmax overlaps the other's products;
// their sums are added once, at the end.  With one (W = 1) it takes all 64.
// Batch*head along x, key tiles along y (key tile 0, the most query tiles
// of a causal band, first).  Launched dependent on the dQ kernel: K and V
// load before it ends, delta after.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(wide_dkdv_threads<D>(),
                                  wide_dkdv_blocks<D>())
flash_bwd_wide_dkdv_kernel(const BwdParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int kTile = tile_bytes<D>();
  constexpr int kStage = dkdv_stage_bytes<D>();
  constexpr int kKSteps = DP / 16;
  constexpr int kStages = wide_dkdv_stages<D>();
  constexpr int W = wide_dkdv_warpgroups<D>();
  constexpr int QN = kRows / W;   // queries of a tile a warpgroup takes
  static_assert(W == 1 || DP * kThreads * 4 <= kStages * kStage,
                "the ring holds the warpgroups' partial sums");
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kTile;
  const uint32_t stage0 = v_s + kTile;   // stage s: Q, dO, lse, delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int k0 = blockIdx.y * kRows;
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8
  const uint32_t qh = wg * QN * 64;      // the warpgroup's rows in a panel
  const int ks0 = wg * QN / 16;          // ... as k-steps of an MN-major B

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;

  // query tiles that see a key of this tile: none past kv_len; with the
  // band, only rows with row + offset >= k0
  const int q_begin = p.masked ? max(0, k0 - p.offset) / kRows : 0;
  const int q_end = k0 >= kv_len ? 0 : (Tq + kRows - 1) / kRows;
  const int n_tiles = max(0, q_end - q_begin);

  // query tile q_begin + i goes to ring stage i mod kStages; this
  // warpgroup's rows of Q and dO, lse and delta
  auto load_stage = [&](int i) {
    const int q0 = (q_begin + i) * kRows;
    const uint32_t dst = stage0 + (i % kStages) * kStage;
    load_rows_by<D>(tid, wg * QN, QN, dst, qb, p.q_st, q0, Tq);
    load_rows_by<D>(tid, wg * QN, QN, dst + kTile, ob, p.o_st, q0, Tq);
    if (tid < 2 * QN) {
      const int r = wg * QN + tid % QN;
      const bool ok = q0 + r < Tq;
      const float* src = tid < QN ? lse_b : dl_b;
      cp_async_4(dst + 2 * kTile + (tid < QN ? 0 : 4 * kRows) + 4 * r,
                 ok ? src + q0 + r : src, ok);
    }
  };

  if (n_tiles > 0) {
    if constexpr (W == 2) {
      // K by warpgroup 0, V by warpgroup 1
      load_tile_by<D>(tid, wg == 0 ? k_s : v_s,
                      wg == 0 ? p.k + b * p.k_sb + h * p.k_sh
                              : p.v + b * p.v_sb + h * p.v_sh,
                      wg == 0 ? p.k_st : p.v_st, k0, Tk);
    } else {
      load_tile<D>(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_st, k0, Tk);
      load_tile<D>(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_st, k0, Tk);
    }
    // delta: written by the dQ kernel, which this launch may overlap
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }

  float dk[DP / 2], dv[DP / 2], st[QN / 2], dpt[QN / 2];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    // K and V come from both warpgroups; after them each waits only for
    // its own rows
    if (i == 0) {
      __syncthreads();
    } else {
      group_sync(1 + wg);
    }
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    cp_async_commit();

    const int q0 = (q_begin + i) * kRows;
    const uint32_t q_s = stage0 + (i % kStages) * kStage;
    const uint32_t o_s = q_s + kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (q_s + 2 * kTile - raw));
    const float* dl_s = lse_s + kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x this warpgroup's queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<QN>(st, desc_k_major(k_s, kk), desc_k_major(q_s + qh, kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<QN>(dpt, desc_k_major(v_s, kk), desc_k_major(o_s + qh, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T (masked entries 0), dropout, dS^T; the dropped P^T replaces S^T
    // and dS^T replaces dP^T in place
#pragma unroll
    for (int i2 = 0; i2 < QN / 2; ++i2) {
      const int qi = wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      st[i2] = ex2(fmaf(st[i2], kLog2e, -lse_s[qi] * kLog2e));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i2 = 0; i2 < QN / 2; ++i2) {
        const int row = q0 + wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
        const int col = (i2 & 2) ? key0 + 8 : key0;
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          st[i2] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < QN / 2; ++i2) {
      const int qi = wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      const int row = q0 + qi;
      const int col = (i2 & 2) ? key0 + 8 : key0;
      const float pr = st[i2];
      float dpr = dpt[i2];
      float pdr = pr;
      if (p.drop.on) {
        const bool kept = p.drop.keep<Groups>(dblk, row, col);
        pdr = kept ? pr * p.drop.inv_keep : 0.f;
        dpr = kept ? dpr * p.drop.inv_keep : 0.f;
      }
      dpt[i2] = pr * (dpr - dl_s[qi]);
      st[i2] = pdr;
    }

    // dV += P^T dO and dK += dS^T Q over this warpgroup's queries, A from
    // registers, B MN-major
    uint32_t pa[QN / 16][4], da[QN / 16][4];
    p_frags(pa, st);
    p_frags(da, dpt);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < QN / 16; ++kc) {
      wgmma_rs_mn<DP>(dv, pa[kc], desc_mn_major(o_s, ks0 + kc));
    }
#pragma unroll
    for (int kc = 0; kc < QN / 16; ++kc) {
      wgmma_rs_mn<DP>(dk, da[kc], desc_mn_major(q_s, ks0 + kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();
  if constexpr (W == 1) {
    store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st, key0, Tk, dk,
                  t4);
    store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st, key0, Tk, dv,
                  t4);
    return;
  }

  // dK = dK_0 + dK_1 and dV = dV_0 + dV_1: warpgroup 0 hands its dV to
  // warpgroup 1 and takes its dK through the ring's shared memory (value i
  // of thread t at i * 128 + t), then each stores one sum
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + (stage0 - raw));
  float* give = red + wg * (DP / 2) * kThreads;
  const float* take = red + (1 - wg) * (DP / 2) * kThreads;
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) give[i * kThreads + tid] = dv[i];
  } else {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) give[i * kThreads + tid] = dk[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] += take[i * kThreads + tid];
    store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st, key0, Tk, dk,
                  t4);
  } else {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dv[i] = take[i * kThreads + tid] + dv[i];
    store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st, key0, Tk, dv,
                  t4);
  }
}

// One (batch*head, 64-query tile): delta = rowsum(dO * O) of its rows into
// the workspace, and dQ, as flash_bwd_dq_kernel.  O is staged in the ring
// stage that the prologue leaves empty.  Batch*head along x; query tiles
// along y, last first, so the blocks with the most key tiles of a causal
// band start first.  wide_dq_blocks blocks an SM (the header); at D = 128
// stating that minimum measured 0.003 ms faster at rate 0.1 than leaving it
// out (PERF.md).
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads, wide_dq_blocks<D>())
flash_bwd_wide_dq_kernel(const BwdParams p, const __nv_bfloat16* o,
                         long long o_sb, long long o_sh, long long o_st,
                         float* delta) {
  constexpr int DP = padded_dim<D>();
  constexpr int kStages = kWideDqStages;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;
  extern __shared__ unsigned char smem[];
  __shared__ float dl_s[kRows];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kTile;
  const uint32_t kv_s = do_s + kTile;   // stage s: K at + 2 s kTile, V after
  const uint32_t out_s = kv_s + 2 * (kStages - 1) * kTile;

  // the dK/dV kernel after this one may start its blocks while the last of
  // these run: it waits for all of them before it reads delta
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  // key tiles with a visible key: none past kv_len, none above the band
  int n_tiles = (max(kv_end, 0) + kRows - 1) / kRows;
  if (p.masked) {
    n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // key tile t goes to ring stage t mod kStages
  auto load_kv = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kStages) * kTile;
    load_tile<D>(dst, kb, p.k_st, t * kRows, Tk);
    load_tile<D>(dst + kTile, vb, p.v_st, t * kRows, Tk);
  };
  // Q, dO and O (for delta, even where no key is visible), key tile 0
  load_tile<D>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, Tq);
  load_tile<D>(do_s, p.dout + b * p.o_sb + h * p.o_sh, p.o_st, q0, Tq);
  load_tile<D>(out_s, o + b * o_sb + h * o_sh, o_st, q0, Tq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float lsel0 = (row0 < Tq ? lse_b[row0] : 0.f) * kLog2e;
  const float lsel1 = (row0 + 8 < Tq ? lse_b[row0 + 8] : 0.f) * kLog2e;
  // delta: thread 2 r + c sums columns 64 c .. 64 c + 63 of row r in fp32,
  // the pair of threads adds its two halves; rows past Tq (zero-filled)
  // give 0 and are not written
  cp_async_wait<kStages - 2>();
  __syncthreads();
  {
    const int r = threadIdx.x / 2;
    const int c = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int pc = 0; pc < DP / 16; ++pc) {   // 16-byte chunks of a half
      const int chunk = c * (DP / 16) + pc;
      const uint32_t off = tile_offset(r, chunk / 4, chunk % 4);
      const uint4 x = ld_shared_v4(do_s + off);
      const uint4 y = ld_shared_v4(out_s + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // a bf16 is a float's high half
        sum = fmaf(__uint_as_float(xs[j] << 16), __uint_as_float(ys[j] << 16),
                   sum);
        sum = fmaf(__uint_as_float(xs[j] & 0xFFFF0000u),
                   __uint_as_float(ys[j] & 0xFFFF0000u), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (c == 0) {
      dl_s[r] = sum;
      if (q0 + r < Tq) delta[(long long)bh * Tq + q0 + r] = sum;
    }
  }
  __syncthreads();
  const float dl0 = dl_s[warp * 16 + g];
  const float dl1 = dl_s[warp * 16 + g + 8];

  float dq[DP / 2], s[32], dp[32];
  zero(dq);
  zero(s);
  zero(dp);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kStages) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(dp, desc_k_major(do_s, kk), desc_k_major(v_s, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? lsel1 : lsel0)));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row0 + 8 : row0;
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          s[i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = i & 2;
      const int row = hi ? row0 + 8 : row0;
      const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const float pr = s[i];
      float dpr = dp[i];
      if (p.drop.on) {
        dpr = p.drop.keep<Groups>(dblk, row, col) ? dpr * p.drop.inv_keep : 0.f;
      }
      s[i] = pr * (dpr - (hi ? dl1 : dl0));   // dS
    }

    // dQ += dS K, dS from registers, K MN-major
    uint32_t da[4][4];
    p_frags(da, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(dq, da[kc], desc_mn_major(k_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st, row0, Tq, dq, t4);
}

// ---------------------------------------------------------------------------
// D = 192 and 256: dQ with delta, then dK/dV, each tile step's scores split
// between two warpgroups (the header)
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 2 * kThreads;  // two warpgroups a block
constexpr int kScoreTileBytes = 2 * kPanelBytes;  // a 64 x 64 bf16 tile

// Streamed tiles in flight: a 64 x 192 tile is 24 KB and three stages fit
// in both kernels (measured faster than two, the header); a 64 x 256 tile
// is 32 KB, and two.
template <int D>
__host__ __device__ constexpr int split_stages() {
  return padded_dim<D>() == 192 ? 3 : 2;
}

__device__ __forceinline__ void st_shared_b32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// K and V resident, split_stages x (Q, dO, lse, delta), the P^T and dS^T
// tiles; +1 KB.
template <int D>
__host__ __device__ constexpr int rowsplit_dkdv_smem_bytes() {
  return 2 * tile_bytes<D>() + split_stages<D>() * dkdv_stage_bytes<D>() +
         2 * kScoreTileBytes + 1024;
}

// One (batch*head, 64-key tile): dK and dV, the warpgroups split by query
// rows.  K and V resident, every thread copying its share of each stage of
// Q, dO, lse and delta.  Warpgroup w computes S^T and dP^T for queries
// 32 w .. 32 w + 31 of each query tile (m64n32k16), P^T (dropped) and dS^T
// for them, and writes them as panel w of two bf16 64 x 64 tiles; after a
// block barrier it adds P^T dO and dS^T Q to its DP / 2 columns of dV and
// dK (m64n96k16 or m64n128k16, A and B from shared memory).  Per query
// tile the tensor cores run S^T, dP^T, dV and dK once each; two block
// barriers a step.
// Batch*head along x, key tiles along y (key tile 0, the most query tiles
// of a causal band, first).  Launched dependent on the dQ kernel: K and V
// load before it ends, delta after.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_rowsplit_dkdv_kernel(const BwdParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int DH = DP / 2;      // columns of dK and dV a warpgroup takes
  constexpr int QN = kRows / 2;   // queries of a tile a warpgroup takes
  constexpr int kTile = tile_bytes<D>();
  constexpr int kStage = dkdv_stage_bytes<D>();
  constexpr int kKSteps = DP / 16;
  constexpr int kSt = split_stages<D>();
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kTile;
  const uint32_t stage0 = v_s + kTile;   // stage s: Q, dO, lse, delta
  const uint32_t pt_s = stage0 + kSt * kStage;   // P^T dropped, keys x queries
  const uint32_t dst_s = pt_s + kScoreTileBytes;  // dS^T

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int k0 = blockIdx.y * kRows;
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8
  const uint32_t half = wg * (DH / 32) * kPanelBytes;   // its first panel

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float* dl_b = p.delta + (long long)bh * Tq;
  const int q_begin = p.masked ? max(0, k0 - p.offset) / kRows : 0;
  const int q_end = k0 >= kv_len ? 0 : (Tq + kRows - 1) / kRows;
  const int n_tiles = max(0, q_end - q_begin);

  const TallCopier<D> q_copy(p.q + b * p.q_sb + h * p.q_sh, p.q_st,
                             threadIdx.x);
  const TallCopier<D> o_copy(p.dout + b * p.o_sb + h * p.o_sh, p.o_st,
                             threadIdx.x);
  // query tile q_begin + i goes to ring stage i mod kSt: Q, dO, lse, delta
  auto load_stage = [&](int i) {
    const int q0 = (q_begin + i) * kRows;
    const uint32_t dst = stage0 + (i % kSt) * kStage;
    q_copy.copy(dst, q0, Tq);
    o_copy.copy(dst + kTile, q0, Tq);
    if (threadIdx.x < 2 * kRows) {
      const int r = threadIdx.x % kRows;
      const bool ok = q0 + r < Tq;
      const float* src = threadIdx.x < kRows ? lse_b : dl_b;
      cp_async_4(dst + 2 * kTile + threadIdx.x * 4, ok ? src + q0 + r : src,
                 ok);
    }
  };

  if (n_tiles > 0) {
    // K by warpgroup 0, V by warpgroup 1
    load_tile_by<D>(tid, wg == 0 ? k_s : v_s,
                    wg == 0 ? p.k + b * p.k_sb + h * p.k_sh
                            : p.v + b * p.v_sb + h * p.v_sh,
                    wg == 0 ? p.k_st : p.v_st, k0, Tk);
    // delta: written by the dQ kernel, which this launch may overlap
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }

  float dk[DH / 2], dv[DH / 2], st[QN / 2], dpt[QN / 2];
  zero(dk);
  zero(dv);
  zero(st);
  zero(dpt);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kSt - 2>();
    fence_proxy_async();
    __syncthreads();
    if (i + kSt - 1 < n_tiles) load_stage(i + kSt - 1);
    cp_async_commit();

    const int q0 = (q_begin + i) * kRows;
    const uint32_t q_s = stage0 + (i % kSt) * kStage;
    const uint32_t o_s = q_s + kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (q_s + 2 * kTile - raw));
    const float* dl_s = lse_s + kRows;
    const uint32_t qh = wg * QN * 64;   // the warpgroup's rows in a panel

    // S^T and dP^T: 64 keys x this warpgroup's 32 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<QN>(st, desc_k_major(k_s, kk), desc_k_major(q_s + qh, kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<QN>(dpt, desc_k_major(v_s, kk), desc_k_major(o_s + qh, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

#pragma unroll
    for (int i2 = 0; i2 < QN / 2; ++i2) {
      const int qi = wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      st[i2] = ex2(fmaf(st[i2], kLog2e, -lse_s[qi] * kLog2e));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i2 = 0; i2 < QN / 2; ++i2) {
        const int row = q0 + wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
        const int col = (i2 & 2) ? key0 + 8 : key0;
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          st[i2] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < QN / 2; ++i2) {
      const int qi = wg * QN + (i2 / 4) * 8 + 2 * t4 + (i2 & 1);
      const int row = q0 + qi;
      const int col = (i2 & 2) ? key0 + 8 : key0;
      const float pr = st[i2];
      float dpr = dpt[i2];
      float pdr = pr;
      if (p.drop.on) {
        const bool kept = p.drop.keep<Groups>(dblk, row, col);
        pdr = kept ? pr * p.drop.inv_keep : 0.f;
        dpr = kept ? dpr * p.drop.inv_keep : 0.f;
      }
      dpt[i2] = pr * (dpr - dl_s[qi]);
      st[i2] = pdr;
    }
    // this warpgroup's 32 query columns (panel wg) of P^T and dS^T
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const int r = warp * 16 + g;
      const uint32_t at = (c % 8) * 2;
      st_shared_b32(pt_s + at + tile_offset(r, wg, c / 8),
                    pack_bf16x2(st[4 * j], st[4 * j + 1]));
      st_shared_b32(pt_s + at + tile_offset(r + 8, wg, c / 8),
                    pack_bf16x2(st[4 * j + 2], st[4 * j + 3]));
      st_shared_b32(dst_s + at + tile_offset(r, wg, c / 8),
                    pack_bf16x2(dpt[4 * j], dpt[4 * j + 1]));
      st_shared_b32(dst_s + at + tile_offset(r + 8, wg, c / 8),
                    pack_bf16x2(dpt[4 * j + 2], dpt[4 * j + 3]));
    }
    fence_proxy_async();
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_ss_mn<DH>(dv, desc_k_major(pt_s, kk),
                      desc_mn_major(o_s + half, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_ss_mn<DH>(dk, desc_k_major(dst_s, kk),
                      desc_mn_major(q_s + half, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();

  store_rows<DH>(p.dk + b * p.dk_sb + h * p.dk_sh + wg * DH, p.dk_st, key0,
                 Tk, dk, t4);
  store_rows<DH>(p.dv + b * p.dv_sb + h * p.dv_sh + wg * DH, p.dv_st, key0,
                 Tk, dv, t4);
}

// Q and dO resident, split_stages x (K, V), the dS tile; +1 KB.  O, for
// delta, goes into the last stage's K tile before the loop loads it.
template <int D>
__host__ __device__ constexpr int keysplit_dq_smem_bytes() {
  return (2 + 2 * split_stages<D>()) * tile_bytes<D>() + kScoreTileBytes +
         1024;
}

// One (batch*head, 64-query tile): delta = rowsum(dO * O) of its rows into
// the workspace (from one read of O, beside the resident dO), and dQ, the
// warpgroups split by keys.  Warpgroup w computes S and dP for keys 32 w ..
// 32 w + 31 of each key tile (m64n32k16), then P, its dropout and dS for
// them, and writes them as panel w of a bf16 64 x 64 dS tile; after a
// block barrier each adds dS K to its DP / 2 columns of dQ (m64n96k16 or
// m64n128k16, A and B from shared memory).  Per key tile the tensor cores
// run S, dP and dQ once each; two block barriers a step.  Batch*head
// along x; query tiles along y, last first, so the blocks with the most
// key tiles of a causal band start first.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_keysplit_dq_kernel(const BwdParams p, const __nv_bfloat16* o,
                             long long o_sb, long long o_sh, long long o_st,
                             float* delta) {
  constexpr int DP = padded_dim<D>();
  constexpr int DH = DP / 2;     // columns of dQ a warpgroup takes
  constexpr int KN = kRows / 2;  // keys of a tile a warpgroup takes
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;
  constexpr int kSt = split_stages<D>();
  extern __shared__ unsigned char smem[];
  __shared__ float dl_s[kRows];
  const uint32_t raw = smem_u32(smem);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + kTile;
  const uint32_t kv_s = do_s + kTile;   // stage s: K at + 2 s kTile, V after
  const uint32_t ds_s = kv_s + 2 * kSt * kTile;
  const uint32_t out_s = kv_s + 2 * (kSt - 1) * kTile;   // the last K tile

  // the dK/dV kernel after this one may start its blocks while the last of
  // these run: it waits for all of them before it reads delta
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int Tq = p.Tq, Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8
  const uint32_t kh = wg * KN * 64;      // the warpgroup's keys in a panel

  // key tiles with a visible key: none past kv_len, none above the band
  int n_tiles = (max(kv_end, 0) + kRows - 1) / kRows;
  if (p.masked) {
    n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
  }
  const TallCopier<D> k_copy(p.k + b * p.k_sb + h * p.k_sh, p.k_st,
                             threadIdx.x);
  const TallCopier<D> v_copy(p.v + b * p.v_sb + h * p.v_sh, p.v_st,
                             threadIdx.x);
  // key tile t goes to ring stage t mod kSt
  auto load_kv = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kSt) * kTile;
    k_copy.copy(dst, t * kRows, Tk);
    v_copy.copy(dst + kTile, t * kRows, Tk);
  };
  // Q, dO and O (for delta, even where no key is visible), key tiles 0 ..
  // kSt - 2
  TallCopier<D>(p.q + b * p.q_sb + h * p.q_sh, p.q_st, threadIdx.x)
      .copy(q_s, q0, Tq);
  TallCopier<D>(p.dout + b * p.o_sb + h * p.o_sh, p.o_st, threadIdx.x)
      .copy(do_s, q0, Tq);
  TallCopier<D>(o + b * o_sb + h * o_sh, o_st, threadIdx.x)
      .copy(out_s, q0, Tq);
#pragma unroll
  for (int t = 0; t < kSt - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const float* lse_b = p.lse + (long long)bh * Tq;
  const float lsel0 = (row0 < Tq ? lse_b[row0] : 0.f) * kLog2e;
  const float lsel1 = (row0 + 8 < Tq ? lse_b[row0 + 8] : 0.f) * kLog2e;
  // delta: thread 4 r + c sums columns DP / 4 c .. DP / 4 (c + 1) - 1 of
  // row r in fp32, the four threads of a row add theirs in a fixed order;
  // rows past Tq (zero-filled) give 0 and are not written
  cp_async_wait<kSt - 2>();
  __syncthreads();
  {
    const int r = threadIdx.x / 4;
    const int c = threadIdx.x % 4;
    float sum = 0.f;
#pragma unroll
    for (int pc = 0; pc < DP / 32; ++pc) {   // 16-byte chunks of a quarter
      const int chunk = c * (DP / 32) + pc;
      const uint32_t off = tile_offset(r, chunk / 4, chunk % 4);
      const uint4 x = ld_shared_v4(do_s + off);
      const uint4 y = ld_shared_v4(out_s + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // a bf16 is a float's high half
        sum = fmaf(__uint_as_float(xs[j] << 16), __uint_as_float(ys[j] << 16),
                   sum);
        sum = fmaf(__uint_as_float(xs[j] & 0xFFFF0000u),
                   __uint_as_float(ys[j] & 0xFFFF0000u), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (c == 0) {
      dl_s[r] = sum;
      if (q0 + r < Tq) delta[(long long)bh * Tq + q0 + r] = sum;
    }
  }
  __syncthreads();
  const float dl0 = dl_s[warp * 16 + g];
  const float dl1 = dl_s[warp * 16 + g + 8];

  float dq[DH / 2], s[KN / 2], dp[KN / 2];
  zero(dq);
  zero(s);
  zero(dp);

  for (int kt = 0; kt < n_tiles; ++kt) {
    // key tile kt has landed; every thread is done with tile kt - 1
    cp_async_wait<kSt - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kSt - 1 < n_tiles) load_kv(kt + kSt - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kSt) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T and dP = dO V^T: 64 queries x this warpgroup's 32 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<KN>(s, desc_k_major(q_s, kk), desc_k_major(k_s + kh, kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<KN>(dp, desc_k_major(do_s, kk), desc_k_major(v_s + kh, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? lsel1 : lsel0)));
    }
    if (k0 + kRows > kv_end || (p.masked && k0 + kRows - 1 > q0 + p.offset)) {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int row = (i & 2) ? row0 + 8 : row0;
        const int col = k0 + wg * KN + (i / 4) * 8 + 2 * t4 + (i & 1);
        if (!(row < Tq && col < kv_end &&
              (!p.masked || col <= row + p.offset))) {
          s[i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      const int hi = i & 2;
      const int row = hi ? row0 + 8 : row0;
      const int col = k0 + wg * KN + (i / 4) * 8 + 2 * t4 + (i & 1);
      float dpr = dp[i];
      if (p.drop.on) {
        dpr = p.drop.keep<Groups>(dblk, row, col) ? dpr * p.drop.inv_keep : 0.f;
      }
      s[i] = s[i] * (dpr - (hi ? dl1 : dl0));   // dS
    }
    // this warpgroup's 32 key columns (panel wg) of the dS tile
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const int r = warp * 16 + g;
      const uint32_t at = ds_s + (c % 8) * 2;
      st_shared_b32(at + tile_offset(r, wg, c / 8),
                    pack_bf16x2(s[4 * j], s[4 * j + 1]));
      st_shared_b32(at + tile_offset(r + 8, wg, c / 8),
                    pack_bf16x2(s[4 * j + 2], s[4 * j + 3]));
    }
    fence_proxy_async();
    __syncthreads();   // dS

    // dQ += dS K over this warpgroup's columns, B MN-major from its half of
    // K's panels
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_ss_mn<DH>(dq, desc_k_major(ds_s, kk),
                      desc_mn_major(k_s + wg * (DH / 32) * kPanelBytes, kk),
                      1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  }
  cp_async_wait<0>();

  store_rows<DH>(p.dq + b * p.dq_sb + h * p.dq_sh + wg * DH, p.dq_st, row0,
                 Tq, dq, t4);
}

template <int D>
cudaError_t launch_delta(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                         float* delta, int B, int H, int T, long long o_sb,
                         long long o_sh, long long o_st, long long do_sb,
                         long long do_sh, long long do_st, cudaStream_t s) {
  const int rows = B * H * T;
  flash_delta_kernel<D><<<(rows + 15) / 16, 256, 0, s>>>(
      o, dout, delta, H, T, rows, o_sb, o_sh, o_st, do_sb, do_sh, do_st);
  return cudaGetLastError();
}

template <int D, bool Groups>
cudaError_t launch(const BwdParams& p, const __nv_bfloat16* o, long long o_sb,
                   long long o_sh, long long o_st, cudaStream_t s) {
  static bool smem_dkdv = false, smem_dq = false;
  constexpr int dkdv_bytes = dkdv_smem_bytes<D>();
  constexpr int dq_bytes = dq_smem_bytes<D>();
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<D, Groups>, dkdv_bytes, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<D, Groups>, dq_bytes, smem_dq);
  if (err != cudaSuccess) return err;
  err = launch_delta<D>(o, p.dout, const_cast<float*>(p.delta), p.B, p.H,
                        p.Tq, o_sb, o_sh, o_st, p.o_sb, p.o_sh, p.o_st, s);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.Tk + kRows - 1) / kRows, p.B * p.H);
  flash_bwd_dkdv_kernel<D, Groups>
      <<<grid_kv, kThreads, dkdv_bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Tq + kRows - 1) / kRows, p.B * p.H);
  flash_bwd_dq_kernel<D, Groups><<<grid_q, kThreads, dq_bytes, s>>>(p);
  return cudaGetLastError();
}

// A backward of two launches: `dq` (dq_threads threads, which fills delta)
// on a (batch*head, query tiles) grid, then `dkdv` on a (batch*head, key
// tiles) grid as its programmatic dependent (its blocks may start as the
// dQ kernel's last ones run; it waits for them before it reads delta).
template <typename DqKernel, typename DkdvKernel>
cudaError_t launch_dq_then_dkdv(DqKernel dq, int dq_bytes, int dq_threads,
                                bool& dq_set, DkdvKernel dkdv, int dkdv_bytes,
                                int dkdv_threads, bool& dkdv_set,
                                const BwdParams& p, const __nv_bfloat16* o,
                                long long o_sb, long long o_sh,
                                long long o_st, cudaStream_t s) {
  cudaError_t err = allow_smem(dkdv, dkdv_bytes, dkdv_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq, dq_bytes, dq_set);
  if (err != cudaSuccess) return err;
  const int bh = p.B * p.H;
  const dim3 grid_q(bh, (p.Tq + kRows - 1) / kRows);
  dq<<<grid_q, dq_threads, dq_bytes, s>>>(p, o, o_sb, o_sh, o_st,
                                          const_cast<float*>(p.delta));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh, (p.Tk + kRows - 1) / kRows);
  cfg.blockDim = dim3(dkdv_threads);
  cfg.dynamicSmemBytes = dkdv_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkdv, p);
}

// The narrow backward (D = 25, 30).
template <int D, bool Groups>
cudaError_t launch_narrow(const BwdParams& p, const __nv_bfloat16* o,
                          long long o_sb, long long o_sh, long long o_st,
                          cudaStream_t s) {
  static bool smem_dkdv = false, smem_dq = false;
  return launch_dq_then_dkdv(
      flash_bwd_narrow_dq_kernel<D, Groups>, narrow_dq_smem_bytes<D>(),
      kThreads, smem_dq, flash_bwd_narrow_dkdv_kernel<D, Groups>,
      narrow_dkdv_smem_bytes<D>(), kThreads, smem_dkdv, p, o, o_sb, o_sh,
      o_st, s);
}

// The backward at D = 128, 50 and 60.
template <int D, bool Groups>
cudaError_t launch_wide(const BwdParams& p, const __nv_bfloat16* o,
                        long long o_sb, long long o_sh, long long o_st,
                        cudaStream_t s) {
  static bool smem_dkdv = false, smem_dq = false;
  return launch_dq_then_dkdv(
      flash_bwd_wide_dq_kernel<D, Groups>, wide_dq_smem_bytes<D>(), kThreads,
      smem_dq, flash_bwd_wide_dkdv_kernel<D, Groups>,
      wide_dkdv_smem_bytes<D>(), wide_dkdv_threads<D>(), smem_dkdv, p, o,
      o_sb, o_sh, o_st, s);
}

// The backward at D = 192 and 256: the dQ kernel with delta, then the dK/dV
// kernel.
template <int D, bool Groups>
cudaError_t launch_split(const BwdParams& p, const __nv_bfloat16* o,
                        long long o_sb, long long o_sh, long long o_st,
                        cudaStream_t s) {
  static bool smem_dkdv = false, smem_dq = false;
  return launch_dq_then_dkdv(
      flash_bwd_keysplit_dq_kernel<D, Groups>, keysplit_dq_smem_bytes<D>(),
      kSplitThreads, smem_dq, flash_bwd_rowsplit_dkdv_kernel<D, Groups>,
      rowsplit_dkdv_smem_bytes<D>(), kSplitThreads, smem_dkdv, p, o, o_sb,
      o_sh, o_st, s);
}

// The backward's launches at head_dim D (the header): two at 25, 30, 50,
// 60, 128, 192 and 256 (dQ with delta, then dK/dV), three at 64 and 96.
template <int D, bool Groups>
cudaError_t launch_by_head_dim(const BwdParams& p, const __nv_bfloat16* o,
                               long long o_sb, long long o_sh, long long o_st,
                               cudaStream_t s) {
  if constexpr (padded_dim<D>() == 32) {
    return launch_narrow<D, Groups>(p, o, o_sb, o_sh, o_st, s);
  } else if constexpr (runs_wide<D>()) {
    return launch_wide<D, Groups>(p, o, o_sb, o_sh, o_st, s);
  } else if constexpr (padded_dim<D>() >= 192) {
    return launch_split<D, Groups>(p, o, o_sb, o_sh, o_st, s);
  } else {
    return launch<D, Groups>(p, o, o_sb, o_sh, o_st, s);
  }
}

}  // namespace

extern "C" {

// q, k, v, dO, o, dq, dk, dv: (B, H, T, D) bf16 by strides (b, h, t); lse
// (B*H, Tq) fp32; delta an fp32 (B*H, Tq) workspace the call fills; kv_lens
// (B,) int32 or null.  Launches, on the stream, at head_dim 64 and 96 the
// delta kernel, the dK/dV kernel, then the dQ kernel; at 25, 30, 50, 60,
// 128, 192 and 256 the dQ kernel (with delta), then the dK/dV kernel
// (launch_by_head_dim).  Dropout's seeds and placement as bpx_flash_fwd's.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a head_dim
// without an instantiation, or for seed groups or a placement that do not
// fit.
int bpx_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* o, const void* lse,
                  void* delta, const void* kv_lens, void* dq, void* dk,
                  void* dv, int B, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_sh, long long q_st,
                  long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st,
                  long long do_sb, long long do_sh, long long do_st,
                  long long o_sb, long long o_sh, long long o_st,
                  long long dq_sb, long long dq_sh, long long dq_st,
                  long long dk_sb, long long dk_sh, long long dk_st,
                  long long dv_sb, long long dv_sh, long long dv_st,
                  int masked, int offset, int dropout,
                  const unsigned int* seeds, int groups,
                  unsigned int threshold, float inv_keep, int tk_p,
                  int b_off, int h_off, int heads_g, int group_stride,
                  void* stream) {
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
  p.o_sb = do_sb; p.o_sh = do_sh; p.o_st = do_st;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.masked = masked;
  p.offset = offset;
  if (!set_dropout(p.drop, p.seed_groups, dropout, seeds, groups, B * H, H,
                   threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                   group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bpx_flash::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (p.seed_groups.grouped()) {
      return launch_by_head_dim<kD, true>(p, ob, o_sb, o_sh, o_st, s);
    }
    return launch_by_head_dim<kD, false>(p, ob, o_sb, o_sh, o_st, s);
  }));
}

// delta = rowsum(dO * O) in fp32 into a contiguous (B*H, T) buffer: the
// first launch of bpx_flash_bwd, on its own.
int bpx_flash_delta(const void* o, const void* dout, void* delta, int B,
                    int H, int T, int D, long long o_sb, long long o_sh,
                    long long o_st, long long do_sb, long long do_sh,
                    long long do_st, void* stream) {
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bpx_flash::with_head_dim(D, [&](auto d) {
    return launch_delta<decltype(d)::value>(ob, dob, dl, B, H, T, o_sb, o_sh,
                                            o_st, do_sb, do_sh, do_st, s);
  }));
}

// Blocks of the dK/dV (kernel 0) or the dQ kernel (kernel 1) at head_dim D
// that one SM holds, into *blocks.  Returns a cudaError_t.
int bpx_flash_bwd_blocks_per_sm(int D, int kernel, int* blocks) {
  return static_cast<int>(bpx_flash::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (padded_dim<kD>() == 32) {
      return kernel == 0
                 ? bpx_flash::blocks_per_sm(
                       flash_bwd_narrow_dkdv_kernel<kD>,
                       narrow_dkdv_smem_bytes<kD>(), blocks)
                 : bpx_flash::blocks_per_sm(flash_bwd_narrow_dq_kernel<kD>,
                                            narrow_dq_smem_bytes<kD>(),
                                            blocks);
    } else if constexpr (runs_wide<kD>()) {
      return kernel == 0
                 ? bpx_flash::blocks_per_sm(flash_bwd_wide_dkdv_kernel<kD>,
                                            wide_dkdv_smem_bytes<kD>(),
                                            blocks, wide_dkdv_threads<kD>())
                 : bpx_flash::blocks_per_sm(flash_bwd_wide_dq_kernel<kD>,
                                            wide_dq_smem_bytes<kD>(), blocks);
    } else if constexpr (padded_dim<kD>() >= 192) {
      return kernel == 0
                 ? bpx_flash::blocks_per_sm(
                       flash_bwd_rowsplit_dkdv_kernel<kD>,
                       rowsplit_dkdv_smem_bytes<kD>(), blocks, kSplitThreads)
                 : bpx_flash::blocks_per_sm(flash_bwd_keysplit_dq_kernel<kD>,
                                            keysplit_dq_smem_bytes<kD>(),
                                            blocks, kSplitThreads);
    } else {
      return kernel == 0
                 ? bpx_flash::blocks_per_sm(flash_bwd_dkdv_kernel<kD>,
                                            dkdv_smem_bytes<kD>(), blocks)
                 : bpx_flash::blocks_per_sm(flash_bwd_dq_kernel<kD>,
                                            dq_smem_bytes<kD>(), blocks);
    }
  }));
}

}  // extern "C"
