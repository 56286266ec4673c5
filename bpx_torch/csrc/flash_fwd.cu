// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 lse.
//
// Replaces the TPU kernel bpx/ops/pallas_attention.py::_fwd_kernel (launched
// from _fwd through flash_attention), its single-pass and its online branch,
// with the in-kernel dropout of _keep_mask.  The function it computes, per
// (batch*head, query row):
//   s     = q . k^T in fp32 (q arrives pre-scaled by head_dim**-0.5)
//   s     = -1e30 where col >= kv_len[b] or (masked and col > row + offset)
//   m     = max_col s,  p = exp(s - m),  l = sum_col p  (fp32, unnormalised,
//           over the undropped probabilities)
//   p     = keep(bh, row, col) ? p * float32(1 / (1 - rate)) : 0   (dropout)
//   o     = (bf16(p) . v) / l     (l == 0 -> 1)
//   lse   = m + log(l)            (dropout leaves it unchanged)
// The -1e30 fill (not -inf) is part of the contract: a row whose every key is
// masked attends uniformly over all Tk keys, as the single-pass branch does.
// The keep bit is the TPU kernels' hash of the global (bh, row, col) index
// (flash_common.cuh), so the backward regenerates the same mask.
//
// Design.  The TPU kernel holds a whole-Tk fp32 score tile (up to 512 x 1024)
// in VMEM; an SM cannot.  One warpgroup (128 threads) owns 64 query rows of
// one (batch, head) and walks the keys in tiles of 64 with the online softmax
// of FlashAttention-2.  Both products run on wgmma: S = Q K^T with Q and K
// from shared memory (K-major), O += P V with P from registers (the S
// accumulator, packed to bf16, is already wgmma's A-fragment layout) and V
// from shared memory as an MN-major operand, so P never touches shared
// memory.  K and V tiles stream through a 3-stage cp.async ring
// (flash_common.cuh says why not TMA): the copies of tiles t + 1 and t + 2
// are in flight while tile t computes.  64-row tiles rather than 128: the
// grid is Tq / 64 x B*H = 256 blocks at Tq = 200 (B*H = 64) and 512 at
// Tq = 512, 2 blocks of 85 KB (D = 96; 3 of 57 KB at D = 64) per SM; at
// Tq = 200 both tilings pad to 256 rows, but 128-row tiles would give half
// the blocks, 128, fewer than the SMs.  No producer warp: every thread
// issues its share of the copies, and the loop is latency-, not
// issue-bound.  (A 2-stage ring fits 3 blocks at D = 96 and measured
// slower over the model's mix; Q as a register A operand, loaded once,
// measured no faster.)  Only edge tiles (the band's diagonal, kv_len, Tk)
// test each score; tiles wholly above the band or past kv_len are skipped,
// exact whenever some key of the row is visible (kv_len > 0); with
// kv_len <= 0 every tile is visited so the uniform-attention result above
// is kept.  exp is exp2 with log2(e) folded
// in; on edge tiles the product and the difference are rounded apart so
// that a -1e30 score minus a -1e30 max is exactly 0.
//
// Narrow heads (D = 25, 30: the mmtrvat presets' 300 / 12 and 300 / 10) have
// a kernel of their own, flash_fwd_narrow_kernel: the same function and
// the same tile step at DP = 32, one panel whose columns D..31 the loads
// zero (flash_common.cuh), S = Q K^T in 2 k-steps, O += P V as m64n32k16.
// What differs:
//   * the grid puts batch*head along x and the query tiles along y, last
//     first: under a causal band query tile i visits i + 1 key tiles, so
//     the longest blocks start first and the short ones fill the tail;
//   * D = 25's rows start at any even byte, which cp.async cannot copy: K
//     and V stream through NarrowTile (flash_common.cuh), each tile's
//     4-byte words loaded into registers before the products of the tile
//     before and written to shared memory after them, through a 2-stage
//     ring; D = 30 keeps its 4-byte cp.async words and 3 stages;
//   * __launch_bounds__ asks for 5 blocks an SM at D = 25 (94 registers,
//     no spills) and 4 at D = 30 (121), where the kernel alone took 146 and
//     149 registers and 3 blocks.
// Measured on an H100 (PERF.md, scripts/torch_flash_bwd_narrow.py), one
// step at a time, each faster than the one before: the order, the loads
// off the chain (D = 25), the blocks per SM.  Pairing query tiles i and
// n - 1 - i in one block (equal work a block), 6 blocks at D = 25 (it
// spills) and at D = 30 a fourth stage or a fifth block measured slower.
// It reaches an eighth of its bound at D = 25 and a sixth at D = 30 (rate
// 0): a 64 x 64 tile step at DP = 32 is a short serial chain (wait, S,
// softmax, P V, wait) that 4-5 blocks an SM do not hide.
//
// D = 128 (mmimdb: 768 / 6) has a kernel of its own, flash_fwd_wide_kernel
// (D = 50 and 60 run it too, at DP = 64, below): the same function over
// four panels, S in 8 k-steps, O += P V as
// m64n128k16 (64 fp32 accumulators a thread beside S's 32).  What differs:
//   * the grid puts batch*head along x and the query tiles along y, last
//     first, as the narrow kernel's;
//   * tile step u issues S_u = Q K_u^T and O += P_{u-1} V_{u-1} together,
//     waits for S_u alone and computes P_u while P_{u-1} V_{u-1} runs
//     (FlashAttention-3's order inside one warpgroup), then rescales O once
//     that product is waited on: one score buffer, no serial wait for P V;
//   * K and V stream through rings of their own (3 stages each), each tile
//     two steps ahead with one barrier a step: at step u the stages of
//     K_{u-1} and V_{u-2} are free;
//   * a thread's copies are worked out once (WideCopier): a tile costs a
//     64-bit offset, two row tests and eight cp.async, where load_tile's
//     address arithmetic took about as many instructions as the softmax;
//   * an edge tile masks with one comparison a score (each row's last
//     visible key), and the dropout hash steps its first product by
//     constants (Dropout::keep_mixed).
// 113 KB of shared memory (Q, 3 K and 3 V tiles): two blocks fill an SM's
// 228 KB, 1 KB reserved for each; 157 registers, no spills.  Measured on an
// H100 (PERF.md, scripts/torch_flash_bwd_narrow.py), one step at a time,
// each faster than the one before: the order with the split rings, the
// overlap, the copies worked out once, the masks and the hash.  Two
// warpgroups on a 128-query tile (one block an SM; with ping-pong
// barriers too, and at 2 stages and 128 registers for two blocks), S_{u+1}
// issued before the softmax of tile u (a second score buffer: ptxas
// serialised the wgmmas), 2 stages, the copies issued after the products,
// the keep bits computed while S runs, and a stated minimum of 2 blocks
// measured slower or no faster.
//
// D = 192 (mmtrvpa's 2E-wide memory encoders at moviescope's widths: 1536 /
// 8) has a kernel of its own, flash_fwd_tall_kernel: six panels, S in 12
// k-steps, O += P V as m64n192k16 (96 fp32 accumulators a thread beside
// S's 32 and P's 16).  A 64 x 192 K or V tile is 24 KB, so one block fills
// an SM's shared memory whatever it does; the D 64/96 kernel over six
// panels held one warpgroup there, a single warp per SM sub-partition
// with nothing to hide its serial tile chain.  What differs:
//   * two warpgroups a block on a 128-query tile, each over its own 64
//     rows, both reading every K and V tile: an SM holds 8 warps, and a
//     K/V tile is read from L2 once per 128 query rows, not 64;
//   * each warpgroup runs the D 128 kernel's step: S_u issued beside
//     P_{u-1} V_{u-1}, split K and V rings of 3 stages, copies worked out
//     once (TallCopier), one comparison a score on edge tiles, keep_mixed;
//   * no block barrier: the rings hand tiles on through mbarriers (a
//     "full" one a stage that the copies arrive on as they land, an
//     "empty" one the products arrive on once they have read it), and
//     the warpgroups take turns to issue their products (the ping-pong of
//     FlashAttention-3, two named barriers), so they drift apart and one's
//     softmax runs beside the other's products;
//   * the grid puts batch*head along x and the query tiles along y, last
//     first; under a causal band the first warpgroup skips the one key
//     tile wholly above its band;
//   * at Tq = 200, 2 x 64 blocks fill 128 of 132 SMs in one wave where
//     the 64-row kernel took two (4 x 64 blocks).
// Q (2 tiles), 3 K and 3 V tiles: 193 KB of shared memory, one block of
// 256 threads an SM, 227 registers, no spills.  Measured on an H100
// (PERF.md, scripts/torch_flash_bwd_narrow.py), one step at a time, each
// faster than the one before: the two warpgroups on 128 rows with a block
// barrier a step (0.61 of the six-panel D 64/96 kernel's time at 512 x
// 512), then the mbarrier rings with the ping-pong (a further 2-7%).  A
// copy warp or warpgroup feeding the rings (ptxas held the kernel at 168
// registers, setmaxnreg or not, and spilled), 2 stages, loads two tiles
// ahead, O staged through shared memory for 16-byte stores and the keep
// bits computed while S runs measured slower or no faster.
//
// D = 50 and 60 (mmtrvpa's 2E-wide memory encoders at iemocap's widths,
// 600 / 12, and at cmu-mosei's, counseling's and cmu-mosi's, 600 / 10) run
// flash_fwd_wide_kernel at DP = 64 (runs_wide, flash_common.cuh): two
// panels whose columns D..63 are zeros, S in 4 k-steps, O += P V as
// m64n64k16, O's stores cut at column D, since the next head's values sit
// there.  What differs from D = 128:
//   * K and V are copied as cp.async words, 4 bytes at D = 50 (rows start
//     100 bytes apart), 8 at D = 60 (120 bytes), by WordCopier, the
//     addresses worked out once; the columns D..63 of every ring stage are
//     zeroed once before the loop, not with every tile;
//   * rings 2 deep (41 KB of shared memory) and a register cap for 3
//     blocks an SM: 157 registers, no spills.
// Measured on an H100 (PERF.md, scripts/torch_flash_bwd_narrow.py --kernel
// fwd at (8, 12, 512, 512) causal for D = 50 and (8, 10, 512, 512) for
// D = 60, rate 0 / 0.1), one step at a time, each against the one before
// in one call; the first design (flash_fwd_kernel at DP = 64, the serial
// chain, first query tile first) read 0.0307 / 0.0379 ms at D = 50 and
// 0.0257 / 0.0319 at D = 60:
//   * the D = 128 kernel's steps with 3 stages at 3 blocks (157
//     registers): 0.0275 / 0.0321 and 0.0234 / 0.0281; without
//     WordCopier (load_tile_by's address arithmetic a tile) 0.0283 /
//     0.0328 and 0.0242 / 0.0287; D = 60 in 4-byte words 0.0257 / 0.0301;
//   * 2 stages: 0.0264 / 0.0304 and 0.0218 / 0.0266 (kept); at 4 blocks
//     (a cap of 128 registers, 122 used) 0.0279 / 0.0309 and 0.0224 /
//     0.0272; at 5 (94 registers, 144 bytes of spills) 0.0339 / 0.0373 and
//     0.0305 / 0.0354;
//   * words as wide as each head's alignment allows (16 bytes where a
//     slice's base and row pitch are 16-byte aligned, else 8, else 4, the
//     word over column D - 1 reading only its columns below D; the width
//     and the bytes a word reads held in registers): 0.0300 / 0.0362 and
//     0.0216 / 0.0275 against that copier's 0.0270 / 0.0339 and 0.0234 /
//     0.0272 at the widths above (both uncapped; at most 8 bytes at
//     D = 50: 0.0300 / 0.0353); that copier itself read 0.0270 / 0.0341
//     and 0.0235 / 0.0272 against WordCopier's 0.0282 / 0.0307 and 0.0224 /
//     0.0267 (uncapped, one call);
//   * the cap, in one call: 3 blocks 0.0266 / 0.0308 and 0.0219 / 0.0266
//     (kept), none stated (122 registers, 4 blocks) 0.0282 / 0.0307 and
//     0.0224 / 0.0267, 4 blocks 0.0282 / 0.0311 and 0.0225 / 0.0272.
// Two warpgroups on a 128-query tile, which lost at D = 128 and in the
// DP = 64 backward's dK/dV kernel, were not built.  At DP = 64 a tile step
// holds half the products of D = 128's and the same softmax, dropout hash
// and copies a score, and D = 50's class has twice D = 128's scores: the
// time follows the scores, not the columns (no instruction profile was
// taken to show where a step waits).
//
// D = 256 (mmtrvpa's memory encoders at mmimdb's widths: 1536 / 6) runs
// flash_fwd_tall_kernel too, with two changes: the K and V rings are 2
// stages deep (a 64 x 256 tile is 32 KB: Q's two tiles and four ring
// tiles take 193 KB), and a warpgroup waits for both products of its turn
// (S_u and P_{u-1} V_{u-1}) before its softmax of S_u (tall_overlap): a
// thread holds O's 128 fp32, and P_{u-1}'s fragments beside S_u through
// the softmax would take it past 255 registers.  The ping-pong still puts
// one warpgroup's softmax beside the other's products.  240 registers, no
// spills, one block of 256 threads an SM.  Measured on an H100 at (8, 6,
// 512, 512) causal (PERF.md, scripts/torch_flash_bwd_narrow.py), rate 0 /
// 0.1, in one call: 0.0388 / 0.0467 ms, against 0.0489 / 0.0553 for the
// first design (flash_fwd_kernel's two-warpgroup branch: 2 stages, a block
// barrier a step).  A K ring 3 deep beside the V ring's 2 (225 KB) read
// 0.0389 / 0.0469 (slower in each of three runs); issuing P_{u-1} V_{u-1},
// waiting, then S_u within a turn 0.0394 / 0.0475; a copy warpgroup
// feeding the rings, with setmaxnreg (40 registers to it, 232 to the two
// computing), made ptxas hold the whole 384-thread kernel at 168 registers
// with 1.3 KB of spills: 0.0717 / 0.0825 ms.

// Bound on an H100: the forward moves q, k, v and o once (bf16) and does
// 4*Tq*Tk*D flops per (batch, head); at the model's shapes (T <= 512, D <=
// 128) the arithmetic intensity is below the card's ~295 flop/byte balance
// point, so the bound is the bytes (at D 192 and 256 too: 4 D flops per
// score against 8 D bytes per row of q, k, v and o).
//
// Inputs are (B, H, T, D) tensors addressed by strides (the last dim
// contiguous), so the q/k/v views of a fused projection need no copy.
// D = 64, 96, 128, 192, 256: every stride a multiple of 8 elements and
// pointers 16-byte aligned; D = 60: strides multiples of 4, 8-byte aligned
// pointers; D = 30, 50: even strides, 4-byte aligned pointers; D = 25: any
// strides (its rows start at any even byte).

#include "flash_common.cuh"

namespace {

using namespace bpx_flash;

constexpr int kStages = 3;   // K/V tiles in flight

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
  Dropout drop;
  SeedGroups seed_groups;   // read by the kernels of several groups only
};

// Q, then kStages x (K, V); +1 KB to align the base to the swizzle.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<D>() + 1024;
}

template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;   // k-steps of Q K^T
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + kTile;   // stage s: K at + 2 s kTile, V after

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row within the warp's 16 (and g + 8)
  const int t4 = lane % 4;    // column pair within an 8-wide block

  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);   // keys from here on are masked

  // key tiles to visit
  int n_tiles = (Tk + kRows - 1) / kRows;
  if (kv_len > 0) {
    n_tiles = min(n_tiles, (kv_len + kRows - 1) / kRows);
    if (p.masked) {
      n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
    }
  }

  // key tile t goes to ring stage t mod kStages
  auto load_kv = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kStages) * kTile;
    load_tile<D>(dst, kb, p.k_st, t * kRows, Tk);
    load_tile<D>(dst + kTile, vb, p.v_st, t * kRows, Tk);
  };
  load_tile<D>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, p.Tq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const int row0 = q0 + warp * 16 + g;   // global query rows of this thread
  const int row1 = row0 + 8;
  float m0 = kMaskFill, m1 = kMaskFill;   // running row max
  float l0 = 0.f, l1 = 0.f;               // per-thread partial row sums
  float acc[DP / 2], s[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt has landed (each thread waits for its own copies, then the
    // barrier publishes everyone's); every warp is done with tile kt - 1
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kStages) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T, 64 rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool edge = k0 + kRows > kv_end ||
                      (p.masked && k0 + kRows - 1 > q0 + p.offset);
    if (edge) {
      // -inf past Tk (not a key at all), -1e30 for masked keys
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (col >= Tk) {
          s[i] = -INFINITY;
        } else if (col >= kv_len || (p.masked && col > row + p.offset)) {
          s[i] = kMaskFill;
        }
      }
    }
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2((m0 - mn0) * kLog2e);
    const float alpha1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = __fmul_rn(mn0, kLog2e);
    const float ml1 = __fmul_rn(mn1, kLog2e);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(__fmul_rn(s[i], kLog2e) - ((i & 2) ? ml1 : ml0));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? ml1 : ml0)));
      }
    }
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // dropout after the row sums, so l keeps the undropped probabilities
    if (p.drop.on) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        s[i] = p.drop.keep<Groups>(dblk, row, col) ? s[i] * p.drop.inv_keep
                                                        : 0.f;
      }
    }

    // O += bf16(P) V, P straight from the score registers
    uint32_t pa[4][4];
    p_frags(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(acc, pa[kc], desc_mn_major(v_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if (row0 < p.Tq) {
    store_row<D, 0>(ob + row0 * p.o_st, acc, t4, ls0);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Tq) {
    store_row<D, 2>(ob + row1 * p.o_st, acc, t4, ls1);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row1] = m1 + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// narrow heads (D = 25, 30): the header
// ---------------------------------------------------------------------------

// K/V tiles in flight: 3 at D = 30 (cp.async, two tiles ahead), 2 at D =
// 25, whose loads wait in registers for the end of the tile before (a
// third stage would not start them earlier).
template <int D>
__host__ __device__ constexpr int narrow_stages() {
  return D % 2 ? 2 : 3;
}

// Blocks per SM the narrow kernel is compiled for: 5 at D = 25, 4 at
// D = 30 (the header).
template <int D>
__host__ __device__ constexpr int narrow_min_blocks() {
  return D % 2 ? 5 : 4;
}

// Q, then stages x (K, V), one panel each; +1 KB for alignment.
template <int D>
__host__ __device__ constexpr int narrow_smem_bytes() {
  return (1 + 2 * narrow_stages<D>()) * kPanelBytes + 1024;
}

// One (batch*head, 64-query tile) at DP = 32: batch*head along x, the
// query tiles along y, the last (the most key tiles of a causal band)
// first.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads, narrow_min_blocks<D>())
flash_fwd_narrow_kernel(const FlashParams p) {
  constexpr int kRing = narrow_stages<D>();
  constexpr int kTile = kPanelBytes;
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + kTile;   // stage s: K at + 2 s kTile, V after

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row within the warp's 16 (and g + 8)
  const int t4 = lane % 4;    // column pair within an 8-wide block

  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);   // keys from here on are masked

  // key tiles to visit
  int n_tiles = (Tk + kRows - 1) / kRows;
  if (kv_len > 0) {
    n_tiles = min(n_tiles, (kv_len + kRows - 1) / kRows);
    if (p.masked) {
      n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
    }
  }

  // key tile t goes to ring stage t mod kRing, started by fetch(t),
  // written by store(t) (D = 25)
  NarrowTile<D> k_next, v_next;
  auto fetch = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kRing) * kTile;
    k_next.fetch(dst, kb, p.k_st, t * kRows, Tk);
    v_next.fetch(dst + kTile, vb, p.v_st, t * kRows, Tk);
  };
  auto store = [&](int t) {
    const uint32_t dst = kv_s + 2 * (t % kRing) * kTile;
    k_next.store(dst);
    v_next.store(dst + kTile);
  };
  load_tile<D>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, p.Tq);
  if (n_tiles > 0) {
    fetch(0);
    store(0);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kRing - 1; ++t) {
    if (t < n_tiles) {
      fetch(t);
      store(t);
    }
    cp_async_commit();
  }

  const int row0 = q0 + warp * 16 + g;   // global query rows of this thread
  const int row1 = row0 + 8;
  float m0 = kMaskFill, m1 = kMaskFill;   // running row max
  float l0 = 0.f, l1 = 0.f;               // per-thread partial row sums
  float acc[16], s[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt has landed (each thread waits for its own copies, then the
    // barrier publishes everyone's); every warp is done with tile kt - 1
    cp_async_wait<kRing - 2>();
    fence_proxy_async();
    __syncthreads();
    const bool more = kt + kRing - 1 < n_tiles;
    if (more) fetch(kt + kRing - 1);
    cp_async_commit();
    const uint32_t k_s = kv_s + 2 * (kt % kRing) * kTile;
    const uint32_t v_s = k_s + kTile;
    const int k0 = kt * kRows;

    // S = Q K^T, 64 rows x 64 keys, 2 k-steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool edge = k0 + kRows > kv_end ||
                      (p.masked && k0 + kRows - 1 > q0 + p.offset);
    if (edge) {
      // -inf past Tk (not a key at all), -1e30 for masked keys
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (col >= Tk) {
          s[i] = -INFINITY;
        } else if (col >= kv_len || (p.masked && col > row + p.offset)) {
          s[i] = kMaskFill;
        }
      }
    }
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2((m0 - mn0) * kLog2e);
    const float alpha1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = __fmul_rn(mn0, kLog2e);
    const float ml1 = __fmul_rn(mn1, kLog2e);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(__fmul_rn(s[i], kLog2e) - ((i & 2) ? ml1 : ml0));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? ml1 : ml0)));
      }
    }
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // dropout after the row sums, so l keeps the undropped probabilities
    if (p.drop.on) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        s[i] = p.drop.keep<Groups>(dblk, row, col) ? s[i] * p.drop.inv_keep
                                                        : 0.f;
      }
    }

    // O += bf16(P) V, P straight from the score registers
    uint32_t pa[4][4];
    p_frags(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<32>(acc, pa[kc], desc_mn_major(v_s, kc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (more) store(kt + kRing - 1);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if (row0 < p.Tq) {
    store_row<D, 0>(ob + row0 * p.o_st, acc, t4, ls0);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Tq) {
    store_row<D, 2>(ob + row1 * p.o_st, acc, t4, ls1);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row1] = m1 + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// D = 128: the header
// ---------------------------------------------------------------------------

// One thread's copies into every 64 x 128 tile of one (batch, head) slice,
// load_tile's chunks with their addresses worked out once: chunk c = t % 4
// of the four panels of rows t / 4 and t / 4 + 32 of the tile.  A tile then
// costs a 64-bit offset, two row tests and eight cp.async.
struct WideCopier {
  const __nv_bfloat16* row;   // row t / 4 of the slice, column 8 c
  const __nv_bfloat16* zero;  // row 0, column 8 c: the address of a zero fill
  long long stride;           // elements between rows
  uint32_t dst;               // byte offset of the first chunk in a tile
  int r0;                     // t / 4

  __device__ __forceinline__ WideCopier(const __nv_bfloat16* slice,
                                        long long stride_t, int tid)
      : stride(stride_t), r0(tid >> 2) {
    zero = slice + (tid & 3) * 8;
    row = zero + (long long)r0 * stride_t;
    dst = tile_offset(r0, 0, tid & 3);
  }

  // rows [t0, t0 + 64) into the tile at `tile`; rows at or past T as zeros
  __device__ __forceinline__ void copy(uint32_t tile, int t0, int T) const {
    const bool ok0 = t0 + r0 < T;
    const bool ok1 = t0 + r0 + 32 < T;
    const __nv_bfloat16* lo = row + (long long)t0 * stride;
    const __nv_bfloat16* a0 = ok0 ? lo : zero;
    const __nv_bfloat16* a1 = ok1 ? lo + 32 * stride : zero;
    const uint32_t d = tile + dst;
#pragma unroll
    for (int panel = 0; panel < 4; ++panel) {
      cp_async_16(d + panel * kPanelBytes, a0 + panel * 32, ok0);
      cp_async_16(d + panel * kPanelBytes + 32 * 64, a1 + panel * 32, ok1);
    }
  }
};

// Blocks per SM the wide kernel is compiled for (its register cap): none
// stated at D = 128 (0), where a stated 1 took ptxas from 157 registers to
// 195; 3 at DP = 64 (D = 50, 60: 157 registers, where none stated took 122
// and 4 blocks, slower; the header).
template <int D>
__host__ __device__ constexpr int wide_min_blocks() {
  return padded_dim<D>() == 128 ? 0 : 3;
}

// The wide kernel's K and V rings: kStages deep each at D = 128, 2 at DP =
// 64 (D = 50, 60; the header).
template <int D>
__host__ __device__ constexpr int wide_stages() {
  return padded_dim<D>() == 128 ? kStages : 2;
}

// Q, then a ring of K tiles, then one of V tiles; +1 KB for alignment.
template <int D>
__host__ __device__ constexpr int wide_smem_bytes() {
  return (1 + 2 * wide_stages<D>()) * tile_bytes<D>() + 1024;
}

// One thread's copies into every 64-row tile of one (batch, head) slice at
// D = 50 and 60, whose rows are only 4- or 8-byte aligned: load_tile_by's
// cp.async words (word_bytes) with their addresses worked out once.
// Thread t takes word column t % kPerRow of rows t / kPerRow + kStep j
// (j < kWords), on one running row pointer.  Columns D..63 are written as
// zeros once, in every ring stage, before the loop (zero_fill), and never
// again: nothing in the ring writes them, so a thread whose word lies
// there copies nothing in the loop (7 of 32 words a row at D = 50, 1 of 16
// at D = 60).  A tile costs a 64-bit offset, a row test a word, and the
// words.
template <int D>
struct WordCopier {
  static constexpr int kW = word_bytes<D>();
  static constexpr int kPerRow = padded_dim<D>() * 2 / kW;   // words a row
  static constexpr int kStep = kThreads / kPerRow;           // rows a step
  static constexpr int kWords = kRows / kStep;               // words a tile
  static_assert(kThreads % kPerRow == 0 && kWords % 2 == 0, "word rows");

  const __nv_bfloat16* slice;   // row 0, column 0: also a zero fill's address
  const __nv_bfloat16* row;     // row t / kPerRow of the slice, its column
  long long stride;             // elements between rows
  uint32_t dst[2];              // byte offsets of words 0 and 1 in a tile
  int r0;                       // t / kPerRow
  bool live;                    // the word's column is below D

  __device__ __forceinline__ WordCopier(const __nv_bfloat16* s,
                                        long long stride_t, int tid)
      : slice(s), stride(stride_t), r0(tid / kPerRow) {
    const int col = (tid % kPerRow) * (kW / 2);
    live = col < D;
    row = s + (long long)r0 * stride_t + col;
    // rows r0 + kStep j, kStep >= 4: the swizzle repeats every two words
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dst[j] = tile_offset(r0 + j * kStep, col / 32, (col % 32) / 8) +
               (col % 8) * 2;
    }
  }

  __device__ __forceinline__ void word(uint32_t d, const void* src,
                                       bool ok) const {
    if constexpr (kW == 8) {
      cp_async_8(d, src, ok);
    } else {
      cp_async_4(d, src, ok);
    }
  }

  // the byte offset of word j in a tile
  __device__ __forceinline__ uint32_t offset(int j) const {
    return dst[j & 1] + (j >> 1) * (2 * kStep * 64);
  }

  // columns D..63 of the tile at `tile` as zeros
  __device__ __forceinline__ void zero_fill(uint32_t tile) const {
    if (live) return;
#pragma unroll
    for (int j = 0; j < kWords; ++j) word(tile + offset(j), slice, false);
  }

  // rows [t0, t0 + 64) into the tile at `tile`, columns below D; rows at
  // or past T as zeros
  __device__ __forceinline__ void copy(uint32_t tile, int t0, int T) const {
    if (!live) return;
    const int rows = T - t0 - r0;   // word j is a row while j kStep < rows
    const __nv_bfloat16* g = row + (long long)t0 * stride;
#pragma unroll
    for (int j = 0; j < kWords; ++j, g += kStep * stride) {
      const bool ok = j * kStep < rows;
      word(tile + offset(j), ok ? g : slice, ok);
    }
  }
};

// Pin the bf16 A fragments of an in-flight P V at this point: their
// registers are not reused before the wgmma that reads them is waited on.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// One (batch*head, 64-query tile) at D = 128, 50 or 60 (runs_wide):
// batch*head along x, the query tiles along y, the last first.  Step u
// issues S_u = Q K_u^T and O += P_{u-1} V_{u-1} together, waits for S_u
// alone and computes P_u while P_{u-1} V_{u-1} runs, then waits for it and
// rescales O.  Shared memory holds Q, then a ring of wide_stages K tiles,
// then one of as many V tiles (wide_smem_bytes).  K_u and V_u go to stage
// u mod kS of their rings, K_u loaded kS - 1 steps ahead and V_u kS - 2:
// at step u, once every thread is past step u - 1, the stages of K_{u-1}
// (read by S_{u-1}) and V_{u-2} (read by P_{u-2} V_{u-2}) are free.  At
// D = 128 a thread's copies are WideCopier's 16-byte chunks, at 50 and 60
// WordCopier's words.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kThreads, wide_min_blocks<D>())
flash_fwd_wide_kernel(const FlashParams p) {
  constexpr int DP = padded_dim<D>();
  static_assert(runs_wide<D>(), "D = 128, 50 or 60");
  using Copier = std::conditional_t<DP == 128, WideCopier, WordCopier<D>>;
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;   // k-steps of Q K^T
  constexpr int kS = wide_stages<D>();
  extern __shared__ unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_ring = q_s + kTile;
  const uint32_t v_ring = k_ring + kS * kTile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // row within the warp's 16 (and g + 8)
  const int t4 = lane % 4;    // column pair within an 8-wide block

  const int Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);   // keys from here on are masked

  // key tiles to visit
  int n_tiles = (Tk + kRows - 1) / kRows;
  if (kv_len > 0) {
    n_tiles = min(n_tiles, (kv_len + kRows - 1) / kRows);
    if (p.masked) {
      n_tiles = min(n_tiles, (q0 + kRows - 1 + p.offset) / kRows + 1);
    }
  }

  // step w loads K_{w + kS - 1} and V_{w + kS - 2}, one commit group
  const Copier k_copy(p.k + b * p.k_sb + h * p.k_sh, p.k_st, threadIdx.x);
  const Copier v_copy(p.v + b * p.v_sb + h * p.v_sh, p.v_st, threadIdx.x);
  if constexpr (DP != 128) {
    // the padding columns of every ring stage, once (the first commit
    // group, complete before step 0)
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      k_copy.zero_fill(k_ring + st * kTile);
      v_copy.zero_fill(v_ring + st * kTile);
    }
  }
  auto load_group = [&](int w) {
    const int jk = w + kS - 1;
    const int jv = w + kS - 2;
    if (jk < n_tiles) k_copy.copy(k_ring + (jk % kS) * kTile, jk * kRows, Tk);
    if (jv >= 0 && jv < n_tiles) {
      v_copy.copy(v_ring + (jv % kS) * kTile, jv * kRows, Tk);
    }
    cp_async_commit();
  };
  load_tile<D>(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, p.Tq);
#pragma unroll
  for (int w = 1 - kS; w < 0; ++w) load_group(w);

  const int row0 = q0 + warp * 16 + g;   // global query rows of this thread
  const int row1 = row0 + 8;
  float m0 = kMaskFill, m1 = kMaskFill;   // running row max
  float l0 = 0.f, l1 = 0.f;               // per-thread partial row sums
  float alpha0 = 1.f, alpha1 = 1.f;       // the last step's rescale
  float acc[DP / 2], s[32];
  uint32_t pa[4][4];                      // bf16(P) of the last step
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // K_u and V_{u-1} have landed (each thread waits for its own copies, the
  // barrier publishes everyone's) and every thread is done with step u - 1
  auto ring_wait = [&]() {
    cp_async_wait<kS - 2>();
    fence_proxy_async();
    __syncthreads();
  };
  auto issue_qk = [&](int u) {
    const uint32_t k_s = k_ring + (u % kS) * kTile;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
  };
  auto issue_pv = [&](int u) {
    const uint32_t v_s = v_ring + (u % kS) * kTile;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(acc, pa[kc], desc_mn_major(v_s, kc));
    }
  };
  // the last visible key of each of this thread's rows (band and kv_len)
  const int vis0 = p.masked ? min(kv_len - 1, row0 + p.offset) : kv_len - 1;
  const int vis1 = p.masked ? min(kv_len - 1, row1 + p.offset) : kv_len - 1;
  // the dropout hash's x = idx * 0x9E3779B9 + seed (flash_common.cuh) of
  // this thread's first score in row0 of key tile 0; a score i of tile u
  // adds a constant
  constexpr uint32_t kMix = 0x9E3779B9u;
  const uint32_t x00 =
      (dblk.bh * 0x85EBCA6Bu +
       static_cast<uint32_t>(row0) * p.drop.tk_p + 2 * t4) * kMix +
      p.drop.block_seed<Groups>(dblk);
  const uint32_t x10 = x00 + 8 * p.drop.tk_p * kMix;   // row1

  // P_u from S_u: the masks, the running max and the rescale factors, exp,
  // the row sums, then dropout
  auto softmax = [&](int u) {
    const int k0 = u * kRows;
    const bool edge = k0 + kRows > kv_end ||
                      (p.masked && k0 + kRows - 1 > q0 + p.offset);
    if (edge) {
      // -inf past Tk (not a key at all), -1e30 for masked keys
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int vis = (i & 2) ? vis1 : vis0;
        s[i] = col >= Tk ? -INFINITY : col > vis ? kMaskFill : s[i];
      }
    }
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    alpha0 = ex2((m0 - mn0) * kLog2e);
    alpha1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = __fmul_rn(mn0, kLog2e);
    const float ml1 = __fmul_rn(mn1, kLog2e);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(__fmul_rn(s[i], kLog2e) - ((i & 2) ? ml1 : ml0));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? ml1 : ml0)));
      }
    }
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
    // dropout after the row sums, so l keeps the undropped probabilities
    if (p.drop.on) {
      const uint32_t xt0 = x00 + static_cast<uint32_t>(k0) * kMix;
      const uint32_t xt1 = x10 + static_cast<uint32_t>(k0) * kMix;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t x = ((i & 2) ? xt1 : xt0) +
                           static_cast<uint32_t>((i / 4) * 8 + (i & 1)) * kMix;
        s[i] = p.drop.keep_mixed(x) ? s[i] * p.drop.inv_keep : 0.f;
      }
    }
  };

  if (n_tiles > 0) {
    // step 0: S_0, P_0
    ring_wait();
    load_group(0);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    p_frags(pa, s);
  }
  for (int u = 1; u < n_tiles; ++u) {
    ring_wait();
    load_group(u);
    wgmma_fence();
    issue_qk(u);
    wgmma_commit();
    issue_pv(u - 1);
    wgmma_commit();
    wgmma_wait<1>();   // S_u; P_{u-1} V_{u-1} may still run
    fence_regs(s);
    softmax(u);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
    p_frags(pa, s);
  }
  if (n_tiles > 0) {
    // O += P_{n-1} V_{n-1}
    ring_wait();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if (row0 < p.Tq) {
    store_row<D, 0>(ob + row0 * p.o_st, acc, t4, ls0);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Tq) {
    store_row<D, 2>(ob + row1 * p.o_st, acc, t4, ls1);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row1] = m1 + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// D = 192 and 256: the header
// ---------------------------------------------------------------------------

constexpr int kTallThreads = 2 * kThreads;   // two warpgroups a block
constexpr int kTallRows = 2 * kRows;         // query rows a block

// K and V tiles in flight in the tall kernel's rings: kStages at D = 192;
// at D = 256, whose tiles are 32 KB, 2 (Q's 64 KB and four tiles, 193 KB;
// the header).
template <int D>
__host__ __device__ constexpr int tall_stages() {
  return padded_dim<D>() > 192 ? 2 : kStages;
}

// Whether a warpgroup's softmax of S_u runs beside its own P_{u-1} V_{u-1}
// (D = 192); at D = 256 a thread would hold O's 128 fp32, P_{u-1} and S_u
// through the softmax, past 255 registers, so each turn's products are
// waited on before it (the header).
template <int D>
__host__ __device__ constexpr bool tall_overlap() {
  return padded_dim<D>() <= 192;
}

// Q (a tile a warpgroup), then a ring of tall_stages K tiles and one of
// tall_stages V tiles; +1 KB to align the base to the swizzle.
template <int D>
__host__ __device__ constexpr int tall_smem_bytes() {
  return (2 + 2 * tall_stages<D>()) * tile_bytes<D>() + 1024;
}

// mbarrier helpers (shared-memory addresses).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Wait until phase `parity` (0 or 1) of `bar` has completed.  A wait that
// outlasts 2^22 polls, far beyond any wait of a sound launch (a lost
// arrival), traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n == (1u << 22)) __trap();
  }
}

// Named barriers: wait for (sync) or signal (arrive) barrier `id` of
// `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One (batch*head, 128-query tile) at D = 192 and 256, two warpgroups:
// warpgroup w takes queries 64 w .. 64 w + 63 of the tile, and both read
// each K and V tile of the block's rings.  Batch*head along x, the query
// tiles along y, the last first.  Each warpgroup runs
// flash_fwd_wide_kernel's step (S_u issued beside P_{u-1} V_{u-1}) over its
// own key tiles, and the two take turns to issue their products (two named
// barriers, FlashAttention-3's ping-pong), so one's softmax runs while the
// other's products do.  At D = 192 a warpgroup's softmax of S_u also runs
// beside its own P_{u-1} V_{u-1}; at 256 it waits for both first
// (tall_overlap).  No block barrier ties them: each loads its half of the
// rows of every K and V tile, a "full" mbarrier a stage says when all the
// copies of a tile have landed (each thread's arrive when its own have),
// and an "empty" one when both warpgroups' products have read it (each
// thread arrives).  At turn u a warpgroup loads K_{u+1} into the stage
// K_{u+1-kS} held and V_u into V_{u-kS}'s (kS the rings' depth: 3 at D =
// 192, 2 at 256), so the two may drift a turn apart.  Under a causal band
// warpgroup 0 has one key tile fewer; it loads its half of the last tile
// and takes its turn there without products.
template <int D, bool Groups = false>
__global__ void __launch_bounds__(kTallThreads, 1)
flash_fwd_tall_kernel(const FlashParams p) {
  constexpr int DP = padded_dim<D>();
  constexpr int kTile = tile_bytes<D>();
  constexpr int kKSteps = DP / 16;   // k-steps of Q K^T
  constexpr int kS = tall_stages<D>();
  extern __shared__ unsigned char smem[];
  // full and empty barriers of each K and V stage, then each Q tile's
  __shared__ __align__(8) uint64_t bars[4 * kS + 2];
  const uint32_t q_base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_ring = q_base + 2 * kTile;
  const uint32_t v_ring = k_ring + kS * kTile;
  const uint32_t bar0 = smem_u32(bars);
  auto k_full = [&](int s) { return bar0 + 8 * s; };
  auto k_empty = [&](int s) { return bar0 + 8 * (kS + s); };
  auto v_full = [&](int s) { return bar0 + 8 * (2 * kS + s); };
  auto v_empty = [&](int s) { return bar0 + 8 * (3 * kS + s); };

  const int bh = blockIdx.x;
  const int qt = (gridDim.y - 1 - blockIdx.y) * kTallRows;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int Tk = p.Tk;
  const int kv_len = p.kv_lens ? p.kv_lens[b] : Tk;
  const int kv_end = min(Tk, kv_len);   // keys from here on are masked

  // key tiles that query rows [r0, r0 + 64) visit
  auto tiles_for = [&](int r0) {
    int n = (Tk + kRows - 1) / kRows;
    if (kv_len > 0) {
      n = min(n, (kv_len + kRows - 1) / kRows);
      if (p.masked) n = min(n, (r0 + kRows - 1 + p.offset) / kRows + 1);
    }
    return n;
  };
  const int n_tiles = tiles_for(qt + kRows);   // the block's: warpgroup 1's

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(k_full(s), kTallThreads);
      mbar_init(v_full(s), kTallThreads);
      mbar_init(k_empty(s), kTallThreads);
      mbar_init(v_empty(s), kTallThreads);
    }
    mbar_init(bar0 + 8 * 4 * kS, kThreads);
    mbar_init(bar0 + 8 * (4 * kS + 1), kThreads);
  }
  __syncthreads();

  // this block's dropout hash values: its seed and its index in its group
  const BlockDropout dblk = block_dropout<Groups>(p.seed_groups, bh);
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;   // thread in its warpgroup
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;     // row within the warp's 16 (and g + 8)
  const int t4 = lane % 4;    // column pair within an 8-wide block
  const int q0 = qt + wg * kRows;           // this warpgroup's query rows
  const uint32_t q_s = q_base + wg * kTile;
  const uint32_t q_full = bar0 + 8 * (4 * kS + wg);
  const int n_mine = tiles_for(q0);

  // this warpgroup's Q tile, then this thread's rows of K_0
  const TallCopier<D> k_copy(p.k + b * p.k_sb + h * p.k_sh, p.k_st,
                             threadIdx.x);
  const TallCopier<D> v_copy(p.v + b * p.v_sb + h * p.v_sh, p.v_st,
                             threadIdx.x);
  load_tile_by<D>(tid, q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_st, q0, p.Tq);
  mbar_arrive_copies(q_full);
  if (n_tiles > 0) {
    k_copy.copy(k_ring, 0, Tk);
    mbar_arrive_copies(k_full(0));
  }
  // turn u's copies: K_{u+1} into the stage of K_{u+1-kS} and V_u into
  // that of V_{u-kS}, once both warpgroups' products have read those
  auto load_turn = [&](int u) {
    const int j = u + 1;
    if (j < n_tiles) {
      if (j >= kS) mbar_wait(k_empty(j % kS), (j / kS - 1) & 1);
      k_copy.copy(k_ring + (j % kS) * kTile, j * kRows, Tk);
      mbar_arrive_copies(k_full(j % kS));
    }
    if (u < n_tiles) {
      if (u >= kS) mbar_wait(v_empty(u % kS), (u / kS - 1) & 1);
      v_copy.copy(v_ring + (u % kS) * kTile, u * kRows, Tk);
      mbar_arrive_copies(v_full(u % kS));
    }
  };

  const int row0 = q0 + warp * 16 + g;   // global query rows of this thread
  const int row1 = row0 + 8;
  float m0 = kMaskFill, m1 = kMaskFill;   // running row max
  float l0 = 0.f, l1 = 0.f;               // per-thread partial row sums
  float alpha0 = 1.f, alpha1 = 1.f;       // the last step's rescale
  float acc[DP / 2], s[32];
  uint32_t pa[4][4];                      // bf16(P) of the last step
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  auto issue_qk = [&](int u) {
    const uint32_t k_s = k_ring + (u % kS) * kTile;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss<64>(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk > 0);
    }
  };
  auto issue_pv = [&](int u) {
    const uint32_t v_s = v_ring + (u % kS) * kTile;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DP>(acc, pa[kc], desc_mn_major(v_s, kc));
    }
  };
  // the last visible key of each of this thread's rows (band and kv_len)
  const int vis0 = p.masked ? min(kv_len - 1, row0 + p.offset) : kv_len - 1;
  const int vis1 = p.masked ? min(kv_len - 1, row1 + p.offset) : kv_len - 1;
  // the dropout hash's x = idx * 0x9E3779B9 + seed (flash_common.cuh) of
  // this thread's first score in row0 of key tile 0; a score i of tile u
  // adds a constant
  constexpr uint32_t kMix = 0x9E3779B9u;
  const uint32_t x00 =
      (dblk.bh * 0x85EBCA6Bu +
       static_cast<uint32_t>(row0) * p.drop.tk_p + 2 * t4) * kMix +
      p.drop.block_seed<Groups>(dblk);
  const uint32_t x10 = x00 + 8 * p.drop.tk_p * kMix;   // row1

  // P_u from S_u: the masks, the running max and the rescale factors, exp,
  // the row sums, then dropout
  auto softmax = [&](int u) {
    const int k0 = u * kRows;
    const bool edge = k0 + kRows > kv_end ||
                      (p.masked && k0 + kRows - 1 > q0 + p.offset);
    if (edge) {
      // -inf past Tk (not a key at all), -1e30 for masked keys
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int vis = (i & 2) ? vis1 : vis0;
        s[i] = col >= Tk ? -INFINITY : col > vis ? kMaskFill : s[i];
      }
    }
    float mx0 = kMaskFill, mx1 = kMaskFill;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the 4 threads of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    alpha0 = ex2((m0 - mn0) * kLog2e);
    alpha1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = __fmul_rn(mn0, kLog2e);
    const float ml1 = __fmul_rn(mn1, kLog2e);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(__fmul_rn(s[i], kLog2e) - ((i & 2) ? ml1 : ml0));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(fmaf(s[i], kLog2e, -((i & 2) ? ml1 : ml0)));
      }
    }
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
    // dropout after the row sums, so l keeps the undropped probabilities
    if (p.drop.on) {
      const uint32_t xt0 = x00 + static_cast<uint32_t>(k0) * kMix;
      const uint32_t xt1 = x10 + static_cast<uint32_t>(k0) * kMix;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t x = ((i & 2) ? xt1 : xt0) +
                           static_cast<uint32_t>((i / 4) * 8 + (i & 1)) * kMix;
        s[i] = p.drop.keep_mixed(x) ? s[i] * p.drop.inv_keep : 0.f;
      }
    }
  };

  // turn u (0 .. n_tiles): S_u (u < n_mine) beside P_{u-1} V_{u-1}
  // (0 < u <= n_mine), issued once the other warpgroup has issued its turn
  // u - 1 (warpgroup 0) or u (warpgroup 1).  Warpgroup 1 lets warpgroup 0
  // take turn 0 and does not hand on its last turn, so every arrival at a
  // turn barrier is waited on.  Each kind of turn issues and waits for its
  // products in one branch (ptxas serialises wgmma issued on divergent
  // paths).
  auto my_turn = [&]() { named_sync(1 + wg, kTallThreads); };
  auto hand_on = [&]() { named_arrive(2 - wg, kTallThreads); };
  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    if (wg == 1) hand_on();
    load_turn(0);
    if (n_mine > 0) {
      // turn 0: S_0, P_0
      mbar_wait(k_full(0), 0);
      fence_proxy_async();
      my_turn();
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      hand_on();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(0));
      softmax(0);
      p_frags(pa, s);
    } else {
      my_turn();
      hand_on();
    }
    for (int u = 1; u < n_tiles; ++u) {
      load_turn(u);
      if (u < n_mine) {
        mbar_wait(k_full(u % kS), (u / kS) & 1);
        mbar_wait(v_full((u - 1) % kS), ((u - 1) / kS) & 1);
        fence_proxy_async();
        my_turn();
        wgmma_fence();
        if constexpr (tall_overlap<D>()) {
          issue_qk(u);
          wgmma_commit();
          issue_pv(u - 1);
          wgmma_commit();
          hand_on();
          wgmma_wait<1>();   // S_u; P_{u-1} V_{u-1} may still run
          fence_regs(s);
          mbar_arrive(k_empty(u % kS));
          softmax(u);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_frags(pa);
          mbar_arrive(v_empty((u - 1) % kS));
        } else {
          issue_qk(u);
          wgmma_commit();
          issue_pv(u - 1);
          wgmma_commit();
          hand_on();
          wgmma_wait<0>();   // S_u and P_{u-1} V_{u-1}
          fence_regs(s);
          fence_regs(acc);
          fence_frags(pa);
          mbar_arrive(k_empty(u % kS));
          mbar_arrive(v_empty((u - 1) % kS));
          softmax(u);
        }
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
        p_frags(pa, s);
      } else if (u == n_mine) {
        // this warpgroup's last product: O += P_{u-1} V_{u-1}
        mbar_wait(v_full((u - 1) % kS), ((u - 1) / kS) & 1);
        fence_proxy_async();
        my_turn();
        wgmma_fence();
        issue_pv(u - 1);
        wgmma_commit();
        hand_on();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(v_empty((u - 1) % kS));
      } else {
        my_turn();
        hand_on();
      }
    }
    // turn n_tiles: O += P_{n-1} V_{n-1} where n_mine is n_tiles
    if (n_mine == n_tiles) {
      const int u = n_tiles;
      mbar_wait(v_full((u - 1) % kS), ((u - 1) / kS) & 1);
      fence_proxy_async();
      my_turn();
      wgmma_fence();
      issue_pv(u - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      my_turn();
    }
    if (wg == 0) hand_on();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
  if (row0 < p.Tq) {
    store_row<D, 0>(ob + row0 * p.o_st, acc, t4, ls0);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Tq) {
    store_row<D, 2>(ob + row1 * p.o_st, acc, t4, ls1);
    if (t4 == 0) p.lse[(long long)bh * p.Tq + row1] = m1 + logf(ls1);
  }
}

template <int D, bool Groups>
cudaError_t launch(const FlashParams& p, cudaStream_t s) {
  static bool smem_set = false;
  const int nq = (p.Tq + kRows - 1) / kRows;
  if constexpr (padded_dim<D>() >= 192) {
    constexpr int bytes = tall_smem_bytes<D>();
    cudaError_t err =
        allow_smem(flash_fwd_tall_kernel<D, Groups>, bytes, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H, (p.Tq + kTallRows - 1) / kTallRows);
    flash_fwd_tall_kernel<D, Groups><<<grid, kTallThreads, bytes, s>>>(p);
  } else if constexpr (runs_wide<D>()) {
    constexpr int bytes = wide_smem_bytes<D>();
    cudaError_t err =
        allow_smem(flash_fwd_wide_kernel<D, Groups>, bytes, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H, nq);
    flash_fwd_wide_kernel<D, Groups><<<grid, kThreads, bytes, s>>>(p);
  } else if constexpr (padded_dim<D>() == 32) {
    constexpr int bytes = narrow_smem_bytes<D>();
    cudaError_t err =
        allow_smem(flash_fwd_narrow_kernel<D, Groups>, bytes, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.H, nq);
    flash_fwd_narrow_kernel<D, Groups><<<grid, kThreads, bytes, s>>>(p);
  } else {
    constexpr int bytes = smem_bytes<D>();
    cudaError_t err =
        allow_smem(flash_fwd_kernel<D, Groups>, bytes, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(nq, p.B * p.H);
    flash_fwd_kernel<D, Groups><<<grid, kThreads, bytes, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a head_dim
// without an instantiation, or for seed groups or a placement that do not
// fit.  dropout != 0 applies the keep mask of (seeds, threshold, tk_p) and
// scales kept probabilities by inv_keep; seeds holds `groups` seeds, one
// per group of B*H / groups consecutive (batch, head) blocks; (b_off,
// h_off, heads_g, group_stride) places the blocks in a global call
// (set_dropout; 0, 0, H, 0 unplaced).
int bpx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* kv_lens, int B, int H, int Tq, int Tk,
                  int D, long long q_sb, long long q_sh, long long q_st,
                  long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st,
                  long long o_sb, long long o_sh, long long o_st, int masked,
                  int offset, int dropout, const unsigned int* seeds,
                  int groups, unsigned int threshold, float inv_keep,
                  int tk_p, int b_off, int h_off, int heads_g,
                  int group_stride, void* stream) {
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
  if (!set_dropout(p.drop, p.seed_groups, dropout, seeds, groups, B * H, H,
                   threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                   group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bpx_flash::with_head_dim(
      D, [&](auto d) {
        constexpr int kD = decltype(d)::value;
        return p.seed_groups.grouped() ? launch<kD, true>(p, s)
                                 : launch<kD, false>(p, s);
      }));
}

// Blocks of the forward kernel at head_dim D that one SM holds, into
// *blocks.  Returns a cudaError_t, as bpx_flash_fwd.
int bpx_flash_fwd_blocks_per_sm(int D, int* blocks) {
  return static_cast<int>(bpx_flash::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (padded_dim<kD>() >= 192) {
      return bpx_flash::blocks_per_sm(flash_fwd_tall_kernel<kD>,
                                      tall_smem_bytes<kD>(), blocks,
                                      kTallThreads);
    } else if constexpr (runs_wide<kD>()) {
      return bpx_flash::blocks_per_sm(flash_fwd_wide_kernel<kD>,
                                      wide_smem_bytes<kD>(), blocks);
    } else if constexpr (padded_dim<kD>() == 32) {
      return bpx_flash::blocks_per_sm(flash_fwd_narrow_kernel<kD>,
                                      narrow_smem_bytes<kD>(), blocks);
    } else {
      return bpx_flash::blocks_per_sm(flash_fwd_kernel<kD>,
                                      smem_bytes<kD>(), blocks);
    }
  }));
}

const char* bpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
