// Flash attention at any head dim from 1 to 256 in fp32 for Hopper
// (sm_90a): the forward, the backward's dQ kernel (which computes delta) and
// its dependent dK/dV kernel, and delta on its own.
//
// Replaces, where the tabled kernels of flash_fwd.cu and flash_bwd.cu and
// their panel builds (bf16 at every head dim up to 256) do not reach (fp32
// at every head dim), the TPU kernels of bpx/ops/pallas_attention.py:
//   * :145 _fwd_kernel (from _fwd, :250), its single-pass and its online
//     branch, with the in-kernel dropout of :102 _keep_mask;
//   * :276 _bwd_dq_kernel (:576) and :357 _bwd_dkv_kernel (:604), and :462
//     _bwd_fused_kernel (:623), which computes the same function in one
//     pass; the delta they take (rowsum(dO * O), in-kernel with
//     BPX_XLA_DELTA=0) is computed here by the dQ kernel.
// The Pallas kernels take any raw head dim and keep their operands in the
// input dtype, so --compute_dtype float32 --attention_impl pallas runs them
// in fp32; these kernels take that domain in fp32 (bf16 up to 256 runs
// the panel builds, on the tensor cores, and with_dtype takes fp32 alone).
//
// The function (flash_fwd.cu and flash_bwd.cu state it in full; the plain
// versions are bpx_torch/ops/flash_attention.py:200-258), per (batch*head):
//   s  = q . k^T in fp32 (q pre-scaled), -1e30 where col >= kv_len[b] or
//        (masked and col > row + offset); a key past Tk does not exist
//   p  = exp(s - m), l = sum p over the undropped p, m the row max
//   o  = T(keep ? p * inv_keep : 0) . v / l,  lse = m + log(l)
//   backward: p = visible ? exp(s - lse) : 0, dp = dO . v^T (kept and
//   scaled as p), dv = T(p_dropped)^T . dO, ds = T(p * (dp - delta)),
//   dk = ds^T . q, dq = ds . k, delta = rowsum(dO * O) in fp32.
// A row with no visible key attends uniformly over all Tk keys in the
// forward (m = -1e30, every p = 1) and gets zero gradients in the backward;
// no tile is skipped, so nothing breaks that.
//
// Design.  SIMT: fp32 FFMA on the CUDA cores, one 128-thread block per
// (batch*head, tile).  The tiles of Q, K, V (or Q, dO, K, V) sit in shared
// memory as fp32 rows of W + 1 floats, W the head dim rounded up to 32, 64, 128
// or 256 (the build's width; the head dim itself is a runtime argument), the
// columns from D to W and the rows past T zeroed there, so nothing is padded in
// device memory.  Every load is an element load at the tensor's strides (the
// last dim contiguous), so a fused projection's (B, H, T, D) views at any D go
// in without a copy.  The odd row stride puts the 16 rows a half-warp reads at
// one column in 16 distinct banks.  The 128 threads are 8 row groups of 16
// lanes: a thread owns 8 rows (ty + 8 i) and the score columns tx + 16 j of
// each key tile, so a row's softmax statistics reduce over one half-warp's
// shuffles, and the output columns tx + 16 j of its rows, accumulated in
// registers over the key (or query) tiles.  The scores of a tile go through
// shared memory between the two products.
//
// No TF32: it keeps about three decimal digits, and fp32 here is held to the
// plain fp32 version.  No atomics: every output element is written by one
// thread of one block, so reruns are bitwise equal.  The dK/dV kernel is a
// programmatic dependent launch after the dQ kernel (as in flash_bwd.cu): it
// stages its K and V tiles, then waits for the dQ grid before it reads
// delta.
//
// What bounds it on this card: the FFMA rate (67 TFLOP/s fp32 outside the
// tensor cores) and, before that, shared-memory reads (one to two loads per
// two to four FMAs).  At the model's shapes it does 4 D flops per visible
// score in the forward and 10 D in the backward against a tensor-core bound
// of 989 TFLOP/s in bf16 and 165 TFLOP/s (three TF32 passes at 495) in fp32,
// so it sits far below both: a first, simple port.  Putting fp32 on the
// tensor cores (three TF32 passes) is the redesign ROADMAP.md queues.
//
// BPX_PLANT_GENERIC_FAULT builds the faults chip_smoke.py must catch, a bit
// per kernel: 1, the forward's row sum leaves out each key tile's first
// key; 2, the dQ kernel leaves delta out of dS; 4, the dK/dV kernel does.
#include "flash_simt.cuh"

#ifndef BPX_PLANT_GENERIC_FAULT
#define BPX_PLANT_GENERIC_FAULT 0
#endif

namespace {

using namespace bpx_flash;

constexpr int kGenThreads = 128;   // 8 row groups x 16 lanes
constexpr int kRowsPerThread = 8;
constexpr int kQTile = 64;         // query rows of the forward's, dQ's tile
constexpr int kMaxHeadDim = 256;

// Rows of the key tiles, and of the dK/dV kernel's query tiles, at width
// W: 32 at the wide builds, so that shared memory holds two or three
// blocks an SM where it can.
template <int W>
__host__ __device__ constexpr int tile_rows() {
  return W >= 128 ? 32 : 64;
}

struct GenericParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward
  const void* o;      // backward: O, for the dQ kernel's delta
  void* out;          // forward O
  float* lse;         // (B*H, Tq): the forward writes it, the backward reads
  float* delta;       // (B*H, Tq): the dQ kernel writes it, dK/dV reads
  const int* kv_lens;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int masked, offset;
  Dropout drop;
  SeedGroups seed_groups;
};

// rows [t0, t0 + rows) of one head into a (rows, W + 1) fp32 tile: columns
// past D and rows past `len` zero (a stale value could be a NaN, and 0 *
// NaN is not 0)
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int rows, int t0,
                                          int len, int D) {
  for (int idx = threadIdx.x; idx < rows * W; idx += kGenThreads) {
    const int r = idx / W;
    const int c = idx % W;
    float x = 0.0f;
    if (c < D && t0 + r < len) x = widen(src[(t0 + r) * st + c]);
    dst[r * (W + 1) + c] = x;
  }
}

__device__ __forceinline__ bool visible(const GenericParams& p, int row,
                                        int col, int kv_len) {
  return col < kv_len && (!p.masked || col <= row + p.offset);
}

template <int W>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return ((kQTile + 2 * tile_rows<W>()) * (W + 1) +
          kQTile * (tile_rows<W>() + 1)) * 4;
}

template <int W>
__host__ __device__ constexpr int dq_smem_bytes() {
  return ((2 * kQTile + 2 * tile_rows<W>()) * (W + 1) +
          kQTile * (tile_rows<W>() + 1) + kQTile) * 4;
}

template <int W>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  // K, V, Q and dO tiles; P^T and dS^T; lse and delta
  constexpr int R = tile_rows<W>();
  return (4 * R * (W + 1) + 2 * R * (R + 1) + 2 * R) * 4;
}

// One (batch*head, 64-query tile): O and lse, over the key tiles with the
// online softmax.
template <typename T, int W, bool Groups>
__global__ void __launch_bounds__(kGenThreads)
    flash_generic_fwd_kernel(const GenericParams p) {
  constexpr int BK = tile_rows<W>();
  constexpr int KJ = BK / kGroupLanes;   // score columns a thread owns
  constexpr int NJ = W / kGroupLanes;    // output columns a thread owns
  constexpr int SW = W + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kQTile * SW;
  float* Vs = Ks + BK * SW;
  float* Ps = Vs + BK * SW;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kQTile;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int D = p.D;
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);

  load_tile<T, W>(Qs, q, p.sq.t, kQTile, q0, p.Tq, D);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += BK) {
    __syncthreads();   // the tile before is read
    load_tile<T, W>(Ks, k, p.sk.t, BK, k0, p.Tk, D);
    load_tile<T, W>(Vs, v, p.sv.t, BK, k0, p.Tk, D);
    __syncthreads();

    float s[kRowsPerThread][KJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRowsPerThread], kb[KJ];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = Qs[(ty + 8 * i) * SW + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kb[j] = Ks[(tx + kGroupLanes * j) * SW + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + 8 * i;
      const int row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int col = k0 + tx + kGroupLanes * j;
        if (col >= p.Tk) {
          s[i][j] = -INFINITY;   // no such key: p = 0, not counted in l
        } else if (!visible(p, row, col, kv_len)) {
          s[i][j] = kMaskFill;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int col = k0 + tx + kGroupLanes * j;
        const float e = expf(s[i][j] - m_new);
#if BPX_PLANT_GENERIC_FAULT & 1
        if (!(tx == 0 && j == 0)) sum += e;
#else
        sum += e;
#endif
        float pd = e;
        if (p.drop.on)
          pd = p.drop.keep<Groups>(blk, row, col) ? e * p.drop.inv_keep
                                                  : 0.0f;
        Ps[r * PS + tx + kGroupLanes * j] = round_to<T>(pd);
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = Ps[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (kGroupLanes * j < D) {
          const float vv = Vs[c * SW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= p.Tq) continue;
    const float ls = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < D) o[row * p.so.t + d] = narrow<T>(acc[i][j] / ls);
    }
    if (tx == 0) p.lse[static_cast<long long>(bh) * p.Tq + row] =
        m[i] + logf(ls);
  }
}

// One (batch*head, 64-query tile) of the backward: delta for its rows
// (written for the dK/dV kernel), then dQ over the key tiles.
template <typename T, int W, bool Groups>
__global__ void __launch_bounds__(kGenThreads)
    flash_generic_dq_kernel(const GenericParams p) {
  constexpr int BK = tile_rows<W>();
  constexpr int KJ = BK / kGroupLanes;
  constexpr int NJ = W / kGroupLanes;
  constexpr int SW = W + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kQTile * SW;
  float* Ks = dOs + kQTile * SW;
  float* Vs = Ks + BK * SW;
  float* dSs = Vs + BK * SW;
  float* dls = dSs + kQTile * PS;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kQTile;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = p.D;
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const T* dout = head_of<T>(p.dout, p.sdo, b, h);
  const T* o = head_of<T>(p.o, p.so, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);
  const long long row0 = static_cast<long long>(bh) * p.Tq;

  load_tile<T, W>(Qs, q, p.sq.t, kQTile, q0, p.Tq, D);
  load_tile<T, W>(dOs, dout, p.sdo.t, kQTile, q0, p.Tq, D);
  __syncthreads();
  // delta = rowsum(dO * O) in fp32: a warp a row, its lanes over the columns
  for (int r = warp; r < kQTile; r += kGenThreads / 32) {
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < p.Tq)
      for (int d = lane; d < D; d += 32)
        sum = fmaf(dOs[r * SW + d], widen(o[row * p.so.t + d]), sum);
    sum = warp_sum(sum);
    if (lane == 0) {
      dls[r] = sum;
      if (row < p.Tq) p.delta[row0 + row] = sum;
    }
  }
  __syncthreads();
  // the dK/dV grid may start; it waits for this grid before reading delta
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float lse[kRowsPerThread], dl[kRowsPerThread], acc[kRowsPerThread][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    lse[i] = row < p.Tq ? p.lse[row0 + row] : 0.0f;
#if BPX_PLANT_GENERIC_FAULT & 2
    dl[i] = 0.0f;
#else
    dl[i] = dls[ty + 8 * i];
#endif
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += BK) {
    __syncthreads();
    load_tile<T, W>(Ks, k, p.sk.t, BK, k0, p.Tk, D);
    load_tile<T, W>(Vs, v, p.sv.t, BK, k0, p.Tk, D);
    __syncthreads();

    float s[kRowsPerThread][KJ], dp[kRowsPerThread][KJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[kRowsPerThread], g[kRowsPerThread], kb[KJ], vb[KJ];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        a[i] = Qs[(ty + 8 * i) * SW + d];
        g[i] = dOs[(ty + 8 * i) * SW + d];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kb[j] = Ks[(tx + kGroupLanes * j) * SW + d];
        vb[j] = Vs[(tx + kGroupLanes * j) * SW + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + 8 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int col = k0 + tx + kGroupLanes * j;
        const bool vis = col < p.Tk && visible(p, row, col, kv_len);
        const float pr = vis ? expf(s[i][j] - lse[i]) : 0.0f;
        float dpv = dp[i][j];
        if (p.drop.on)
          dpv = p.drop.keep<Groups>(blk, row, col) ? dpv * p.drop.inv_keep
                                                   : 0.0f;
        dSs[r * PS + tx + kGroupLanes * j] = round_to<T>(pr * (dpv - dl[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        dsv[i] = dSs[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (kGroupLanes * j < D) {
          const float kk = Ks[c * SW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < D) dq[row * p.sdq.t + d] = narrow<T>(acc[i][j]);
    }
  }
}

// One (batch*head, key tile) of the backward: dK and dV over the query
// tiles, after the dQ kernel's delta.  A thread owns keys ty + 8 i and, of
// each query tile's scores, the queries tx + 16 j.
template <typename T, int W, bool Groups>
__global__ void __launch_bounds__(kGenThreads)
    flash_generic_dkdv_kernel(const GenericParams p) {
  constexpr int BK = tile_rows<W>();
  constexpr int BQ = tile_rows<W>();
  constexpr int KI = BK / 8;             // keys a thread owns
  constexpr int QJ = BQ / kGroupLanes;   // score columns (queries) it owns
  constexpr int NJ = W / kGroupLanes;
  constexpr int SW = W + 1;
  constexpr int QS = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * SW;
  float* Qs = Vs + BK * SW;
  float* dOs = Qs + BQ * SW;
  float* Pts = dOs + BQ * SW;
  float* dSts = Pts + BK * QS;
  float* lses = dSts + BK * QS;
  float* dls = lses + BQ;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int D = p.D;
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const T* dout = head_of<T>(p.dout, p.sdo, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);
  const long long row0 = static_cast<long long>(bh) * p.Tq;

  load_tile<T, W>(Ks, k, p.sk.t, BK, k0, p.Tk, D);
  load_tile<T, W>(Vs, v, p.sv.t, BK, k0, p.Tk, D);
  // delta: written by the dQ kernel, which this launch may overlap
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  float dk[KI][NJ], dv[KI][NJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
    __syncthreads();
    load_tile<T, W>(Qs, q, p.sq.t, BQ, q0, p.Tq, D);
    load_tile<T, W>(dOs, dout, p.sdo.t, BQ, q0, p.Tq, D);
    for (int r = threadIdx.x; r < BQ; r += kGenThreads) {
      const bool in = q0 + r < p.Tq;
      lses[r] = in ? p.lse[row0 + q0 + r] : 0.0f;
#if BPX_PLANT_GENERIC_FAULT & 4
      dls[r] = 0.0f;
#else
      dls[r] = in ? p.delta[row0 + q0 + r] : 0.0f;
#endif
    }
    __syncthreads();

    float s[KI][QJ], dp[KI][QJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kk[KI], vv[KI], qq[QJ], gg[QJ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kk[i] = Ks[(ty + 8 * i) * SW + d];
        vv[i] = Vs[(ty + 8 * i) * SW + d];
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        qq[j] = Qs[(tx + kGroupLanes * j) * SW + d];
        gg[j] = dOs[(tx + kGroupLanes * j) * SW + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int c = ty + 8 * i;
      const int col = k0 + c;
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int r = tx + kGroupLanes * j;
        const int row = q0 + r;
        const bool vis = row < p.Tq && col < p.Tk &&
                         visible(p, row, col, kv_len);
        const float pr = vis ? expf(s[i][j] - lses[r]) : 0.0f;
        float pd = pr, dpv = dp[i][j];
        if (p.drop.on) {
          const bool kept = p.drop.keep<Groups>(blk, row, col);
          pd = kept ? pr * p.drop.inv_keep : 0.0f;
          dpv = kept ? dpv * p.drop.inv_keep : 0.0f;
        }
        Pts[c * QS + r] = round_to<T>(pd);
        dSts[c * QS + r] = round_to<T>(pr * (dpv - dls[r]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = Pts[(ty + 8 * i) * QS + r];
        dsv[i] = dSts[(ty + 8 * i) * QS + r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (kGroupLanes * j < D) {
          const float g = dOs[r * SW + tx + kGroupLanes * j];
          const float qv = Qs[r * SW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            dv[i][j] = fmaf(pv[i], g, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int col = k0 + ty + 8 * i;
    if (col >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < D) {
        dkp[col * p.sdk.t + d] = narrow<T>(dk[i][j]);
        dvp[col * p.sdv.t + d] = narrow<T>(dv[i][j]);
      }
    }
  }
}

// delta[bh, t] = sum_d dO[b, h, t, d] * O[b, h, t, d] in fp32, a warp a row,
// into a contiguous (B*H, T) buffer.
template <typename T>
__global__ void __launch_bounds__(kGenThreads)
    flash_generic_delta_kernel(const T* o, const T* dout, float* delta,
                               int H, int T_len, int D, int rows, Strides so,
                               Strides sdo) {
  const int row = blockIdx.x * (kGenThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / T_len, t = row % T_len;
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * so.b + h * so.h + t * so.t;
  const T* drow = dout + b * sdo.b + h * sdo.h + t * sdo.t;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32)
    sum = fmaf(widen(drow[d]), widen(orow[d]), sum);
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

// f(std::integral_constant<int, W>()) for the build whose width W holds D
template <typename F>
cudaError_t with_width(int D, F&& f) {
  if (D < 1 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

template <typename T, int W, bool Groups>
cudaError_t launch_fwd(const GenericParams& p, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_generic_fwd_kernel<T, W, Groups>;
  cudaError_t err = allow_smem(kernel, fwd_smem_bytes<W>(), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + kQTile - 1) / kQTile);
  kernel<<<grid, kGenThreads, fwd_smem_bytes<W>(), s>>>(p);
  return cudaGetLastError();
}

// The dQ kernel (with delta) on a (batch*head, query tiles) grid, then the
// dK/dV kernel on a (batch*head, key tiles) grid as its programmatic
// dependent.
template <typename T, int W, bool Groups>
cudaError_t launch_bwd(const GenericParams& p, cudaStream_t s) {
  static bool dq_set = false, dkdv_set = false;
  auto dq = flash_generic_dq_kernel<T, W, Groups>;
  auto dkdv = flash_generic_dkdv_kernel<T, W, Groups>;
  cudaError_t err = allow_smem(dq, dq_smem_bytes<W>(), dq_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv, dkdv_smem_bytes<W>(), dkdv_set);
  if (err != cudaSuccess) return err;
  const int bh = p.B * p.H;
  dq<<<dim3(bh, (p.Tq + kQTile - 1) / kQTile), kGenThreads,
       dq_smem_bytes<W>(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh, (p.Tk + tile_rows<W>() - 1) / tile_rows<W>());
  cfg.blockDim = dim3(kGenThreads);
  cfg.dynamicSmemBytes = dkdv_smem_bytes<W>();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkdv, p);
}

bool set_common(GenericParams& p, int B, int H, int Tq, int Tk, int D,
                const void* kv_lens, int masked, int offset, int dropout,
                const unsigned int* seeds, int groups, unsigned int threshold,
                float inv_keep, int tk_p, int b_off, int h_off, int heads_g,
                int group_stride) {
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.masked = masked;
  p.offset = offset;
  return set_dropout(p.drop, p.seed_groups, dropout, seeds, groups, B * H, H,
                     threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                     group_stride);
}

}  // namespace

extern "C" {

// As bpx_flash_fwd (flash_fwd.cu), at any head_dim D from 1 to 256 and with
// dtype 1 (fp32) for q, k, v and o.  Returns a cudaError_t;
// cudaErrorInvalidValue for a D or dtype outside that, or for seed groups
// or a placement that do not fit.
int bpx_flash_generic_fwd(const void* q, const void* k, const void* v,
                          void* o, void* lse, const void* kv_lens, int B,
                          int H, int Tq, int Tk, int D, int dtype,
                          long long q_sb, long long q_sh, long long q_st,
                          long long k_sb, long long k_sh, long long k_st,
                          long long v_sb, long long v_sh, long long v_st,
                          long long o_sb, long long o_sh, long long o_st,
                          int masked, int offset, int dropout,
                          const unsigned int* seeds, int groups,
                          unsigned int threshold, float inv_keep, int tk_p,
                          int b_off, int h_off, int heads_g, int group_stride,
                          void* stream) {
  GenericParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  if (!set_common(p, B, H, Tq, Tk, D, kv_lens, masked, offset, dropout, seeds,
                  groups, threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                  group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_dtype<false>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_width(D, [&](auto w) {
      constexpr int W = decltype(w)::value;
      return p.seed_groups.grouped() ? launch_fwd<T, W, true>(p, s)
                                     : launch_fwd<T, W, false>(p, s);
    });
  }));
}

// As bpx_flash_bwd (flash_bwd.cu), at any head_dim D from 1 to 256 and with
// dtype 1 (fp32) for q, k, v, dO, o, dq, dk and dv: the dQ
// kernel (with delta, into the (B*H, Tq) workspace `delta`), then the dK/dV
// kernel as its dependent launch.  Returns a cudaError_t, as
// bpx_flash_generic_fwd.
int bpx_flash_generic_bwd(const void* q, const void* k, const void* v,
                          const void* dout, const void* o, const void* lse,
                          void* delta, const void* kv_lens, void* dq,
                          void* dk, void* dv, int B, int H, int Tq, int Tk,
                          int D, int dtype, long long q_sb, long long q_sh,
                          long long q_st, long long k_sb, long long k_sh,
                          long long k_st, long long v_sb, long long v_sh,
                          long long v_st, long long do_sb, long long do_sh,
                          long long do_st, long long o_sb, long long o_sh,
                          long long o_st, long long dq_sb, long long dq_sh,
                          long long dq_st, long long dk_sb, long long dk_sh,
                          long long dk_st, long long dv_sb, long long dv_sh,
                          long long dv_st, int masked, int offset,
                          int dropout, const unsigned int* seeds, int groups,
                          unsigned int threshold, float inv_keep, int tk_p,
                          int b_off, int h_off, int heads_g, int group_stride,
                          void* stream) {
  GenericParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.o = o;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.sdo = {do_sb, do_sh, do_st};
  p.so = {o_sb, o_sh, o_st};
  p.sdq = {dq_sb, dq_sh, dq_st};
  p.sdk = {dk_sb, dk_sh, dk_st};
  p.sdv = {dv_sb, dv_sh, dv_st};
  if (!set_common(p, B, H, Tq, Tk, D, kv_lens, masked, offset, dropout, seeds,
                  groups, threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                  group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_dtype<false>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_width(D, [&](auto w) {
      constexpr int W = decltype(w)::value;
      return p.seed_groups.grouped() ? launch_bwd<T, W, true>(p, s)
                                     : launch_bwd<T, W, false>(p, s);
    });
  }));
}

// delta = rowsum(dO * O) in fp32 into a contiguous (B*H, T) buffer, at any
// head_dim D from 1 to 256 and dtype 1 (fp32).
int bpx_flash_generic_delta(const void* o, const void* dout, void* delta,
                            int B, int H, int T, int D, int dtype,
                            long long o_sb, long long o_sh, long long o_st,
                            long long do_sb, long long do_sh, long long do_st,
                            void* stream) {
  if (D < 1 || D > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * H * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kGenThreads / 32;
  return static_cast<int>(with_dtype<false>(dtype, [&](auto t) {
    using E = typename decltype(t)::type;
    flash_generic_delta_kernel<E>
        <<<(rows + per_block - 1) / per_block, kGenThreads, 0, s>>>(
            static_cast<const E*>(o), static_cast<const E*>(dout),
            static_cast<float*>(delta), H, T, D, rows,
            Strides{o_sb, o_sh, o_st}, Strides{do_sb, do_sh, do_st});
    return cudaGetLastError();
  }));
}

// Blocks of the generic forward (kernel 0), dK/dV (1) or dQ kernel (2) at
// head_dim D and dtype 1 (fp32) that one SM holds, into *blocks.  Returns
// a cudaError_t.
int bpx_flash_generic_blocks_per_sm(int D, int dtype, int kernel,
                                    int* blocks) {
  return static_cast<int>(with_dtype<false>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_width(D, [&](auto w) {
      constexpr int W = decltype(w)::value;
      if (kernel == 0)
        return bpx_flash::blocks_per_sm(flash_generic_fwd_kernel<T, W, false>,
                                        fwd_smem_bytes<W>(), blocks,
                                        kGenThreads);
      if (kernel == 1)
        return bpx_flash::blocks_per_sm(
            flash_generic_dkdv_kernel<T, W, false>, dkdv_smem_bytes<W>(),
            blocks, kGenThreads);
      if (kernel == 2)
        return bpx_flash::blocks_per_sm(flash_generic_dq_kernel<T, W, false>,
                                        dq_smem_bytes<W>(), blocks,
                                        kGenThreads);
      return cudaErrorInvalidValue;
    });
  }));
}

}  // extern "C"
