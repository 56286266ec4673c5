// Flash attention at any head dim above 256, in bf16 and in fp32, for Hopper
// (sm_90a): the forward, the backward's dQ kernel (which computes delta) and
// its dependent dK/dV kernel, and delta on its own.
//
// Replaces, where the tabled kernels (flash_fwd.cu, flash_bwd.cu) and the
// generic ones (flash_generic.cu, head dims 1 to 256) do not reach, the TPU
// kernels of bpx/ops/pallas_attention.py:
//   * :145 _fwd_kernel (from _fwd, :250), its single-pass and its online
//     branch, with the in-kernel dropout of :102 _keep_mask;
//   * :276 _bwd_dq_kernel (:604) and :357 _bwd_dkv_kernel (:623), and :462
//     _bwd_fused_kernel (:576), which computes the same function in one
//     pass; the delta they take (rowsum(dO * O)) is computed here by the dQ
//     kernel.
// The Pallas kernels take any raw head dim (pallas_attention.py:46-48: D is
// not padded in HBM, Mosaic pads the VMEM tiles); these kernels take every D
// the generic ones do not, with no upper limit.  The function is the one
// flash_generic.cu states, per (batch*head), with the same masking, dropout
// hash, rounding of P and dS to the input dtype, and treatment of a row with
// no visible key.
//
// Why a kernel of its own.  The generic kernels hold a whole row of the head
// dim: a thread's output accumulator (acc[8][W / 16]) and fp32 tiles of W + 1
// floats a row.  At W 512 the accumulator alone is 256 registers a thread
// (the limit is 255) and the forward's tiles 270 KB (the limit 227 KB).
//
// Design.  The head dim is split into chunks of kChunk = 128 columns, the
// last one partial; the grid gains the chunk index.  A block owns one
// (batch*head, query tile, output chunk) in the forward and the dQ kernel,
// one (batch*head, key tile, output chunk) in the dK/dV kernel.  It builds
// its scores over the whole D, S = sum_c Q_c K_c^T (and in the backward dP =
// sum_c dO_c V_c^T), by streaming the chunks of Q and K (dO and V) through
// shared memory, then computes only its own columns: O_c = P~ V_c, dQ_c = dS
// K_c, dV_c = P~^T dO_c, dK_c = dS^T Q_c.  So the score products run once a
// chunk: for n = ceil(D / 128) chunks the forward does 2 D (n + 1) flops per
// score against the function's 4 D, (n + 1) / 2 times the work (2 at D 300
// and 384, 6.5 at 1536), and the backward (4 n + 6) D against 10 D (1.8 at
// n 3).  The chunk blocks of a tile agree bit for bit: each sums the same
// chunks in the same order with the same code, so its scores, row max m,
// row sum l and (backward) P and dS are those of every other chunk block;
// the chunk-0 block writes lse; delta is the full-D rowsum(dO * O), which
// every chunk block of the dQ kernel computes for itself from device memory
// (the same sum in the same order) and the chunk-0 block writes for the
// dK/dV kernel, which reads it after it waits for the dQ grid; the dropout
// mask is a function of (group, batch*head, row, col) alone, so every chunk
// block draws the same bits.
//
// Why 128 columns: at kChunk 128 a thread's output accumulator is 64
// registers (8 rows x 8 columns) and the shared tiles of 129 floats a row
// hold three forward blocks an SM (73 KB: Q 64 rows, K and V 32, P), two dQ
// blocks (105 KB: Q and dO 64 rows, K and V 32, dS) and three dK/dV blocks
// (73 KB: K, V, Q and dO 32 rows, P^T and dS^T); at 256 the accumulator
// would be 128 registers and each kernel one block an SM (137, 201 and
// 137 KB), with more columns wasted in a partial last chunk (D 300: 384
// columns at 128, 512 at 256).  The odd row stride of 129 floats puts the
// 16 rows a half-warp reads at one column in 16 distinct banks.
//
// Threads, tiles and loads are the generic kernels' at their width 128:
// SIMT fp32 FFMA, 128 threads as 8 row groups of 16 lanes; bf16 widened to
// fp32 as it is loaded (exact); element loads at the tensors' strides (last
// dim contiguous), so a fused projection's (B, H, T, D) views go in without
// a copy; no TF32 and no atomics, so reruns are bitwise equal.  The dK/dV
// kernel is a programmatic dependent launch after the dQ kernel.
//
// What bounds it on this card: the FFMA rate (67 TFLOP/s fp32 outside the
// tensor cores) and shared-memory reads, far below the tensor-core bound of
// 989 TFLOP/s in bf16 and 165 TFLOP/s (three TF32 passes) in fp32, and the
// recomputed scores on top: a first, simple port, which ROADMAP.md queues
// for the redesign of the generic kernels.
//
// BPX_PLANT_CHUNKED_FAULT builds the faults chip_smoke.py must catch, a bit
// per kernel: 1, the forward's scores leave out chunk 1's columns; 2, the dQ
// kernel's delta leaves out the last chunk's columns; 4, the dK/dV kernel's
// scores leave out chunk 1's columns.  Each shows in an output the other
// two do not touch: O, dQ and dV.
#include "flash_simt.cuh"

#ifndef BPX_PLANT_CHUNKED_FAULT
#define BPX_PLANT_CHUNKED_FAULT 0
#endif

namespace {

using namespace bpx_flash;

constexpr int kChunkThreads = 128;   // 8 row groups x 16 lanes
constexpr int kRowsPerThread = 8;
constexpr int kQTile = 64;           // query rows of the forward's, dQ's tile
constexpr int kKTile = 32;           // key rows; the dK/dV kernel's queries
constexpr int kChunk = 128;          // head-dim columns a block owns
constexpr int kMinHeadDim = 257;     // below it the generic kernels run
constexpr int kSW = kChunk + 1;      // a tile row, in floats
constexpr int kNJ = kChunk / kGroupLanes;   // output columns a thread owns

struct ChunkedParams {
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
  int chunks;         // ceil(D / kChunk)
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int masked, offset;
  Dropout drop;
  SeedGroups seed_groups;
};

// The width of chunk c (kChunk, or less for the last one).
__device__ __forceinline__ int chunk_width(int c, int D) {
  return min(kChunk, D - c * kChunk);
}

// rows [t0, t0 + rows) of one head's chunk (src points at its first column)
// into a (rows, kSW) fp32 tile: columns past `width` and rows past `len`
// zero (a stale value could be a NaN, and 0 * NaN is not 0)
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           long long st, int rows, int t0,
                                           int len, int width) {
  for (int idx = threadIdx.x; idx < rows * kChunk; idx += kChunkThreads) {
    const int r = idx / kChunk;
    const int c = idx % kChunk;
    float x = 0.0f;
    if (c < width && t0 + r < len) x = widen(src[(t0 + r) * st + c]);
    dst[r * kSW + c] = x;
  }
}

__device__ __forceinline__ bool visible(const ChunkedParams& p, int row,
                                        int col, int kv_len) {
  return col < kv_len && (!p.masked || col <= row + p.offset);
}

__host__ __device__ constexpr int fwd_smem_bytes() {
  return ((kQTile + 2 * kKTile) * kSW + kQTile * (kKTile + 1)) * 4;
}

__host__ __device__ constexpr int dq_smem_bytes() {
  return ((2 * kQTile + 2 * kKTile) * kSW + kQTile * (kKTile + 1) + kQTile) *
         4;
}

__host__ __device__ constexpr int dkdv_smem_bytes() {
  // K, V, Q and dO tiles; P^T and dS^T; lse and delta
  return (4 * kKTile * kSW + 2 * kKTile * (kKTile + 1) + 2 * kKTile) * 4;
}

// One (batch*head, 64-query tile, column chunk): its chunk of O (and, the
// chunk-0 block, lse) over the key tiles with the online softmax.
template <typename T, bool Groups>
__global__ void __launch_bounds__(kChunkThreads)
    flash_chunked_fwd_kernel(const ChunkedParams p) {
  constexpr int KJ = kKTile / kGroupLanes;   // score columns a thread owns
  constexpr int PS = kKTile + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kQTile * kSW;
  float* Vs = Ks + kKTile * kSW;
  float* Ps = Vs + kKTile * kSW;

  const int bh = blockIdx.x / p.chunks;
  const int c = blockIdx.x % p.chunks;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kQTile;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int D = p.D;
  const int c0 = c * kChunk, cw = chunk_width(c, D);
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kNJ];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += kKTile) {
    // S over the whole head dim, a chunk of Q and K at a time
    float s[kRowsPerThread][KJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
    for (int cc = 0; cc < p.chunks; ++cc) {
      const int dw = chunk_width(cc, D);
      __syncthreads();   // the tiles before are read
      load_chunk<T>(Qs, q + cc * kChunk, p.sq.t, kQTile, q0, p.Tq, dw);
      load_chunk<T>(Ks, k + cc * kChunk, p.sk.t, kKTile, k0, p.Tk, dw);
      if (cc == 0) load_chunk<T>(Vs, v + c0, p.sv.t, kKTile, k0, p.Tk, cw);
      __syncthreads();
#if BPX_PLANT_CHUNKED_FAULT & 1
      if (cc == 1) continue;
#endif
#pragma unroll 4
      for (int d = 0; d < dw; ++d) {
        float a[kRowsPerThread], kb[KJ];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = Qs[(ty + 8 * i) * kSW + d];
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          kb[j] = Ks[(tx + kGroupLanes * j) * kSW + d];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
      }
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
        sum += e;
        float pd = e;
        if (p.drop.on)
          pd = p.drop.keep<Groups>(blk, row, col) ? e * p.drop.inv_keep
                                                  : 0.0f;
        Ps[r * PS + tx + kGroupLanes * j] = round_to<T>(pd);
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kc = 0; kc < kKTile; ++kc) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = Ps[(ty + 8 * i) * PS + kc];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (kGroupLanes * j < cw) {
          const float vv = Vs[kc * kSW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h + c0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= p.Tq) continue;
    const float ls = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < cw) o[row * p.so.t + d] = narrow<T>(acc[i][j] / ls);
    }
    if (c == 0 && tx == 0)
      p.lse[static_cast<long long>(bh) * p.Tq + row] = m[i] + logf(ls);
  }
}

// One (batch*head, 64-query tile, column chunk) of the backward: delta for
// its rows over the whole head dim (the chunk-0 block writes it for the
// dK/dV kernel), then its chunk of dQ over the key tiles.
template <typename T, bool Groups>
__global__ void __launch_bounds__(kChunkThreads)
    flash_chunked_dq_kernel(const ChunkedParams p) {
  constexpr int KJ = kKTile / kGroupLanes;
  constexpr int PS = kKTile + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kQTile * kSW;
  float* Ks = dOs + kQTile * kSW;
  float* Vs = Ks + kKTile * kSW;
  float* dSs = Vs + kKTile * kSW;
  float* dls = dSs + kQTile * PS;

  const int bh = blockIdx.x / p.chunks;
  const int c = blockIdx.x % p.chunks;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kQTile;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = p.D;
  const int c0 = c * kChunk, cw = chunk_width(c, D);
  const int last = p.chunks - 1;
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const T* dout = head_of<T>(p.dout, p.sdo, b, h);
  const T* o = head_of<T>(p.o, p.so, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);
  const long long row0 = static_cast<long long>(bh) * p.Tq;

  // delta = rowsum(dO * O) in fp32 over the whole head dim: a warp a row,
  // its lanes over the columns
#if BPX_PLANT_CHUNKED_FAULT & 2
  const int delta_cols = last * kChunk;
#else
  const int delta_cols = D;
#endif
  for (int r = warp; r < kQTile; r += kChunkThreads / 32) {
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < p.Tq)
      for (int d = lane; d < delta_cols; d += 32)
        sum = fmaf(widen(dout[row * p.sdo.t + d]), widen(o[row * p.so.t + d]),
                   sum);
    sum = warp_sum(sum);
    if (lane == 0) {
      dls[r] = sum;
      if (c == 0 && row < p.Tq) p.delta[row0 + row] = sum;
    }
  }
  __syncthreads();
  // the dK/dV grid may start; it waits for this grid before reading delta
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float lse[kRowsPerThread], dl[kRowsPerThread], acc[kRowsPerThread][kNJ];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    lse[i] = row < p.Tq ? p.lse[row0 + row] : 0.0f;
    dl[i] = dls[ty + 8 * i];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += kKTile) {
    // S and dP over the whole head dim, a chunk of Q, dO, K, V at a time
    float s[kRowsPerThread][KJ], dp[kRowsPerThread][KJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int cc = 0; cc < p.chunks; ++cc) {
      const int dw = chunk_width(cc, D);
      __syncthreads();
      load_chunk<T>(Qs, q + cc * kChunk, p.sq.t, kQTile, q0, p.Tq, dw);
      load_chunk<T>(dOs, dout + cc * kChunk, p.sdo.t, kQTile, q0, p.Tq, dw);
      load_chunk<T>(Ks, k + cc * kChunk, p.sk.t, kKTile, k0, p.Tk, dw);
      load_chunk<T>(Vs, v + cc * kChunk, p.sv.t, kKTile, k0, p.Tk, dw);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < dw; ++d) {
        float a[kRowsPerThread], g[kRowsPerThread], kb[KJ], vb[KJ];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          a[i] = Qs[(ty + 8 * i) * kSW + d];
          g[i] = dOs[(ty + 8 * i) * kSW + d];
        }
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          kb[j] = Ks[(tx + kGroupLanes * j) * kSW + d];
          vb[j] = Vs[(tx + kGroupLanes * j) * kSW + d];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            s[i][j] = fmaf(a[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
          }
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
    // this block's chunk of K (the last chunk is in place already)
    if (c != last) {
      load_chunk<T>(Ks, k + c0, p.sk.t, kKTile, k0, p.Tk, cw);
      __syncthreads();
    }

#pragma unroll 4
    for (int kc = 0; kc < kKTile; ++kc) {
      float dsv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        dsv[i] = dSs[(ty + 8 * i) * PS + kc];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (kGroupLanes * j < cw) {
          const float kk = Ks[kc * kSW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h + c0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < cw) dq[row * p.sdq.t + d] = narrow<T>(acc[i][j]);
    }
  }
}

// One (batch*head, 32-key tile, column chunk) of the backward: its chunk of
// dK and dV over the query tiles, after the dQ kernel's delta.  A thread
// owns keys ty + 8 i and, of each query tile's scores, the queries tx + 16 j.
template <typename T, bool Groups>
__global__ void __launch_bounds__(kChunkThreads)
    flash_chunked_dkdv_kernel(const ChunkedParams p) {
  constexpr int BK = kKTile;
  constexpr int BQ = kKTile;
  constexpr int KI = BK / 8;             // keys a thread owns
  constexpr int QJ = BQ / kGroupLanes;   // score columns (queries) it owns
  constexpr int QS = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * kSW;
  float* Qs = Vs + BK * kSW;
  float* dOs = Qs + BQ * kSW;
  float* Pts = dOs + BQ * kSW;
  float* dSts = Pts + BK * QS;
  float* lses = dSts + BK * QS;
  float* dls = lses + BQ;

  const int bh = blockIdx.x / p.chunks;
  const int c = blockIdx.x % p.chunks;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x / kGroupLanes, tx = threadIdx.x % kGroupLanes;
  const int D = p.D;
  const int c0 = c * kChunk, cw = chunk_width(c, D);
  const int last = p.chunks - 1;
  const T* q = head_of<T>(p.q, p.sq, b, h);
  const T* k = head_of<T>(p.k, p.sk, b, h);
  const T* v = head_of<T>(p.v, p.sv, b, h);
  const T* dout = head_of<T>(p.dout, p.sdo, b, h);
  const int kv_len = p.kv_lens ? p.kv_lens[b] : p.Tk;
  const BlockDropout blk = block_dropout<Groups>(p.seed_groups, bh);
  const long long row0 = static_cast<long long>(bh) * p.Tq;

  // delta: written by the dQ kernel, which this launch may overlap
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  float dk[KI][kNJ], dv[KI][kNJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
    // S^T and dP^T over the whole head dim, a chunk of K, V, Q, dO at a time
    float s[KI][QJ], dp[KI][QJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int cc = 0; cc < p.chunks; ++cc) {
      const int dw = chunk_width(cc, D);
      __syncthreads();
      load_chunk<T>(Ks, k + cc * kChunk, p.sk.t, BK, k0, p.Tk, dw);
      load_chunk<T>(Vs, v + cc * kChunk, p.sv.t, BK, k0, p.Tk, dw);
      load_chunk<T>(Qs, q + cc * kChunk, p.sq.t, BQ, q0, p.Tq, dw);
      load_chunk<T>(dOs, dout + cc * kChunk, p.sdo.t, BQ, q0, p.Tq, dw);
      if (cc == 0) {
        for (int r = threadIdx.x; r < BQ; r += kChunkThreads) {
          const bool in = q0 + r < p.Tq;
          lses[r] = in ? p.lse[row0 + q0 + r] : 0.0f;
          dls[r] = in ? p.delta[row0 + q0 + r] : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < dw; ++d) {
        float kk[KI], vv[KI], qq[QJ], gg[QJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          kk[i] = Ks[(ty + 8 * i) * kSW + d];
          vv[i] = Vs[(ty + 8 * i) * kSW + d];
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          qq[j] = Qs[(tx + kGroupLanes * j) * kSW + d];
          gg[j] = dOs[(tx + kGroupLanes * j) * kSW + d];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
#if BPX_PLANT_CHUNKED_FAULT & 4
            if (cc != 1)
#endif
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int kc = ty + 8 * i;
      const int col = k0 + kc;
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
        Pts[kc * QS + r] = round_to<T>(pd);
        dSts[kc * QS + r] = round_to<T>(pr * (dpv - dls[r]));
      }
    }
    __syncthreads();
    // this block's chunk of Q and dO (the last chunk is in place already)
    if (c != last) {
      load_chunk<T>(Qs, q + c0, p.sq.t, BQ, q0, p.Tq, cw);
      load_chunk<T>(dOs, dout + c0, p.sdo.t, BQ, q0, p.Tq, cw);
      __syncthreads();
    }

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = Pts[(ty + 8 * i) * QS + r];
        dsv[i] = dSts[(ty + 8 * i) * QS + r];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (kGroupLanes * j < cw) {
          const float g = dOs[r * kSW + tx + kGroupLanes * j];
          const float qv = Qs[r * kSW + tx + kGroupLanes * j];
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            dv[i][j] = fmaf(pv[i], g, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h + c0;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h + c0;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int col = k0 + ty + 8 * i;
    if (col >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + kGroupLanes * j;
      if (d < cw) {
        dkp[col * p.sdk.t + d] = narrow<T>(dk[i][j]);
        dvp[col * p.sdv.t + d] = narrow<T>(dv[i][j]);
      }
    }
  }
}

// delta[bh, t] = sum_d dO[b, h, t, d] * O[b, h, t, d] in fp32, a warp a row,
// into a contiguous (B*H, T) buffer.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
    flash_chunked_delta_kernel(const T* o, const T* dout, float* delta,
                               int H, int T_len, int D, int rows, Strides so,
                               Strides sdo) {
  const int row = blockIdx.x * (kChunkThreads / 32) + threadIdx.x / 32;
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

template <typename T, bool Groups>
cudaError_t launch_fwd(const ChunkedParams& p, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_chunked_fwd_kernel<T, Groups>;
  cudaError_t err = allow_smem(kernel, fwd_smem_bytes(), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H * p.chunks, (p.Tq + kQTile - 1) / kQTile);
  kernel<<<grid, kChunkThreads, fwd_smem_bytes(), s>>>(p);
  return cudaGetLastError();
}

// The dQ kernel (with delta) on a (batch*head x chunk, query tiles) grid,
// then the dK/dV kernel on a (batch*head x chunk, key tiles) grid as its
// programmatic dependent.  A tile's chunk blocks are neighbours in x, so
// they run together and share their chunk loads in L2.
template <typename T, bool Groups>
cudaError_t launch_bwd(const ChunkedParams& p, cudaStream_t s) {
  static bool dq_set = false, dkdv_set = false;
  auto dq = flash_chunked_dq_kernel<T, Groups>;
  auto dkdv = flash_chunked_dkdv_kernel<T, Groups>;
  cudaError_t err = allow_smem(dq, dq_smem_bytes(), dq_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv, dkdv_smem_bytes(), dkdv_set);
  if (err != cudaSuccess) return err;
  const int blocks = p.B * p.H * p.chunks;
  dq<<<dim3(blocks, (p.Tq + kQTile - 1) / kQTile), kChunkThreads,
       dq_smem_bytes(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (p.Tk + kKTile - 1) / kKTile);
  cfg.blockDim = dim3(kChunkThreads);
  cfg.dynamicSmemBytes = dkdv_smem_bytes();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkdv, p);
}

bool set_common(ChunkedParams& p, int B, int H, int Tq, int Tk, int D,
                const void* kv_lens, int masked, int offset, int dropout,
                const unsigned int* seeds, int groups, unsigned int threshold,
                float inv_keep, int tk_p, int b_off, int h_off, int heads_g,
                int group_stride) {
  if (D < kMinHeadDim) return false;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.chunks = (D + kChunk - 1) / kChunk;
  p.masked = masked;
  p.offset = offset;
  return set_dropout(p.drop, p.seed_groups, dropout, seeds, groups, B * H, H,
                     threshold, inv_keep, tk_p, b_off, h_off, heads_g,
                     group_stride);
}

}  // namespace

extern "C" {

// As bpx_flash_generic_fwd (flash_generic.cu), at any head_dim D from 257
// up, with dtype 0 (bf16) or 1 (fp32) for q, k, v and o.  Returns a
// cudaError_t; cudaErrorInvalidValue for a D or dtype outside that, or for
// seed groups or a placement that do not fit.
int bpx_flash_chunked_fwd(const void* q, const void* k, const void* v,
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
  ChunkedParams p = {};
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
  return static_cast<int>(with_dtype<true>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return p.seed_groups.grouped() ? launch_fwd<T, true>(p, s)
                                   : launch_fwd<T, false>(p, s);
  }));
}

// As bpx_flash_generic_bwd (flash_generic.cu), at any head_dim D from 257
// up, with dtype 0 (bf16) or 1 (fp32) for q, k, v, dO, o, dq, dk and dv:
// the dQ kernel (with delta, into the (B*H, Tq) workspace `delta`), then
// the dK/dV kernel as its dependent launch.  Returns a cudaError_t, as
// bpx_flash_chunked_fwd.
int bpx_flash_chunked_bwd(const void* q, const void* k, const void* v,
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
  ChunkedParams p = {};
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
  return static_cast<int>(with_dtype<true>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return p.seed_groups.grouped() ? launch_bwd<T, true>(p, s)
                                   : launch_bwd<T, false>(p, s);
  }));
}

// delta = rowsum(dO * O) in fp32 into a contiguous (B*H, T) buffer, at any
// head_dim D from 257 up and dtype 0 (bf16) or 1 (fp32).
int bpx_flash_chunked_delta(const void* o, const void* dout, void* delta,
                            int B, int H, int T, int D, int dtype,
                            long long o_sb, long long o_sh, long long o_st,
                            long long do_sb, long long do_sh, long long do_st,
                            void* stream) {
  if (D < kMinHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * H * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kChunkThreads / 32;
  return static_cast<int>(with_dtype<true>(dtype, [&](auto t) {
    using E = typename decltype(t)::type;
    flash_chunked_delta_kernel<E>
        <<<(rows + per_block - 1) / per_block, kChunkThreads, 0, s>>>(
            static_cast<const E*>(o), static_cast<const E*>(dout),
            static_cast<float*>(delta), H, T, D, rows,
            Strides{o_sb, o_sh, o_st}, Strides{do_sb, do_sh, do_st});
    return cudaGetLastError();
  }));
}

// Blocks of the chunked forward (kernel 0), dK/dV (1) or dQ kernel (2) at
// head_dim D (257 up) and dtype 0 (bf16) or 1 (fp32) that one SM holds,
// into *blocks (the same at every such D: the tiles are a chunk wide).
// Returns a cudaError_t.
int bpx_flash_chunked_blocks_per_sm(int D, int dtype, int kernel,
                                    int* blocks) {
  if (D < kMinHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_dtype<true>(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (kernel == 0)
      return bpx_flash::blocks_per_sm(flash_chunked_fwd_kernel<T, false>,
                                      fwd_smem_bytes(), blocks,
                                      kChunkThreads);
    if (kernel == 1)
      return bpx_flash::blocks_per_sm(flash_chunked_dkdv_kernel<T, false>,
                                      dkdv_smem_bytes(), blocks,
                                      kChunkThreads);
    if (kernel == 2)
      return bpx_flash::blocks_per_sm(flash_chunked_dq_kernel<T, false>,
                                      dq_smem_bytes(), blocks, kChunkThreads);
    return cudaErrorInvalidValue;
  }));
}

}  // extern "C"
