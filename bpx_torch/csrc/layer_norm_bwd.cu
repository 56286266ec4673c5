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
// Design: one cooperative launch per call; dw and db are summed in a fixed
// order with no atomics, so reruns give the same bits.  The TPU kernel sums
// dw and db across its grid in VMEM scratch, which works because a TPU runs
// the grid in order; blocks on the card run in no order.  Here the grid is
// sized to the card (one block per 8 rows, but no more than the card holds
// at once, from the occupancy calculator) and launched cooperatively, so
// every block is resident and a grid-wide barrier is safe:
//   1. rows: block j takes a contiguous range of n / G rows, its warps every
//      8th row of it.  On the vector path (E % 4 == 0, E <= 1024, every
//      pointer 16-byte aligned: the model's E = 768, and 300) a lane holds
//      its columns of a row of x and dy in registers (8- or 16-byte loads);
//      the warp issues the next row's loads before it reduces the current
//      row's mean(a) and mean(a xhat) by shuffles, and each lane keeps its
//      columns of dw and db in registers across the warp's rows.  The block
//      adds its warps' sums in a fixed tree through shared memory and writes
//      one partial row of dw and one of db to the workspace.  Rows wider
//      than 1024, up to 1536 (mmtrvpa's memory encoders), take the same
//      kernel with two warps a row (P = 2): each warp holds half the row
//      in the 768-wide path's registers, and the pair adds its two sums
//      through shared memory behind a 64-thread barrier.
//      Other widths or alignments take a scalar path that re-reads the row
//      from L1/L2 and keeps one partial row per warp in the workspace.
//   2. the grid barrier (cooperative_groups, split into arrive and wait):
//      each warp computes its last row's dx between the two, so that work
//      hides part of the barrier's latency.
//   3. block j sums column slice j of the partial rows: each thread a
//      strided subset of them, in order, then the threads' sums in a fixed
//      tree.  The order depends only on (n, E, the grid).
// dw and db are written in full by step 3: the wrapper allocates them with
// torch.empty and caches the workspace.
//
// Bound on an H100: memory.  It reads x and dy once and writes dx once (plus
// 8 bytes of statistics per row) at ~12 flops per element, far below the
// card's flop/byte balance point; the partial rows (G x 2E fp32) stay in L2.
// At the model's sizes (1600 and 4096 rows of 768) the fixed latencies of
// steps 2 and 3 and of the warp tree weigh as much as the rows do.
//
// Built with -DBPX_LN_TRACE (scripts/torch_ln_bwd_phases.py; checked by
// tests/test_torch_cuda.py), the vector paths' thread 0 of each block stamps
// the global timer at its start and after its rows, its partial rows, the
// barrier and its column sums, for bpx_ln_trace_read.

#include <cooperative_groups.h>

#include <utility>

#include "layer_norm_common.cuh"

#ifdef BPX_LN_TRACE
constexpr int kTraceBlocks = 4096;
__device__ unsigned long long g_ln_trace[kTraceBlocks][5];
#define LN_TRACE(k)                                                   \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {              \
      unsigned long long t;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));           \
      g_ln_trace[blockIdx.x][k] = t;                                  \
    }                                                                 \
  } while (0)
// Copies the stamps of the first `blocks` blocks of the last launch (5 per
// block, ns) to `host`; returns a cudaError_t.
extern "C" int bpx_ln_trace_read(void* host, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_ln_trace, sizeof(unsigned long long) * 5 * blocks));
}
#else
#define LN_TRACE(k)
#endif

namespace {

using namespace ln;
namespace cg = cooperative_groups;

// Step 3: column slice blockIdx.x of the sums over `parts` partial rows of
// dw (part[0 : parts e]) and db (part[parts e : 2 parts e]).  Thread t sums
// column t % width of the slice over the partial rows t / width + k groups
// (8 loads in flight at a time, added in row order); the groups' sums are
// then added in a fixed tree.  `sm` holds kThreads floats.  Every thread of
// the block calls it.
__device__ void reduce_parts(const float* __restrict__ part, int parts, int e,
                             float* __restrict__ dw, float* __restrict__ db,
                             float* sm) {
  const int cols = 2 * e;
  const int per_block = (cols + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * per_block;
  const int end = min(begin + per_block, cols);
  const int t = threadIdx.x;
  for (int c0 = begin; c0 < end; c0 += kThreads) {
    const int width = min(kThreads, end - c0);
    const int groups = kThreads / width;
    const int grp = t / width;
    const int col = c0 + t % width;
    float s = 0.f;
    if (grp < groups) {
      const float* src = col < e ? part + col
                                 : part + (long long)parts * e + (col - e);
      for (int r0 = grp; r0 < parts; r0 += 8 * groups) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int r = r0 + k * groups;
          v[k] = r < parts ? src[(long long)r * e] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) s += v[k];
      }
    }
    sm[t] = s;
    __syncthreads();
    int half = 1;
    while (2 * half < groups) half *= 2;
    for (; half > 0; half /= 2) {
      if (grp < half && grp + half < groups) sm[t] += sm[t + half * width];
      __syncthreads();
    }
    if (grp == 0) {
      if (col < e) {
        dw[col] = sm[t];
      } else {
        db[col - e] = sm[t];
      }
    }
    __syncthreads();
  }
}

// This block's rows: [first, last), n / G or n / G + 1 of them.
__device__ __forceinline__ void block_rows(int n, int* first, int* last) {
  const int each = n / gridDim.x, extra = n % gridDim.x;
  const int b = blockIdx.x;
  *first = b * each + min(b, extra);
  *last = *first + each + (b < extra ? 1 : 0);
}

// One row of x and dy (a lane's K chunks of 4: chunks first + 32 P c of
// the row, P the warps that share it) and its statistics.
template <typename Tx, typename Tdy, int K, int P = 1>
struct Row {
  typename Vec4<Tx>::Raw x[K];
  typename Vec4<Tdy>::Raw g[K];
  float mu, rstd;

  __device__ __forceinline__ void load(const Tx* __restrict__ xs,
                                       const Tdy* __restrict__ dys,
                                       const float* __restrict__ mus,
                                       const float* __restrict__ rstds,
                                       int row, int e, int first) {
    const long long off = (long long)row * e;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int idx = first + c * 32 * P;
      if (idx < e / 4) {
        x[c] = Vec4<Tx>::load(xs + off + idx * 4);
        g[c] = Vec4<Tdy>::load(dys + off + idx * 4);
      }
    }
    mu = mus[row];
    rstd = rstds[row];
  }
};

// dx of one row held in registers, from its mean(a) and mean(a xhat).
template <typename Tx, typename Tdy, int K, int P>
__device__ __forceinline__ void dx_pass(const Row<Tx, Tdy, K, P>& r,
                                        const float* w_s, float m1, float m2,
                                        Tx* __restrict__ dxr, int first,
                                        int chunks) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int idx = first + c * 32 * P;
    if (idx < chunks) {
      float xv[4], gv[4], out[4];
      Vec4<Tx>::unpack(r.x[c], xv);
      Vec4<Tdy>::unpack(r.g[c], gv);
      const float4 wv = reinterpret_cast<const float4*>(w_s)[idx];
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xh = (xv[i] - r.mu) * r.rstd;
        out[i] = r.rstd * (gv[i] * wa[i] - m1 - xh * m2);
      }
      Vec4<Tx>::store(dxr + idx * 4, out);
    }
  }
}

// The barrier of the P warps of row group `group` (named barrier 1 +
// group).
template <int P>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(32 * P) : "memory");
}

// The vector path.  P warps share a row: one up to E = 1024, two for rows
// too wide for one warp's registers (up to 2 x 32 x K x 4: 1536 at K = 6,
// the 768-wide path's registers a warp).  Row group g (warps P g ..
// P g + P - 1) takes every (8 / P)-th row of the block's range; warp p of
// the group holds chunks 32 p + lane + 32 P c of the row, and the same
// columns of dw and db across the group's rows.  With two warps a row they
// add their shuffled sums through shared memory behind the group's own
// barrier, warp 0's first, so both compute the same mean(a) and
// mean(a xhat); the slots alternate by row so that one barrier a row
// suffices.
template <typename Tx, typename Tdy, int K, int P>
__global__ void __launch_bounds__(kThreads)
ln_bwd_vec_kernel(const Tx* __restrict__ x, const Tdy* __restrict__ dy,
                  const float* __restrict__ w, const float* __restrict__ mu,
                  const float* __restrict__ rstd, Tx* __restrict__ dx,
                  float* __restrict__ part, float* __restrict__ dw,
                  float* __restrict__ db, int n, int e) {
  constexpr int kGroups = kWarps / P;   // rows in flight a block
  // w (e floats), then the tree of the warps' dw/db sums (kWarps / 2
  // slots of 8 K floats per lane)
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  __shared__ float2 sums[kGroups][2][P];   // [group][row parity][warp]
  float* w_s = smem;
  float4* tree = reinterpret_cast<float4*>(smem + P * K * 128);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / P;
  const int sub = warp % P;
  const int mine = sub * 32 + lane;   // this lane's first chunk of a row
  const int chunks = e / 4;
  LN_TRACE(0);

  int first, last;
  block_rows(n, &first, &last);
  Row<Tx, Tdy, K, P> cur, nxt;
  int row = first + group;
  if (row < last) cur.load(x, dy, mu, rstd, row, e, mine);
  for (int i = threadIdx.x; i < e; i += kThreads) w_s[i] = w[i];
  float aw[K][4], ab[K][4];
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) aw[c][i] = ab[c][i] = 0.f;
  }
  __syncthreads();   // w_s

  // every row but the group's last: both passes; the last row's dx pass
  // waits until the block has arrived at the grid barrier
  float m1 = 0.f, m2 = 0.f;
  int parity = 0;
  for (; row < last; row += kGroups) {
    const bool more = row + kGroups < last;
    if (more) nxt.load(x, dy, mu, rstd, row + kGroups, e, mine);
    const float m = cur.mu, rs = cur.rstd;
    float s_a = 0.f, s_ax = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int idx = mine + c * 32 * P;
      if (idx < chunks) {
        float xv[4], gv[4];
        Vec4<Tx>::unpack(cur.x[c], xv);
        Vec4<Tdy>::unpack(cur.g[c], gv);
        const float4 wv = reinterpret_cast<const float4*>(w_s)[idx];
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xh = (xv[i] - m) * rs;
          const float a = gv[i] * wa[i];
          s_a += a;
          s_ax += a * xh;
          aw[c][i] += gv[i] * xh;
          ab[c][i] += gv[i];
        }
      }
    }
    s_a = warp_sum(s_a);
    s_ax = warp_sum(s_ax);
    if constexpr (P > 1) {
      if (lane == 0) sums[group][parity][sub] = make_float2(s_a, s_ax);
      group_sync<P>(group);
      s_a = s_ax = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float2 v = sums[group][parity][q];
        s_a += v.x;
        s_ax += v.y;
      }
      parity ^= 1;
    }
    m1 = s_a / e;
    m2 = s_ax / e;
    if (!more) break;
    dx_pass(cur, w_s, m1, m2, dx + (long long)row * e, mine, chunks);
    cur = nxt;
  }
  LN_TRACE(1);

  // the block's partial rows: the groups' sums added in a fixed tree
  // (group g += group g + h for h = 4, 2, 1 / P), warp p of each group
  // holding the same columns, in registers
#pragma unroll
  for (int h = kGroups / 2; h > 0; h /= 2) {
    if (group >= h && group < 2 * h) {
      float4* slot = tree + ((group - h) * P + sub) * 2 * K * 32 + lane;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        slot[c * 32] = make_float4(aw[c][0], aw[c][1], aw[c][2], aw[c][3]);
        slot[(K + c) * 32] =
            make_float4(ab[c][0], ab[c][1], ab[c][2], ab[c][3]);
      }
    }
    __syncthreads();
    if (group < h) {
      const float4* slot = tree + (group * P + sub) * 2 * K * 32 + lane;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float4 u = slot[c * 32], v = slot[(K + c) * 32];
        aw[c][0] += u.x; aw[c][1] += u.y; aw[c][2] += u.z; aw[c][3] += u.w;
        ab[c][0] += v.x; ab[c][1] += v.y; ab[c][2] += v.z; ab[c][3] += v.w;
      }
    }
    __syncthreads();
  }
  if (group == 0) {
    float4* pw = reinterpret_cast<float4*>(part + (long long)blockIdx.x * e);
    float4* pb = reinterpret_cast<float4*>(
        part + ((long long)gridDim.x + blockIdx.x) * e);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int idx = mine + c * 32 * P;
      if (idx < chunks) {
        pw[idx] = make_float4(aw[c][0], aw[c][1], aw[c][2], aw[c][3]);
        pb[idx] = make_float4(ab[c][0], ab[c][1], ab[c][2], ab[c][3]);
      }
    }
  }
  LN_TRACE(2);

  cg::grid_group grid = cg::this_grid();
  auto token = grid.barrier_arrive();
  if (row < last) {
    dx_pass(cur, w_s, m1, m2, dx + (long long)row * e, mine, chunks);
  }
  grid.barrier_wait(std::move(token));
  LN_TRACE(3);
  reduce_parts(part, gridDim.x, e, dw, db, red);
  LN_TRACE(4);
}

template <typename Tx, typename Tdy>
__global__ void __launch_bounds__(kThreads)
ln_bwd_scalar_kernel(const Tx* __restrict__ x, const Tdy* __restrict__ dy,
                     const float* __restrict__ w, const float* __restrict__ mu,
                     const float* __restrict__ rstd, Tx* __restrict__ dx,
                     float* __restrict__ part, float* __restrict__ dw,
                     float* __restrict__ db, int n, int e) {
  __shared__ float red[kThreads];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  float* pw = part + (long long)gw * e;             // this warp's partial rows
  float* pb = part + ((long long)parts + gw) * e;
  for (int i = lane; i < e; i += 32) pw[i] = pb[i] = 0.f;
  int first, last;
  block_rows(n, &first, &last);
  for (int row = first + warp; row < last; row += kWarps) {
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

  cg::this_grid().sync();
  reduce_parts(part, parts, e, dw, db, red);
}

struct Args {
  const void* x;
  const void* dy;
  const float* w;
  const float* mu;
  const float* rstd;
  void* dx;
  float* part;
  float* dw;
  float* db;
  int n, e;
};

// Launches `kernel` cooperatively (or, with `need` set, only writes there
// the workspace's size in floats: 2 x parts_per_block x grid x e).
template <typename Tx, typename Tdy, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int* cache, int smem,
                          int parts_per_block, const Args& a, cudaStream_t s,
                          long long* need, int rows = kWarps) {
  int grid = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(kernel),
                                   smem, cache, a.n, &grid, rows);
  if (err != cudaSuccess) return err;
  if (need != nullptr) {
    *need = 2LL * parts_per_block * grid * a.e;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const Tx*>(a.x),
                            static_cast<const Tdy*>(a.dy), a.w, a.mu, a.rstd,
                            static_cast<Tx*>(a.dx), a.part, a.dw, a.db, a.n,
                            a.e);
}

// A block has 8 / P rows in flight: one block per 8 / P rows, as the card
// allows.
template <typename Tx, typename Tdy, int K, int P>
cudaError_t launch_vec(const Args& a, cudaStream_t s, long long* need) {
  static int cache[kMaxDevices];
  // w for the widest row of this K and P, and the tree of the warps' sums
  const int smem = (P * K * 128 + kWarps / 2 * 8 * K * 32) * (int)sizeof(float);
  return launch_kernel<Tx, Tdy>(ln_bwd_vec_kernel<Tx, Tdy, K, P>, cache,
                                smem, 1, a, s, need, kWarps / P);
}

template <typename Tx, typename Tdy>
cudaError_t launch(const Args& a, int vector_ok, cudaStream_t s,
                   long long* need) {
  const BwdPlan plan =
      vector_ok && a.e % 4 == 0 ? bwd_plan(a.e) : BwdPlan{0, 0};
  if (plan.warps == 2) return launch_vec<Tx, Tdy, 6, 2>(a, s, need);
  switch (plan.chunks) {
    case 3: return launch_vec<Tx, Tdy, 3, 1>(a, s, need);
    case 6: return launch_vec<Tx, Tdy, 6, 1>(a, s, need);
    case 8: return launch_vec<Tx, Tdy, 8, 1>(a, s, need);
    default: {
      static int cache[kMaxDevices];
      return launch_kernel<Tx, Tdy>(ln_bwd_scalar_kernel<Tx, Tdy>, cache, 0,
                                    kWarps, a, s, need);
    }
  }
}

cudaError_t dispatch(const Args& a, int x_bf16, int dy_bf16, int vector_ok,
                     cudaStream_t s, long long* need) {
  if (x_bf16 && dy_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(a, vector_ok, s, need);
  } else if (x_bf16) {
    return launch<__nv_bfloat16, float>(a, vector_ok, s, need);
  } else if (dy_bf16) {
    return launch<float, __nv_bfloat16>(a, vector_ok, s, need);
  }
  return launch<float, float>(a, vector_ok, s, need);
}

}  // namespace

extern "C" {

// fp32 elements of workspace that bpx_layer_norm_bwd needs for these
// arguments on the current device, or minus a cudaError_t.
long long bpx_layer_norm_bwd_workspace(int n, int e, int x_bf16, int dy_bf16,
                                       int vector_ok) {
  Args a = {};
  a.n = n;
  a.e = e;
  long long need = 0;
  const cudaError_t err = dispatch(a, x_bf16, dy_bf16, vector_ok, nullptr,
                                   &need);
  return err == cudaSuccess ? need : -static_cast<long long>(err);
}

// x, dy, dx (n, e) contiguous, n > 0 (x and dx one type, dy bf16 or fp32); w
// (e,) fp32; mu, rstd (n,) fp32 from the forward; dw, db (e,) fp32, written
// in full; work as sized by bpx_layer_norm_bwd_workspace, used by one call
// at a time.  vector_ok says every pointer is 16-byte aligned.  Returns a
// cudaError_t (0 on success).
int bpx_layer_norm_bwd(const void* x, const void* dy, const void* w,
                       const void* mu, const void* rstd, void* dx, void* dw,
                       void* db, void* work, int n, int e, int x_bf16,
                       int dy_bf16, int vector_ok, void* stream) {
  const Args a{x,
               dy,
               static_cast<const float*>(w),
               static_cast<const float*>(mu),
               static_cast<const float*>(rstd),
               dx,
               static_cast<float*>(work),
               static_cast<float*>(dw),
               static_cast<float*>(db),
               n,
               e};
  return static_cast<int>(dispatch(a, x_bf16, dy_bf16, vector_ok,
                                   static_cast<cudaStream_t>(stream),
                                   nullptr));
}

}  // extern "C"
