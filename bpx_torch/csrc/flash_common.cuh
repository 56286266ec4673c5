// Device helpers shared by the flash-attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels for Hopper (sm_90a): tile loads into a
// swizzled shared-memory layout, the wgmma matrix descriptors and
// instructions that read it, row stores, and the in-kernel dropout hash.
//
// Tile layout.  Every tile is 64 rows (queries or keys) of DP bf16 values,
// DP the head dim D rounded up to 32, split into DP / 32 column panels of
// 32 values (64 bytes).  A panel holds its 64 rows back to back (64 B apart,
// 4 KB per panel) with the 64-byte swizzle of wgmma and TMA (16-byte chunk c
// of row r stored at chunk c ^ ((r / 2) % 4)), so the 16-byte copies of a
// warp and the tensor cores' reads hit distinct banks.  D = 96 is not a
// swizzle span (192 B), but three 64-byte panels are; D = 64 is two panels,
// D = 128 four, D = 192 six and D = 256 eight.  A narrow head (D = 25, 30)
// is one panel, and D = 50 and 60 are two, whose columns D..DP-1 hold
// zeros (written by every load, or, in the D 50/60 forward's K and V rings,
// once a ring stage): the products then run at DP = 32 or 64 and the
// padding adds nothing to them (a stale value there could be a NaN, and
// 0 * NaN is not 0).  A panel build (below) runs any head dim d up to 256
// so, at the panel width that holds it, its loads zeroing columns d..DP-1.
//
// The same tile serves both operand majors of wgmma:
//   * K-major, when D is the reduction (S = Q K^T): the 16-wide k-step kk
//     starts at panel kk / 2, byte 32 (kk % 2); 8-row groups are 512 B apart.
//   * MN-major, when the 64 rows are the reduction and D the output width
//     (O = P V): the k-step of 16 rows starts 1 KB further on; the 32-wide
//     output panels are 4 KB apart (the leading byte offset), the 8-row
//     groups 512 B (the stride byte offset).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// BPX_PLANT_PANEL_FAULT builds the faults chip_smoke.py's phase 22 must
// catch in the panel builds alone (panel_fault), a bit per kernel: 1, the
// forward's row sum leaves out each key tile's first key; 2, the dQ kernel
// leaves delta out of dS; 4, the dK/dV kernel does.
#ifndef BPX_PLANT_PANEL_FAULT
#define BPX_PLANT_PANEL_FAULT 0
#endif

namespace bpx_flash {

// The head dims the kernels are instantiated for: f(std::integral_constant
// <int, D>()) for a tabled D, cudaErrorInvalidValue for any other.  The
// wrapper's KERNEL_ALIGN (bpx_torch/ops/flash_attention.py) lists the same.
template <typename F>
__host__ cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 25:
      return f(std::integral_constant<int, 25>());
    case 30:
      return f(std::integral_constant<int, 30>());
    case 50:
      return f(std::integral_constant<int, 50>());
    case 60:
      return f(std::integral_constant<int, 60>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 96:
      return f(std::integral_constant<int, 96>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 192:
      return f(std::integral_constant<int, 192>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr float kMaskFill = -1e30f;   // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;         // one warpgroup per block
constexpr int kRows = 64;             // rows of every tile
constexpr int kPanelBytes = kRows * 64;

// Panel builds (the "panel" route of the wrapper's kernel_route): bf16 at
// every head dim d from 1 to 256 that with_head_dim does not list runs the
// kernels of the tabled head dim of its panel width DP (32, 64, 128, 192 or
// 256: the narrow, wide and tall kernels) with d a runtime argument
// (FlashParams::d, BwdParams::d).  Such a build's template head dim is
// kPanelChunks + DP when its rows are copied in 16-byte cp.async chunks (d a
// multiple of 8, every view 16-byte aligned), kPanelWords + DP when in the
// words of PanelDims::wb bytes that d and the views allow (8- or 4-byte
// cp.async words, or 2-byte loads); the tabled instantiations are the code
// they were.  Columns d..DP-1 of every tile are zeros in shared memory, so
// the products run at DP, and the stores stop at column d.
constexpr int kPanelChunks = 1000;
constexpr int kPanelWords = 2000;

template <int D>
__host__ __device__ constexpr bool is_panel() {
  return D > kPanelChunks;
}

template <int D>
__host__ __device__ constexpr bool panel_words() {
  return D > kPanelWords;
}

template <int DP, bool Words>
__host__ __device__ constexpr int panel_build() {
  return (Words ? kPanelWords : kPanelChunks) + DP;
}

// The head dim the products run at: D rounded up to a whole panel (a panel
// build's width).
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return is_panel<D>() ? D % kPanelChunks : (D + 31) / 32 * 32;
}

// Whether a panel build carries planted fault `bit` (the macro above).
template <int D>
__host__ __device__ constexpr bool panel_fault(int bit) {
  return is_panel<D>() && (BPX_PLANT_PANEL_FAULT & bit) != 0;
}

// A panel build's half width (the D 192 and 256 backward's columns a
// warpgroup takes) as a panel build, DP / 2 at a tabled D.
template <int D>
__host__ __device__ constexpr int half_dim() {
  return is_panel<D>() ? D - padded_dim<D>() / 2 : padded_dim<D>() / 2;
}

// The panel width of head dim d (1..256): the smallest of 32, 64, 128, 192
// and 256 that holds it (the wrapper's panel_width); f(integral_constant<int,
// DP>()), cudaErrorInvalidValue outside 1..256.
template <typename F>
__host__ cudaError_t with_panel_width(int d, F&& f) {
  if (d < 1 || d > 256) return cudaErrorInvalidValue;
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  if (d <= 192) return f(std::integral_constant<int, 192>());
  return f(std::integral_constant<int, 256>());
}

// The head dims that run the D 128 kernels in either direction (the
// forward's flash_fwd_wide_kernel, the backward's flash_bwd_wide_dq_kernel
// and its dependent flash_bwd_wide_dkdv_kernel): 128, and 50 and 60 at DP =
// 64.  D 64 and 96 keep kernels of their own.
template <int D>
__host__ __device__ constexpr bool runs_wide() {
  return D == 50 || D == 60 || padded_dim<D>() == 128 ||
         (is_panel<D>() && padded_dim<D>() == 64);
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  constexpr int DP = padded_dim<D>();
  static_assert(DP <= 256, "head_dim must be <= 256");
  static_assert(is_panel<D>() || D == DP || D < 32 || D % 2 == 0,
                "head_dim must be 32*k, even, or one panel");
  return DP / 32 * kPanelBytes;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// tile loads
// ---------------------------------------------------------------------------
//
// cp.async rather than TMA: the q/k/v/dO tiles are strided (B, H, T, D)
// views with ragged T, and a narrow head's rows start 50 or 60 bytes apart
// (100 or 120 at D = 50, 60), which no TMA descriptor (16-byte strides)
// describes; one per tensor would also have to be encoded on the host at
// every call of a host-bound path.  How a row is read depends on what its
// alignment allows:
//   * D = 64, 96, 128, 192, 256 (rows 16-byte aligned): 16-byte cp.async
//     chunks, four neighbouring threads per 64-byte panel row, so a warp's
//     stores cover 512 distinct bytes;
//   * D = 30, 50 (rows 4-byte aligned) and D = 60 (8-byte aligned): 4- or
//     8-byte cp.async words (word_bytes), a row's words on neighbouring
//     threads, the words past column D zero-filled;
//   * D = 25 (rows only 2-byte aligned, and cp.async copies 4, 8 or 16
//     bytes): load_tile does plain 2-byte loads into registers, then
//     shared-memory stores, a warp per row, columns past D stored as zeros.
//     The stores are the generic proxy's, as cp.async's are, so the same
//     fence.proxy.async and barrier publish them to wgmma.  load_tile waits
//     for its loads before it returns, so the narrow kernels' streamed
//     tiles (the forward's K and V, the backward's) take NarrowTile below
//     instead, whose loads are issued a tile ahead and stored after the
//     products of the tile before, so they do not wait on the chain; only
//     the tiles loaded once before the loop (Q, and the backward's
//     resident ones) wait.
// Rows at or past T are zero-filled, and no load reads a column >= D: in a
// fused (B, T, 3, H, D) projection the next head's values sit there, and
// past the last head of the last row the allocation ends.

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Bytes of the cp.async words an even-D row that is not 16-byte aligned is
// loaded in: the widest that a row's alignment allows (the wrapper's
// KERNEL_ALIGN), 8 at D = 60 (4 k + 0 elements), 4 at D = 30 and 50.
template <int D>
__host__ __device__ constexpr int word_bytes() {
  return D % 4 == 0 ? 8 : 4;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t dst, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

// Make this thread's completed shared-memory writes (cp.async's and plain
// stores) visible to the async proxy (wgmma's operand reads); a block
// barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (0..3) of row r in panel `panel`.
__device__ __forceinline__ uint32_t tile_offset(int r, int panel, int c) {
  return panel * kPanelBytes + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// Load rows [t0, t0 + 64) of one (batch, head) slice (row pitch stride_t
// elements, last dim contiguous, D values a row) into the tile at dst, by
// the 128 threads of one warpgroup (tid: the thread's index in it):
// started as cp.async copies, or, at odd D, done before it returns.
template <int D>
__device__ __forceinline__ void load_tile_by(int tid, uint32_t dst,
                                             const __nv_bfloat16* src,
                                             long long stride_t, int t0,
                                             int T) {
  static_assert(!is_panel<D>(), "a panel build loads with panel_load");
  if constexpr (D % 32 == 0) {
    constexpr int kChunks = kRows * D / 8;
    static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int j = 0; j < kChunks / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int c = i & 3;
      const int r = (i >> 2) & (kRows - 1);
      const int panel = i >> 8;
      const bool ok = t0 + r < T;
      const __nv_bfloat16* g =
          ok ? src + (long long)(t0 + r) * stride_t + panel * 32 + c * 8
             : src;
      cp_async_16(dst + tile_offset(r, panel, c), g, ok);
    }
  } else if constexpr (D % 2 == 0) {
    // a thread takes one column of words, every kStep-th row: one row
    // pointer, stepped kStep rows at a time (at D = 50 sixteen words a
    // tile; offsets worked out apart for each held 16 pointers and spilled)
    constexpr int kW = word_bytes<D>();
    constexpr int kPerRow = padded_dim<D>() * 2 / kW;   // words of a row
    constexpr int kStep = kThreads / kPerRow;           // rows a step
    static_assert(kThreads % kPerRow == 0, "whole rows a step");
    const int col = (tid % kPerRow) * (kW / 2);   // the words' first column
    const int r0 = tid / kPerRow;
    const uint32_t d0 = dst + (col % 8) * 2;
    const long long step = kStep * stride_t;
    const __nv_bfloat16* g = src + (long long)(t0 + r0) * stride_t + col;
#pragma unroll
    for (int j = 0; j < kRows / kStep; ++j, g += step) {
      const int r = r0 + j * kStep;
      const bool ok = t0 + r < T && col < D;
      const uint32_t d = d0 + tile_offset(r, col / 32, (col % 32) / 8);
      if constexpr (kW == 8) {
        cp_async_8(d, ok ? g : src, ok);
      } else {
        cp_async_4(d, ok ? g : src, ok);
      }
    }
  } else {
    constexpr int kPer = kRows * 32 / kThreads;   // values per thread
    const int c = tid % 32;                       // this lane's column
    const int r0 = tid / 32;                      // rows r0, r0 + 4, ...
    uint16_t v[kPer];
    // every load first, then every store: the loads are in flight together
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = r0 + 4 * j;
      v[j] = (t0 + r < T && c < D)
                 ? __ldg(reinterpret_cast<const unsigned short*>(
                       src + (long long)(t0 + r) * stride_t + c))
                 : uint16_t(0);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      st_shared_u16(dst + tile_offset(r0 + 4 * j, 0, c / 8) + (c % 8) * 2,
                    v[j]);
    }
  }
}

// load_tile_by for a block of one warpgroup.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride_t, int t0, int T) {
  load_tile_by<D>(threadIdx.x, dst, src, stride_t, t0, T);
}

// One thread's copies into every 64-row tile of one (batch, head) slice,
// by the 256 threads of a two-warpgroup block (the D 192 and 256 kernels):
// chunk t % 4 of every panel of row t / 4 (warpgroup w copies rows 32 w ..
// 32 w + 31), the addresses worked out once.  A tile costs a 64-bit
// offset, a row test and DP / 32 cp.async.
template <int D>
struct TallCopier {
  const __nv_bfloat16* row;   // row t / 4 of the slice, column 8 c
  const __nv_bfloat16* zero;  // row 0, column 8 c: the address of a zero fill
  long long stride;           // elements between rows
  uint32_t dst;               // byte offset of the first chunk in a tile
  int r0;                     // t / 4

  static_assert(!is_panel<D>(), "a panel build copies with PanelCopier");

  __device__ __forceinline__ TallCopier(const __nv_bfloat16* slice,
                                        long long stride_t, int tid)
      : stride(stride_t), r0(tid >> 2) {
    zero = slice + (tid & 3) * 8;
    row = zero + (long long)r0 * stride_t;
    dst = tile_offset(r0, 0, tid & 3);
  }

  // rows [t0, t0 + 64) into the tile at `tile`; rows at or past T as zeros
  __device__ __forceinline__ void copy(uint32_t tile, int t0, int T) const {
    const bool ok = t0 + r0 < T;
    const __nv_bfloat16* a = ok ? row + (long long)t0 * stride : zero;
#pragma unroll
    for (int panel = 0; panel < padded_dim<D>() / 32; ++panel) {
      cp_async_16(tile + dst + panel * kPanelBytes, a + panel * 32, ok);
    }
  }
};

// A narrow (D < 32) tile, rows [t0, t0 + 64) of a (batch, head) slice,
// loaded in two steps so that its loads need not wait on the products of
// the tile before: fetch() starts them, store() puts them into the tile at
// dst (the same dst both times).  Columns D..31 and rows >= T are written
// as zeros.
//   * D even (rows 4-byte aligned): fetch() is load_tile (4-byte cp.async
//     words); store() does nothing.
//   * D odd (rows 2-byte aligned): fetch() issues plain loads into
//     registers and returns; store() waits for them and writes the tile.
//     Thread t owns row t / 2, columns 16 h .. 16 h + 15 (h = t % 2), read
//     as the 4-byte words that cover them: from the row's first column if
//     the row starts at a multiple of 4 bytes, else from the column before
//     it (in the same aligned word as column 0, so never before the
//     allocation; the byte permute drops it).  A word whose high half would
//     be column D is a 2-byte load: no load reads a column >= D.  store()
//     puts each pair of columns together from two words with a byte
//     permute and writes two 16-byte chunks a thread, conflict-free.
template <int D>
struct NarrowTile {
  static_assert(D < 32, "one panel");
  uint32_t w[9];   // D odd: the covering words
  int shift;       // D odd: 1 if the row starts 2 bytes past a word

  NarrowTile() = default;
  // PanelTile's constructor, which takes the head dim and the word bytes
  __device__ __forceinline__ NarrowTile(int, int) {}

  __device__ __forceinline__ void fetch(uint32_t dst, const __nv_bfloat16* src,
                                        long long stride_t, int t0, int T) {
    if constexpr (D % 2 == 0) {
      load_tile<D>(dst, src, stride_t, t0, T);
    } else {
      const int r = threadIdx.x / 2;
      const int h = threadIdx.x % 2;
      const bool ok = t0 + r < T;
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          ok ? src + (long long)(t0 + r) * stride_t : src);
      shift = ok ? static_cast<int>(a >> 1) & 1 : 0;
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(a - 2 * shift) + 8 * h;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int lo = 16 * h + 2 * j - shift;   // column of the low half
        uint32_t x = 0;
        if (ok && (j < 8 || shift)) {
          if (lo + 1 < D) {
            x = __ldg(words + j);
          } else if (lo < D) {
            x = __ldg(reinterpret_cast<const unsigned short*>(words + j));
          }
        }
        w[j] = x;
      }
    }
  }

  __device__ __forceinline__ void store(uint32_t dst) const {
    if constexpr (D % 2 != 0) {
      const int r = threadIdx.x / 2;
      const int h = threadIdx.x % 2;
      uint32_t o[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        o[m] = shift ? __byte_perm(w[m], w[m + 1], 0x5432) : w[m];
      }
      st_shared_v4(dst + tile_offset(r, 0, 2 * h), o);
      st_shared_v4(dst + tile_offset(r, 0, 2 * h + 1), o + 4);
    }
  }
};

// A panel build's tile load (is_panel): rows [t0 + r0, t0 + r0 + kN) of a
// (batch, head) slice into those rows of the 64-row tile at dst, by the kT
// threads of the block that copy it (tid: the thread's index among them),
// columns d..DP-1 and rows at or past T written as zeros, no column >= d
// read.  Chunks (Words false): thread t copies 16-byte chunk t % 4 of every
// panel of rows r0 + t / 4 + (kT / 4) j, as TallCopier does.  Words: the
// wb-byte words that d and the views allow (PanelDims), 8 or 4 bytes as
// cp.async words, a thread a word column of every panel; 2 bytes as plain
// loads and shared-memory stores (cp.async has no 2-byte form), done before
// it returns.  Those stores are the generic proxy's, as cp.async's copies
// are, so the same fence.proxy.async and barrier publish them; where a ring
// stage is handed on through an mbarrier, PanelCopier::arrive fences them
// before its arrival.
template <int DP, int kT, int kN, int W>
__device__ __forceinline__ void panel_words_by(int tid, uint32_t dst,
                                               const __nv_bfloat16* src,
                                               long long stride_t, int t0,
                                               int T, int r0, int d) {
  constexpr int kPer = 64 / W;        // words of a row in a panel
  constexpr int kStep = kT / kPer;    // rows a step
  static_assert(kT % kPer == 0 && kN % kStep == 0, "whole rows a step");
  const int wc = (tid % kPer) * (W / 2);   // the word's column in a panel
  const int rt = r0 + tid / kPer;
  const uint32_t at = (wc % 8) * 2;
  if constexpr (W >= 4) {
#pragma unroll
    for (int j = 0; j < kN / kStep; ++j) {
      const int r = rt + j * kStep;
      const bool row_ok = t0 + r < T;
      const __nv_bfloat16* g = src + (long long)(t0 + r) * stride_t + wc;
#pragma unroll
      for (int pn = 0; pn < DP / 32; ++pn) {
        const bool ok = row_ok && pn * 32 + wc < d;
        const uint32_t to = dst + tile_offset(r, pn, wc / 8) + at;
        if constexpr (W == 8) {
          cp_async_8(to, ok ? g + pn * 32 : src, ok);
        } else {
          cp_async_4(to, ok ? g + pn * 32 : src, ok);
        }
      }
    }
  } else {
#pragma unroll 2
    for (int j = 0; j < kN / kStep; ++j) {
      const int r = rt + j * kStep;
      const bool row_ok = t0 + r < T;
      const unsigned short* g = reinterpret_cast<const unsigned short*>(
          src + (long long)(t0 + r) * stride_t + wc);
      uint16_t v[DP / 32];
#pragma unroll
      for (int pn = 0; pn < DP / 32; ++pn) {
        v[pn] = row_ok && pn * 32 + wc < d ? __ldg(g + pn * 32) : uint16_t(0);
      }
#pragma unroll
      for (int pn = 0; pn < DP / 32; ++pn) {
        st_shared_u16(dst + tile_offset(r, pn, wc / 8) + at, v[pn]);
      }
    }
  }
}

template <int DP, int kT, int kN, bool Words>
__device__ __forceinline__ void panel_load(int tid, uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long stride_t, int t0, int T,
                                           int r0, int d, int wb) {
  if constexpr (!Words) {
    constexpr int kStep = kT / 4;
    static_assert(kN % kStep == 0, "whole rows a step");
    const int c = tid & 3;
    const int rt = r0 + (tid >> 2);
#pragma unroll
    for (int j = 0; j < kN / kStep; ++j) {
      const int r = rt + j * kStep;
      const bool row_ok = t0 + r < T;
      const __nv_bfloat16* g = src + (long long)(t0 + r) * stride_t + c * 8;
#pragma unroll
      for (int pn = 0; pn < DP / 32; ++pn) {
        const bool ok = row_ok && pn * 32 + c * 8 < d;
        cp_async_16(dst + tile_offset(r, pn, c), ok ? g + pn * 32 : src, ok);
      }
    }
  } else if (wb == 8) {
    panel_words_by<DP, kT, kN, 8>(tid, dst, src, stride_t, t0, T, r0, d);
  } else if (wb == 4) {
    panel_words_by<DP, kT, kN, 4>(tid, dst, src, stride_t, t0, T, r0, d);
  } else {
    panel_words_by<DP, kT, kN, 2>(tid, dst, src, stride_t, t0, T, r0, d);
  }
}

// A panel build's head dim and word bytes (16 for a chunk build; 8, 4 or 2
// for a words build), chosen on the host by panel_word_bytes.
struct PanelDims {
  int d;
  int wb;
};

// The widest copy (16, 8, 4 or 2 bytes) that every row of the views with
// data pointers `ptrs` and (b, h, t) strides `strides` allows at head dim d:
// a word must not straddle column d, and every row's start must be aligned
// to it.
__host__ inline int panel_word_bytes(int d, const void* const* ptrs, int n,
                                     const long long* strides, int m) {
  for (int wb = 16; wb > 2; wb /= 2) {
    bool ok = d % (wb / 2) == 0;
    for (int i = 0; i < n && ok; ++i) {
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % wb == 0;
    }
    for (int i = 0; i < m && ok; ++i) ok = strides[i] % (wb / 2) == 0;
    if (ok) return wb;
  }
  return 2;
}

// One thread's copies into every 64-row tile of one (batch, head) slice in
// a panel build, by the kT threads of a block, TallCopier's 16-byte chunks
// with their addresses worked out once (Words false), or panel_load's words
// (their addresses worked out a tile).  arrive() signals an mbarrier once
// this thread's copies have landed.
template <int DP, int kT, bool Words>
struct PanelCopier {
  static constexpr int kStep = kT / 4;   // rows between a thread's chunks
  const __nv_bfloat16* slice;   // row 0, column 0: also a zero fill's address
  const __nv_bfloat16* row;     // chunks: row t / 4, column 8 (t % 4)
  long long stride;             // elements between rows
  uint32_t dst;                 // chunks: the first chunk's byte offset
  int r0;                       // chunks: t / 4; words: t
  int live;                     // chunks: bit p, panel p's chunk is below d
  PanelDims pd;

  __device__ __forceinline__ PanelCopier(const __nv_bfloat16* s,
                                         long long stride_t, int tid,
                                         PanelDims dims)
      : slice(s), stride(stride_t), pd(dims) {
    if constexpr (Words) {
      r0 = tid;
    } else {
      r0 = tid >> 2;
      row = s + (long long)r0 * stride_t + (tid & 3) * 8;
      dst = tile_offset(r0, 0, tid & 3);
      live = 0;
#pragma unroll
      for (int pn = 0; pn < DP / 32; ++pn) {
        live |= (pn * 32 + (tid & 3) * 8 < dims.d) << pn;
      }
    }
  }

  // rows [t0, t0 + 64) into the tile at `tile`; rows at or past T, and
  // columns d..DP-1, as zeros
  __device__ __forceinline__ void copy(uint32_t tile, int t0, int T) const {
    if constexpr (Words) {
      panel_load<DP, kT, kRows, true>(r0, tile, slice, stride, t0, T, 0,
                                      pd.d, pd.wb);
    } else {
      const __nv_bfloat16* lo = row + (long long)t0 * stride;
#pragma unroll
      for (int j = 0; j < kRows / kStep; ++j) {
        const bool row_ok = t0 + r0 + j * kStep < T;
        const __nv_bfloat16* a = lo + (long long)(j * kStep) * stride;
#pragma unroll
        for (int pn = 0; pn < DP / 32; ++pn) {
          const bool ok = row_ok && ((live >> pn) & 1);
          cp_async_16(tile + dst + j * kStep * 64 + pn * kPanelBytes,
                      ok ? a + pn * 32 : slice, ok);
        }
      }
    }
  }

  // arrive on the mbarrier `bar` once this thread's copies so far have
  // landed: through cp.async, or, for 2-byte loads (done, by plain stores),
  // after a proxy fence
  __device__ __forceinline__ void arrive(uint32_t bar) const {
    if (Words && pd.wb == 2) {
      fence_proxy_async();
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
    } else {
      asm volatile(
          "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
          : "memory");
    }
  }
};

// A panel build's tile for the narrow kernels' streamed loads, NarrowTile's
// two steps: fetch() is panel_load (done before it returns for 2-byte
// loads), store() does nothing.
template <int DP, bool Words>
struct PanelTile {
  PanelDims pd;

  __device__ __forceinline__ PanelTile(int d, int wb) : pd{d, wb} {}

  __device__ __forceinline__ void fetch(uint32_t dst, const __nv_bfloat16* src,
                                        long long stride_t, int t0, int T) {
    panel_load<DP, kThreads, kRows, Words>(threadIdx.x, dst, src, stride_t,
                                           t0, T, 0, pd.d, pd.wb);
  }

  __device__ __forceinline__ void store(uint32_t) const {}
};

// ---------------------------------------------------------------------------
// wgmma: descriptors, synchronisation, instructions
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 64-byte swizzle (layout type 2).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

// The tile at `tile` as a K-major operand (64 rows x 16 of D), k-step kk.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return sw64_desc(tile + (kk >> 1) * kPanelBytes + (kk & 1) * 32, 16, 512);
}

// The tile at `tile` as an MN-major operand (16 rows x D), k-step ks.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int ks) {
  return sw64_desc(tile + ks * 1024, kPanelBytes, 512);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: the compiler
// sees wgmma as synchronous, so reads after wgmma_wait and writes before
// the next wgmma must not move across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d(64 x N, fp32) (+)= A(64 x 16) . B(16 x N), A and B K-major in shared
// memory (descriptors a, b); accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

// d(64 x N, fp32) += A(64 x 16, bf16 registers) . B(16 x N), B MN-major in
// shared memory.  The A registers are the m16n8k16 A fragment of each warp's
// 16 rows, which is the layout two adjacent 8-column blocks of a wgmma
// accumulator take once packed to bf16 pairs (see p_frags).
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64 x N, fp32) (+)= A(64 x 16) . B(16 x N), A K-major and B MN-major in
// shared memory (descriptors a, b): the D = 192 and 256 backward's second
// products (dS K, P^T dO, dS^T Q) over a warpgroup's half of the columns,
// with dS, P^T and dS^T from shared memory (flash_bwd.cu).
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_mn<96>(float (&d)[48], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_mn<128>(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<96>(float (&d)[48],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<192>(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<256>(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The bf16 A fragments of P . B for a 64 x 2N fp32 accumulator p (N per
// thread: 32 for 64 columns, 16 for 32): k-step kc (columns 16 kc ..
// 16 kc + 15) takes the accumulator's 8-column blocks 2 kc and 2 kc + 1,
// already in the A fragment's places.
template <int N>
__device__ __forceinline__ void p_frags(uint32_t (&a)[N / 8][4],
                                        const float (&p)[N]) {
#pragma unroll
  for (int kc = 0; kc < N / 8; ++kc) {
    a[kc][0] = pack_bf16x2(p[8 * kc + 0], p[8 * kc + 1]);
    a[kc][1] = pack_bf16x2(p[8 * kc + 2], p[8 * kc + 3]);
    a[kc][2] = pack_bf16x2(p[8 * kc + 4], p[8 * kc + 5]);
    a[kc][3] = pack_bf16x2(p[8 * kc + 6], p[8 * kc + 7]);
  }
}

// Store this thread's share of one row of a 64 x DP fp32 accumulator (as
// wgmma lays it out) as bf16, each value divided by div: columns
// 8 j + 2 t4 + {0, 1} of row g (Hi = 0) or g + 8 (Hi = 2), those below D
// only (a panel build's: below d).  An odd-D row may start at any even byte
// and takes 2-byte stores; every other row is 4-byte aligned (the
// wrapper's outputs, (B, T, H, D) memory).
template <int D, int Hi>
__device__ __forceinline__ void store_row(
    __nv_bfloat16* row, const float (&acc)[padded_dim<D>() / 2], int t4,
    float div, int d) {
#pragma unroll
  for (int j = 0; j < padded_dim<D>() / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float x = acc[4 * j + Hi] / div;
    const float y = acc[4 * j + Hi + 1] / div;
    if constexpr (is_panel<D>()) {
      if (d % 2 == 0) {
        if (c < d) *reinterpret_cast<uint32_t*>(row + c) = pack_bf16x2(x, y);
      } else {
        if (c < d) row[c] = __float2bfloat16_rn(x);
        if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(y);
      }
    } else if constexpr (D % 2 == 0) {
      if (c < D) *reinterpret_cast<uint32_t*>(row + c) = pack_bf16x2(x, y);
    } else {
      if (c < D) row[c] = __float2bfloat16_rn(x);
      if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(y);
    }
  }
}

// What a block hashes with: its index in its seed group and its seed.
struct BlockDropout {
  uint32_t bh;
  uint32_t seed;
};

// Dropout parameters of one call.  keep() is the TPU kernels' _keep_mask
// (bpx/ops/pallas_attention.py:102): the global element index
// bh * 0x85EBCA6B + row * tk_p + col in uint32 with wrap, then a 2-round
// xorshift-multiply mixer with the seed, kept when >= threshold.  With
// several seed groups, or a placement (SeedGroups), a block hashes with
// its group's seed and its (placed) index in its group instead.
struct Dropout {
  int on;
  uint32_t seed;        // with several seed groups, group 0's
  uint32_t threshold;   // min(int(rate * 2**32), 2**32 - 1)
  float inv_keep;       // float32(1 / (1 - rate))
  uint32_t tk_p;        // the key length the TPU kernels index with

  __device__ __forceinline__ bool keep(int bh, int row, int col) const {
    const uint32_t idx = static_cast<uint32_t>(bh) * 0x85EBCA6Bu +
                         static_cast<uint32_t>(row) * tk_p +
                         static_cast<uint32_t>(col);
    return keep_mixed(idx * 0x9E3779B9u + seed);
  }

  // keep bit of (row, col) of the block whose hash values are `blk`
  // (block_dropout).  A kernel built for one seed group (Groups false: the
  // single-seed path) hashes as keep() does, with the call's seed.
  template <bool Groups>
  __device__ __forceinline__ bool keep(const BlockDropout& blk, int row,
                                       int col) const {
    if constexpr (Groups) {
      const uint32_t idx = blk.bh * 0x85EBCA6Bu +
                           static_cast<uint32_t>(row) * tk_p +
                           static_cast<uint32_t>(col);
      return keep_mixed(idx * 0x9E3779B9u + blk.seed);
    } else {
      return keep(static_cast<int>(blk.bh), row, col);
    }
  }

  // the block's seed: with one group the call's, read where it is used
  template <bool Groups>
  __device__ __forceinline__ uint32_t block_seed(
      const BlockDropout& blk) const {
    if constexpr (Groups) {
      return blk.seed;
    } else {
      return seed;
    }
  }

  // keep() from x = idx * 0x9E3779B9 + seed: a caller that steps idx by a
  // constant steps x by a constant too
  __device__ __forceinline__ bool keep_mixed(uint32_t x) const {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    return x >= threshold;
  }
};

// Seeds one launch takes (MAX_SEED_GROUPS in ops/flash_attention.py).
constexpr int kMaxSeedGroups = 16;

// The seed groups of one call.  The B*H blocks form groups of group_bh
// consecutive blocks, one per seed: block bh hashes with seeds[bh /
// group_bh] and its index bh % group_bh in its group (the multi-seed step
// folds its seeds into the batch; under vmap the TPU kernels would run one
// kernel body per seed with a local bh).
//
// The placement (b_off, h_off, heads_g) puts the call's blocks into a
// global call, as a rank of a mesh holds some batch rows and heads of it:
// block i of a group, of `heads` heads a row, hashes as global block
// (b_off + i / heads) * heads_g + h_off + i % heads = i + base + (i /
// heads) * dheads.  Unplaced, (0, 0, heads): block i is i.  Group g's
// blocks move on by g * group_stride global blocks: a grouped pair's two
// members, folded into one call's batch, are two groups of one seed, and
// member m's rows sit m * B_g rows into the global call (group_stride =
// B_g * heads_g); 0 (every other call) places each group from its 0.
//
// The launch picks the kernel built for seed groups (Groups true) only
// for several groups or a placement (grouped()), and only that kernel
// reads these fields: they follow everything else in the kernels'
// parameters, so a one-group kernel is the code it was before placement.
struct SeedGroups {
  int groups;
  int group_bh;         // B*H / groups
  uint32_t heads;       // the call's heads
  uint32_t dheads;      // heads_g - heads
  uint32_t base;        // b_off * heads_g + h_off
  uint32_t seeds[kMaxSeedGroups];
  uint32_t group_stride;  // global blocks between two groups' block 0

  // whether a call needs the kernel built for seed groups
  __host__ bool grouped() const { return groups > 1 || base || dheads; }

  // the global block of block i of a group
  __device__ __forceinline__ uint32_t placed(uint32_t i) const {
    return i + base + (dheads ? i / heads * dheads : 0u);
  }

  // block bh's seed: selected with constant indices, so the seeds stay in
  // the kernel's parameter space.  BPX_PLANT_SEED_FAULT builds the two
  // faults chip_smoke.py's multi-seed phase must catch: 1, every group
  // hashes with group 0's seed; 2, bh is not reduced to its group.
  __device__ __forceinline__ uint32_t seed_of(int bh) const {
#if BPX_PLANT_SEED_FAULT == 1
    return seeds[0];
#endif
    const int group = bh / group_bh;
    uint32_t seed = seeds[0];
#pragma unroll
    for (int i = 1; i < kMaxSeedGroups; ++i) {
      if (i == group) seed = seeds[i];
    }
    return seed;
  }

  // block bh's index in its seed group
  __device__ __forceinline__ int group_index(int bh) const {
#if BPX_PLANT_SEED_FAULT == 2
    return bh;
#endif
    return bh % group_bh;
  }

  // the global block of block 0 of block bh's group, past the placement
  __device__ __forceinline__ uint32_t group_base(int bh) const {
    return static_cast<uint32_t>(bh / group_bh) * group_stride;
  }
};

// Block bh's hash values, worked out once beside its block indices: with
// several groups or a placement its placed index in its group and its
// group's seed; with one, bh itself (Dropout::keep<false> reads the
// call's seed).
template <bool Groups>
__device__ __forceinline__ BlockDropout block_dropout(const SeedGroups& g,
                                                      int bh) {
  if constexpr (Groups) {
    return {g.placed(static_cast<uint32_t>(g.group_index(bh))) +
                g.group_base(bh),
            g.seed_of(bh)};
  } else {
    return {static_cast<uint32_t>(bh), 0u};
  }
}

// Fill in one call's dropout parameters on the host; false when the seed
// groups do not fit (more than kMaxSeedGroups, or not dividing the B*H
// blocks) or the placement does not hold the call's heads.  `seed_list`
// holds n_groups seeds (null with dropout off); (b_off, h_off, heads_g,
// group_stride) places the blocks, and matters only with dropout on.
inline bool set_dropout(Dropout& d, SeedGroups& g, int dropout,
                        const unsigned int* seed_list, int n_groups,
                        int bh_blocks, int heads, unsigned int thresh,
                        float inv, int tk_pad, int b_off, int h_off,
                        int heads_g, int group_stride) {
  d.on = dropout;
  d.seed = dropout ? seed_list[0] : 0u;
  d.threshold = thresh;
  d.inv_keep = inv;
  d.tk_p = static_cast<uint32_t>(tk_pad);
  for (int i = 0; i < kMaxSeedGroups; ++i) g.seeds[i] = 0;
  g.groups = 1;
  g.group_bh = bh_blocks > 0 ? bh_blocks : 1;
  g.heads = static_cast<uint32_t>(heads > 0 ? heads : 1);
  g.dheads = 0;
  g.base = 0;
  g.group_stride = 0;
  if (b_off < 0 || h_off < 0 || h_off + heads > heads_g || group_stride < 0)
    return false;
  if (!dropout) return true;
  g.dheads = static_cast<uint32_t>(heads_g - heads);
  g.group_stride = static_cast<uint32_t>(group_stride);
  g.base = static_cast<uint32_t>(b_off) * static_cast<uint32_t>(heads_g) +
           static_cast<uint32_t>(h_off);
  if (n_groups < 1 || n_groups > kMaxSeedGroups || bh_blocks % n_groups)
    return false;
  for (int i = 0; i < n_groups; ++i) g.seeds[i] = seed_list[i];
  g.groups = n_groups;
  g.group_bh = bh_blocks / n_groups > 0 ? bh_blocks / n_groups : 1;
  return true;
}

// Set a kernel's dynamic shared-memory limit once per process.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

// Blocks of `kernel` (`threads` threads, `bytes` of dynamic shared memory)
// that one SM of the current device holds, by the occupancy calculator.
template <typename Kernel>
__host__ cudaError_t blocks_per_sm(Kernel kernel, int bytes, int* blocks,
                                   int threads = kThreads) {
  bool done = false;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, bytes);
}

}  // namespace bpx_flash
