// The tensor-core core of the k3 submanifold convs K1 (csrc/brick_conv3.cu)
// and K2 (csrc/pillar_conv3.cu): an implicit GEMM over 128 compacted
// output rows x 128 output channels, K ordered as (tap, input channel),
// with the source row of every (tap, row) looked up once into a shared
// table src[tap][row] (-1 reads zeros and is never dereferenced). Only
// that table knows the geometry: each kernel fills it through its own
// source map (fill_src), and everything here is geometry-free.
//
// Instances (picked by kernels/brick_conv3.py::instance for both):
//   Tf32x3     float32 through 3xTF32 on mma.sync m16n8k8: each operand
//              split hi = rna(x), lo = rna(x - hi) in integer operations
//              (tf32_rna, csrc/tf32x3.cuh), lo*hi + hi*lo + hi*hi; each 16
//              channels' products start from zero and are added in
//              round-to-nearest FADD, since the tensor cores truncate as
//              they accumulate (one chain as long as K drifted by 8.5e-5
//              of max|ref|).
//   Bf16Wgmma  bf16 on wgmma m64n64k16 from 128B-swizzled tiles: the
//              gathered rows K-major, the weight slice in two 64-channel
//              MN-major halves.
// Both run through a kStages-deep cp.async ring with one barrier per K
// step (run_steps); kVec = false fills shared memory element by element
// (ragged channels or unaligned tensors) on the same products.
//
// The design notes, bounds and measurements are in the two kernels'
// header notes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // tf32_rna, split_tf32, mma_tf32

// Bounds probe, 0 in the port: brick_conv_variants.py builds K1 with
// -DK1_PROBE=<bits> to time it with a part taken out (1: the tensor-core
// products, 2: the global-to-shared copies, 4: two of float32's three
// TF32 products). A probe's results are wrong.
#ifndef K1_PROBE
#define K1_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;  // output rows per tile
constexpr int kTileN = 128;  // output channels per tile
constexpr int kTaps = 27;

// ---------------------------------------------------------------------------
// helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  if ((K1_PROBE & 2) != 0) return;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The 128-byte swizzle of wgmma: 16-byte chunk c of row r lies at chunk
// c ^ (r & 7). The hardware takes r from address bits 7-9, so every tile
// starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Shared-memory matrix descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (both 1024 bytes, the step between 8-row
// groups; for K-major operands and 64-wide MN-major ones the hardware
// reads only the stride offset) and the swizzle mode. Each field counts
// 16-byte units, so adding n to the descriptor moves its start n*16 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// makes cp.async's (generic proxy) writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across this point:
// wgmma writes its accumulators after its asm statement has returned,
// until the wait.
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A K-major and B MN-major
// (n contiguous), both 128B-swizzled in shared memory. Per warp w of the
// warpgroup, d holds rows 16w..16w+15 in the mma.sync m16n8 C layout:
// d[4j + e] is row g + 8*(e/2), column 8j + 2*t4 + e%2.
__device__ __forceinline__ void wgmma_n64_kmaj_mn(float (&d)[32], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// ---------------------------------------------------------------------------
// the instances and their K step

// Per instance: input channels per K step, ring depth, and the resident
// blocks per SM that ptxas budgets registers for.
// kWgmma: products on wgmma from 128B-swizzled tiles (64-channel steps),
// else on mma.sync from padded rows.
struct Tf32x3 {
  using T = float;
  static constexpr int kBK = 32;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kWgmma = false;
};

struct Bf16Wgmma {
  using T = __nv_bfloat16;
  static constexpr int kBK = 64;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 2;
  static constexpr bool kWgmma = true;
};

template <class M>
struct Layout {
  using T = typename M::T;
  static constexpr int kBK = M::kBK;
  static constexpr int kStages = M::kStages;
  static constexpr int kE = 16 / sizeof(T);    // elements per 16-byte copy
  static constexpr int kAS = kBK + kE;         // A row stride, padded
  static constexpr int kBS = kTileN + 8;       // B row stride
  // wgmma: A as 128 rows of 128 bytes, B as two 64-channel halves of kBK
  // rows of 128 bytes, all swizzled; the ring starts 1024-byte aligned
  static_assert(!M::kWgmma || kBK * sizeof(T) == 128, "128-byte rows");
  static constexpr int kABytes =
      M::kWgmma ? kTileM * 128 : kTileM * kAS * sizeof(T);
  static constexpr int kBHalf = kBK * 128;
  static constexpr int kBBytes =
      M::kWgmma ? 2 * kBHalf : kBK * kBS * sizeof(T);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSlack = M::kWgmma ? 1024 : 0;
  static constexpr int kSrcOffset = kStages * kStageBytes;
  static constexpr int kBytes = kSlack + kSrcOffset + kTaps * kTileM * 4;
  static constexpr int kACopies = kTileM * kBK / kE / kThreads;
  static constexpr int kBCopies = kBK * kTileN / kE / kThreads;
  static_assert(kACopies * kE * kThreads == kTileM * kBK, "A tile copies");
  static_assert(kBCopies * kE * kThreads == kBK * kTileN, "B tile copies");
};

// One K step (tap t, channels [c0, c0 + kBK)) into ring slot `stage`: the
// gathered A tile (128 source rows) and the weight slice B (kBK x 128).
// kVec: 16-byte cp.async, zero-filled for a miss or past C / Cout (needs C
// and Cout multiples of 16 bytes' elements and 16-byte aligned tensors);
// otherwise element by element through registers (ragged channels).
template <class M, bool kVec, typename T = typename M::T>
__device__ __forceinline__ void load_step(uint8_t* stage, const int* src,
                                          const T* __restrict__ feats,
                                          const T* __restrict__ w, int t,
                                          int c0, int n0, int c, int cout) {
  using L = Layout<M>;
  T* a_sm = reinterpret_cast<T*>(stage);
  T* b_sm = reinterpret_cast<T*>(stage + L::kABytes);
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < L::kACopies; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / (L::kBK / L::kE), ch = idx % (L::kBK / L::kE);
    const int s = src[t * kTileM + r];
    const int k = c0 + ch * L::kE;
    T* dst = M::kWgmma ? reinterpret_cast<T*>(stage + swz(r, ch))
                       : a_sm + r * L::kAS + ch * L::kE;
    const T* p = feats + (long long)s * c + k;
    if constexpr (kVec) {
      const bool in = s >= 0 && k < c;
      cp_async16(dst, in ? p : feats, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < L::kE; ++e)
        dst[e] = (s >= 0 && k + e < c) ? p[e] : zero<T>();
    }
  }
#pragma unroll
  for (int i = 0; i < L::kBCopies; ++i) {
    const int idx = tid + i * kThreads;
    const int kr = idx / (kTileN / L::kE), ch = idx % (kTileN / L::kE);
    const int k = c0 + kr, n = n0 + ch * L::kE;
    T* dst = M::kWgmma ? reinterpret_cast<T*>(stage + L::kABytes +
                                              (ch / 8) * L::kBHalf +
                                              swz(kr, ch % 8))
                       : b_sm + kr * L::kBS + ch * L::kE;
    const T* p = w + ((long long)t * c + k) * cout + n;
    if constexpr (kVec) {
      const bool in = k < c && n < cout;
      cp_async16(dst, in ? p : w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < L::kE; ++e)
        dst[e] = (k < c && n + e < cout) ? p[e] : zero<T>();
    }
  }
}

// One step's products for this warp's 32 x 64 sub-tile (2 x 8 m16n8 tiles).
// The tensor cores truncate as they accumulate, so a chain of mma over all
// of K (up to 27 * 416 / 8 * 3 products) drifts by about 1e-4 of the sum;
// instead each 16 channels' 6 products per tile start from zero and are
// added to acc with round-to-nearest FADD.
__device__ __forceinline__ void mma_step(Tf32x3, float (&acc)[2][8][4],
                                         const uint8_t* stage, int warp,
                                         int n0, int cout) {
  using L = Layout<Tf32x3>;
  const int wm = warp % 4, wn = warp / 4;
  static_assert(L::kBK % 16 == 0, "pairs of k8 slices per step");
  const float* a_sm = reinterpret_cast<const float*>(stage);
  const float* b_sm = reinterpret_cast<const float*>(stage + L::kABytes);
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < L::kBK; k0 += 16) {
    uint32_t ahi[2][2][4], alo[2][2][4];  // [k8 slice][m16 tile][fragment]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p =
            a_sm + (wm * 32 + mi * 16 + g) * L::kAS + k0 + kk * 8 + t4;
        split_tf32(p[0], ahi[kk][mi][0], alo[kk][mi][0]);
        split_tf32(p[8 * L::kAS], ahi[kk][mi][1], alo[kk][mi][1]);
        split_tf32(p[4], ahi[kk][mi][2], alo[kk][mi][2]);
        split_tf32(p[8 * L::kAS + 4], ahi[kk][mi][3], alo[kk][mi][3]);
      }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int n = wn * 64 + nj * 8;
      if (n0 + n >= cout) continue;  // warp-uniform
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* p = b_sm + (k0 + kk * 8 + t4) * L::kBS + n + g;
        uint32_t bhi0, blo0, bhi1, blo1;
        split_tf32(p[0], bhi0, blo0);
        split_tf32(p[4 * L::kBS], bhi1, blo1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr ((K1_PROBE & 1) != 0) {  // fragments still made
            part[mi][0] += __uint_as_float(ahi[kk][mi][0] ^ alo[kk][mi][1] ^
                                           bhi0 ^ blo1);
            continue;
          }
          if constexpr ((K1_PROBE & 4) == 0) {
            mma_tf32(part[mi], alo[kk][mi], bhi0, bhi1);
            mma_tf32(part[mi], ahi[kk][mi], blo0, blo1);
          }
          mma_tf32(part[mi], ahi[kk][mi], bhi0, bhi1);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][e];
    }
  }
}

// The same on wgmma: warpgroup wg owns rows [64 wg, 64 wg + 64) and both
// 64-channel halves of the tile (acc[h] is the half's 32 accumulators).
__device__ __forceinline__ void mma_step(Bf16Wgmma, float (&acc)[2][8][4],
                                         const uint8_t* stage, int warp,
                                         int n0, int cout) {
  using L = Layout<Bf16Wgmma>;
  const uint64_t a = sw128_desc(stage + (warp / 4) * 64 * 128);
  const uint64_t b = sw128_desc(stage + L::kABytes);
  float(&d0)[32] = reinterpret_cast<float(&)[32]>(acc[0]);
  float(&d1)[32] = reinterpret_cast<float(&)[32]>(acc[1]);
  const bool hi = n0 + 64 < cout;  // block-uniform
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk) {
    // k16 slice kk: 32 bytes into A's rows, 16 rows (2048 bytes) into B
    if constexpr ((K1_PROBE & 1) != 0) continue;
    wgmma_n64_kmaj_mn(d0, a + 2 * kk, b + 128 * kk);
    if (hi) wgmma_n64_kmaj_mn(d1, a + 2 * kk, b + (L::kBHalf >> 4) + 128 * kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(d0);
  reg_fence(d1);
}

// ---------------------------------------------------------------------------
// what the kernels share around the products

// src[t * kTileM + r] = map(t, r) for the taps t in [t0, t1) and every row
// r of the tile: the source map is the only geometry of a kernel. With
// `live` (shared, zeroed by the caller), live[t] is set to 1 where some
// row of the tile has a tap-t source.
template <class Map>
__device__ __forceinline__ void fill_src(int* src, const Map& map, int t0,
                                         int t1, int* live = nullptr) {
  for (int i = threadIdx.x; i < (t1 - t0) * kTileM; i += kThreads) {
    const int t = t0 + i / kTileM, r = i % kTileM;
    const int s = map(t, r);
    src[t * kTileM + r] = s;
    if (live != nullptr && s >= 0) live[t] = 1;
  }
}

// The K loop of one tile: `steps` steps of (tap tap_list[step / chunks],
// kBK input channels from (step % chunks) * kBK) through the cp.async ring,
// products added to acc. Leaves no copy in flight; the caller zeroes acc
// and syncs before the ring or src is written again.
template <class M, bool kVec, typename T = typename M::T>
__device__ __forceinline__ void run_steps(float (&acc)[2][8][4],
                                          uint8_t* smem, const int* src,
                                          const int* tap_list, int steps,
                                          const T* __restrict__ feats,
                                          const T* __restrict__ w, int n0,
                                          int c, int cout) {
  using L = Layout<M>;
  const int warp = threadIdx.x / 32;
  const int chunks = (c + L::kBK - 1) / L::kBK;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < steps)
      load_step<M, kVec>(smem + s * L::kStageBytes, src, feats, w,
                         tap_list[s / chunks], (s % chunks) * L::kBK, n0, c,
                         cout);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<L::kStages - 2>();  // this step's copies have landed
    if constexpr (M::kWgmma) fence_proxy_async();
    __syncthreads();  // ... for every thread; the slot refilled below
                      // was last read in the previous step
    const int nxt = step + L::kStages - 1;
    if (nxt < steps)
      load_step<M, kVec>(smem + (nxt % L::kStages) * L::kStageBytes, src,
                         feats, w, tap_list[nxt / chunks],
                         (nxt % chunks) * L::kBK, n0, c, cout);
    cp_async_commit();
    mma_step(M(), acc, smem + (step % L::kStages) * L::kStageBytes, warp,
             n0, cout);
  }
  cp_async_wait<0>();
}

// f(row, col, v0, v1) for every pair of this thread's accumulators: v0 at
// (row, col) and v1 at (row, col + 1) of the 128 x 128 tile. Thread
// (g, t4) of the m16n8 C layout holds rows g and g + 8, columns 2*t4 and
// 2*t4 + 1 of each n8 tile; acc[mi] is a 16-row tile of the warp
// (mma.sync: the warp owns 32 rows x 64 channels) or a 64-channel half of
// the warp's 16 rows (wgmma: the warpgroup owns 64 rows x 128 channels).
template <class M, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[2][8][4],
                                              F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = M::kWgmma ? warp * 16 : (warp % 4) * 32 + mi * 16;
      const int col = M::kWgmma ? mi * 64 : (warp / 4) * 64;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        f(row + g + 8 * h, col + nj * 8 + 2 * t4, acc[mi][nj][2 * h],
          acc[mi][nj][2 * h + 1]);
    }
}

// The launches' shared-memory setup: dynamic bytes above 48 KB, and as
// much shared memory as the SM has, so that kMinBlocks blocks fit.
template <class M, class K>
cudaError_t set_smem(K kernel) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<M>::kBytes);
  if (attr != cudaSuccess) return attr;
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  return cudaSuccess;
}

}  // namespace
