// K1: fused halo gather + k3 submanifold convolution on brick-dense voxels.
//
// Replaces the TPU kernel dropclip_tpu/sparse/pallas_conv.py::
// pallas_brick_conv3 (body _kernel). Computes exactly
// bricks.brick_conv(feats, level, w, ksize=3):
//
//   out[b, v, :] = occ[b, v] * sum_{t < 27} halo_b[v + off_t, :] @ w[t]
//
// where halo_b is brick b with a one-voxel border taken from the 26
// neighbour bricks nbr[b, t] (a row outside [0, Bm) reads zeros and is
// never dereferenced; the centre comes from nbr[b, 13], which real
// topologies set to b itself).
//
// Layouts (all contiguous): feats (Bm, bx, by, bz, C) float32 or bfloat16,
// nbr (Bm, 27) int32 in lexicographic (dx, dy, dz) order, w (27, C, Cout)
// in the feats dtype, out like feats with Cout channels. Any power-of-two
// brick shape, any C and Cout; float32 accumulation. The wrapper
// (kernels/brick_conv3.py::row_order) also passes, all on the device so
// that no host synchronisation is needed: every voxel row's 27-bit tap
// mask (masks; bit t set where the tap-t source exists and its features
// are not all zero), the occupied rows sorted by (mask, row) and then the
// empty ones (order, Bm*bx*by*bz int32), and the occupied count (n_occ).
//
// Bound. Only occupied output voxels are kept, and only live input voxels
// contribute: at (4, 4, 2) on tabletop scenes a sixth of the level-0
// slots are occupied and a row reads 8.3 of its 27 taps on average (14-17
// at levels 1-4). Counting those pairs, the 16 convs of one batch-8
// forward are 0.62 TFLOP, and the widest (level 0, 416 -> 384) does about
// 140 pair FLOPs per byte it must move in float32: operations bound the
// eight convs to 384 channels, which hold nearly all of the work; the
// narrow encoder convs are bound by bytes. float32 must stay
// float32-accurate (rtol 1e-4): one TF32 product (10 mantissa bits)
// misses that limit, so float32 costs three TF32 products and its bound
// is 3 * pairs at 495 TFLOP/s; bf16's is pairs at 989 TFLOP/s.
//
// Design (v3). v2 ran both dtypes on the CUDA cores (an 8 x 8 register
// tile per thread, gathers through registers) over every tap of every
// occupied row. v3 keeps its implicit GEMM over the occupied rows in
// `order`: one block per (128 rows, 128 output channels), the source row
// of each (tap, row) looked up once into shared memory, K ordered as
// (tap, input channel), blocks past n_occ writing zeros. In stages:
//  A  the products run on mma.sync tensor cores. Eight warps each own a
//     32 x 64 sub-tile. Each K step (one tap, 32 channels) is gathered by
//     16-byte cp.async (src-size 0 zero-fills a miss, which is never
//     dereferenced) with its weight slice into a ring, one barrier per
//     step; rows are padded by 16 bytes (A) and 8 elements (B) so that
//     fragment reads hit distinct banks. float32 splits each operand in
//     registers, hi = rna(x), lo = rna(x - hi) (rna in integer operations,
//     see tf32_rna), and runs lo*hi + hi*lo + hi*hi on m16n8k8 TF32
//     (3xTF32). The tensor cores truncate as they accumulate: one mma
//     chain over all of K drifted by up to 8.5e-5 of max|ref| and broke
//     the pillar-vs-brick check, so each 16 channels' products start
//     from zero and are added in round-to-nearest FADD.
//  B  bf16 ran m16n8k16 with fragments from ldmatrix on the same ring;
//     the output is rounded to bf16 once. v2 is gone. D replaced B.
//  C  a tile computes only the taps that one of its rows has a live
//     source at (the union of its rows' masks, listed once per block).
//     Skipped taps add only zeros, so no sum changes (for finite
//     weights). Rows sorted by mask (TorchSparse++'s bitmask order) share
//     masks, but almost every level-0 row has a mask of its own, so a
//     128-row tile still reads 19-21 of 27 taps.
//  D  bf16 runs on wgmma: the gathered rows land in a 128B-swizzled
//     K-major tile (64 channels a step), the weight slice in two
//     64-channel MN-major halves, and each warpgroup runs m64n64k16 for
//     its 64 rows and both halves straight from shared memory. The
//     descriptors are the forms attention v3 holds against a float32
//     product (K-major A, 64-wide MN-major B, 1024-byte group stride).
// float32 takes 32-channel steps in a 3-stage ring at one block per SM,
// which measured faster at every conv than 16-channel steps at two.
// Ragged channels (C or Cout not a multiple of 16 bytes, or unaligned
// tensors) fill shared memory element by element (kVec = false) on the
// same products and store scalars; kernels/brick_conv3.py::instance picks
// the instance. What bounds v3 (brick_conv_variants.py, which builds this
// file with parts taken out through K1_PROBE): float32 its three mma.sync
// products and the splits, bf16 the copies and the products about
// equally. Left for later: float32 on wgmma (TF32 wgmma takes B only
// K-major, so the weights need a transposed copy, and the split needs
// hi/lo B tiles), and a schedule finer than a tile's union of taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Bounds probe, 0 in the port: brick_conv_variants.py builds this file
// with -DK1_PROBE=<bits> to time it with a part taken out (1: the
// tensor-core products, 2: the global-to-shared copies, 4: two of
// float32's three TF32 products). A probe's results are wrong.
#ifndef K1_PROBE
#define K1_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;  // output voxel rows per block
constexpr int kTileN = 128;  // output channels per block
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

// Round to the nearest TF32 (10 mantissa bits), ties away from zero: half
// a TF32 ulp added to the magnitude bits, the low 13 bits cleared. For
// every finite x this is cvt.rna.tf32.f32(x), in two full-rate integer
// operations where cvt runs at a fraction of that rate (14% of K1's
// float32 time per forward, brick_conv_timing.py).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 21 mantissa bits: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Source voxel row of every (tap, output row) of the block; -1 reads zeros.
// row_m and row_mask hold each row's voxel and tap mask (bit t: the tap-t
// source exists and is live); a row past n_occ has mask 0.
__device__ __forceinline__ void build_src(int* src, const int* row_m,
                                          const unsigned* row_mask,
                                          const int* __restrict__ nbr,
                                          int bm, int bx, int by, int bz) {
  const int v = bx * by * bz;
  for (int i = threadIdx.x; i < kTaps * kTileM; i += kThreads) {
    const int t = i / kTileM, r = i % kTileM;
    int s = -1;
    if (row_mask[r] >> t & 1) {
      const int m = row_m[r];
      const int b = m / v, vox = m % v;
      const int x = vox / (by * bz) + t / 9 - 1;
      const int y = (vox / bz) % by + t / 3 % 3 - 1;
      const int z = vox % bz + t % 3 - 1;
      const int dx = x < 0 ? -1 : (x >= bx ? 1 : 0);
      const int dy = y < 0 ? -1 : (y >= by ? 1 : 0);
      const int dz = z < 0 ? -1 : (z >= bz ? 1 : 0);
      const int r_nb = nbr[(long long)b * kTaps + (dx + 1) * 9 +
                           (dy + 1) * 3 + (dz + 1)];
      if (r_nb >= 0 && r_nb < bm)
        s = r_nb * v + ((x - dx * bx) * by + (y - dy * by)) * bz +
            (z - dz * bz);
    }
    src[i] = s;
  }
}

// ---------------------------------------------------------------------------
// the tensor-core kernel

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

// Grid: one block per (128-row tile of `order`, 128-channel output tile),
// the channel tiles of a row tile adjacent, so that the blocks that gather
// the same rows run together. 8 warps: on mma.sync each owns a 32-row x
// 64-channel sub-tile, on wgmma each warpgroup 64 rows x 128 channels; K
// runs over (live tap, input channel) through a kStages-deep cp.async
// ring, one barrier per step.
template <class M, bool kVec, typename T = typename M::T>
__global__ void __launch_bounds__(kThreads, M::kMinBlocks)
brick_conv3_mma(const T* __restrict__ feats, const int* __restrict__ nbr,
                const T* __restrict__ w, const int* __restrict__ order,
                const int* __restrict__ n_occ, const int* __restrict__ masks,
                T* __restrict__ out, int bm, int bx, int by, int bz, int c,
                int cout) {
  using L = Layout<M>;
  extern __shared__ __align__(16) uint8_t dyn_smem[];
  uint8_t* smem = M::kWgmma ? align1024(dyn_smem) : dyn_smem;
  int* src = reinterpret_cast<int*>(smem + L::kSrcOffset);
  __shared__ int row_m[kTileM];
  __shared__ unsigned row_mask[kTileM];
  __shared__ int tap_list[kTaps];
  __shared__ unsigned tap_union;

  const int rows = bm * bx * by * bz;
  const int n_tiles = (cout + kTileN - 1) / kTileN;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;
  const int pos0 = (blockIdx.x / n_tiles) * kTileM;
  const int count = *n_occ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  if (pos0 < count) {  // block-uniform
    // the rows' voxels and tap masks, and their union: the taps that
    // some row of the block has a live source at
    if (threadIdx.x == 0) tap_union = 0u;
    __syncthreads();
    if (threadIdx.x < kTileM) {
      const int pos = pos0 + threadIdx.x;
      int m = 0;
      unsigned mk = 0u;
      if (pos < count) {
        m = order[pos];
        mk = (unsigned)masks[m];
      }
      row_m[threadIdx.x] = m;
      row_mask[threadIdx.x] = mk;
      mk = __reduce_or_sync(0xffffffffu, mk);
      if (lane == 0 && mk) atomicOr(&tap_union, mk);
    }
    __syncthreads();
    const unsigned taps = tap_union;
    if (threadIdx.x < kTaps && (taps >> threadIdx.x & 1))
      tap_list[__popc(taps & ((1u << threadIdx.x) - 1))] = threadIdx.x;
    build_src(src, row_m, row_mask, nbr, bm, bx, by, bz);
    __syncthreads();
    // K steps: (live tap, chunk of kBK input channels); a tap that no row
    // has a live source at is skipped, which changes no sum
    const int chunks = (c + L::kBK - 1) / L::kBK;
    const int steps = __popc(taps) * chunks;
#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      if (s < steps)
        load_step<M, kVec>(smem + s * L::kStageBytes, src, feats, w,
                           tap_list[s / chunks], (s % chunks) * L::kBK, n0,
                           c, cout);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<L::kStages - 2>();  // this step's copies have landed
      if constexpr (M::kWgmma) fence_proxy_async();
      __syncthreads();  // ... for every thread; the slot refilled below
                        // was last read in the previous step
      const int nxt = step + L::kStages - 1;
      if (nxt < steps)
        load_step<M, kVec>(smem + (nxt % L::kStages) * L::kStageBytes,
                           src, feats, w, tap_list[nxt / chunks],
                           (nxt % chunks) * L::kBK, n0, c, cout);
      cp_async_commit();
      mma_step(M(), acc, smem + (step % L::kStages) * L::kStageBytes, warp,
               n0, cout);
    }
    cp_async_wait<0>();
  }

  // Epilogue: occupied rows get their sums, empty rows zeros. Thread
  // (g, t4) of the m16n8 C layout holds rows g and g + 8, columns 2*t4
  // and 2*t4 + 1 of each n8 tile; acc[mi] is a 16-row tile of the warp
  // (mma.sync) or a 64-channel half of the warp's 16 rows (wgmma).
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = M::kWgmma ? warp * 16 : (warp % 4) * 32 + mi * 16;
      const int col = M::kWgmma ? mi * 64 : (warp / 4) * 64;
      const int pos = pos0 + row + g + 8 * h;
      if (pos >= rows) continue;
      const bool on = pos < count;
      T* o = out + (long long)order[pos] * cout;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int n = n0 + col + nj * 8 + 2 * t4;
        const float v0 = on ? acc[mi][nj][2 * h] : 0.f;
        const float v1 = on ? acc[mi][nj][2 * h + 1] : 0.f;
        if constexpr (kVec) {
          if (n < cout) store2(o + n, v0, v1);  // Cout is even
        } else {
          if (n < cout) store_as(o + n, v0);
          if (n + 1 < cout) store_as(o + n + 1, v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// launches

template <class M, bool kVec>
int launch_mma(const void* feats, const int* nbr, const void* w,
               const int* order, const int* n_occ, const int* masks,
               void* out, int bm, int bx, int by, int bz, int c, int cout,
               cudaStream_t stream) {
  using L = Layout<M>;
  using T = typename M::T;
  auto kernel = brick_conv3_mma<M, kVec>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  // as much shared memory as the SM has, so that two blocks fit
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  const long long rows = (long long)bm * bx * by * bz;
  const long long blocks =
      (rows + kTileM - 1) / kTileM * ((cout + kTileN - 1) / kTileN);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(feats), nbr, static_cast<const T*>(w), order,
      n_occ, masks, static_cast<T*>(out), bm, bx, by, bz, c, cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 = float32 3xTF32, 1 = float32 3xTF32 with ragged channels,
// 2 = bfloat16 on wgmma, 3 = bfloat16 on wgmma with ragged channels. Returns
// cudaGetLastError() after the launch (0 = launched).
int dropclip_brick_conv3(const void* feats, const int* nbr, const void* w,
                         const int* order, const int* n_occ,
                         const int* masks, void* out, int bm, int bx, int by,
                         int bz, int c, int cout, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_mma<Tf32x3, true>(feats, nbr, w, order, n_occ, masks,
                                      out, bm, bx, by, bz, c, cout, s);
    case 1:
      return launch_mma<Tf32x3, false>(feats, nbr, w, order, n_occ, masks,
                                       out, bm, bx, by, bz, c, cout, s);
    case 2:
      return launch_mma<Bf16Wgmma, true>(feats, nbr, w, order, n_occ, masks,
                                         out, bm, bx, by, bz, c, cout, s);
    case 3:
      return launch_mma<Bf16Wgmma, false>(feats, nbr, w, order, n_occ,
                                          masks, out, bm, bx, by, bz, c, cout,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
