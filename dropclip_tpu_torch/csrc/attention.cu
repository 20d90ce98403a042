// K3, K4 and K5: multi-head attention for one (batch, head, 64-query tile)
// per block, with an online softmax over 64-key tiles.
//
// Replaces three TPU kernels of dropclip_tpu/ops/attention.py:
//   K3 oneshot_attention_packed (body _kernel_packed): q/k/v packed as
//      (B, T, H*D), the raw projection outputs of the CLIP ViT;
//   K4 oneshot_attention (body _kernel): q/k/v as (B, T, H, D);
//   K5 flash_attention_padded (the library's TPU flash kernel): (B, T, H, D)
//      with an optional causal mask and any T.
// A contiguous (B, T, H, D) tensor has the memory layout of a packed
// (B, T, H*D) one, so all three are this one source: token t of head h
// starts at element (b*T + t)*H*D + h*D. The TPU needed two kernels only
// because of the transposes XLA put around the per-head one.
//
// Four instances, chosen by the wrapper (kernels/attention.py) from the
// type and the head dim: v3 (bf16, D = 64, the head dim of the OpenAI CLIP
// and DINO towers), d80 (bf16, D = 80: OpenCLIP ViT-H/14), v2 (bf16, D = 16
// and 32) and f32x3 (float32, D = 16, 32 and 64: DINO v1's teacher and
// `build_clip`'s default dtype).
//
// Numerics, the same in all three and those of the TPU body: logits
// s = q.k in float32, then exp2(s * scale*log2(e) - m) with keys past T
// (and, if causal, past the query) masked to -inf; the unnormalised
// probabilities are rounded to the input type before the P.V product,
// which accumulates in float32, and the (T, D) output is divided by the
// float32 row sum. Unlike the TPU body the row maximum m is a running one
// (online softmax): each new key tile rescales the running sum and output
// by exp2(m_old - m_new). That rounds the probabilities against another
// maximum, so results differ from the one-pass order by a few bf16 ulps;
// chip_smoke.py and the cuda tests state the tolerance. Key and value rows
// past T are loaded as zeros, so nothing past the tensor is read and
// 0 * Inf cannot leak; query rows past T are computed on zeros and never
// written.
//
// Bound. At the ViT-L teacher's shape (B=96, T=769, H=16, D=64, bf16) one
// call does 4*B*H*T^2*D = 232.5 GFLOP in the two matmuls and must move
// 4*B*T*H*D*2 bytes = 605 MB (q, k, v in, o out): 0.235 ms at 989 TFLOP/s
// against 0.18 ms at 3.35 TB/s, so it is bound by operations. No (T, T)
// matrix goes to device memory.
//
// v3 (bf16, D = 64) replaces v2 at that type and head dim, which are all
// the port's paths run (ViT-L/14@336px vision 1024/16, DINO 384/6, text
// 768/12). v2 ran 1.2448 ms at the teacher's shape (187 TFLOP/s, 5.3x the
// bound) against 0.7978 ms for F.scaled_dot_product_attention, K5 at
// (8, 3073, 16, 64) 1.4227 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// What held v2 back: the legacy mma.sync path, each warp reading whole K
// and V tiles from shared memory by ldmatrix, and the one-key 13th key
// tile at T = 769 computed in full. Design:
// - one warpgroup (128 threads) per (batch, head, 64-row query tile),
//   v2's grid. Q, K and V tiles are 64 rows of exactly 128 bytes, staged
//   by cp.async (16-byte copies, zero-filled past T) into the 128-byte
//   swizzle that wgmma reads, each tile on a 1024-byte boundary;
// - S = Q.K^T is four wgmma.m64n64k16 k-steps with both operands in
//   shared memory (K-major). The accumulator of each warp has the
//   mma.sync m16n8 C layout, so the online softmax runs on it in
//   registers, and the probabilities, packed to bf16, are the register A
//   operand of O += P.V (the RS form, four k-steps over the keys), whose
//   B is the V tile as it lies in memory (MN-major, the same swizzle);
// - the softmax, not the tensor cores, bounds a 64 x 64 tile step: per
//   element it costs about as much on the FP32 and special-function pipes
//   as the two products do on the tensor cores. So the maximum is taken on
//   the raw logits, exp2(s * scale - m) is one fma into ex2.approx.ftz,
//   and a warp rescales O only when a row maximum of its 16 rows moved;
// - a ragged last key tile of at most 16 keys runs at n16 and one P.V
//   k-step (T = 769: 784 keys of work instead of 832);
// - K and V stream through a two-stage ring, so tile kt+1 loads while
//   tile kt computes, with one barrier per tile; after each cp.async
//   wait, fence.proxy.async makes the copies visible to wgmma's async
//   proxy before the barrier. 41 KB of shared memory and 90 registers
//   let five blocks share an SM, so one block's softmax overlaps the
//   others' products.
// Not used: TMA, mbarriers, warp specialisation, a persistent grid. Two
// variants were measured slower and are not kept (PERF.md, Findings): two
// warpgroups per 128-row block sharing each K/V tile on a 3-stage ring
// (98 registers: two blocks per SM, both warpgroups in lockstep), and
// the next tile's S issued with this tile's P.V, its softmax run under
// wgmma.wait_group 1 (106 registers, four blocks per SM, fences that
// ptxas inserts around the register operands).
//
// v2 (bf16, D = 16 and 32) runs both products on mma.sync from padded
// tiles (ldmatrix), one warp per 16 query rows.
//
// f32x3 (float32) runs both products on the TF32 tensor cores in 3xTF32
// (csrc/tf32x3.cuh, K1's split) on v2's grid: at D = 64 on wgmma, at D = 16
// and 32 on mma.sync; its notes are at the kernels. Bound: at DINO v1
// S/8's (1, 16130, 6, 64) one call does 399.6 GFLOP, three TF32 products
// each: 2.42 ms at 495 TFLOP/s, against 0.025 ms for its 25 MB (5.26 ms,
// 0.46 of it, on the card). The instance it replaces ran both products as
// scalar FMAs on the CUDA cores (26.88 ms there, 14.9 TFLOP/s, slower than
// its plain version's 21.12 and SDPA's 11.96; NVIDIA H100 80GB HBM3, 700
// W, PERF.md): a quarter of a float4 shared-memory broadcast per FMA, a
// warp shuffle per key (two threads shared a query row) and 64 logits, 32
// q values and 32 accumulators live per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32x3.cuh"  // split_tf32, mma_tf32x3

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
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

// v2: the bf16 instance at D = 16 and 32
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int T, int H,
                     float scale_log2, int causal) {
  static_assert(D % 16 == 0 && D <= 64, "head dim");
  constexpr int LD = D + 8;  // padded row (16 bytes) of every tile
  constexpr int CH = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sQ[kBQ][LD];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBK][LD];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBK][LD];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)blockIdx.z * T * row_stride + (long long)h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // stage the rows [r0, r0 + 64) of src into dst, zeros past T
  auto stage = [&](__nv_bfloat16 (*dst)[LD], const __nv_bfloat16* src, int r0) {
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r0 + r < T;
      const __nv_bfloat16* p = src + base + (in ? (r0 + r) * row_stride + c : 0);
      cp_async16(&dst[r][c], p, in ? 16 : 0);
    }
  };
  stage(sQ, q, q0);
  stage(sK[0], k, 0);
  stage(sV[0], v, 0);
  cp_async_commit();

  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  const int row_q[2] = {q0 + wr, q0 + wr + 8};
  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  // ldmatrix lane roles: matrix m = lane / 8, row r = lane % 8
  const int lm = lane >> 3, lr = lane & 7;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {  // prefetch the next tile into the other stage
      stage(sK[buf ^ 1], k, (kt + 1) * kBK);
      stage(sV[buf ^ 1], v, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = ld32(&sQ[wr][kk * 16 + tg * 2]);
        qa[kk][1] = ld32(&sQ[wr + 8][kk * 16 + tg * 2]);
        qa[kk][2] = ld32(&sQ[wr][kk * 16 + 8 + tg * 2]);
        qa[kk][3] = ld32(&sQ[wr + 8][kk * 16 + 8 + tg * 2]);
      }
    }
    const int k0 = kt * kBK;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys; one
    // ldmatrix.x4 gives the B fragments of two 8-key slices
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, &sK[buf][nt * 8 + (lm >> 1) * 8 + lr][kk * 16 + (lm & 1) * 8]);
        mma_bf16(s[nt], qa[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, mask where the tile needs it, running maximum per row
    const bool full = k0 + kBK <= T && (!causal || k0 + kBK - 1 <= q0);
    float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        float x = s[nt][e] * scale_log2;
        if (!full) {
          const int key = k0 + nt * 8 + tg * 2 + (e & 1);
          if (key >= T || (causal && key > row_q[ri])) x = -CUDART_INF_F;
        }
        s[nt][e] = x;
        m_tile[ri] = fmaxf(m_tile[ri], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 1));
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 2));
      const float m_new = fmaxf(m_run[ri], m_tile[ri]);
      // a row with no key yet keeps m = -inf; exp2 against 0 then gives 0
      m_use[ri] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[ri] = exp2f(m_run[ri] - m_use[ri]);
      m_run[ri] = m_new;
      l_run[ri] *= alpha[ri];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P V: the S accumulators of key slices 2kk and 2kk+1 are the A
    // fragment of key step kk; ldmatrix.trans gives V's B fragments for
    // two 8-wide slices of D at once
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sV[buf][kk * 16 + (lm & 1) * 8 + lr][n * 8 + (lm >> 1) * 8]);
        mma_bf16(acc[n], pa, b[0], b[1]);
        mma_bf16(acc[n + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[ri] = 1.f / l;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row_q[ri] >= T) continue;
    __nv_bfloat16* orow = o + base + row_q[ri] * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[n][2 * ri] * inv[ri], acc[n][2 * ri + 1] * inv[ri]);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tg * 2) = val;
    }
  }
}

// ---- v3: the bf16 instance at D = 64, on wgmma ----------------------------

constexpr int kTile = 64 * 128;  // one 64 x 64 bf16 tile: 64 rows of 128 bytes

// The 128-byte swizzle of wgmma: 16-byte chunk c of row r lies at chunk
// c ^ (r & 7). The hardware takes r from address bits 7-9, so every tile
// starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// makes cp.async's (generic proxy) writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across this point:
// wgmma writes its accumulators (and reads its A registers) after its
// asm statement has returned, until wgmma_wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define V3_D32                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define V3_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A and B K-major in shared
// memory (SS). Per warp w of the warpgroup, d holds rows 16w..16w+15 in
// the mma.sync m16n8 C layout: d[4j + e] is row g + 8*(e/2), column
// 8j + 2*tg + e%2 (g = lane/4, tg = lane%4).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " V3_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : V3_D32
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d (64 x 16) += A (64 x 16) B (16 x 16), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// the same with A in registers (RS; the mma.sync m16n8k16 A fragment of
// the warp's 16 rows) and B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " V3_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : V3_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// One key tile of v3 for one warpgroup: S = Q K^T on wgmma, the online
// softmax on its accumulators, O += P V on wgmma. NB 8-key slices: 8 for a
// tile of 64 keys, 2 for a last tile that holds at most 16 (n16 for S, one
// k-step for P V); the keys past T in it are masked.
template <int NB>
__device__ __forceinline__ void v3_tile(float (&acc)[32], float (&m_run)[2],
                                        float (&l_run)[2], uint64_t dq,
                                        uint64_t dk, uint64_t dv, int k0,
                                        int q0, const int (&row_q)[2],
                                        int tg, int T, float scale_log2,
                                        int causal) {
  constexpr int D = 64;
  // S = Q K^T: four k-steps of 16 over D, 32 bytes along the rows
  float s[4 * NB];
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);

  // mask where the tile needs it; the running maximum per row is taken on
  // the raw logits and then scaled (scale_log2 > 0 and rounding is
  // monotonic, so it is the maximum of the scaled logits, as in v2), and
  // exp2(s * scale_log2 - m) is one fma into ex2 (ex2.approx.ftz differs
  // from exp2f only below 2^-126)
  const bool full = k0 + 8 * NB <= T && (!causal || k0 + 8 * NB - 1 <= q0);
  float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) {
    const int ri = (i >> 1) & 1;
    if (!full) {
      const int key = k0 + (i >> 2) * 8 + tg * 2 + (i & 1);
      if (key >= T || (causal && key > row_q[ri])) s[i] = -CUDART_INF_F;
    }
    m_tile[ri] = fmaxf(m_tile[ri], s[i]);
  }
  float alpha[2], m_use[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 1));
    m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 2));
    const float m_new = fmaxf(m_run[ri], m_tile[ri] * scale_log2);
    // a row with no key yet keeps m = -inf; exp2 against 0 then gives 0
    m_use[ri] = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[ri] = ex2(m_run[ri] - m_use[ri]);
    m_run[ri] = m_new;
    l_run[ri] *= alpha[ri];
  }
  // O changes only where a row's maximum moved (alpha is exactly 1
  // elsewhere); the warp skips the rescale when no row of its 16 did
  if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
    s[i] = p;
    l_run[(i >> 1) & 1] += p;
  }

  // O += P V: the S accumulators of key slices 2kk and 2kk+1, packed to
  // bf16, are the A fragment of key step kk (RS); V is B as it lies in
  // memory, MN-major, and each key step starts 16 rows (2048 bytes) on
  uint32_t pa[NB / 2][4];
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  wgmma_fence();  // orders the rescaled acc and P before wgmma reads them
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) wgmma_rs_n64_mn(acc, pa[kk], dv + 128 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) reg_fence(pa[kk]);
}

// v3: one warpgroup per (batch, head, 64-row query tile), v2's grid.
__global__ void __launch_bounds__(kThreads)
    attention_kernel_v3(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int T, int H,
                        float scale_log2, int causal) {
  constexpr int D = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + kTile;      // two stages
  uint8_t* sV = sK + 2 * kTile;  // two stages

  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = (long long)H * D;
  const long long base =
      (long long)blockIdx.z * T * row_stride + (long long)blockIdx.y * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // stage the rows [r0, r0 + 64) of src into a swizzled tile, zeros past T
  auto stage = [&](uint8_t* dst, const __nv_bfloat16* src, int r0) {
#pragma unroll
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const bool in = r0 + r < T;
      const __nv_bfloat16* p =
          src + base + (in ? (r0 + r) * row_stride + c * 8 : 0);
      cp_async16(dst + swz(r, c), p, in ? 16 : 0);
    }
  };
  stage(sQ, q, q0);
  stage(sK, k, 0);
  stage(sV, v, 0);
  cp_async_commit();

  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  const int row_q[2] = {q0 + wr, q0 + wr + 8};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint64_t dq = sw128_desc(sQ);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();  // tile kt has landed
    fence_proxy_async();
    // every thread is done with tile kt - 1, whose stage is refilled now
    // with tile kt + 1 while tile kt computes
    __syncthreads();
    if (kt + 1 < n_tiles) {
      stage(sK + (buf ^ 1) * kTile, k, (kt + 1) * kBK);
      stage(sV + (buf ^ 1) * kTile, v, (kt + 1) * kBK);
      cp_async_commit();
    }
    const int k0 = kt * kBK;
    const uint64_t dk = sw128_desc(sK + buf * kTile);
    const uint64_t dv = sw128_desc(sV + buf * kTile);
    if (T - k0 <= 16)  // a ragged last tile of at most 16 keys
      v3_tile<2>(acc, m_run, l_run, dq, dk, dv, k0, q0, row_q, tg, T,
                 scale_log2, causal);
    else
      v3_tile<8>(acc, m_run, l_run, dq, dk, dv, k0, q0, row_q, tg, T,
                 scale_log2, causal);
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[ri] = 1.f / l;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row_q[ri] >= T) continue;
    __nv_bfloat16* orow = o + base + row_q[ri] * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[4 * n + 2 * ri] * inv[ri], acc[4 * n + 2 * ri + 1] * inv[ri]);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tg * 2) = val;
    }
  }
}

// ---- d80: the bf16 instance at D = 80, on wgmma ---------------------------
//
// OpenCLIP ViT-H/14's heads (16 of 80 at width 1280). A row of 80 bf16 is
// 160 bytes, which no swizzle atom divides (128-byte rows for the 128-byte
// swizzle), so the tiles take wgmma's no-swizzle ("interleave") canonical
// layout: 8 rows x 16 bytes make one core matrix of 128 contiguous bytes
// (conflict-free for the tensor cores), the ten core matrices of 8 rows
// lie one after another (1280 bytes), and the 8-row groups follow. Chunk i
// of a tile (row 8 (i / 80) + i % 8, 16-byte chunk (i / 8) % 10) lies at
// byte 16 i, so the cp.async stage writes each tile contiguously, and a
// warp reads 64 bytes of each of 8 rows: whole 32-byte sectors. The same
// layout is K-major for Q and K (S = Q K^T: five k-steps of 16 dims, LBO
// the next 8 dims' core matrix, SBO the next 8 rows) and MN-major for V
// (O += P V at N = 80: SBO the next 8 dims, LBO the next 8 keys), so V is
// read as it lies, as in v3. The tensors are read in place: padding them
// to D = 128 in device memory would add 60% to the bytes of a launch that
// is bound by them.
//
// Bound. At ViT-H/14's ingest shape (B = 96 crops, T = 337, H = 16) one
// launch does 4 B H T^2 D = 55.8 GFLOP and moves 4 B T H D 2 = 331 MB:
// 0.056 ms at 989 TFLOP/s against 0.099 ms at 3.35 TB/s, so bytes bound
// it. A block is two warpgroups, each on 64 query rows, that share every
// K and V tile, so a (batch, head) reads its K and V from L2 once for 128
// query rows; a ragged last key tile runs at n16 or n32. Otherwise v3's
// design: the online softmax on the S accumulators in registers, P the
// register A operand of P V, a two-stage cp.async ring, one barrier a
// tile. 98 registers, 61 KB of shared memory: two blocks an SM. Measured
// at (96, 337, 16, 80) and not kept (PERF.md, Findings): one warpgroup a
// block 0.50 ms, three 0.36-0.37 ms, a 3- or 4-stage ring 0.334-0.335 ms,
// three blocks an SM (80 registers, 420 bytes spilled) 0.73 ms, against
// 0.329 ms here.

constexpr int kD80 = 80;
constexpr int kD80Tile = 64 * kD80 * 2;  // one 64-row tile: 10240 bytes
constexpr int kD80Warpgroups = 2;        // a block's 64-row query tiles
// the descriptors' byte offsets: K-major Q and K (LBO the next 8 dims, SBO
// the next 8 rows), MN-major V (LBO the next 8 keys, SBO the next 8 dims)
constexpr uint32_t kD80KLbo = 128, kD80KSbo = 1280;
constexpr uint32_t kD80VLbo = 1280, kD80VSbo = 128;

// Shared-memory matrix descriptor of a no-swizzle tile: start address and
// the leading and stride byte offsets, in 16-byte units (layout type 0).
__device__ __forceinline__ uint64_t plain_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 127) & ~127u) - a);
}

// d (64 x 32) += A (64 x 16) B (16 x 32), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d (64 x 80, f32) += A (64 x 16, registers: the mma.sync m16n8k16 A
// fragment of the warp's 16 rows) B (16 x 80, MN-major in shared memory);
// d[4j + e] is row g + 8 (e / 2), column 8j + 2 tg + e % 2
__device__ __forceinline__ void wgmma_rs_n80_mn(float (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// One key tile of d80 for one warpgroup, as v3_tile: NB 8-key slices (8
// for a full tile, 4 for a last tile of at most 32 keys, 2 for one of at
// most 16), the keys past T in it masked.
template <int NB>
__device__ __forceinline__ void d80_tile(float (&acc)[40], float (&m_run)[2],
                                         float (&l_run)[2], uint64_t dq,
                                         uint64_t dk, uint64_t dv, int k0,
                                         int q0, const int (&row_q)[2],
                                         int tg, int T, float scale_log2,
                                         int causal) {
  // S = Q K^T: five k-steps of 16 dims, two core matrices (256 bytes) each
  float s[4 * NB];
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD80 / 16; ++kk)
    wgmma_ss(s, dq + 16 * kk, dk + 16 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);

  const bool full = k0 + 8 * NB <= T && (!causal || k0 + 8 * NB - 1 <= q0);
  float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) {
    const int ri = (i >> 1) & 1;
    if (!full) {
      const int key = k0 + (i >> 2) * 8 + tg * 2 + (i & 1);
      if (key >= T || (causal && key > row_q[ri])) s[i] = -CUDART_INF_F;
    }
    m_tile[ri] = fmaxf(m_tile[ri], s[i]);
  }
  float alpha[2], m_use[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 1));
    m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 2));
    const float m_new = fmaxf(m_run[ri], m_tile[ri] * scale_log2);
    m_use[ri] = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[ri] = ex2(m_run[ri] - m_use[ri]);
    m_run[ri] = m_new;
    l_run[ri] *= alpha[ri];
  }
  if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
#pragma unroll
  for (int i = 0; i < 4 * NB; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
    s[i] = p;
    l_run[(i >> 1) & 1] += p;
  }

  // O += P V: key step kk starts two 8-key groups (2560 bytes) on
  uint32_t pa[NB / 2][4];
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) wgmma_rs_n80_mn(acc, pa[kk], dv + 160 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) reg_fence(pa[kk]);
}

// d80: two warpgroups per (batch, head, 128-row query tile); warpgroup w
// takes rows 64 w..64 w + 63 of the tile.
__global__ void __launch_bounds__(kThreads * kD80Warpgroups)
    attention_kernel_d80(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int T, int H,
                         float scale_log2, int causal) {
  constexpr int D = kD80, WG = kD80Warpgroups;
  constexpr int kRows = kBQ * WG;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align128(smem_raw);  // WG tiles
  uint8_t* sK = sQ + WG * kD80Tile;  // two stages
  uint8_t* sV = sK + 2 * kD80Tile;   // two stages

  const int qb = blockIdx.x * kRows;
  const long long row_stride = (long long)H * D;
  const long long base =
      (long long)blockIdx.z * T * row_stride + (long long)blockIdx.y * D;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int q0 = qb + kBQ * wg;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (qb + kRows - 1) / kBK + 1);

  // stage the rows [r0, r0 + n) of src, zeros past T: chunk i at byte 16 i
  auto stage = [&](uint8_t* dst, const __nv_bfloat16* src, int r0, int n) {
#pragma unroll
    for (int i = tid; i < n * kChunks; i += kThreads * WG) {
      const int r = (i / (8 * kChunks)) * 8 + (i & 7);
      const int c = (i >> 3) % kChunks;
      const bool in = r0 + r < T;
      const __nv_bfloat16* p =
          src + base + (in ? (long long)(r0 + r) * row_stride + c * 8 : 0);
      cp_async16(dst + 16 * i, p, in ? 16 : 0);
    }
  };
  stage(sQ, q, qb, kRows);
  stage(sK, k, 0, kBK);
  stage(sV, v, 0, kBK);
  cp_async_commit();

  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  const int row_q[2] = {q0 + wr, q0 + wr + 8};
  float acc[40];
#pragma unroll
  for (int i = 0; i < 40; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const uint64_t dq = plain_desc(sQ + wg * kD80Tile, kD80KLbo, kD80KSbo);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();  // tile kt has landed
    fence_proxy_async();
    // every thread is done with tile kt - 1, whose stage is refilled now
    // with tile kt + 1 while tile kt computes
    __syncthreads();
    if (kt + 1 < n_tiles) {
      stage(sK + (buf ^ 1) * kD80Tile, k, (kt + 1) * kBK, kBK);
      stage(sV + (buf ^ 1) * kD80Tile, v, (kt + 1) * kBK, kBK);
      cp_async_commit();
    }
    const int k0 = kt * kBK;
    const uint64_t dk = plain_desc(sK + buf * kD80Tile, kD80KLbo, kD80KSbo);
    const uint64_t dv = plain_desc(sV + buf * kD80Tile, kD80VLbo, kD80VSbo);
    if (T - k0 <= 16)
      d80_tile<2>(acc, m_run, l_run, dq, dk, dv, k0, q0, row_q, tg, T,
                  scale_log2, causal);
    else if (T - k0 <= 32)
      d80_tile<4>(acc, m_run, l_run, dq, dk, dv, k0, q0, row_q, tg, T,
                  scale_log2, causal);
    else
      d80_tile<8>(acc, m_run, l_run, dq, dk, dv, k0, q0, row_q, tg, T,
                  scale_log2, causal);
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[ri] = 1.f / l;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row_q[ri] >= T) continue;
    __nv_bfloat16* orow = o + base + (long long)row_q[ri] * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[4 * n + 2 * ri] * inv[ri], acc[4 * n + 2 * ri + 1] * inv[ri]);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tg * 2) = val;
    }
  }
}

// Descriptor self-test (a test oracle; no path of the port calls it): one
// 64 x 64 x 64 product on wgmma from 64 x 64 bf16 row-major a and b.
// mode 0: c = a b^T, a and b K-major in shared memory (the S = Q K^T form);
// mode 1: c = a b, a in registers, b MN-major in shared memory (the P V
// form). c is float32 row-major.
__global__ void __launch_bounds__(kThreads)
    wgmma_selftest_kernel(const __nv_bfloat16* __restrict__ a,
                          const __nv_bfloat16* __restrict__ b,
                          float* __restrict__ c, int mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align1024(smem_raw);
  uint8_t* sB = sA + kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  for (int i = tid; i < 64 * 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7;
    cp_async16(sA + swz(r, ch), a + r * 64 + ch * 8, 16);
    cp_async16(sB + swz(r, ch), b + r * 64 + ch * 8, 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int row = warp * 16 + g;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    af[kk][0] = ld32(a + row * 64 + kk * 16 + tg * 2);
    af[kk][1] = ld32(a + (row + 8) * 64 + kk * 16 + tg * 2);
    af[kk][2] = ld32(a + row * 64 + kk * 16 + 8 + tg * 2);
    af[kk][3] = ld32(a + (row + 8) * 64 + kk * 16 + 8 + tg * 2);
  }
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint64_t da = sw128_desc(sA), db = sw128_desc(sB);
  wgmma_fence();
  if (mode == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk);
  } else {
    // k-step kk starts 16 rows (2048 bytes) further into b
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_mn(d, af[kk], db + 128 * kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(d);
  reg_fence(af[0]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(row + 8 * (e >> 1)) * 64 + 8 * j + 2 * tg + (e & 1)] = d[4 * j + e];
  }
}

// ---- f32x3: the float32 instance, 3xTF32 on the tensor cores --------------
//
// Both products on the TF32 tensor cores in 3xTF32 (csrc/tf32x3.cuh, K1's
// split: hi = rna(x), lo = rna(x - hi), lo*hi + hi*lo + hi*hi), v2's grid
// and online softmax; probabilities stay float32 (the TPU body's cast to
// the input type is a no-op), exp2f keeps them to float32's accuracy, and
// each key tile's P V starts from zero and is added to the rescaled O in
// one FFMA (O alpha + part): the tensor cores truncate as they accumulate,
// so no chain runs over more than one tile. At D = 64 (DINO v1, every
// shape the port's paths run) on wgmma, at D = 16 and 32 on mma.sync.

// Bounds probe, 0 in the port: attention_timing.py --define
// K5F32_PROBE=<bits> times the wgmma kernel with a part taken out (1: the
// two small TF32 products of each product, 2: the split of K and V into
// the tiles wgmma reads). A probe's results are wrong.
#ifndef K5F32_PROBE
#define K5F32_PROBE 0
#endif

// d (64 x 64, f32) += A (64 x 8, registers) B (8 x 64, K-major in shared
// memory), TF32. A is the mma.sync m16n8k8 TF32 fragment of the warp's 16
// rows (a0 row g col t, a1 row g+8 col t, a2 row g col t+4, a3 row g+8
// col t+4).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " V3_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : V3_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a b in 3xTF32 on wgmma, B's hi and lo parts in two tiles
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[32],
                                             const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4],
                                             uint64_t bhi, uint64_t blo) {
  if ((K5F32_PROBE & 1) == 0) {
    wgmma_rs_tf32(d, alo, bhi);
    wgmma_rs_tf32(d, ahi, blo);
  }
  wgmma_rs_tf32(d, ahi, bhi);
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// Shared memory of the wgmma kernel: the raw K and V tiles as cp.async
// lands them (64 rows of 256 bytes, 16-byte chunk c of row r at c ^
// raw_swz(r)), and the split tiles that wgmma reads, each 64 rows of 128
// bytes in the 128-byte swizzle: K hi and lo as two halves of D (row =
// key, K-major), V^T hi and lo as two halves of the keys (row = dim).
constexpr int kRawTile = 64 * 256;
constexpr int kF32WgmmaSmem = 2 * kRawTile + 8 * kTile + 1024;

// the eight rows 8q + 2i + h (q = 0..3, h = 0, 1) that a phase of the V
// transpose reads at one chunk land on eight banks
__device__ __forceinline__ int raw_swz(int r) {
  return ((r >> 3) & 3) << 1 | (r & 1);
}

// f32x3 at D = 64 on wgmma: one warpgroup per (64-query tile, head, batch).
// - TF32 wgmma reads B only K-major, and 3xTF32 needs B's hi and lo parts
//   apart, so each key tile is split once per block in shared memory: K as
//   it lies (row = key), V transposed (row = dim). Q and P are A in
//   registers, split there.
// - O += P V with no shuffles: the S accumulator holds keys 2t and 2t + 1
//   of each 8-key slice, so V^T keeps its keys in the order of P's
//   relabelled A fragment (position t of each 8-key group is key 2t, t + 4
//   key 2t + 1).
// - The raw tile of the next keys lands while this one's products run; two
//   barriers a tile. 96 KB of shared memory and 245 registers: two blocks
//   per SM.
// At D = 64 it replaced the mma.sync form that the D = 16 and 32 kernel
// below keeps: 7.49 ms at (1, 16130, 6, 64) there against 5.19-5.27 here,
// where the mma.sync form split every K and V fragment in each of the
// block's four warps and held 255 registers. Not kept: ex2.approx.ftz for
// exp2f (no gain) and the split of each tile's V under its S and of the
// next K under its P V (four barriers a tile, 5.66 ms). The probe reads
// 3.65 ms without the split pass and 3.99 ms with one TF32 product per
// product (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
__global__ void __launch_bounds__(kThreads, 2)
    attention_kernel_f32x3_wgmma(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o, int T, int H,
                                 float scale_log2, int causal) {
  constexpr int D = 64;
  constexpr uint64_t kStep = kTile >> 4;  // one split tile, in descriptor units
  extern __shared__ uint8_t smem_f32[];
  uint8_t* sT = align1024(smem_f32);  // KH0 KH1 KL0 KL1 VH0 VH1 VL0 VL1
  float* rK = reinterpret_cast<float*>(sT + 8 * kTile);
  float* rV = rK + kRawTile / 4;

  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = (long long)H * D;
  const long long base =
      (long long)blockIdx.z * T * row_stride + (long long)blockIdx.y * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // stage the raw K and V rows [r0, r0 + 64), zeros past T
  auto stage = [&](int r0) {
#pragma unroll
    for (int i = tid; i < kBK * 16; i += kThreads) {
      const int r = i >> 4, c = i & 15;
      const bool in = r0 + r < T;
      const long long off =
          base + (in ? (long long)(r0 + r) * row_stride + c * 4 : 0);
      const int at = r * 64 + ((c ^ raw_swz(r)) << 2);
      cp_async16(rK + at, k + off, in ? 16 : 0);
      cp_async16(rV + at, v + off, in ? 16 : 0);
    }
  };
  stage(0);
  cp_async_commit();

  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  const int row_q[2] = {q0 + wr, q0 + wr + 8};
  uint32_t qhi[D / 8][4], qlo[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row_q[i & 1], d = kk * 8 + t + 4 * (i >> 1);
      split_tf32(r < T ? q[base + r * row_stride + d] : 0.f, qhi[kk][i],
                 qlo[kk][i]);
    }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint64_t dT = sw128_desc(sT);  // split tile n at dT + n * kStep

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // raw tile kt has landed; the split tiles are free
    if ((K5F32_PROBE & 2) == 0) {
      // K: chunk c of row r to tile c / 8 (hi) and 2 + c / 8 (lo)
#pragma unroll
      for (int u = tid; u < 64 * 16; u += kThreads) {
        const int r = u >> 4, c = u & 15;
        const float4 x = *reinterpret_cast<const float4*>(
            rK + r * 64 + ((c ^ raw_swz(r)) << 2));
        uint4 hi, lo;
        split_tf32(x.x, hi.x, lo.x);
        split_tf32(x.y, hi.y, lo.y);
        split_tf32(x.z, hi.z, lo.z);
        split_tf32(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(sT + (c >> 3) * kTile + swz(r, c & 7)) = hi;
        *reinterpret_cast<uint4*>(sT + (2 + (c >> 3)) * kTile +
                                  swz(r, c & 7)) = lo;
      }
      // V^T: unit (8-key group qg, parity h, 4-dim chunk dc) reads keys
      // 8 qg + 2i + h (i = 0..3) at dims 4 dc..4 dc + 3 and writes them to
      // positions 8 qg + 4h + i of each dim's row
#pragma unroll
      for (int u = tid; u < 8 * 2 * 16; u += kThreads) {
        const int qg = ((u >> 7) << 2) | ((u & 7) >> 1), h = u & 1;
        const int dc = (u >> 3) & 15;
        float x[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 8 * qg + 2 * i + h;
          const float4 y = *reinterpret_cast<const float4*>(
              rV + r * 64 + ((dc ^ raw_swz(r)) << 2));
          x[i][0] = y.x, x[i][1] = y.y, x[i][2] = y.z, x[i][3] = y.w;
        }
        const int pos = 8 * qg + 4 * h;
        const int tile = pos >> 5, c = (pos & 31) >> 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint4 hi, lo;
          split_tf32(x[0][j], hi.x, lo.x);
          split_tf32(x[1][j], hi.y, lo.y);
          split_tf32(x[2][j], hi.z, lo.z);
          split_tf32(x[3][j], hi.w, lo.w);
          const int dim = 4 * dc + j;
          *reinterpret_cast<uint4*>(sT + (4 + tile) * kTile + swz(dim, c)) = hi;
          *reinterpret_cast<uint4*>(sT + (6 + tile) * kTile + swz(dim, c)) = lo;
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // the split tiles are written, the raw tile is read
    if (kt + 1 < n_tiles) {
      stage((kt + 1) * kBK);
      cp_async_commit();
    }
    const int k0 = kt * kBK;

    // S = Q K^T, k-step kk of 8 dims in half kk / 4 of D
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t b = dT + (kk >> 2) * kStep + 2 * (kk & 3);
      wgmma_tf32x3(s, qhi[kk], qlo[kk], b, b + 2 * kStep);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // mask where the tile needs it; the running maximum per row is taken on
    // the raw logits and then scaled (scale_log2 > 0), and
    // exp2(s * scale_log2 - m) is one fma into exp2f
    const bool full = k0 + kBK <= T && (!causal || k0 + kBK - 1 <= q0);
    float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      if (!full) {
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (key >= T || (causal && key > row_q[ri])) s[i] = -CUDART_INF_F;
      }
      m_tile[ri] = fmaxf(m_tile[ri], s[i]);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 1));
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 2));
      const float m_new = fmaxf(m_run[ri], m_tile[ri] * scale_log2);
      // a row with no key yet keeps m = -inf; exp2 against 0 then gives 0
      m_use[ri] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[ri] = exp2f(m_run[ri] - m_use[ri]);
      m_run[ri] = m_new;
      l_run[ri] *= alpha[ri];
    }
    // P, split: key slice j's accumulator is k-step j's A fragment with a1
    // and a2 swapped (key 2t + 1 is k-index t + 4)
    uint32_t phi[kBK / 8][4], plo[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += p;
      const int e = i & 3, a = e == 1 ? 2 : e == 2 ? 1 : e;
      split_tf32(p, phi[i >> 2][a], plo[i >> 2][a]);
    }

    // O = O alpha + P V
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const uint64_t b = dT + (4 + (j >> 2)) * kStep + 2 * (j & 3);
      wgmma_tf32x3(part, phi[j], plo[j], b, b + 2 * kStep);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(phi);
    reg_fence(plo);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[ri] = 1.f / l;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row_q[ri] >= T) continue;
    float* orow = o + base + row_q[ri] * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[4 * n + 2 * ri] * inv[ri],
                      acc[4 * n + 2 * ri + 1] * inv[ri]);
  }
}

// The mma.sync kernel's K and V tiles (D = 16 and 32). Row strides (floats)
// padded so that each fragment read of a warp touches every bank once per
// 128-byte phase: K's (a float4 per lane at row 8j + g, column 16m + 4t)
// with a stride of 16 mod 32, V's (kW floats per lane at row 2t (+1),
// column kW g) with a stride of 4 mod 32.
template <int D>
struct F32Mma {
  static_assert(D == 16 || D == 32, "head dim");
  static constexpr int kLdK = D == 32 ? D + 16 : D;
  static constexpr int kLdV = D + 4;
  static constexpr int kW = D / 8;  // V floats per read, O tiles per warp
  static constexpr int kSmem = 2 * kBK * (kLdK + kLdV) * 4;  // two stages
};

template <int W>
__device__ __forceinline__ void ld_f32(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
  } else {
    const float2 r = *reinterpret_cast<const float2*>(p);
    x[0] = r.x, x[1] = r.y;
  }
}

template <int W>
__device__ __forceinline__ void st_f32(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// f32x3 at D = 16 and 32 on mma.sync m16n8k8: each warp owns 16 query
// rows, whose fragments are split once; K and V stream raw through a
// cp.async double buffer and are split in registers, as K1's mma_step does.
// - S = Q K^T: the reduction over D is order-free, so k-step 2m + e of
//   thread t takes the dims 16m + 4t + 2e and +1: a float4 of K's row (one
//   shared read for two k-steps) and of Q's, straight from memory.
// - O += P V with no shuffles: P V's k-index t is key 2t and t + 4 key
//   2t + 1 (the S accumulator's layout), so V's B fragment takes rows 2t
//   and 2t + 1; output column n of 8-wide tile w is dim kW n + w, so a lane
//   reads kW contiguous floats of V per row and writes 2 kW of O.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel_f32x3(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int T, int H, float scale_log2, int causal) {
  using L = F32Mma<D>;
  constexpr int W = L::kW;
  extern __shared__ __align__(16) float smem_mma[];
  float* sK = smem_mma;                      // two stages of kBK x kLdK
  float* sV = smem_mma + 2 * kBK * L::kLdK;  // two stages of kBK x kLdV

  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = (long long)H * D;
  const long long base =
      (long long)blockIdx.z * T * row_stride + (long long)blockIdx.y * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // stage the K and V rows [r0, r0 + 64) into stage buf, zeros past T
  auto stage = [&](int buf, int r0) {
    float* dk = sK + buf * kBK * L::kLdK;
    float* dv = sV + buf * kBK * L::kLdV;
    constexpr int R4 = D / 4;  // 16-byte chunks per row
#pragma unroll
    for (int i = tid; i < kBK * R4; i += kThreads) {
      const int r = i / R4, c = (i % R4) * 4;
      const bool in = r0 + r < T;
      const long long off =
          base + (in ? (long long)(r0 + r) * row_stride + c : 0);
      cp_async16(dk + r * L::kLdK + c, k + off, in ? 16 : 0);
      cp_async16(dv + r * L::kLdV + c, v + off, in ? 16 : 0);
    }
  };
  stage(0, 0);
  cp_async_commit();

  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  const int row_q[2] = {q0 + wr, q0 + wr + 8};
  uint32_t qhi[D / 8][4], qlo[D / 8][4];
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    float a[2][4];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (row_q[ri] < T)
        ld_f32<4>(a[ri], q + base + row_q[ri] * row_stride + 16 * m + 4 * t);
      else
        a[ri][0] = a[ri][1] = a[ri][2] = a[ri][3] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split_tf32(a[0][2 * e], qhi[2 * m + e][0], qlo[2 * m + e][0]);
      split_tf32(a[1][2 * e], qhi[2 * m + e][1], qlo[2 * m + e][1]);
      split_tf32(a[0][2 * e + 1], qhi[2 * m + e][2], qlo[2 * m + e][2]);
      split_tf32(a[1][2 * e + 1], qhi[2 * m + e][3], qlo[2 * m + e][3]);
    }
  }

  float acc[W][4];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();  // tile kt has landed
    // every thread is done with tile kt - 1, whose stage is refilled now
    // with tile kt + 1 while tile kt computes
    __syncthreads();
    if (kt + 1 < n_tiles) {
      stage(buf ^ 1, (kt + 1) * kBK);
      cp_async_commit();
    }
    const float* tK = sK + buf * kBK * L::kLdK;
    const float* tV = sV + buf * kBK * L::kLdV;
    const int k0 = kt * kBK;

    // S = Q K^T, one chain from zero per 8-key slice
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const float* kr = tK + (nt * 8 + g) * L::kLdK + 4 * t;
#pragma unroll
      for (int m = 0; m < D / 16; ++m) {
        float x[4];
        ld_f32<4>(x, kr + 16 * m);
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(x[i], bh[i], bl[i]);
        mma_tf32x3(s[nt], qhi[2 * m], qlo[2 * m], bh[0], bl[0], bh[1], bl[1]);
        mma_tf32x3(s[nt], qhi[2 * m + 1], qlo[2 * m + 1], bh[2], bl[2],
                   bh[3], bl[3]);
      }
    }

    // the softmax step of the wgmma kernel, on the mma.sync layout
    const bool full = k0 + kBK <= T && (!causal || k0 + kBK - 1 <= q0);
    float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        if (!full) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          if (key >= T || (causal && key > row_q[ri])) s[nt][e] = -CUDART_INF_F;
        }
        m_tile[ri] = fmaxf(m_tile[ri], s[nt][e]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 1));
      m_tile[ri] = fmaxf(m_tile[ri], __shfl_xor_sync(0xffffffff, m_tile[ri], 2));
      const float m_new = fmaxf(m_run[ri], m_tile[ri] * scale_log2);
      m_use[ri] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[ri] = exp2f(m_run[ri] - m_use[ri]);
      m_run[ri] = m_new;
      l_run[ri] *= alpha[ri];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], scale_log2, -m_use[e >> 1]));
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O = O alpha + P V; P's A fragment of key slice nt is its S
    // accumulator, relabelled
    float part[W][4] = {};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      uint32_t ph[4], pl[4];
      split_tf32(s[nt][0], ph[0], pl[0]);
      split_tf32(s[nt][2], ph[1], pl[1]);
      split_tf32(s[nt][1], ph[2], pl[2]);
      split_tf32(s[nt][3], ph[3], pl[3]);
      const float* vr = tV + (nt * 8 + 2 * t) * L::kLdV + W * g;
      float x0[W], x1[W];
      ld_f32<W>(x0, vr);
      ld_f32<W>(x1, vr + L::kLdV);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0[w], bh0, bl0);
        split_tf32(x1[w], bh1, bl1);
        mma_tf32x3(part[w], ph, pl, bh0, bl0, bh1, bl1);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[w][e] = fmaf(acc[w][e], alpha[e >> 1], part[w][e]);
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[ri] = 1.f / l;
  }
  // this thread's columns n = 2t + e of tile w hold dims kW (2t + e) + w
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row_q[ri] >= T) continue;
    float* orow = o + base + row_q[ri] * row_stride;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = acc[w][2 * ri + e] * inv[ri];
      st_f32<W>(orow + W * (2 * t + e), x);
    }
  }
}

template <typename E>
using Kernel = void (*)(const E*, const E*, const E*, E*, int, int, float,
                        int);

// v2's grid: one block of 128 threads per (64-row query tile, head, batch)
template <typename E>
int launch(Kernel<E> kernel, int smem, const void* q, const void* k,
           const void* v, void* o, int B, int T, int H, float scale_log2,
           int causal, void* stream) {
  if (kernel == nullptr || B <= 0 || T <= 0 || H <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), T, H, scale_log2, causal);
  return (int)cudaGetLastError();
}

// Q, two K and two V stages, and the slack to align them to 1024 bytes
constexpr int kV3Smem = 5 * kTile + 1024;

// devices whose shared-memory attribute a launch remembers
constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory is dynamic only when set so: once per
// device and kernel (``set`` is the kernel's own record), not on every launch
template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool (&set)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && set[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = true;
  return err;
}

// d80: two tiles of Q, two K and two V stages, and the slack to align them
constexpr int kD80Smem = (kD80Warpgroups + 4) * kD80Tile + 128;

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B, T, H, D), equivalently (B, T, H*D).
// scale_log2 = D^-0.5 * log2(e). Each returns cudaGetLastError() after
// the launch (0 = launched).

// v3: bfloat16, D = 64
int dropclip_attention_v3(const void* q, const void* k, const void* v,
                          void* o, int B, int T, int H, float scale_log2,
                          int causal, void* stream) {
  return launch<__nv_bfloat16>(attention_kernel_v3, kV3Smem, q, k, v, o, B,
                               T, H, scale_log2, causal, stream);
}

// v2: bfloat16, D = 16 or 32
int dropclip_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int T, int H, int D, float scale_log2, int causal,
                       void* stream) {
  Kernel<__nv_bfloat16> kernel = D == 16   ? attention_kernel<16>
                                 : D == 32 ? attention_kernel<32>
                                           : nullptr;
  return launch(kernel, 0, q, k, v, o, B, T, H, scale_log2, causal, stream);
}

// float32 (3xTF32), D = 16, 32 or 64
int dropclip_attention_f32(const void* q, const void* k, const void* v, void* o,
                           int B, int T, int H, int D, float scale_log2,
                           int causal, void* stream) {
  Kernel<float> kernel = D == 16   ? attention_kernel_f32x3<16>
                         : D == 32 ? attention_kernel_f32x3<32>
                         : D == 64 ? attention_kernel_f32x3_wgmma
                                   : nullptr;
  const int smem = D == 16   ? F32Mma<16>::kSmem
                   : D == 32 ? F32Mma<32>::kSmem
                             : kF32WgmmaSmem;
  // above 48 KB: the wgmma kernel only
  static bool attr_set[kMaxDevices] = {};
  if (kernel != nullptr) {
    const cudaError_t err = allow_smem(kernel, smem, attr_set);
    if (err != cudaSuccess) return (int)err;
  }
  return launch(kernel, smem, q, k, v, o, B, T, H, scale_log2, causal, stream);
}

// d80: bfloat16, D = 80; one block of two warpgroups per (128-row query
// tile, head, batch)
int dropclip_attention_d80(const void* q, const void* k, const void* v,
                           void* o, int B, int T, int H, float scale_log2,
                           int causal, void* stream) {
  constexpr int WG = kD80Warpgroups;
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(attention_kernel_d80, kD80Smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((T + kBQ * WG - 1) / (kBQ * WG)), (unsigned)H,
            (unsigned)B);
  attention_kernel_d80<<<grid, kThreads * WG, kD80Smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      T, H, scale_log2, causal);
  return (int)cudaGetLastError();
}

// the descriptor self-test: a, b 64 x 64 bf16, c 64 x 64 float32
int dropclip_wgmma_selftest(const void* a, const void* b, void* c, int mode,
                            void* stream) {
  wgmma_selftest_kernel<<<1, kThreads, 2 * kTile + 1024,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), mode);
  return (int)cudaGetLastError();
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
