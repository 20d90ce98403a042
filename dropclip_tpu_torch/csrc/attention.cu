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
// (B, T, H*D) one, so all three are this one kernel: token t of head h
// starts at element (b*T + t)*H*D + h*D. The TPU needed two kernels only
// because of the transposes XLA put around the per-head one.
//
// Numerics follow the TPU body: logits s = q.k in float32, then
// exp2(s * scale*log2(e) - m) with keys past T (and, if causal, past the
// query) masked to -inf; the unnormalised probabilities are rounded to the
// input type before the P.V product, which accumulates in float32, and the
// (T, D) output is divided by the float32 row sum. Unlike the TPU body the
// row maximum m is a running one (online softmax): each new key tile
// rescales the running sum and output by exp2(m_old - m_new). That rounds
// the probabilities against another maximum, so results differ from the
// one-pass order by a few bf16 ulps; chip_smoke.py and the cuda tests
// state the tolerance. Key and value rows past T are loaded as zeros, so
// nothing past the tensor is read and 0 * Inf cannot leak; query rows past
// T are computed on zeros and never written.
//
// Bound. At the ViT-L teacher's shape (B=96, T=769, H=16, D=64, bf16) one
// call does 4*B*H*T^2*D = 232.5 GFLOP in the two matmuls and must move
// 4*B*T*H*D*2 bytes = 605 MB (q, k, v in, o out): 0.235 ms at 989 TFLOP/s
// against 0.18 ms at 3.35 TB/s, so it is bound by operations. No (T, T)
// matrix goes to device memory.
//
// Design. 128 threads: each of 4 warps owns 16 query rows of the tile. The
// Q tile is staged once in shared memory and kept in registers as mma A
// fragments. K and V tiles stream through a two-stage ring in shared
// memory with cp.async (16-byte copies, zero-filled past T), so tile kt+1
// loads while tile kt computes. S = Q.K^T and O += P.V run as bf16
// mma.sync.m16n8k16 with float32 accumulators; their B fragments come from
// ldmatrix (K as stored, V transposed by ldmatrix.trans, so V is copied
// as it lies in memory), and the S accumulators become the P.V A fragments
// in registers (the m16n8 accumulator and the m16n8k16 A operand line up),
// so P never touches shared memory. Rows are padded by 16 bytes, which
// makes the ldmatrix row reads conflict-free. Tiles that need no mask skip
// the masking pass. Not used yet: TMA, wgmma, warp specialisation. A
// float32 instance on the CUDA cores follows at the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

// Float32 instance (the JAX kernels also run in float32). The same tiles,
// masks and online softmax on the CUDA cores: the tensor cores take float32
// only as TF32, which would round the inputs to 10 mantissa bits. Two
// threads share a query row, each holding half of the head dim in
// registers; a key's dot product is their two halves added with one
// shuffle, so both hold the same logits, maximum and row sum. K and V
// tiles are staged in shared memory (zeros past T) and every thread of a
// warp reads the same key row, a broadcast. Probabilities stay in float32
// (the TPU body's cast to the input type is then a no-op).
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int T,
                         int H, float scale_log2, int causal) {
  static_assert(D % 8 == 0 && D <= 64, "head dim");
  constexpr int HD = D / 2;  // dims per thread
  constexpr int C4 = D / 4;  // float4 chunks per row
  __shared__ __align__(16) float sK[kBK][D];
  __shared__ __align__(16) float sV[kBK][D];

  const int q0 = blockIdx.x * kBQ;
  const long long row_stride = (long long)H * D;
  const long long base =
      (long long)blockIdx.z * T * row_stride + (long long)blockIdx.y * D;
  const int tid = threadIdx.x;
  const int row = q0 + (tid >> 1), d0 = (tid & 1) * HD;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = row < T ? q[base + row * row_stride + d0 + c] : 0.f;
    acc[c] = 0.f;
  }
  float m_run = -CUDART_INF_F, l_run = 0.f;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < T) {
        const long long off = base + (k0 + r) * row_stride + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&sK[j][d0]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 x = kr[c];
        dot += qr[4 * c] * x.x + qr[4 * c + 1] * x.y + qr[4 * c + 2] * x.z +
               qr[4 * c + 3] * x.w;
      }
      dot += __shfl_xor_sync(0xffffffff, dot, 1);
      const int key = k0 + j;
      const float x = (key >= T || (causal && key > row)) ? -CUDART_INF_F
                                                           : dot * scale_log2;
      s[j] = x;
      m_tile = fmaxf(m_tile, x);
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_use);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = exp2f(s[j] - m_use);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(&sV[j][d0]);
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 x = vr[c];
        acc[4 * c] += p * x.x;
        acc[4 * c + 1] += p * x.y;
        acc[4 * c + 2] += p * x.z;
        acc[4 * c + 3] += p * x.w;
      }
    }
  }

  if (row >= T) return;
  const float inv = 1.f / l_run;
  float* orow = o + base + row * row_stride + d0;
#pragma unroll
  for (int c = 0; c < HD / 4; ++c)
    *reinterpret_cast<float4*>(orow + 4 * c) =
        make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                    acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T,
           int H, float scale_log2, int causal, cudaStream_t stream) {
  dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  const E *qe = static_cast<const E*>(q), *ke = static_cast<const E*>(k),
          *ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(o);
  if constexpr (sizeof(E) == 4)
    attention_kernel_f32<D><<<grid, kThreads, 0, stream>>>(
        qe, ke, ve, oe, T, H, scale_log2, causal);
  else
    attention_kernel<D><<<grid, kThreads, 0, stream>>>(
        qe, ke, ve, oe, T, H, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int T,
             int H, int D, float scale_log2, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<E, 16>(q, k, v, o, B, T, H, scale_log2, causal, s);
    case 32: return launch<E, 32>(q, k, v, o, B, T, H, scale_log2, causal, s);
    case 64: return launch<E, 64>(q, k, v, o, B, T, H, scale_log2, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B, T, H, D), equivalently (B, T, H*D), bfloat16
// (dropclip_attention) or float32 (dropclip_attention_f32).
// scale_log2 = D^-0.5 * log2(e). Returns cudaGetLastError() after the
// launch (0 = launched).
int dropclip_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int T, int H, int D, float scale_log2, int causal,
                       void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, T, H, D, scale_log2, causal,
                                 stream);
}

int dropclip_attention_f32(const void* q, const void* k, const void* v, void* o,
                           int B, int T, int H, int D, float scale_log2,
                           int causal, void* stream) {
  return dispatch<float>(q, k, v, o, B, T, H, D, scale_log2, causal, stream);
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
