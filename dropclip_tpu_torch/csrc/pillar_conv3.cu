// K2: fused k3 submanifold convolution in pillar layout, with the folded
// batch-norm epilogue.
//
// Replaces the TPU kernel dropclip_tpu/sparse/pallas_pillar.py::
// pallas_pillar_conv3 (body _pillar_kernel). Computes exactly its
// function, kernels/pillar_conv3.py::pillar_conv3_plain:
//
//   out[p, z, :] = occ[p, z] * relu?(scale * sum_{j < 9, dz in -1..1}
//                      col_j[z + dz, :] @ w[j, dz + 1] + bias)
//
// where col_j is the (Z, C) column of pillar nbr[p, j] (PILLAR_DIRS order:
// dx-major, dy-minor, j = 4 the pillar itself), reading zeros where z + dz
// leaves [0, Z) or the neighbour is a miss (any row outside [0, P); it is
// never dereferenced).
//
// Layouts (all contiguous): feats (P, Z, C) float32 or bfloat16, nbr (P, 9)
// int32, w (9, 3, C, Cout) in the feats dtype (the canonical (27, C, Cout)
// kernel reshaped: tap t = 3 * j + dz + 1), scale and bias (Cout) float32,
// out (P, Z, Cout) in the feats dtype. Any P, Z, C and Cout; float32
// accumulation. The wrapper also passes the occupied (p, z) slots first,
// in ascending order, then the empty ones (order, P*Z int32), their count
// (n_occ, one int32 on the device), so no host synchronisation is needed,
// and a zeroed float32 scratch of P*Z*Cout for the split sums.
//
// Bound. The padded product 2*P*Z*27*C*Cout is not the work: the epilogue
// keeps only occupied slots, and on the student's path every layer masks
// its output, so only occupied sources contribute. The pillar student
// passes each level's occupancy (JAX passes all ones and lets the next
// masked batch norm zero the rest; the block output is the same, and only
// the conv's own empty slots differ, zeros here). On the volumetric serve
// scenes a tenth of the level-0 slots are occupied; counting occupied
// (output, source) pairs the conv does hundreds of FLOPs per byte it must
// move, so in float32 on the CUDA cores (67 TFLOP/s) it is bound by
// operations.
//
// Design. The Pallas kernel DMAs each pillar's 9 neighbour columns into
// VMEM and takes the z taps as row shifts of the resident columns, over
// every slot. Here, as in K1 (csrc/brick_conv3.cu), the output rows are
// the compacted occupied slots (an implicit GEMM): a tile is 128 occupied
// rows by 128 output channels, and the GEMM's K axis is (tap, input
// channel). Per step of 16 channels of one tap, the block gathers the 128
// source rows of that tap into shared memory, stages the tap's 16 x 128
// weight slice, and each of 256 threads accumulates an 8 x 8 register
// tile; the next step's global loads are issued before the current step's
// FMAs. The source of a row is computed per (tap, row) from (p, z) with
// the z bounds tested before any address is formed, so z - 1 at z = 0
// never reads the previous pillar's last slot. Taps whose 128 sources are
// all misses are skipped.
//
// The deep levels have few occupied rows (80 to 1100 on the serve scenes)
// against K depths up to 27 * 512, so one block per tile left most of the
// 132 SMs idle (v1: 21.1 ms per forward, NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py). v2 splits K by taps: the grid is persistent (two blocks
// per SM), and on the device each block reads the occupied count, picks
// the number of tap groups S (1 to 27) for which the (tile, tap group)
// items fill one pass of the grid, and walks the items. With S = 1 an
// item stores its sums, else it adds them to the scratch with atomics (the
// order of the S float32 sums then varies from run to run). A second kernel applies the epilogue and
// writes every slot. Tensor cores, TMA and skipping empty sources inside
// a tap are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;  // output (p, z) rows per tile
constexpr int kTileN = 128;  // output channels per tile
constexpr int kChunk = 16;   // input channels per step
constexpr int kTM = 8;       // rows per thread: ty + 16 * i
constexpr int kTN = 8;       // channels per thread: tx*4 + j, 64 + tx*4 + j
constexpr int kTaps = 27;    // 9 xy-directions x 3 z offsets

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pillar_conv3_kernel(const T* __restrict__ feats, const int* __restrict__ nbr,
                    const T* __restrict__ w, const int* __restrict__ order,
                    const int* __restrict__ n_occ, float* __restrict__ sums,
                    int p, int z, int c, int cout) {
  __shared__ float a_sm[kChunk][kTileM];        // gathered inputs, k-major
  __shared__ __align__(16) float b_sm[kChunk][kTileN];  // weight slice
  __shared__ int src[kTaps][kTileM];            // source row per (tap, row)
  __shared__ int live[kTaps];                   // taps with a real source
  __shared__ int n_live;

  const int count = *n_occ;
  const int n_tiles = ((count + kTileM - 1) / kTileM) *
                      ((cout + kTileN - 1) / kTileN);
  if (n_tiles == 0) return;
  // tap groups: as many items as fit in one pass of the grid, at most one
  // tap each
  const int groups = min(kTaps, max(1, (int)gridDim.x / n_tiles));
  const int n_items = n_tiles * groups;
  const int n_cb = (cout + kTileN - 1) / kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // this thread's share of one step: 8 channels of one gathered row
  // (a_row, a_k0) and 8 output channels of one weight row (b_k, b_n0)
  const int a_row = tid / 2, a_k0 = (tid % 2) * 8;
  const int b_k = tid / 16, b_n0 = (tid % 16) * 8;
  const int chunks = (c + kChunk - 1) / kChunk;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int g = item % groups, tile = item / groups;
    const int pos0 = (tile / n_cb) * kTileM, n0 = (tile % n_cb) * kTileN;
    const int t0 = g * kTaps / groups, t1 = (g + 1) * kTaps / groups;

    __syncthreads();  // the previous item is done with shared memory
    if (tid < kTaps) live[tid] = 0;
    __syncthreads();
    // Source slot of every (tap, output row) of this tap group; -1 reads
    // zeros.
    for (int i = tid; i < (t1 - t0) * kTileM; i += kThreads) {
      const int t = t0 + i / kTileM, r = i % kTileM;
      const int pos = pos0 + r;
      int s = -1;
      if (pos < count) {
        const int m = order[pos];
        const int pil = m / z;
        const int zz = m % z + t % 3 - 1;
        if (zz >= 0 && zz < z) {
          const int nb = nbr[(long long)pil * 9 + t / 3];
          if (nb >= 0 && nb < p) s = nb * z + zz;
        }
      }
      src[t][r] = s;
      if (s >= 0) live[t] = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int t = t0; t < t1; ++t)
        if (live[t]) live[n++] = t;
      n_live = n;
    }
    __syncthreads();
    const int steps = n_live * chunks;
    if (steps == 0) continue;  // uniform: nothing to add

    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    float ra[8], rb[8];

    auto load = [&](int step) {
      const int t = live[step / chunks], c0 = (step % chunks) * kChunk;
      const int s = src[t][a_row];
      const T* pa = feats + (long long)s * c + c0 + a_k0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ra[j] = (s >= 0 && c0 + a_k0 + j < c) ? to_float(pa[j]) : 0.f;
      const int k = c0 + b_k;
      const T* pb = w + ((long long)t * c + k) * cout + n0 + b_n0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rb[j] = (k < c && n0 + b_n0 + j < cout) ? to_float(pb[j]) : 0.f;
    };

    load(0);
    for (int step = 0; step < steps; ++step) {
      __syncthreads();  // previous step's reads of a_sm / b_sm are done
#pragma unroll
      for (int j = 0; j < 8; ++j) a_sm[a_k0 + j][a_row] = ra[j];
      *reinterpret_cast<float4*>(&b_sm[b_k][b_n0]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
      *reinterpret_cast<float4*>(&b_sm[b_k][b_n0 + 4]) =
          make_float4(rb[4], rb[5], rb[6], rb[7]);
      __syncthreads();
      if (step + 1 < steps) load(step + 1);

#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4 b0 = *reinterpret_cast<const float4*>(&b_sm[k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&b_sm[k][64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float a = a_sm[k][ty + 16 * i];
          acc[i][0] += a * b0.x;
          acc[i][1] += a * b0.y;
          acc[i][2] += a * b0.z;
          acc[i][3] += a * b0.w;
          acc[i][4] += a * b1.x;
          acc[i][5] += a * b1.y;
          acc[i][6] += a * b1.z;
          acc[i][7] += a * b1.w;
        }
      }
    }

    // This group's sums of the tile's occupied rows, by compacted row.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int pos = pos0 + ty + 16 * i;
      if (pos >= count) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (n >= cout) continue;
        float* dst = sums + (long long)pos * cout + n;
        if (groups == 1)
          *dst = acc[i][j];
        else
          atomicAdd(dst, acc[i][j]);
      }
    }
  }
}

// Every slot: occupied ones relu?(sum * scale + bias), empty ones 0.
template <typename T>
__global__ void pillar_epilogue_kernel(const float* __restrict__ sums,
                                       const int* __restrict__ order,
                                       const int* __restrict__ n_occ,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       T* __restrict__ out, long long rows,
                                       int cout, int relu) {
  const int count = *n_occ;
  const long long total = rows * cout;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long pos = i / cout;
    const int n = (int)(i % cout);
    float y = 0.f;
    if (pos < count) {
      y = sums[i] * scale[n] + bias[n];
      if (relu) y = fmaxf(y, 0.f);
    }
    store_as(out + (long long)order[pos] * cout + n, y);
  }
}

template <typename T>
int launch(const void* feats, const int* nbr, const void* w,
           const float* scale, const float* bias, const int* order,
           const int* n_occ, float* sums, void* out, int p, int z, int c,
           int cout, int relu, int n_blocks, cudaStream_t stream) {
  pillar_conv3_kernel<T><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), nbr, static_cast<const T*>(w), order,
      n_occ, sums, p, z, c, cout);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)p * z * cout;
  const long long blocks = (total + 255) / 256;
  pillar_epilogue_kernel<T><<<(unsigned)(blocks < 8192 ? blocks : 8192), 256,
                              0, stream>>>(
      sums, order, n_occ, scale, bias, static_cast<T*>(out),
      (long long)p * z, cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; n_blocks: the persistent grid (two per
// SM). Returns cudaGetLastError() after the launches (0 = launched).
int dropclip_pillar_conv3(const void* feats, const int* nbr, const void* w,
                          const float* scale, const float* bias,
                          const int* order, const int* n_occ, float* sums,
                          void* out, int p, int z, int c, int cout, int relu,
                          int dtype, int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feats, nbr, w, scale, bias, order, n_occ, sums, out,
                         p, z, c, cout, relu, n_blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, nbr, w, scale, bias, order, n_occ,
                                 sums, out, p, z, c, cout, relu, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
