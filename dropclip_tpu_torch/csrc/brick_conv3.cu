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
// brick shape, any C and Cout; float32 accumulation. The wrapper also
// passes the occupied voxel rows first, in ascending order, then the
// empty ones (order, Bm*bx*by*bz int32), and their count (n_occ, one
// int32 on the device), so that no host synchronisation is needed.
//
// Bound. The padded count 2*Bm*bx*by*bz*27*C*Cout is not the work: only
// occupied output voxels are kept, and on the student's path, where every
// layer masks its output, only occupied input voxels contribute. On
// tabletop scenes at (4, 4, 2) a sixth of the level-0
// slots are occupied, and the pairs of occupied voxels one tap apart are
// a twentieth of the padded product. Counting those pairs, the conv does
// tens to hundreds of FLOPs per byte it must move (feats in, out out,
// weights), so in float32, which runs on the CUDA cores at 67 TFLOP/s,
// it is bound by operations.
//
// Design. The Pallas kernel builds each brick's (bx+2, by+2, bz+2) halo in
// VMEM and runs 27 dense tap matmuls over every voxel slot, occupied or
// not. Here the grid walks the voxel rows in `order`, so a block's 128
// output rows are occupied voxels (an implicit GEMM over the compacted
// rows; blocks past n_occ only write zeros). The GEMM's K axis is
// (tap, input channel): per step of 16 channels of one tap, the block
// gathers the 128 source rows of that tap into shared memory (zeros for a
// miss), stages the tap's 16 x 128 weight slice, and each of 256 threads
// accumulates an 8 x 8 register tile. The next step's global loads are
// issued into registers before the current step's FMAs, so gather latency
// overlaps compute. This cuts the padded FLOPs by the occupancy (about 6x
// at level 0); the remaining waste is the empty input voxels inside each
// tap's gather. Tensor cores (wgmma, and 3xTF32 for float32 accuracy), TMA
// and a per-tap skip of empty sources are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;  // output voxel rows per block
constexpr int kTileN = 128;  // output channels per block
constexpr int kChunk = 16;   // input channels per step
constexpr int kTM = 8;       // rows per thread: ty + 16 * i
constexpr int kTN = 8;       // channels per thread: tx*4 + j, 64 + tx*4 + j
constexpr int kTaps = 27;

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
brick_conv3_kernel(const T* __restrict__ feats, const int* __restrict__ nbr,
                   const T* __restrict__ w, const int* __restrict__ order,
                   const int* __restrict__ n_occ, T* __restrict__ out,
                   int bm, int bx, int by, int bz, int c, int cout) {
  __shared__ float a_sm[kChunk][kTileM];        // gathered inputs, k-major
  __shared__ __align__(16) float b_sm[kChunk][kTileN];  // weight slice
  __shared__ int src[kTaps][kTileM];            // source row per (tap, row)

  const int v = bx * by * bz;
  const int rows = bm * v;
  const int pos0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int count = *n_occ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (pos0 < count) {
    // Source voxel row of every (tap, output row); -1 reads zeros.
    for (int i = tid; i < kTaps * kTileM; i += kThreads) {
      const int t = i / kTileM, r = i % kTileM;
      const int pos = pos0 + r;
      int s = -1;
      if (pos < count) {
        const int m = order[pos];
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
      src[t][r] = s;
    }
    __syncthreads();

    // This thread's share of one step: 8 channels of one gathered row
    // (a_row, a_k0) and 8 output channels of one weight row (b_k, b_n0).
    const int a_row = tid / 2, a_k0 = (tid % 2) * 8;
    const int b_k = tid / 16, b_n0 = (tid % 16) * 8;
    const int chunks = (c + kChunk - 1) / kChunk;
    const int steps = kTaps * chunks;
    float ra[8], rb[8];

    auto load = [&](int step) {
      const int t = step / chunks, c0 = (step % chunks) * kChunk;
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
  }

  // Epilogue: occupied rows get their sums, empty rows zeros.
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int pos = pos0 + ty + 16 * i;
    if (pos >= rows) continue;
    const long long m = order[pos];
    const bool on = pos < count;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < cout) store_as(out + m * cout + n, on ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
int launch(const void* feats, const int* nbr, const void* w,
           const int* order, const int* n_occ, void* out, int bm, int bx,
           int by, int bz, int c, int cout, cudaStream_t stream) {
  const long long rows = (long long)bm * bx * by * bz;
  dim3 grid((unsigned)((rows + kTileM - 1) / kTileM),
            (unsigned)((cout + kTileN - 1) / kTileN));
  brick_conv3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), nbr, static_cast<const T*>(w), order,
      n_occ, static_cast<T*>(out), bm, bx, by, bz, c, cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
int dropclip_brick_conv3(const void* feats, const int* nbr, const void* w,
                         const int* order, const int* n_occ, void* out,
                         int bm, int bx, int by, int bz, int c, int cout,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feats, nbr, w, order, n_occ, out, bm, bx, by, bz, c,
                         cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, nbr, w, order, n_occ, out, bm, bx,
                                 by, bz, c, cout, s);
  return (int)cudaErrorInvalidValue;
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
