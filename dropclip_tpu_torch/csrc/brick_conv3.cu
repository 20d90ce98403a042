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
// The geometry-free core (the instances, the ring, the products) lives
// in csrc/sparse_conv3_mma.cuh, which K2 shares; this file keeps the
// brick halo's source map, the tap skip and the grid.
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

#include "sparse_conv3_mma.cuh"

namespace {

// The brick halo: the source voxel row of (tap t, output row r); -1 reads
// zeros. row_m and row_mask hold each row's voxel and tap mask (bit t: the
// tap-t source exists and is live); a row past n_occ has mask 0.
struct BrickMap {
  const int* row_m;
  const unsigned* row_mask;
  const int* __restrict__ nbr;
  int bm, bx, by, bz;

  __device__ __forceinline__ int operator()(int t, int r) const {
    if (!(row_mask[r] >> t & 1)) return -1;
    const int v = bx * by * bz;
    const int m = row_m[r];
    const int b = m / v, vox = m % v;
    const int x = vox / (by * bz) + t / 9 - 1;
    const int y = (vox / bz) % by + t / 3 % 3 - 1;
    const int z = vox % bz + t % 3 - 1;
    const int dx = x < 0 ? -1 : (x >= bx ? 1 : 0);
    const int dy = y < 0 ? -1 : (y >= by ? 1 : 0);
    const int dz = z < 0 ? -1 : (z >= bz ? 1 : 0);
    const int r_nb =
        nbr[(long long)b * kTaps + (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)];
    if (r_nb < 0 || r_nb >= bm) return -1;
    return r_nb * v + ((x - dx * bx) * by + (y - dy * by)) * bz +
           (z - dz * bz);
  }
};

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
  const int lane = threadIdx.x % 32;

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
    fill_src(src, BrickMap{row_m, row_mask, nbr, bm, bx, by, bz}, 0, kTaps);
    __syncthreads();
    // K steps: (live tap, chunk of kBK input channels); a tap that no row
    // has a live source at is skipped, which changes no sum
    const int chunks = (c + L::kBK - 1) / L::kBK;
    run_steps<M, kVec>(acc, smem, src, tap_list, __popc(taps) * chunks,
                       feats, w, n0, c, cout);
  }

  // Epilogue: occupied rows get their sums, empty rows zeros.
  for_each_pair<M>(acc, [&](int r, int col, float v0, float v1) {
    const int pos = pos0 + r, n = n0 + col;
    if (pos >= rows || n >= cout) return;
    const bool on = pos < count;
    T* o = out + (long long)order[pos] * cout + n;
    if (!on) v0 = v1 = 0.f;
    if constexpr (kVec) {
      store2(o, v0, v1);  // Cout is even
    } else {
      store_as(o, v0);
      if (n + 1 < cout) store_as(o + 1, v1);
    }
  });
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
  const cudaError_t attr = set_smem<M>(kernel);
  if (attr != cudaSuccess) return (int)attr;
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
