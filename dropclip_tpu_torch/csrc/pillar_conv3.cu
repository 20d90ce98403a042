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
// never dereferenced). Without scale and bias (null) there is no affine
// step.
//
// Layouts (all contiguous): feats (P, Z, C) float32 or bfloat16, nbr (P, 9)
// int32, w (9, 3, C, Cout) in the feats dtype (the canonical (27, C, Cout)
// kernel reshaped: tap t = 3 * j + dz + 1), scale and bias (Cout) float32,
// out (P, Z, Cout) in the feats dtype. Any P, Z, C and Cout; float32
// accumulation. The wrapper passes the level's row schedule
// (kernels/pillar_conv3.py::row_order, on the device, so no host sync):
// the occupied (p, z) slots ascending, then the empty ones (order, P*Z
// int32), and their count (n_occ, one int32).
//
// Bound. Only occupied output slots are kept and only existing sources
// (neighbour pillar present, z + dz inside the column) are read. On the
// volumetric serve scenes the 16 convs of one forward are 74.3 GFLOP of
// occupied (output, source) pairs, hundreds of FLOPs per byte they must
// move: operations bound it. float32 must stay float32-accurate (rtol
// 1e-4), so it costs three TF32 products per product: 3 * 74.3 GFLOP at
// 495 TFLOP/s = 0.450 ms per forward; bf16 74.3 GFLOP at 989 TFLOP/s =
// 0.075 ms.
//
// Design (v3). v2 ran both dtypes on the CUDA cores (an 8 x 8 register
// tile of float32 FMAs per thread), sorted the slots in every call,
// cleared a P*Z*Cout float32 scratch and ran a second epilogue kernel
// over every slot. v3 runs K1's tensor-core core (csrc/sparse_conv3_mma.cuh:
// float32 through 3xTF32 on mma.sync with short chains added in FADD,
// bf16 on wgmma from 128B-swizzled tiles, a cp.async ring) under the
// pillar source map, in one launch per conv:
//  - the grid is persistent, kMinBlocks blocks per SM. Each block reads
//    n_occ and splits K by taps on the device, as v2 did: an item is
//    (tile of 128 rows x 128 channels, tap group), and its K steps are
//    the group's taps that some row of the tile has a source at, times
//    the channel chunks. float32 (one block per SM, so the grid runs in
//    waves) takes the S in [1, 27] whose items finish soonest
//    (tap_groups): S = 1 where the tiles fill whole waves, S = 27 at the
//    deep levels, where 8-60 occupied rows face K up to 27 * 384, and
//    S = 9 for 141 tiles on 132 SMs, which would otherwise run a second
//    wave of 9 tiles (29% off level 0 there on an H100,
//    pillar_conv_timing.py --n-occ 7000). bf16 (two blocks per SM)
//    keeps v2's rule, S = min(27, grid / n_tiles): a lone block per SM
//    runs faster than half a pair, and the cost model's S = 9 measured
//    slower at 141 tiles;
//  - S = 1: the item applies scale, bias and relu to its sums and writes
//    the occupied rows straight into out;
//  - S > 1: items add their sums to a float32 scratch tile with atomics
//    (the order of the S sums varies from run to run) and count
//    themselves on the tile; the item that completes the count applies
//    the epilogue and leaves the scratch tile and its count zero again.
//    The scratch (a tile for each of up to two tiles per SM; more tiles
//    do not split) and the counts are allocated zero once per device and
//    stream, so a call allocates and clears nothing and needs no second
//    launch;
//  - every block then writes zeros to its share of the empty slots.
// K1's tap-mask row order (its stage C) is left out: volumetric
// rows read most of their taps (18-22 of 27 at level 0), so a tile of
// 128 rows reads 24-27 taps whatever the order.

#include "sparse_conv3_mma.cuh"

namespace {

// The pillar map: the source slot of (tap t = 3 j + dz + 1, output row r)
// is slot z + dz of pillar nbr[p, j], where row r holds slot (p, z); -1
// reads zeros. The z bounds are tested before any address is formed, so
// z - 1 at z = 0 never reads the previous pillar's last slot.
struct PillarMap {
  const int* row_m;  // the slot of each row of the tile, -1 past n_occ
  const int* __restrict__ nbr;
  int p, z;

  __device__ __forceinline__ int operator()(int t, int r) const {
    const int m = row_m[r];
    if (m < 0) return -1;
    const int zz = m % z + t % 3 - 1;
    if (zz < 0 || zz >= z) return -1;
    const int nb = nbr[(long long)(m / z) * 9 + t / 3];
    return nb >= 0 && nb < p ? nb * z + zz : -1;
  }
};

// relu?(v * scale[n] + bias[n]); no scale and bias: relu?(v)
struct Epilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  int relu;

  __device__ __forceinline__ float operator()(float v, int n) const {
    if (scale != nullptr) v = v * scale[n] + bias[n];
    return relu ? fmaxf(v, 0.f) : v;
  }
};

// Empty slots get zeros: rows [count, rows) of `order`, a warp per row;
// kVec: 16-byte stores (Cout a multiple of 16 bytes' elements).
template <bool kVec, typename T>
__device__ __forceinline__ void zero_empty(T* __restrict__ out,
                                           const int* __restrict__ order,
                                           int count, int rows, int cout) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kE = kVec ? 16 / sizeof(T) : 1;
  const int lane = threadIdx.x % 32;
  for (int pos = count + blockIdx.x * kWarps + threadIdx.x / 32; pos < rows;
       pos += gridDim.x * kWarps) {
    T* o = out + (long long)order[pos] * cout;
    for (int n = lane * kE; n < cout; n += 32 * kE) {
      if constexpr (kVec)
        *reinterpret_cast<uint4*>(o + n) = make_uint4(0u, 0u, 0u, 0u);
      else
        o[n] = zero<T>();
    }
  }
}

// The number of tap groups S in [1, 27] whose (tile, group) items finish
// soonest on `blocks` blocks, one per SM: waves of items times the steps
// of an item (ceil(27 / S) taps of `chunks` steps, all taps counted as
// live), plus about two steps of set-up per item and three of atomics
// where K is split; the fewest groups of equals. S = 1 where the tiles
// fill whole waves, S = 27 at the deepest levels.
__device__ __forceinline__ int tap_groups(int n_tiles, int blocks,
                                          int chunks) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= kTaps; ++g) {
    const long long waves = ((long long)n_tiles * g + blocks - 1) / blocks;
    const long long cost =
        waves * ((kTaps + g - 1) / g * chunks + (g > 1 ? 5 : 2));
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// The tensor-core kernel (csrc/sparse_conv3_mma.cuh) under the pillar map.
// A persistent grid of kMinBlocks blocks per SM walks the items (row tile,
// channel tile, tap group); then every block writes zeros to its share of
// the empty slots.
template <class M, bool kVec, typename T = typename M::T>
__global__ void __launch_bounds__(kThreads, M::kMinBlocks)
pillar_conv3_mma(const T* __restrict__ feats, const int* __restrict__ nbr,
                 const T* __restrict__ w, const int* __restrict__ order,
                 const int* __restrict__ n_occ,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 float* __restrict__ sums, int* __restrict__ counts, int p,
                 int z, int c, int cout, int relu, int split_tiles) {
  using L = Layout<M>;
  extern __shared__ __align__(16) uint8_t dyn_smem[];
  uint8_t* smem = M::kWgmma ? align1024(dyn_smem) : dyn_smem;
  int* src = reinterpret_cast<int*>(smem + L::kSrcOffset);
  __shared__ int row_m[kTileM];
  __shared__ int live[kTaps];
  __shared__ int tap_list[kTaps];
  __shared__ int n_live, last;

  const int count = *n_occ;
  const int n_cb = (cout + kTileN - 1) / kTileN;
  const int n_tiles = (count + kTileM - 1) / kTileM * n_cb;
  const int chunks = (c + L::kBK - 1) / L::kBK;
  const int groups =
      n_tiles == 0 || n_tiles > split_tiles ? 1
      : M::kMinBlocks == 1 ? tap_groups(n_tiles, gridDim.x, chunks)
                           : min(kTaps, max(1, (int)gridDim.x / n_tiles));
  const int n_items = n_tiles * groups;
  const Epilogue epi{scale, bias, relu};
  const int tid = threadIdx.x;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int g = item % groups, tile = item / groups;
    const int pos0 = (tile / n_cb) * kTileM, n0 = (tile % n_cb) * kTileN;
    const int t0 = g * kTaps / groups, t1 = (g + 1) * kTaps / groups;

    __syncthreads();  // the previous item is done with shared memory
    if (tid < kTileM) row_m[tid] = pos0 + tid < count ? order[pos0 + tid] : -1;
    if (tid < kTaps) live[tid] = 0;
    __syncthreads();
    fill_src(src, PillarMap{row_m, nbr, p, z}, t0, t1, live);
    __syncthreads();
    if (tid == 0) {  // the group's taps that some row has a source at
      int n = 0;
      for (int t = t0; t < t1; ++t)
        if (live[t]) tap_list[n++] = t;
      n_live = n;
    }
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    run_steps<M, kVec>(acc, smem, src, tap_list, n_live * chunks, feats, w,
                       n0, c, cout);

    if (groups == 1) {  // the whole sum: epilogue straight into out
      for_each_pair<M>(acc, [&](int r, int col, float v0, float v1) {
        const int pos = pos0 + r, n = n0 + col;
        if (pos >= count || n >= cout) return;
        T* o = out + (long long)order[pos] * cout + n;
        if constexpr (kVec) {
          store2(o, epi(v0, n), epi(v1, n + 1));  // Cout is even
        } else {
          store_as(o, epi(v0, n));
          if (n + 1 < cout) store_as(o + 1, epi(v1, n + 1));
        }
      });
      continue;
    }
    // Split: add to the tile's float32 scratch; the item that adds the
    // tile's last group applies the epilogue and leaves the scratch and
    // the tile's count zero again.
    float* part = sums + (long long)tile * kTileM * kTileN;
    for_each_pair<M>(acc, [&](int r, int col, float v0, float v1) {
      if (pos0 + r >= count || n0 + col >= cout) return;
      atomicAdd(part + r * kTileN + col, v0);
      if (n0 + col + 1 < cout) atomicAdd(part + r * kTileN + col + 1, v1);
    });
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(counts + tile, 1) == groups - 1;
    __syncthreads();
    if (!last) continue;
    __threadfence();
    for (int i = tid; i < kTileM * kTileN; i += kThreads) {
      const int pos = pos0 + i / kTileN, n = n0 + i % kTileN;
      if (pos >= count || n >= cout) continue;
      const float v = __ldcg(part + i);
      __stcg(part + i, 0.f);
      store_as(out + (long long)order[pos] * cout + n, epi(v, n));
    }
    if (tid == 0) counts[tile] = 0;
  }
  zero_empty<kVec>(out, order, count, p * z, cout);
}

template <class M, bool kVec>
int launch_mma(const void* feats, const int* nbr, const void* w,
               const int* order, const int* n_occ, const float* scale,
               const float* bias, void* out, float* sums, int* counts, int p,
               int z, int c, int cout, int relu, int n_sm, int split_tiles,
               cudaStream_t stream) {
  using T = typename M::T;
  auto kernel = pillar_conv3_mma<M, kVec>;
  const cudaError_t attr = set_smem<M>(kernel);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_sm * M::kMinBlocks, kThreads, Layout<M>::kBytes, stream>>>(
      static_cast<const T*>(feats), nbr, static_cast<const T*>(w), order,
      n_occ, scale, bias, static_cast<T*>(out), sums, counts, p, z, c, cout,
      relu, split_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 = float32 3xTF32, 1 = float32 3xTF32 with ragged channels,
// 2 = bfloat16 on wgmma, 3 = bfloat16 on wgmma with ragged channels
// (kernels/brick_conv3.py::instance). scale and bias may both be null
// (no affine step). sums (split_tiles x 128 x 128 float32) and counts
// (split_tiles int32) are zero on entry and left zero. n_sm: the card's
// SM count. Returns cudaGetLastError() after the launch (0 = launched).
int dropclip_pillar_conv3(const void* feats, const int* nbr, const void* w,
                          const int* order, const int* n_occ,
                          const float* scale, const float* bias, void* out,
                          float* sums, int* counts, int p, int z, int c,
                          int cout, int relu, int kind, int n_sm,
                          int split_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_mma<Tf32x3, true>(feats, nbr, w, order, n_occ, scale,
                                      bias, out, sums, counts, p, z, c, cout,
                                      relu, n_sm, split_tiles, s);
    case 1:
      return launch_mma<Tf32x3, false>(feats, nbr, w, order, n_occ, scale,
                                       bias, out, sums, counts, p, z, c,
                                       cout, relu, n_sm, split_tiles, s);
    case 2:
      return launch_mma<Bf16Wgmma, true>(feats, nbr, w, order, n_occ, scale,
                                         bias, out, sums, counts, p, z, c,
                                         cout, relu, n_sm, split_tiles, s);
    case 3:
      return launch_mma<Bf16Wgmma, false>(feats, nbr, w, order, n_occ, scale,
                                          bias, out, sums, counts, p, z, c,
                                          cout, relu, n_sm, split_tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dropclip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
