// Hopper (sm_90a) kernel of the fused edge-consensus update: the Pallas
// kernel consensus_update of dip_admm_tpu/ops/pallas/consensus.py (both
// bodies, _kernel_midpoint and _kernel_weighted), written again for CUDA.
//
//   K5 dip_consensus <- consensus_update
//
// For every edge slot (i, j) and pixel p, with a the proposals x^ + y:
//   z'  = adj_ij * fuse(a[i,j,p], a[j,i,p])   midpoint: (a + aT) / 2
//                                              weighted: (w_i a + w_j aT)
//                                                        / (w_i + w_j)
//   y'  = adj_ij * (a - z')
//   pri[i,j] = sum_p (adj_ij * (a - y - z'))^2
//   dz2[i,j] = sum_p (adj_ij * (z' - z))^2
// Every pair is computed, masked ones included, so a NaN propagates as it
// does in the TPU kernel and in the plain version.
//
// What bounds it on an H100: HBM bandwidth. At 256^2/8 each of a, y, z is
// [8, 8, 65536] f32 (16.8 MB); one call reads a twice (as a and as its
// transpose, read by index from a[j, i, :] instead of a materialized copy),
// y and z once, and writes z' and y': about 100 MB, ~30 us at 3.35 TB/s.
// Each thread does a handful of flops per 24 bytes, so nothing but the
// streams matters: consecutive threads touch consecutive pixels of all six
// streams (coalesced), and 2048-pixel tiles give thousands of blocks.
//
// Design: two launches and a deterministic reduction, no atomics.
//   1. dip_consensus_tile: one block per (pixel tile, pair). It writes z'
//      and y' and the tile's two partial sums (per-thread sums, then a fixed
//      shuffle tree) to a [2, P*P, n_tiles] scratch.
//   2. dip_consensus_sum: one warp per pair sums its n_tiles partials in a
//      fixed order (lane-strided, then a shuffle tree).
// The TPU kernel carries the per-pair sum across its sequential pixel-tile
// grid axis; blocks here run in no order, so the second pass replaces that
// carry. One block per pair looping over all pixels would also be
// deterministic, but gives only P*P = 64 blocks for 132 SMs at 8 nodes.
// The same inputs therefore give bitwise-equal outputs on every call. The
// tile need not divide n: the last tile of a row is masked.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// The entry launches on the given stream, does not synchronise and returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block of the tile pass
constexpr int NW = NT / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(NT)
consensus_tile(const float* __restrict__ a, const float* __restrict__ y,
               const float* __restrict__ z, const float* __restrict__ adjm,
               const float* __restrict__ w, float* __restrict__ zn,
               float* __restrict__ yn, float* __restrict__ part, int P, int n,
               int tile, int n_tiles) {
  const int pair = blockIdx.y;  // i * P + j
  const int i = pair / P, j = pair % P;
  const int t = blockIdx.x;
  const long row = (long)pair * n;
  const long row_t = ((long)j * P + i) * n;  // a[j, i, :]
  const float adj = adjm[pair];
  const int p1 = min((t + 1) * tile, n);
  float pri = 0.f, dz2 = 0.f;
  for (int p = t * tile + threadIdx.x; p < p1; p += NT) {
    const float av = a[row + p], at = a[row_t + p];
    float zv;
    if (WEIGHTED) {
      const float wi = w[(long)i * n + p], wj = w[(long)j * n + p];
      zv = ((wi * av + wj * at) / (wi + wj)) * adj;
    } else {
      zv = 0.5f * (av + at) * adj;
    }
    const float dp = (av - y[row + p] - zv) * adj;
    const float dz = (zv - z[row + p]) * adj;
    zn[row + p] = zv;
    yn[row + p] = (av - zv) * adj;
    pri += dp * dp;
    dz2 += dz * dz;
  }
  __shared__ float sp[NW], sd[NW];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  pri = warp_sum(pri);
  dz2 = warp_sum(dz2);
  if (lane == 0) {
    sp[warp] = pri;
    sd[warp] = dz2;
  }
  __syncthreads();
  if (warp == 0) {
    pri = warp_sum(lane < NW ? sp[lane] : 0.f);
    dz2 = warp_sum(lane < NW ? sd[lane] : 0.f);
    if (lane == 0) {
      const long k = (long)pair * n_tiles + t;
      part[k] = pri;
      part[(long)P * P * n_tiles + k] = dz2;
    }
  }
}

__global__ void __launch_bounds__(32)
consensus_sum(const float* __restrict__ part, float* __restrict__ pri,
              float* __restrict__ dz2, int PP, int n_tiles) {
  const int pair = blockIdx.x;
  const float* pp = part + (long)pair * n_tiles;
  const float* pd = part + ((long)PP + pair) * n_tiles;
  float sp = 0.f, sd = 0.f;
  for (int t = threadIdx.x; t < n_tiles; t += 32) {
    sp += pp[t];
    sd += pd[t];
  }
  sp = warp_sum(sp);
  sd = warp_sum(sd);
  if (threadIdx.x == 0) {
    pri[pair] = sp;
    dz2[pair] = sd;
  }
}

}  // namespace

// a, y, z: [P, P, n] f32; adjm: [P, P] f32; w: [P, n] f32 (weighted only,
// else ignored); zn, yn: [P, P, n] f32 out; part: [2, P*P, n_tiles] f32
// scratch with n_tiles = ceil(n / tile); pri, dz2: [P, P] f32 out.
// weighted: 0 = midpoint, 1 = weighted.
extern "C" int dip_consensus(const void* a, const void* y, const void* z,
                             const void* adjm, const void* w, void* zn,
                             void* yn, void* part, void* pri, void* dz2, int P,
                             int n, int tile, int weighted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + tile - 1) / tile;
  const dim3 grid(n_tiles, P * P);
  const float* fa = static_cast<const float*>(a);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fm = static_cast<const float*>(adjm);
  const float* fw = static_cast<const float*>(w);
  float* fzn = static_cast<float*>(zn);
  float* fyn = static_cast<float*>(yn);
  float* fp = static_cast<float*>(part);
  if (weighted)
    consensus_tile<true><<<grid, NT, 0, s>>>(fa, fy, fz, fm, fw, fzn, fyn, fp,
                                             P, n, tile, n_tiles);
  else
    consensus_tile<false><<<grid, NT, 0, s>>>(fa, fy, fz, fm, fw, fzn, fyn,
                                              fp, P, n, tile, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  consensus_sum<<<P * P, 32, 0, s>>>(fp, static_cast<float*>(pri),
                                     static_cast<float*>(dz2), P * P, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
