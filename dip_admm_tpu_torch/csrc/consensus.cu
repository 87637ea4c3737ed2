// Hopper (sm_90a) kernel of the fused edge-consensus update: the Pallas
// kernel consensus_update of dip_admm_tpu/ops/pallas/consensus.py (both
// bodies, _kernel_midpoint and _kernel_weighted), written again for CUDA.
//
//   K5 dip_consensus         <- consensus_update, single device
//   K5 dip_consensus_sharded <- consensus_update with its caller's a_t
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
// Sharded form (the node x pixel mesh): a rank holds the rows i of its node
// block, [P_loc, P, n_loc] over its pixel block, and a_ji lies on another
// rank. The caller gathers it with an all_to_all into a_t [P_loc, P, n_loc],
// which the kernel reads in place of a[j, i], and passes its own weights
// w_own [P_loc, n_loc] beside every node's w_all [P, n_loc] (the TPU
// kernel's contract). The same two passes run over P_loc * P pairs; the
// single-device entry is this form with a_t read from a by index and
// w_own = w_all = w.
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

template <bool WEIGHTED, bool SHARDED>
__global__ void __launch_bounds__(NT)
consensus_tile(const float* __restrict__ a, const float* __restrict__ y,
               const float* __restrict__ z, const float* __restrict__ at,
               const float* __restrict__ adjm,
               const float* __restrict__ w_own,
               const float* __restrict__ w_all, float* __restrict__ zn,
               float* __restrict__ yn, float* __restrict__ part, int P, int n,
               int tile, int n_tiles) {
  const int pair = blockIdx.y;  // i * P + j, i local to the rank
  const int i = pair / P, j = pair % P;
  const int t = blockIdx.x;
  const long row = (long)pair * n;
  // a_ji: the caller's a_t at this pair (sharded), else a[j, i, :].
  const float* src_t = SHARDED ? at + row : a + ((long)j * P + i) * n;
  const float adj = adjm[pair];
  const int p1 = min((t + 1) * tile, n);
  float pri = 0.f, dz2 = 0.f;
  for (int p = t * tile + threadIdx.x; p < p1; p += NT) {
    const float av = a[row + p], atv = src_t[p];
    float zv;
    if (WEIGHTED) {
      const float wi = w_own[(long)i * n + p], wj = w_all[(long)j * n + p];
      zv = ((wi * av + wj * atv) / (wi + wj)) * adj;
    } else {
      zv = 0.5f * (av + atv) * adj;
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
      part[(long)gridDim.y * n_tiles + k] = dz2;  // after the P_loc*P pri rows
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

template <bool SHARDED>
cudaError_t launch(const void* a, const void* y, const void* z, const void* at,
                   const void* adjm, const void* w_own, const void* w_all,
                   void* zn, void* yn, void* part, void* pri, void* dz2,
                   int P_loc, int P, int n, int tile, int weighted,
                   cudaStream_t s) {
  const int n_tiles = (n + tile - 1) / tile;
  const dim3 grid(n_tiles, P_loc * P);
  const float* fa = static_cast<const float*>(a);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fat = static_cast<const float*>(at);
  const float* fm = static_cast<const float*>(adjm);
  const float* fwo = static_cast<const float*>(w_own);
  const float* fwa = static_cast<const float*>(w_all);
  float* fzn = static_cast<float*>(zn);
  float* fyn = static_cast<float*>(yn);
  float* fp = static_cast<float*>(part);
  if (weighted)
    consensus_tile<true, SHARDED><<<grid, NT, 0, s>>>(
        fa, fy, fz, fat, fm, fwo, fwa, fzn, fyn, fp, P, n, tile, n_tiles);
  else
    consensus_tile<false, SHARDED><<<grid, NT, 0, s>>>(
        fa, fy, fz, fat, fm, fwo, fwa, fzn, fyn, fp, P, n, tile, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  consensus_sum<<<P_loc * P, 32, 0, s>>>(fp, static_cast<float*>(pri),
                                         static_cast<float*>(dz2), P_loc * P,
                                         n_tiles);
  return cudaGetLastError();
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
  return static_cast<int>(launch<false>(
      a, y, z, nullptr, adjm, w, w, zn, yn, part, pri, dz2, P, P, n, tile,
      weighted, static_cast<cudaStream_t>(stream)));
}

// The sharded form: a, y, z, a_t: [P_loc, P, n] f32 over this rank's pixel
// block (n = n_loc); adjm: [P_loc, P] f32; w_own: [P_loc, n], w_all: [P, n]
// f32 (weighted only, else ignored); zn, yn: [P_loc, P, n] f32 out; part:
// [2, P_loc*P, n_tiles] f32 scratch; pri, dz2: [P_loc, P] f32 out.
extern "C" int dip_consensus_sharded(const void* a, const void* y,
                                     const void* z, const void* a_t,
                                     const void* adjm, const void* w_own,
                                     const void* w_all, void* zn, void* yn,
                                     void* part, void* pri, void* dz2,
                                     int P_loc, int P, int n, int tile,
                                     int weighted, void* stream) {
  return static_cast<int>(launch<true>(
      a, y, z, a_t, adjm, w_own, w_all, zn, yn, part, pri, dz2, P_loc, P, n,
      tile, weighted, static_cast<cudaStream_t>(stream)));
}
