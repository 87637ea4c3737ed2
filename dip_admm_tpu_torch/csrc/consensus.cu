// Hopper (sm_90a) kernel of the fused edge-consensus update: the Pallas
// kernel consensus_update of dip_admm_tpu/ops/pallas/consensus.py (both
// bodies, _kernel_midpoint and _kernel_weighted), written again for CUDA.
//
//   K5 dip_consensus         <- consensus_update, single device, over a
//                               leading batch of B independent edge states
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
// [8, 8, 65536] f32 (16.8 MB); the least a call can move is a, y and z read
// once and z', y' written once, 83.9 MB, 25 us at 3.35 TB/s. Each pixel
// costs a handful of flops, so nothing but the streams matters.
//
// Design: one launch, no scratch, no atomics, deterministic.
// - Single device: one thread-block cluster of C = 8 blocks for each
//   unordered pair {i, j}, i <= j. A thread loads a_ij and a_ji once, with
//   y and z of both ordered pairs, and writes z', y' and the partial sums of
//   both (i, j) and (j, i): each proposal is read once (the first design
//   read a twice, as a_ij and by index as a_ji: 100.7 MB a call). Each
//   ordered pair is masked by its own adjm entry (adjm need not be
//   symmetric), and each fuses as the first design fused it, so z' and y'
//   are the same expressions, bit for bit. A diagonal pair (i, i) reads its
//   row once, as itself.
// - Sharded form (the node x pixel mesh): a rank holds the rows i of its
//   node block, [P_loc, P, n_loc] over its pixel block, and a_ji lies on
//   another rank. The caller gathers it with an all_to_all into a_t
//   [P_loc, P, n_loc], which the kernel reads in place of a[j, i], and
//   passes its own weights w_own [P_loc, n_loc] beside every node's w_all
//   [P, n_loc] (the TPU kernel's contract). One cluster for each ordered
//   pair (i, j); the six streams a, a_t, y, z, z', y' once each.
// - Within a cluster, block r streams its 1/C of the pair's pixels in
//   16-byte loads and stores (n % 4 == 0 and every row 16-byte aligned;
//   else a scalar path in the same kernel, as for odd N), keeps per-thread
//   sums, and reduces them with the fixed shuffle tree of the first design
//   (warps, then the warp partials in warp 0), and writes its partials into
//   rank 0's shared memory over distributed shared memory. After one
//   cluster barrier rank 0 adds the C partials in rank order and writes pri
//   and dz2; no block's shared memory is read after the barrier but rank
//   0's own (a first form in which rank 0 read each block's shared memory
//   needed a second barrier before any block could exit). The TPU kernel
//   carries the per-pair sum across its sequential pixel-tile axis; the
//   cluster replaces that carry and the first design's second launch and
//   scratch. The same inputs give bitwise-equal outputs on every call. The
//   one-launch alternative, a last-block ticket (2048-pixel blocks write
//   their partials to a scratch; an atomic count per pair lets the pair's
//   last block add them in tile order), was slower on the card at the
//   main-path shapes (PERF.md, section 6, PR 14).
// - Batch (scenario batching): a, y, z [B, P, P, n] against one graph and
//   one set of weights. Batch b is grid row blockIdx.z, its pointers
//   offset by b P P n (the partials by b P P); every lane computes what a
//   call on that lane alone computes, bit for bit. The offsets are a
//   template case of their own (BATCHED, B > 1), so that B = 1 runs the
//   unbatched kernel's code: with them in every kernel the weighted form
//   took 6% longer at B = 1 (PERF.md, section 6).
// - C = 8, the portable cluster size (16 and 4 were slower, and other
//   block sizes no faster: PERF.md, section 6, PR 14). 256-thread
//   blocks with 256 bytes of shared memory; at 256^2/8 36 clusters (288 blocks) and in a 2 x 2 mesh
//   rank's block 32 clusters, all resident at once (dip_consensus_clusters
//   returns cudaOccupancyMaxActiveClusters for this configuration).
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// The entries launch on the given stream, do not synchronise and return
// cudaGetLastError() (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int C = 8;  // blocks per cluster

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum
}

// One pixel of one ordered pair (i, j): av = a_ij, atv = a_ji, wi, wj the
// fusion weights of nodes i and j (weighted only); writes z', y' and adds
// to the pair's sums. The plain version's expressions, term for term; the
// weighted products are rounded apart (__fmul_rn), as the plain version
// rounds them, so that no fused multiply-add moves z'.
template <bool WEIGHTED>
__device__ __forceinline__ void update(float av, float atv, float yv,
                                       float zv, float wi, float wj,
                                       float adj, float& zo, float& yo,
                                       float& pri, float& dz2) {
  float zn;
  if (WEIGHTED)
    zn = ((__fmul_rn(wi, av) + __fmul_rn(wj, atv)) / (wi + wj)) * adj;
  else
    zn = 0.5f * (av + atv) * adj;
  const float dp = (av - yv - zn) * adj;
  const float dz = (zn - zv) * adj;
  zo = zn;
  yo = (av - zn) * adj;
  pri += dp * dp;
  dz2 += dz * dz;
}

struct Args {
  const float *a, *y, *z, *at, *adjm, *w_own, *w_all;
  float *zn, *yn, *pri, *dz2;
  int P, n;
};

// Pair (i, j) (and (j, i) where TWO) over pixels [p0, p1), one at a time.
template <bool WEIGHTED, bool TWO>
__device__ __forceinline__ void stream_scalar(const Args& g, long rij,
                                              long rji, const float* src_t,
                                              const float* wi_r,
                                              const float* wj_r, float m_ij,
                                              float m_ji, int p0, int p1,
                                              float (&s)[4]) {
  for (int p = p0 + threadIdx.x; p < p1; p += NT) {
    const float av = __ldg(g.a + rij + p), atv = __ldg(src_t + p);
    const float wi = WEIGHTED ? __ldg(wi_r + p) : 0.f;
    const float wj = WEIGHTED ? __ldg(wj_r + p) : 0.f;
    float zo, yo;
    update<WEIGHTED>(av, atv, __ldg(g.y + rij + p), __ldg(g.z + rij + p), wi,
                     wj, m_ij, zo, yo, s[0], s[1]);
    g.zn[rij + p] = zo;
    g.yn[rij + p] = yo;
    if (TWO) {
      update<WEIGHTED>(atv, av, __ldg(g.y + rji + p), __ldg(g.z + rji + p),
                       wj, wi, m_ji, zo, yo, s[2], s[3]);
      g.zn[rji + p] = zo;
      g.yn[rji + p] = yo;
    }
  }
}

// Loads through the read-only path: no store of the kernel aliases them.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The same over pixels [4 q0, 4 q1) in 16-byte steps, the four pixels of a
// step in order (not unrolled: unrolling by 2 or 4 was no faster, and 5%
// slower in the weighted single-device form).
template <bool WEIGHTED, bool TWO>
__device__ __forceinline__ void stream_vec(const Args& g, long rij, long rji,
                                           const float* src_t,
                                           const float* wi_r,
                                           const float* wj_r, float m_ij,
                                           float m_ji, int q0, int q1,
                                           float (&s)[4]) {
#pragma unroll 1
  for (int q = q0 + threadIdx.x; q < q1; q += NT) {
    const long p = 4L * q;
    const float4 A = ld4(g.a + rij + p), AT = ld4(src_t + p);
    const float4 Y = ld4(g.y + rij + p), Z = ld4(g.z + rij + p);
    float4 WI = make_float4(0.f, 0.f, 0.f, 0.f), WJ = WI;
    if (WEIGHTED) {
      WI = ld4(wi_r + p);
      WJ = ld4(wj_r + p);
    }
    float4 Y2 = WI, Z2 = WI;
    if (TWO) {
      Y2 = ld4(g.y + rji + p);
      Z2 = ld4(g.z + rji + p);
    }
    float4 zo, yo, zo2, yo2;
    update<WEIGHTED>(A.x, AT.x, Y.x, Z.x, WI.x, WJ.x, m_ij, zo.x, yo.x, s[0],
                     s[1]);
    update<WEIGHTED>(A.y, AT.y, Y.y, Z.y, WI.y, WJ.y, m_ij, zo.y, yo.y, s[0],
                     s[1]);
    update<WEIGHTED>(A.z, AT.z, Y.z, Z.z, WI.z, WJ.z, m_ij, zo.z, yo.z, s[0],
                     s[1]);
    update<WEIGHTED>(A.w, AT.w, Y.w, Z.w, WI.w, WJ.w, m_ij, zo.w, yo.w, s[0],
                     s[1]);
    st4(g.zn + rij + p, zo);
    st4(g.yn + rij + p, yo);
    if (TWO) {
      update<WEIGHTED>(AT.x, A.x, Y2.x, Z2.x, WJ.x, WI.x, m_ji, zo2.x, yo2.x,
                       s[2], s[3]);
      update<WEIGHTED>(AT.y, A.y, Y2.y, Z2.y, WJ.y, WI.y, m_ji, zo2.y, yo2.y,
                       s[2], s[3]);
      update<WEIGHTED>(AT.z, A.z, Y2.z, Z2.z, WJ.z, WI.z, m_ji, zo2.z, yo2.z,
                       s[2], s[3]);
      update<WEIGHTED>(AT.w, A.w, Y2.w, Z2.w, WJ.w, WI.w, m_ji, zo2.w, yo2.w,
                       s[2], s[3]);
      st4(g.zn + rji + p, zo2);
      st4(g.yn + rji + p, yo2);
    }
  }
}

// grid (C, pairs, B), clusters of C blocks along x: cluster y is unordered
// pair y (single device; i <= j in row-major order) or ordered pair y
// (sharded); block rank r streams pixels [r * chunk, (r + 1) * chunk).
template <bool WEIGHTED, bool SHARDED, bool VEC, bool BATCHED>
__global__ void __launch_bounds__(NT) consensus(Args g) {
  const int P = g.P, n = g.n;
  if (BATCHED) {  // batch lane blockIdx.z
    const long lane = blockIdx.z;
    const long so = lane * P * P * n;
    g.a += so;
    g.y += so;
    g.z += so;
    g.zn += so;
    g.yn += so;
    g.pri += lane * P * P;
    g.dz2 += lane * P * P;
  }
  int i, j;
  if (SHARDED) {
    i = blockIdx.y / P;
    j = blockIdx.y % P;
  } else {
    int u = blockIdx.y;
    i = 0;
    while (u >= P - i) {
      u -= P - i;
      ++i;
    }
    j = i + u;
  }
  const bool two = !SHARDED && i != j;
  const long rij = ((long)i * P + j) * n, rji = ((long)j * P + i) * n;
  // a_ji: the caller's a_t at this pair (sharded), else a[j, i, :].
  const float* src_t = SHARDED ? g.at + rij : g.a + rji;
  const float* wi_r = g.w_own + (long)i * n;
  const float* wj_r = g.w_all + (long)j * n;
  const float m_ij = g.adjm[(long)i * P + j];
  const float m_ji = two ? g.adjm[(long)j * P + i] : 0.f;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  // Arrive now, wait before the first write to rank 0's shared memory: by
  // then every block of the cluster has started (distributed shared memory
  // is valid only then), so the wait costs nothing.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float s[4] = {0.f, 0.f, 0.f, 0.f};  // pri_ij, dz2_ij, pri_ji, dz2_ji
  if (VEC) {
    const int nq = n / 4, chunk = (nq + C - 1) / C;
    const int q0 = min(r * chunk, nq), q1 = min(q0 + chunk, nq);
    if (two)
      stream_vec<WEIGHTED, true>(g, rij, rji, src_t, wi_r, wj_r, m_ij, m_ji,
                                 q0, q1, s);
    else
      stream_vec<WEIGHTED, false>(g, rij, rji, src_t, wi_r, wj_r, m_ij, m_ji,
                                  q0, q1, s);
  } else {
    const int chunk = (n + C - 1) / C;
    const int p0 = min(r * chunk, n), p1 = min(p0 + chunk, n);
    if (two)
      stream_scalar<WEIGHTED, true>(g, rij, rji, src_t, wi_r, wj_r, m_ij,
                                    m_ji, p0, p1, s);
    else
      stream_scalar<WEIGHTED, false>(g, rij, rji, src_t, wi_r, wj_r, m_ij,
                                     m_ji, p0, p1, s);
  }
  __shared__ float sw[4][NW];
  __shared__ float sb[C][4];  // rank 0's: every block's partials, by rank
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(s[k]);
    if (lane == 0) sw[k][warp] = v;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    float* dst = cluster.map_shared_rank(&sb[r][0], 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = warp_sum(lane < NW ? sw[k][lane] : 0.f);
      if (lane == 0) dst[k] = v;
    }
  }
  cluster.sync();  // every block's partials are in rank 0's sb
  if (r == 0 && threadIdx.x < (two ? 4 : 2)) {
    const int k = threadIdx.x;
    float acc = 0.f;
    for (int q = 0; q < C; ++q) acc += sb[q][k];
    const long pair = k < 2 ? (long)i * P + j : (long)j * P + i;
    (k % 2 == 0 ? g.pri : g.dz2)[pair] = acc;
  }
}

// The launch configuration of a grid of clusters of C blocks along x, the
// pairs along y and the batch along z.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int pairs, int batch, cudaStream_t s) {
    cfg.gridDim = dim3(C, pairs, batch);
    cfg.blockDim = dim3(NT);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <bool WEIGHTED, bool SHARDED, bool VEC>
cudaError_t launch3(const Args& g, int pairs, int batch, cudaStream_t s) {
  ClusterLaunch l(pairs, batch, s);
  if (!SHARDED && batch > 1)
    return cudaLaunchKernelEx(&l.cfg, consensus<WEIGHTED, SHARDED, VEC, true>,
                              g);
  return cudaLaunchKernelEx(&l.cfg, consensus<WEIGHTED, SHARDED, VEC, false>,
                            g);
}

template <bool SHARDED, bool VEC>
cudaError_t launch2(const Args& g, int weighted, int pairs, int batch,
                    cudaStream_t s) {
  return weighted ? launch3<true, SHARDED, VEC>(g, pairs, batch, s)
                  : launch3<false, SHARDED, VEC>(g, pairs, batch, s);
}

bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <bool SHARDED>
cudaError_t launch(Args g, int P_loc, int batch, int weighted,
                   cudaStream_t s) {
  const int P = g.P;
  const int pairs = SHARDED ? P_loc * P : P * (P + 1) / 2;
  if (pairs < 1 || pairs > 65535 || g.n < 1 || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  bool vec = g.n % 4 == 0 && aligned(g.a) && aligned(g.y) && aligned(g.z) &&
             aligned(g.zn) && aligned(g.yn) && (!SHARDED || aligned(g.at));
  if (weighted) vec = vec && aligned(g.w_own) && aligned(g.w_all);
  return vec ? launch2<SHARDED, true>(g, weighted, pairs, batch, s)
             : launch2<SHARDED, false>(g, weighted, pairs, batch, s);
}

}  // namespace

// a, y, z: [B, P, P, n] f32; adjm: [P, P] f32; w: [P, n] f32 (weighted
// only, else ignored), both shared by the batch; zn, yn: [B, P, P, n] f32
// out; pri, dz2: [B, P, P] f32 out. weighted: 0 = midpoint, 1 = weighted.
extern "C" int dip_consensus(const void* a, const void* y, const void* z,
                             const void* adjm, const void* w, void* zn,
                             void* yn, void* pri, void* dz2, int B, int P,
                             int n, int weighted, void* stream) {
  Args g{};
  g.a = static_cast<const float*>(a);
  g.y = static_cast<const float*>(y);
  g.z = static_cast<const float*>(z);
  g.adjm = static_cast<const float*>(adjm);
  g.w_own = g.w_all = static_cast<const float*>(w);
  g.zn = static_cast<float*>(zn);
  g.yn = static_cast<float*>(yn);
  g.pri = static_cast<float*>(pri);
  g.dz2 = static_cast<float*>(dz2);
  g.P = P;
  g.n = n;
  return static_cast<int>(
      launch<false>(g, P, B, weighted, static_cast<cudaStream_t>(stream)));
}

// The sharded form: a, y, z, a_t: [P_loc, P, n] f32 over this rank's pixel
// block (n = n_loc); adjm: [P_loc, P] f32; w_own: [P_loc, n], w_all: [P, n]
// f32 (weighted only, else ignored); zn, yn: [P_loc, P, n] f32 out; pri,
// dz2: [P_loc, P] f32 out.
extern "C" int dip_consensus_sharded(const void* a, const void* y,
                                     const void* z, const void* a_t,
                                     const void* adjm, const void* w_own,
                                     const void* w_all, void* zn, void* yn,
                                     void* pri, void* dz2, int P_loc, int P,
                                     int n, int weighted, void* stream) {
  Args g{};
  g.a = static_cast<const float*>(a);
  g.y = static_cast<const float*>(y);
  g.z = static_cast<const float*>(z);
  g.at = static_cast<const float*>(a_t);
  g.adjm = static_cast<const float*>(adjm);
  g.w_own = static_cast<const float*>(w_own);
  g.w_all = static_cast<const float*>(w_all);
  g.zn = static_cast<float*>(zn);
  g.yn = static_cast<float*>(yn);
  g.pri = static_cast<float*>(pri);
  g.dz2 = static_cast<float*>(dz2);
  g.P = P;
  g.n = n;
  return static_cast<int>(
      launch<true>(g, P_loc, 1, weighted,
                   static_cast<cudaStream_t>(stream)));
}

// cudaOccupancyMaxActiveClusters of the kernel (sharded: 0 or 1, weighted:
// 0 or 1, the 16-byte path) with its clusters of C blocks of NT threads: how
// many clusters the card holds at once (negative: the CUDA error).
extern "C" int dip_consensus_clusters(int sharded, int weighted) {
  void (*kern)(Args) =
      sharded ? (weighted ? consensus<true, true, true, false>
                          : consensus<false, true, true, false>)
              : (weighted ? consensus<true, false, true, false>
                          : consensus<false, false, true, false>);
  ClusterLaunch l(1, 1, nullptr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kern, &l.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
