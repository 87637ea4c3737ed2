// Hopper (sm_90a) kernels of the fft_skew and fft_shear projectors: six
// Pallas kernels of dip_admm_tpu/ops/pallas/shear_sum.py, written again for
// CUDA.
//
//   K1 dip_skew_fwd  <- skew_sum_planes    (_skew_fwd_pallas_planes)
//   K2 dip_skew_t    <- skew_sum_planes_t  (_skew_t_pallas_planes)
//   K3 dip_eval_fwd  <- eval_shear         (_eval_fwd_pallas, with the Wd
//                                           epilogue of its caller)
//   K4 dip_eval_t    <- eval_shear_t       (_eval_t_pallas, with the Wd
//                                           pre-contraction of its caller)
//   K6 dip_skew_t    <- skew_sum_planes_t_rows (_skew_t_pallas_planes with
//                       row_width: K2 at a row width WS above the row count
//                       NB * nb of one pixel shard's row blocks)
//   K7 dip_shear_fwd <- shear_sum_planes   (_fwd_pallas_planes)
//   K8 dip_shear_t   <- shear_sum_planes_t (_t_pallas_planes)
//   K9 dip_shear_fwd <- shear_sum          (_fwd_pallas; plane null)
//   K10 dip_shear_t  <- shear_sum_t        (_t_pallas; plane null)
//
// Each computes what the TPU kernel computes and rounds to the table type
// at the same points (bf16 tables: the image rows before the tap product,
// the skew sum z before the DFT-back, the phase products in K2/K3 and PhiD
// in K3/K4, the pre-contracted cotangent in K4; the row spectra before
// K7's tap product and the phased cotangent S before K8's). f32 tables
// round nowhere.
// Accumulation is always f32.
//
// Node-shared tables: every entry takes an image batch PB and a table batch
// PT that divides it; image p reads table set p % PT (the rule of the JAX
// kernels' vmap, which folds an image batch into the node axis and keeps one
// table set). The parallel paths run PT = PB, the fan-beam path PT = 1.
//
// Design of K1/K2 with f32 tables, and of K3's R stage and K4's phase
// products with f32 tables: a plain shared-memory tiled product on the CUDA
// cores. A block owns a 16 x 64 output tile; each of its 256 threads keeps
// one row and four columns (tx + 16 j) in registers. The TPU grid's
// sequential axes become loops inside the block: K1 loops over the row
// blocks whose spectra it sums, K2 over the angle blocks that feed its
// image plane, K4 over the detector blocks, so every output element is
// written once by one block and no atomics are needed. The tap stage
// (about 14.5 GFLOP per apply at 256^2/8, the bulk of the projector) is
// bound by shared-memory reads in this form (5 loads per 4 FMAs).
//
// K3/K4 (the eval tail; redesigned) are two launches each, with either
// table type. The JAX package keeps the Wd epilogue of K3 and the Wd
// pre-contraction of K4 as XLA einsums outside Pallas (VMEM, and Mosaic's
// dot without batch dims); here they are hand-written kernels too, so that
// no f32 copy of Wd (151 MB at 256^2/8) and no cast of PhiD is made and a
// call moves about the ~86 MB that the function needs:
// - K3: the R stage (bf16 tables: bf16 mma.sync, M = 16 angle rows, N = z,
//   K = f, A/B and PhiD rounded to bf16 in the block; f32 tables: the
//   CUDA-core product above), R in f32 [PB, DB, Tp, D2p], then the
//   epilogue, one stream over the dense Wd in its own type (16 z groups,
//   each summing its z in ascending order, the partials added in ascending
//   group), writing out [PB, Tp, DB * db] directly;
// - K4: the pre-contraction as the same stream (a z row's d summed by a
//   fixed shuffle tree), Rbar rounded to the table type, then the phase
//   products (bf16 tables: bf16 mma.sync, M = 32 angle rows, K = z, N = f
//   through ldmatrix.trans; f32 tables: the CUDA-core product) and the
//   phase combine in ascending b.
// The Wd streams are dense on purpose: Wd is 98.96% zeros at 256^2/8, but
// a NaN in R or in the cotangent must reach every element of its row, as
// the plain version's dense einsum carries it. Two launches rather than
// one: a block owning a whole (p, b, 16-row) tile would give 96 blocks at
// 256^2/8 and 48 at a mesh rank's P_loc = 4, and a fused K4 would read Wd
// again for every f chunk. Every element's sum order is fixed and does not
// depend on the batch or the grid, so a node block's outputs equal the
// whole batch's rows bit for bit. What bounds them now: the Wd streams run
// at ~77% of HBM's rate (their loads are branch-free when db is a multiple
// of 8: a branch between a thread's loads held them near 60%), and the R
// stage and K4's phase products are bound by their L2 reads (every block
// reads its z rows of PhiD again, in f32; the R stage reads PhiD and g
// once for a pair of detector blocks, a third of the time of a block per
// detector block at 256^2/8). PERF.md has the times.
//
// K1 with bf16 tables (redesigned; every card path runs bf16 tables) runs
// both stages on the tensor cores. The TPU kernel (_skew_fwd_body) runs
// them on the MXU with the rows, taps, z and D in bf16 and f32 sums, so a
// bf16 mma.sync (m16n8k16, f32 accumulators) gives exactly its products.
// On the CUDA cores the tap product was bound by shared-memory reads and
// the f32 FMA rate (2.26 ms at 256^2/8, 0.94% of the bytes bound). Now:
// - two layout passes: the rows are rounded to bf16 once and transposed
//   (xT [..., u, n]), and D is copied to 16-byte rows (its F = 513
//   columns are not), so every later load is a 16-byte cp.async;
// - the tap product is one contraction over K = (d, n), with v as the M
//   dimension and 8 slots t as N: the row window is staged [column][row],
//   so the shift by tap d is a row offset of the ldmatrix A operand and no
//   window is staged again per tap; a block takes all v of its angle block
//   (where the grid stays wide enough), so each tap is read from memory
//   once; 32 taps a stage stream through a cp.async ring;
// - the tap table is 98.6% zeros (two adjacent taps of D2 per row): the
//   block marks which (d, 16 rows, 8 slots) tiles hold a nonzero, 19% of
//   them at 256^2/8, and the warps run the MMAs of those only (a zero tile
//   adds exact zeros for finite rows; a NaN pixel still reaches every real
//   slot, since each real slot has a nonzero tap on its row);
// - z leaves stage 1 already rounded to bf16 (the TPU kernel's rounding
//   point) and the DFT-back reads D through ldmatrix.trans as a second
//   bf16 product; each row block's term E_b * (z_b @ D) is formed whole in
//   registers and added to the running f32 sum in ascending b, so a pixel
//   mesh's sum of per-shard K1 outputs equals K1 on all rows bit for bit.
//   No sum depends on the tiling.
// What bounds it now: the tap product's shared-memory fragment loads (an
// m16 A fragment per MMA, as N is only 8 slots) and MMAs on the nonzero
// tiles; then the DFT-back, latency-bound for its 0.8 GFLOP. PERF.md has
// the times.
//
// K2 with bf16 tables (redesigned) is K1's design transposed. The TPU
// kernel (_skew_t_pallas_planes) rounds the phased cotangent Zr/Zi to bf16
// before the DFT-forward and the zbar windows before the tap product, and
// sums in f32, so both products are exact on bf16 mma.sync. On the CUDA
// cores the tap product ran all ~14.5 GFLOP of the dense product at
// 256^2/8 (1.6-1.7 ms, 1.3% of the bytes bound). Now three launches:
// - a phase pass forms Zr/Zi in f32 and rounds them once into 16-byte rows
//   (g and SE have F = 513 columns, so they are not);
// - the DFT-forward reads D*T [f][w] (rows of WZ bf16) through
//   ldmatrix.trans as the A operand, w as M and the slots as N, over the
//   columns w a tap can read, and writes zbar already rounded to bf16 and
//   transposed, zT [w][t], so the tap product needs no layout pass;
// - the tap product is one contraction over K = (tb, d, t) with u as M and
//   the image rows n as N: the angle block's zT window is staged [w][t]
//   once, so tap d is a row offset of the A operand; K runs in units of 8
//   slots, so an 8-slot fan block pairs taps d and d + 1 in one k16 step
//   (the second half a row offset one smaller) instead of padding t to 16;
//   the block marks which (k16 step, 8 n) tap tiles hold a nonzero and the
//   warps run the MMAs of those only; each output tile is written once by
//   the block that owns it, zeros included for a plane no angle block
//   reads, so the output needs no memset.
// The K order of every element is fixed (tb ascending, then d, then t), so
// no sum depends on the grid, which adapts to the batch, and K6's one-block
// row shards concatenated equal K2 bit for bit. What bounds it now: the
// tap product's walk over the nonzero tiles, one visited k16 step after
// another (latency, not MMA throughput: the tensor cores are mostly idle),
// and its per-stage marking of the tiles, more than the wait for the dense
// tap table (98.6% zeros); then the DFT-forward, latency-bound for its
// ~1.5 GFLOP. PERF.md has the times.
//
// K7/K8 (fft_shear's tap contraction on the row spectra) with f32 tables
// keep the plain register-tiled product on the CUDA cores: the TPU
// kernel's dense [tt*D2, nb] x [nb, F] product, re and im, 4 FMAs per
// shared-memory load (K7: 1 angle x 8 taps x 4 frequencies of S a thread;
// K8: 4 rows x 4 frequencies); K7's block owns g[p, angle tile, f tile]
// and loops over the row blocks and taps, K8's owns one (image, plane, row
// block, n tile, f tile) and adds the angle blocks on its plane in order.
//
// K7/K8 with bf16 tables (redesigned; every card path runs bf16 tables)
// run the tap product on the tensor cores. The TPU kernel (_fwd_kernel,
// _t_pallas_planes) rounds the spectra (K7) or S = conj(Phi) conj(E_b) gbar
// (K8) to bf16 and sums in f32 on the MXU, so bf16 mma.sync (m16n8k16, f32
// accumulators) gives its products exactly. The dense product is ~58 GFLOP
// a direction at 256^2/8, but only two of a row's D2 taps are nonzero
// (1.39% of Wt): the function needs ~0.8 GFLOP, and its bound is the ~83 MB
// it must move, 56.6 MB of them Wt. Two launches each:
// - a mask pass reads Wt once, densely (each byte of it from HBM once), and
//   writes a word per (table set, row block, angle, 8 taps) whose bit q
//   marks a nonzero 8 x 8 tile (rows 8q..); 8.2% of the tiles at 256^2/8;
// - the tap product walks only the marked steps. K7: M = 16 frequencies,
//   N = 8 taps of one angle, K = 16 rows; a warp holds its frequencies'
//   rounded spectra (all nb rows of a row block) as A fragments in
//   registers, and a step is one (row block, angle, 8 taps). K8: M = 16
//   frequencies, N = 8 rows, K = 16 taps of one angle; the A fragment (S,
//   formed in f32 in the TPU kernel's order and rounded once) is made in
//   registers from T = conj(E_b) gbar and Phi for each marked step, with
//   no S tensor in memory, and a step is one (angle, 16 taps) of a 64-row
//   half. A group of four warps (four 16-frequency m-tiles) shares each
//   step's B: the step's marked 8 x 8 tiles are copied by cp.async into the
//   group's ring (zeros for an unmarked tile, no global read), three steps
//   deep, and read back by ldmatrix (K8: .trans, as a k pair is two tap
//   rows); the marked steps are compacted into a list once per block, so
//   the walk is an index. Phi's f32 rows for the block's 64 frequencies are
//   staged in shared memory once per block. K7 applies Phi to each step's
//   C in f32, the lane quad's partial sums meet by a fixed shuffle tree,
//   then E_b, and adds the row blocks in ascending b; K8 accumulates its
//   64 rows x 16 frequencies in registers over the steps in the order tb,
//   t, J. No sum depends on the grid (K7's adapts to the batch), so a second
//   call repeats the first bit for bit and K9 gives K7's bits.
// Skipping unmarked tiles is exact for finite inputs. A NaN still travels
// as the dense product carries it on real slots: every real slot has a
// nonzero tap on every row, so a NaN spectrum element reaches each real
// slot's g at its frequency through a marked tile of its row (K7), and a
// NaN in a real slot's cotangent reaches every row of its plane at its
// frequency (K8). An all-zero slack slot gets zeros where the dense product
// gives NaN; the projectors drop those slots.
// What bounds them now: not bytes (their Wt reads are a tenth of the
// dense table after the mask pass, which itself runs near HBM's rate) nor
// MMAs (~2 marked 16-row chunks a K7 step, ~4 n8 tiles a K8 step, the
// tensor cores mostly idle), but each step's fixed cost: the ring's copy
// and wait, the list and the Phi and shuffle work around a few MMAs
// (scripts/torch_shear_profile.py gives the cycles by phase). PERF.md has
// the times.
//
// K9/K10 are K7/K8 on slot spectra [PB, TB, N, F] gathered one-hot per angle
// block instead of the two planes: the same kernels with the source index
// the angle block tb itself (no plane table) and TB sources per image. K9
// gives K7's bits on the gathered spectra; K10 is K8 as a pure map, each
// block writing slot tb from angle block tb alone (no plane accumulation,
// nothing left unwritten). Their work and bounds are K7's and K8's; they are
// on no path of the system (the JAX package's stage bench alone runs them).
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;   // threads along the tile's columns
constexpr int TY = 16;   // threads along the tile's rows
constexpr int BM = 16;   // tile rows (= TY)
constexpr int BN = 64;   // tile columns (= 4 * TX)
constexpr int BK = 32;   // contraction chunk of the plain products
constexpr int DC = 16;   // tap chunk of the skew products
constexpr int NC = 16;   // row / angle chunk of the skew products
constexpr int NT = TX * TY;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> __device__ __forceinline__ float ld(const T* p, long i);
template <> __device__ __forceinline__ float ld<float>(const float* p, long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                   long i) {
  return __bfloat162float(p[i]);
}

// Round an f32 value to the table type's precision (identity for f32).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// K1, stage 1: tap product and skew sum.
//   z[p,tb,b,t,v] = sum_d sum_n WtT[p,b,d,tb*tt+t,n] * x[n, v-(D2-1)+d]
// with x = rows2[p, plane[p,tb], b*nb:(b+1)*nb, :] (zero outside [0, WS)).
// Block: (v tile, t tile, (p, tb, b)). Shared: a [DC, BM, NC] tap chunk and
// the [NC, BN+DC-1] row window that the chunk's DC shifts read.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
skew_tap_fwd(const float* __restrict__ rows2, const T* __restrict__ wtt,
             const int* __restrict__ plane, float* __restrict__ z, int PT,
             int NB, int D2, int Tp, int nb, int TB, int WS, int WZ) {
  __shared__ float Ws[DC][BM][NC];
  __shared__ float Xs[NC][BN + DC];
  const int tt = Tp / TB, N = NB * nb;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int v0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int b = blockIdx.z % NB, tb = (blockIdx.z / NB) % TB;
  const int p = blockIdx.z / (NB * TB), pt = p % PT;
  const int pl = plane[pt * TB + tb];
  const float* x = rows2 + ((long)(p * 2 + pl) * N + (long)b * nb) * WS;
  const T* w = wtt + (long)(pt * NB + b) * D2 * Tp * nb;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int d0 = 0; d0 < D2; d0 += DC) {
    const int ubase = v0 - (D2 - 1) + d0;  // u of window column 0
    // Skip tap chunks whose whole row window lies outside [0, WS): they
    // only add zeros (about half of the (v tile, d chunk) pairs, as v
    // spans WZ >= WS + D2 - 1). The test is uniform over the block.
    if (ubase + BN + DC - 2 < 0 || ubase >= WS) continue;
    for (int n0 = 0; n0 < nb; n0 += NC) {
      for (int i = tid; i < DC * BM * NC; i += NT) {
        const int n = i % NC, t = (i / NC) % BM, dl = i / (NC * BM);
        const int d = d0 + dl, tg = t0 + t, ng = n0 + n;
        float val = 0.f;
        if (d < D2 && tg < tt && ng < nb)
          val = ld<T>(w, ((long)d * Tp + tb * tt + tg) * nb + ng);
        Ws[dl][t][n] = val;
      }
      for (int i = tid; i < NC * (BN + DC - 1); i += NT) {
        const int c = i % (BN + DC - 1), n = i / (BN + DC - 1);
        const int u = ubase + c, ng = n0 + n;
        float val = 0.f;
        if (ng < nb && u >= 0 && u < WS) val = rnd<T>(x[(long)ng * WS + u]);
        Xs[n][c] = val;
      }
      __syncthreads();
#pragma unroll 4
      for (int dl = 0; dl < DC; ++dl) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float wv = Ws[dl][ty][n];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += wv * Xs[n][tx + TX * j + dl];
        }
      }
      __syncthreads();
    }
  }
  const int tg = t0 + ty;
  if (tg >= tt) return;
  float* zo = z + ((long)(p * TB + tb) * NB + b) * tt * WZ + (long)tg * WZ;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + tx + TX * j;
    if (v < WZ) zo[v] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// K1, stage 2: DFT-back, phase, and the sum over row blocks.
//   g[p,tb*tt+t,f] = sum_b E_b * (z_b @ D)[t,f],  E_b = SE[p,b,tb*tt+t,f]
// Block: (f tile, t tile, (p, tb)); it loops over the NB row blocks itself,
// so g is written once, whatever order the blocks run in.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
skew_dft_fwd(const float* __restrict__ z, const float* __restrict__ sere,
             const float* __restrict__ seim, const T* __restrict__ dre,
             const T* __restrict__ dim, float* __restrict__ gre,
             float* __restrict__ gim, int PT, int NB, int Tp, int TB, int WZ,
             int F) {
  __shared__ float Zs[BM][BK + 1];
  __shared__ float Dr[BK][BN];
  __shared__ float Di[BK][BN];
  const int tt = Tp / TB;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int f0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  const int tg = t0 + ty;
  float gr[4] = {0.f, 0.f, 0.f, 0.f}, gi[4] = {0.f, 0.f, 0.f, 0.f};

  for (int b = 0; b < NB; ++b) {
    const float* zb = z + ((long)(p * TB + tb) * NB + b) * tt * WZ;
    float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < WZ; k0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int k = i % BK, t = i / BK;
        float val = 0.f;
        if (t0 + t < tt && k0 + k < WZ)
          val = rnd<T>(zb[(long)(t0 + t) * WZ + k0 + k]);
        Zs[t][k] = val;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int f = i % BN, k = i / BN;
        float vr = 0.f, vi = 0.f;
        if (k0 + k < WZ && f0 + f < F) {
          const long o = (long)(k0 + k) * F + f0 + f;
          vr = ld<T>(dre, o);
          vi = ld<T>(dim, o);
        }
        Dr[k][f] = vr;
        Di[k][f] = vi;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float zv = Zs[ty][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ar[j] += zv * Dr[k][tx + TX * j];
          ai[j] += zv * Di[k][tx + TX * j];
        }
      }
      __syncthreads();
    }
    if (tg < tt) {
      const long eo = ((long)(pt * NB + b) * Tp + tb * tt + tg) * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx + TX * j;
        if (f < F) {
          const float er = sere[eo + f], ei = seim[eo + f];
          gr[j] += ar[j] * er - ai[j] * ei;
          gi[j] += ar[j] * ei + ai[j] * er;
        }
      }
    }
  }
  if (tg >= tt) return;
  const long go = ((long)p * Tp + tb * tt + tg) * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = f0 + tx + TX * j;
    if (f < F) {
      gre[go + f] = gr[j];
      gim[go + f] = gi[j];
    }
  }
}

// ---------------------------------------------------------------------------
// K1 with bf16 tables, on the tensor cores (bf16 mma.sync m16n8k16, f32
// accumulators in registers). Four launches: two layout passes, the tap
// product, the DFT-back. Their scratch, in one bf16 buffer (see
// skew_scratch): z [PB, TB, NB, tt, ZS], the rounded rows transposed
// xT [PB, 2, NB, WS, nbp], and D padded to 16-byte rows [2, ZS, Fp].
// ---------------------------------------------------------------------------
using B16 = __nv_bfloat16;
constexpr int TC_NT = 128;      // 4 warps (DFT-back)
constexpr int TC_WARPS1 = 8;    // tap product
constexpr int TC_NT1 = 32 * TC_WARPS1;
constexpr int TC_STAGES = 3;    // tap stages in flight (cp.async ring)
constexpr int TC_DS = 32;       // taps d per stage
constexpr int TC_NCH = 32;      // image rows n per window chunk, at most
constexpr int TC_PAD = 8;       // bf16 padding of a shared-memory row
constexpr int TC_KC = 64;       // v per DFT-back stage
constexpr int TC_DSTAGES = 4;   // DFT-back stages in flight
constexpr int TC_MAX_SMEM = 232448;

struct SkewScratch {
  int ZS, NCH, nbp, Fp;
  long x_off, d_off, total;  // bf16 elements; z at 0
};

// The layout of K1's bf16 scratch (the wrapper allocates `total` elements,
// asking dip_skew_fwd_scratch).
SkewScratch skew_scratch(int PB, int TB, int NB, int tt, int nb, int D2,
                         int WS, int F) {
  SkewScratch s;
  s.ZS = cdiv(WS + D2 - 1, 64) * 64;  // z columns that can be nonzero
  s.NCH = nb >= TC_NCH ? TC_NCH : cdiv(nb, 16) * 16;
  s.nbp = cdiv(nb, s.NCH) * s.NCH;
  s.Fp = cdiv(F, 64) * 64;
  s.x_off = (long)PB * TB * NB * tt * s.ZS;
  s.d_off = s.x_off + (long)PB * 2 * NB * WS * s.nbp;
  s.total = s.d_off + 2L * s.ZS * s.Fp;
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
// With .trans each thread receives the transposed fragments.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 products summed in f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// B fragments of NT8 n8 tiles (rows t of a [t][k] bf16 tile with row
// stride ld; rows up to 8 * NT8 rounded up to 16 staged) at k offset kk.
template <int NT8>
__device__ __forceinline__ void load_b(unsigned (&bf)[NT8 + 1][2],
                                       const B16* tile, int ld, int kk,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < NT8; j += 2) {
    unsigned r[4];
    ldsm_x4(r, tile + (8 * (j + (lane >> 4)) + (lane & 7)) * ld + kk +
                   ((lane >> 3) & 1) * 8);
    bf[j][0] = r[0];
    bf[j][1] = r[1];
    bf[j + 1][0] = r[2];
    bf[j + 1][1] = r[3];
  }
}

// Layout pass 1: xT[p, pl, b, u, n] = bf16(rows2[p, pl, b*nb + n, u]),
// zero for n >= nb: the rows rounded to bf16 once (the TPU kernel's
// rounding point) and transposed, so that a window row is 16-byte pieces.
__global__ void __launch_bounds__(256)
skew_prep_x(const float* __restrict__ rows2, B16* __restrict__ xT, int NB,
            int nb, int nbp, int WS) {
  __shared__ float tile[32][33];
  const int u0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const long q = blockIdx.z;  // (p * 2 + pl) * NB + b
  const float* src = rows2 + q * nb * WS;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int n = n0 + j, u = u0 + threadIdx.x;
    tile[j][threadIdx.x] = n < nb && u < WS ? src[(long)n * WS + u] : 0.f;
  }
  __syncthreads();
  B16* dst = xT + q * WS * nbp;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int u = u0 + j, n = n0 + threadIdx.x;
    if (u < WS && n < nbp)
      dst[(long)u * nbp + n] = __float2bfloat16_rn(tile[threadIdx.x][j]);
  }
}

// Layout pass 2: D (rows of F bf16, an odd count, so not 16-byte aligned)
// copied to rows of Fp, zero past F and for v >= WZ: dp [2, ZS, Fp].
__global__ void __launch_bounds__(256)
skew_prep_d(const B16* __restrict__ dre, const B16* __restrict__ dim,
            B16* __restrict__ dp, int WZ, int F, int ZS, int Fp) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long)ZS * Fp) return;
  const int v = (int)(i / Fp), f = (int)(i % Fp);
  const bool in = v < WZ && f < F;
  const long o = (long)v * F + f;
  dp[i] = in ? dre[o] : __float2bfloat16_rn(0.f);
  dp[(long)ZS * Fp + i] = in ? dim[o] : __float2bfloat16_rn(0.f);
}

// Tap product as one contraction over K = (d, n),
//   zT[v, t] = sum_d sum_n X[v + d, n] * WtT[d, t, n],
// X[r, n] = xT[u = v0 - (D2-1) + r, n] the row window in [column][row]
// form, so the shift by d is a row offset of the A operand. Block: (v tile
// of BV = 128*MT, 8 slots t, (p, tb, b)); warp w owns v rows
// [16*MT*w, 16*MT*(w+1)). Per stage TC_DS taps of the window chunk's NCH
// rows arrive by cp.async; the block marks which (d, 16 rows) tap tiles
// hold a nonzero (at most 64 a stage, one bit each) and every warp walks
// the set bits only: an all-zero tile adds exact zeros for finite rows. A
// warp also passes over a tap whose window rows all lie outside [0, WS).
// The K order (chunk, d, 16 rows) is fixed, so an element's sum does not
// depend on the tiling. z is written rounded to bf16 with row stride ZS.
template <int MT>
__global__ void __launch_bounds__(TC_NT1)
skew_tap_fwd_tc(const B16* __restrict__ xT, const B16* __restrict__ wtt,
                const int* __restrict__ plane, B16* __restrict__ z, int PT,
                int NB, int D2, int Tp, int nb, int TB, int WS, int ZS,
                int NCH, int nbp, int vec) {
  constexpr int BV = 16 * MT * TC_WARPS1, WV = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned smask[TC_WARPS1];
  const int LD = NCH + TC_PAD, RW = BV + D2 - 1, per = NCH / 8;
  const int KU = NCH / 16, units = TC_DS * KU;  // tap tiles a stage, <= 64
  B16* Xs = reinterpret_cast<B16*>(smem);  // [RW][LD]
  B16* Ws = Xs + (size_t)RW * LD;          // [TC_STAGES][TC_DS][8][LD]
  const int tt = Tp / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * BV, t0 = blockIdx.y * 8;
  const int b = blockIdx.z % NB, tb = (blockIdx.z / NB) % TB;
  const int p = blockIdx.z / (NB * TB), pt = p % PT;
  const int pl = plane[pt * TB + tb];
  const B16* xw = xT + (long)((p * 2 + pl) * NB + b) * WS * nbp;
  // tap (d, t, n) of these 8 slots at w[(d * Tp + t) * nb + n]
  const B16* w =
      wtt + (long)(pt * NB + b) * D2 * Tp * nb + (long)(tb * tt + t0) * nb;
  // Taps whose window columns all lie outside [0, WS) only add zeros.
  const int dlo = max(0, D2 - BV - v0), dhi = min(D2, WS + D2 - 1 - v0);
  const int ng = max(0, cdiv(dhi - dlo, TC_DS)), nch = nbp / NCH;
  const int total = ng * nch;
  const int ubase = v0 - (D2 - 1);  // u of window row 0
  const int uw = ubase + WV * warp;  // u of this warp's first row at d = 0
  float acc[MT][4] = {};

  auto load_taps = [&](int i) {
    if (i < total) {
      const int dg = dlo + (i % ng) * TC_DS, n0 = (i / ng) * NCH;
      B16* dst = Ws + (size_t)(i % TC_STAGES) * TC_DS * 8 * LD;
      for (int k = threadIdx.x; k < TC_DS * 8 * per; k += TC_NT1) {
        const int q = k % per, t = (k / per) % 8, dd = k / (per * 8);
        const int d = dg + dd, n = n0 + 8 * q;
        const bool in = d < dhi && t0 + t < tt && n < nb;
        const B16* src = w + ((long)d * Tp + t) * nb + n;
        B16* o = dst + (dd * 8 + t) * LD + 8 * q;
        if (vec) {
          cp_async16(o, in ? src : w, in);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = in && n + e < nb ? src[e] : __float2bfloat16_rn(0.f);
        }
      }
    }
    cp_async_commit();
  };
  auto load_window = [&](int c) {
    const int n0 = c * NCH;
    for (int k = threadIdx.x; k < RW * per; k += TC_NT1) {
      const int r = k / per, q = k % per, u = ubase + r;
      const bool in = u >= 0 && u < WS;
      cp_async16(Xs + (size_t)r * LD + 8 * q,
                 in ? xw + (long)u * nbp + n0 + 8 * q : xw, in);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) load_taps(s);
  for (int i = 0; i < total; ++i) {
    const int c = i / ng, dg = dlo + (i % ng) * TC_DS;
    if (i % ng == 0) {  // a new window chunk, once every warp is done
      __syncthreads();
      load_window(c);
      cp_async_wait<0>();
    } else {
      cp_async_wait<TC_STAGES - 2>();
    }
    __syncthreads();
    load_taps(i + TC_STAGES - 1);  // into the buffer computed at i - 1
    const B16* Wb = Ws + (size_t)(i % TC_STAGES) * TC_DS * 8 * LD;
    {  // 4 threads a tile (rows 2j, 2j + 1, two 16-byte pieces each)
      const int u = threadIdx.x >> 2, t = 2 * (threadIdx.x & 3);
      bool nz = false;
      if (u < units) {
        const B16* r = Wb + ((u / KU) * 8 + t) * LD + (u % KU) * 16;
        const uint4* q0 = reinterpret_cast<const uint4*>(r);
        const uint4* q1 = reinterpret_cast<const uint4*>(r + LD);
        const uint4 x0 = q0[0], x1 = q0[1], x2 = q1[0], x3 = q1[1];
        nz = (x0.x | x0.y | x0.z | x0.w | x1.x | x1.y | x1.z | x1.w | x2.x |
              x2.y | x2.z | x2.w | x3.x | x3.y | x3.z | x3.w) != 0u;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      if (lane == 0) {
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) bits |= (((bal >> (4 * j)) & 0xfu) != 0u) << j;
        smask[warp] = bits;  // tiles 8 * warp + j
      }
    }
    __syncthreads();
    unsigned long long mask = 0;
#pragma unroll
    for (int j = 0; j < TC_WARPS1; ++j)
      mask |= (unsigned long long)smask[j] << (8 * j);
    while (mask) {
      const int u = __ffsll(mask) - 1;
      mask &= mask - 1;
      const int dd = u / KU, kk = (u % KU) * 16, d = dg + dd;
      if (uw + d + WV - 1 < 0 || uw + d >= WS) continue;  // warp-uniform
      unsigned b0, b1;
      ldsm_x2(b0, b1, Wb + (dd * 8 + (lane & 7)) * LD + kk +
                          ((lane >> 3) & 1) * 8);
      unsigned a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_x4(a[mi], Xs + (size_t)(WV * warp + 16 * mi + (lane & 15) + d) *
                               LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi], a[mi], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // zT -> z [t][v] through shared memory, then 16-byte stores.
  const int LZ = BV + 8;
  B16* Zt = Xs;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = WV * warp + 16 * mi + (lane >> 2) + (e >> 1) * 8;
      Zt[(2 * (lane & 3) + (e & 1)) * LZ + v] = __float2bfloat16_rn(acc[mi][e]);
    }
  __syncthreads();
  B16* zo = z + ((long)(p * TB + tb) * NB + b) * tt * ZS;
  for (int k = threadIdx.x; k < 8 * (BV / 8); k += TC_NT1) {
    const int t = k / (BV / 8), v = v0 + 8 * (k % (BV / 8));
    if (t0 + t < tt && v < ZS)
      *reinterpret_cast<uint4*>(zo + (long)(t0 + t) * ZS + v) =
          *reinterpret_cast<const uint4*>(Zt + t * LZ + v - v0);
  }
}

// DFT-back, phase, and the sum over row blocks, on the tensor cores:
// gT[f, t] = sum_b E_b[t, f] * sum_v D[v, f] z_b[t, v], D read through
// ldmatrix.trans as the A operand [f][v], z_b as B. Block: (64
// frequencies, t group of 8*NT8, (p, tb)); warp w owns frequencies
// [16w, 16w+16). The (b, 64-column v chunk) stages stream through a
// TC_DSTAGES-deep cp.async ring in dynamic shared memory. Each row block's
// term is formed whole in registers and added to the running f32 sum in
// ascending b.
template <int NT8>
__global__ void __launch_bounds__(TC_NT)
skew_dft_fwd_tc(const B16* __restrict__ z, const float* __restrict__ sere,
                const float* __restrict__ seim, const B16* __restrict__ dp,
                float* __restrict__ gre, float* __restrict__ gim, int PT,
                int NB, int Tp, int TB, int ZS, int Fp, int F) {
  constexpr int NP = (NT8 + 1) / 2 * 2, TG = 8 * NT8;
  constexpr int LD = TC_KC + TC_PAD;  // z tile [8 * NP][LD]
  constexpr int LF = 64 + TC_PAD;     // D tiles [TC_KC][LF]
  constexpr int STAGE = 2 * TC_KC * LF + 8 * NP * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  B16* sm = reinterpret_cast<B16*>(smem);
  const int tt = Tp / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * 64, t0 = blockIdx.y * TG;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  const bool busy = f0 + 16 * warp < F;  // warp-uniform
  const int nk = ZS / TC_KC, total = NB * nk;

  auto load = [&](int i) {
    if (i < total) {
      const int b = i / nk, k0 = (i % nk) * TC_KC;
      B16* Dr = sm + (size_t)(i % TC_DSTAGES) * STAGE;
      B16* Di = Dr + TC_KC * LF;
      B16* Zs = Di + TC_KC * LF;
      const B16* zb = z + ((long)(p * TB + tb) * NB + b) * tt * ZS;
      for (int k = threadIdx.x; k < 8 * NP * (TC_KC / 8); k += TC_NT) {
        const int t = k / (TC_KC / 8), q = k % (TC_KC / 8), tg = t0 + t;
        const bool in = t < TG && tg < tt;
        cp_async16(Zs + t * LD + 8 * q,
                   in ? zb + (long)tg * ZS + k0 + 8 * q : zb, in);
      }
      for (int k = threadIdx.x; k < TC_KC * 8; k += TC_NT) {
        const int v = k / 8, q = k % 8;
        const long o = (long)(k0 + v) * Fp + f0 + 8 * q;
        cp_async16(Dr + v * LF + 8 * q, dp + o, true);
        cp_async16(Di + v * LF + 8 * q, dp + (long)ZS * Fp + o, true);
      }
    }
    cp_async_commit();
  };

  float gr[NT8][4] = {}, gi[NT8][4] = {}, ar[NT8][4], ai[NT8][4];
#pragma unroll
  for (int s = 0; s < TC_DSTAGES - 1; ++s) load(s);
  for (int i = 0; i < total; ++i) {
    const int b = i / nk;
    cp_async_wait<TC_DSTAGES - 2>();
    __syncthreads();
    load(i + TC_DSTAGES - 1);  // into the buffer computed at i - 1
    const B16* Dr = sm + (size_t)(i % TC_DSTAGES) * STAGE;
    const B16* Di = Dr + TC_KC * LF;
    const B16* Zs = Di + TC_KC * LF;
    if (i % nk == 0) {
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ar[j][e] = ai[j][e] = 0.f;
    }
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < TC_KC; kk += 16) {
        unsigned bf[NT8 + 1][2], a_r[4], a_i[4];
        load_b<NT8>(bf, Zs, LD, kk, lane);
        const int m = lane >> 3;
        const int o = (kk + (lane & 7) + (m >> 1) * 8) * LF + 16 * warp +
                      (m & 1) * 8;
        ldsm_x4_t(a_r, Dr + o);
        ldsm_x4_t(a_i, Di + o);
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          mma_bf16(ar[j], a_r, bf[j][0], bf[j][1]);
          mma_bf16(ai[j], a_i, bf[j][0], bf[j][1]);
        }
      }
    }
    if (i % nk == nk - 1) {  // row block b is complete
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + 16 * warp + (lane >> 2) + (e >> 1) * 8;
          const int tg = t0 + 8 * j + 2 * (lane & 3) + (e & 1);
          if (f < F && tg < tt) {
            const long eo = ((long)(pt * NB + b) * Tp + tb * tt + tg) * F + f;
            const float er = sere[eo], ei = seim[eo];
            gr[j][e] += ar[j][e] * er - ai[j][e] * ei;
            gi[j][e] += ar[j][e] * ei + ai[j][e] * er;
          }
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + 16 * warp + (lane >> 2) + (e >> 1) * 8;
      const int tg = t0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (f < F && tg < tt) {
        const long go = ((long)p * Tp + tb * tt + tg) * F + f;
        gre[go] = gr[j][e];
        gim[go] = gi[j][e];
      }
    }
}

// ---------------------------------------------------------------------------
// K2, stage 1: conj-phase and DFT-forward of the cotangent.
//   zbar[p,tb,b,t,w] = sum_f Zr[t,f] DreT[f,w] + Zi[t,f] DimT[f,w]
//   Zr = g_re*E_re + g_im*E_im,  Zi = g_im*E_re - g_re*E_im  (E = SE[p,b])
// Block: (w tile, t tile, (p, tb, b)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
skew_dft_t(const float* __restrict__ gre, const float* __restrict__ gim,
           const float* __restrict__ sere, const float* __restrict__ seim,
           const T* __restrict__ dret, const T* __restrict__ dimt,
           float* __restrict__ zbar, int PT, int NB, int Tp, int TB, int WZ,
           int F) {
  __shared__ float Zr[BM][BK + 1];
  __shared__ float Zi[BM][BK + 1];
  __shared__ float Dr[BK][BN];
  __shared__ float Di[BK][BN];
  const int tt = Tp / TB;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int w0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int b = blockIdx.z % NB, tb = (blockIdx.z / NB) % TB;
  const int p = blockIdx.z / (NB * TB), pt = p % PT;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int k = i % BK, t = i / BK;
      float vr = 0.f, vi = 0.f;
      if (t0 + t < tt && k0 + k < F) {
        const long go = ((long)p * Tp + tb * tt + t0 + t) * F + k0 + k;
        const long eo = ((long)(pt * NB + b) * Tp + tb * tt + t0 + t) * F + k0 + k;
        const float g_r = gre[go], g_i = gim[go];
        const float er = sere[eo], ei = seim[eo];
        vr = rnd<T>(g_r * er + g_i * ei);
        vi = rnd<T>(g_i * er - g_r * ei);
      }
      Zr[t][k] = vr;
      Zi[t][k] = vi;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int w = i % BN, k = i / BN;
      float vr = 0.f, vi = 0.f;
      if (k0 + k < F && w0 + w < WZ) {
        const long o = (long)(k0 + k) * WZ + w0 + w;
        vr = ld<T>(dret, o);
        vi = ld<T>(dimt, o);
      }
      Dr[k][w] = vr;
      Di[k][w] = vi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float zr = Zr[ty][k], zi = Zi[ty][k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] += zr * Dr[k][tx + TX * j] + zi * Di[k][tx + TX * j];
    }
    __syncthreads();
  }
  const int tg = t0 + ty;
  if (tg >= tt) return;
  float* zo = zbar + ((long)(p * TB + tb) * NB + b) * tt * WZ + (long)tg * WZ;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = w0 + tx + TX * j;
    if (w < WZ) zo[w] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// K2, stage 2: the transposed tap product into the image planes.
//   x2[p,pl,b*nb+n,u] = sum_{tb: plane[p,tb]=pl} sum_d sum_t
//                       WtT[p,b,d,tb*tt+t,n] * zbar[p,tb,b,t,(D2-1-d)+u]
// Block: (u tile, n tile, (p, pl, b)). It owns its output tile and loops
// over the angle blocks whose plane is its own, so it writes every element
// once, zeros included where no angle block reads the plane.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
skew_tap_t(const float* __restrict__ zbar, const T* __restrict__ wtt,
           const int* __restrict__ plane, float* __restrict__ x2, int PT,
           int NB, int D2, int Tp, int nb, int TB, int WS, int WZ) {
  __shared__ float Ws[DC][NC][BM];
  __shared__ float Zs[NC][BN + DC];
  const int tt = Tp / TB, N = NB * nb;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int u0 = blockIdx.x * BN, n0 = blockIdx.y * BM;
  const int b = blockIdx.z % NB, pl = (blockIdx.z / NB) % 2;
  const int p = blockIdx.z / (NB * 2), pt = p % PT;
  const T* w = wtt + (long)(pt * NB + b) * D2 * Tp * nb;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int tb = 0; tb < TB; ++tb) {
    if (plane[pt * TB + tb] != pl) continue;  // uniform over the block
    const float* zb = zbar + ((long)(p * TB + tb) * NB + b) * tt * WZ;
    for (int d0 = 0; d0 < D2; d0 += DC) {
      const int wbase = (D2 - 1) - (d0 + DC - 1) + u0;  // w of column 0
      for (int s0 = 0; s0 < tt; s0 += NC) {
        for (int i = tid; i < DC * NC * BM; i += NT) {
          const int n = i % BM, t = (i / BM) % NC, dl = i / (BM * NC);
          const int d = d0 + dl, tg = s0 + t, ng = n0 + n;
          float val = 0.f;
          if (d < D2 && tg < tt && ng < nb)
            val = ld<T>(w, ((long)d * Tp + tb * tt + tg) * nb + ng);
          Ws[dl][t][n] = val;
        }
        for (int i = tid; i < NC * (BN + DC - 1); i += NT) {
          const int c = i % (BN + DC - 1), t = i / (BN + DC - 1);
          const int wi = wbase + c, tg = s0 + t;
          float val = 0.f;
          if (tg < tt && wi >= 0 && wi < WZ)
            val = rnd<T>(zb[(long)tg * WZ + wi]);
          Zs[t][c] = val;
        }
        __syncthreads();
#pragma unroll 4
        for (int dl = 0; dl < DC; ++dl) {
#pragma unroll
          for (int t = 0; t < NC; ++t) {
            const float wv = Ws[dl][t][ty];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[j] += wv * Zs[t][(DC - 1 - dl) + tx + TX * j];
          }
        }
        __syncthreads();
      }
    }
  }
  const int ng = n0 + ty;
  if (ng >= nb) return;
  float* xo = x2 + ((long)(p * 2 + pl) * N + (long)b * nb + ng) * WS;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = u0 + tx + TX * j;
    if (u < WS) xo[u] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// K2 with bf16 tables, on the tensor cores. Three launches: the phase pass,
// the DFT-forward, the transposed tap product. Their scratch, in one bf16
// buffer (see skew_t_scratch): zT [PB, TB, NB, ZW, ttp], zbar rounded to
// bf16 and transposed (rows w < ZW, the columns a tap reads, rounded up to
// 16; slots padded to ttp = 8 * cdiv(tt, 8)), and the phased cotangent
// Z [PB, TB, NB, 2, ttp, Fp] (re, im; zero past tt and F).
// ---------------------------------------------------------------------------
constexpr int T2_FC = 64;       // f per DFT-forward stage
constexpr int T2_FSTAGES = 4;   // DFT-forward stages in flight
constexpr int T2_STAGES = 3;    // tap stages in flight
constexpr int T2_MAX_TTP = 64;  // slots of an angle block the window holds
constexpr int T2_MAX_TB = 64;   // angle blocks per image

struct SkewTScratch {
  int ttp, ZW, Fp;
  long z_off, total;  // bf16 elements; zT at 0
};

// The layout of K2's bf16 scratch (the wrapper allocates `total` elements,
// asking dip_skew_t_scratch).
SkewTScratch skew_t_scratch(int PB, int TB, int NB, int tt, int D2, int WS,
                            int F) {
  SkewTScratch s;
  s.ttp = cdiv(tt, 8) * 8;
  s.ZW = cdiv(WS + D2 - 1, 16) * 16;
  s.Fp = cdiv(F, T2_FC) * T2_FC;
  const long Q = (long)PB * TB * NB;
  s.z_off = Q * s.ZW * s.ttp;
  s.total = s.z_off + Q * 2 * s.ttp * s.Fp;
  return s;
}

// The row length of a shared-memory tile of n bf16 columns: an odd count of
// 16-byte pieces, so the 8 rows an ldmatrix reads fall in distinct banks.
__host__ __device__ constexpr int odd_ld(int n) {
  return (n / 8) % 2 ? n : n + 8;
}

// Phase pass: Z[q, 0, t, f] = bf16(g_re E_re + g_im E_im) and Z[q, 1, t, f]
// = bf16(g_im E_re - g_re E_im), E = SE[p % PT, b, tb*tt + t, f], formed in
// f32 and rounded once (the TPU kernel's rounding point); zero for t >= tt
// or f >= F. q = (p * TB + tb) * NB + b.
__global__ void __launch_bounds__(256)
skew_phase_t(const float* __restrict__ gre, const float* __restrict__ gim,
             const float* __restrict__ sere, const float* __restrict__ seim,
             B16* __restrict__ zph, int PT, int NB, int Tp, int TB, int F,
             int ttp, int Fp) {
  const int f = blockIdx.x * 256 + threadIdx.x, t = blockIdx.y;
  const long q = blockIdx.z;
  if (f >= Fp) return;
  const int b = q % NB, tb = (q / NB) % TB, p = q / (NB * TB), pt = p % PT;
  const int tt = Tp / TB;
  float zr = 0.f, zi = 0.f;
  if (t < tt && f < F) {
    const long go = ((long)p * Tp + tb * tt + t) * F + f;
    const long eo = ((long)(pt * NB + b) * Tp + tb * tt + t) * F + f;
    const float g_r = gre[go], g_i = gim[go], er = sere[eo], ei = seim[eo];
    zr = g_r * er + g_i * ei;
    zi = g_i * er - g_r * ei;
  }
  B16* o = zph + (q * 2 * ttp + t) * Fp + f;
  o[0] = __float2bfloat16_rn(zr);
  o[(long)ttp * Fp] = __float2bfloat16_rn(zi);
}

// DFT-forward on the tensor cores:
//   zT[q, w, t] = bf16(sum_f DreT[f, w] Z[q,0,t,f] + DimT[f, w] Z[q,1,t,f]),
// D*T read through ldmatrix.trans as the A operand [w][f] (rows of WZ bf16,
// 16-byte pieces: no layout pass), Z as B. K runs over (re, im) x f in
// stages of T2_FC frequencies through a T2_FSTAGES-deep cp.async ring, into
// one f32 sum per element, rounded to bf16 once (the TPU kernel's rounding
// point of the windows). Block: (128 w, t group of 8*NT8 slots, q); warp w
// owns w rows [16w, 16w+16).
template <int NT8>
__global__ void __launch_bounds__(TC_NT1)
skew_dft_t_tc(const B16* __restrict__ zph, const B16* __restrict__ dret,
              const B16* __restrict__ dimt, B16* __restrict__ zT, int WZ,
              int F, int ttp, int ZW, int Fp) {
  constexpr int NP = (NT8 + 1) / 2 * 2, TG = 8 * NT8;
  constexpr int BW = 16 * TC_WARPS1;
  constexpr int LW = odd_ld(BW);     // D tile [T2_FC][LW]
  constexpr int LZ = odd_ld(T2_FC);  // Z tile [8 * NP][LZ]
  constexpr int STAGE = T2_FC * LW + 8 * NP * LZ;
  extern __shared__ __align__(16) unsigned char smem[];
  B16* sm = reinterpret_cast<B16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * BW, t0 = blockIdx.y * TG;
  const long q = blockIdx.z;
  const bool busy = w0 + 16 * warp < ZW;  // warp-uniform
  const int nf = Fp / T2_FC, total = 2 * nf;
  const B16* zq = zph + q * 2 * ttp * Fp;

  auto load = [&](int i) {
    if (i < total) {
      const int c = i / nf, f0 = (i % nf) * T2_FC;
      B16* Ds = sm + (size_t)(i % T2_FSTAGES) * STAGE;
      B16* Zs = Ds + T2_FC * LW;
      const B16* dt = c ? dimt : dret;
      for (int k = threadIdx.x; k < T2_FC * (BW / 8); k += TC_NT1) {
        const int r = k / (BW / 8), w = w0 + 8 * (k % (BW / 8));
        const bool in = f0 + r < F && w < WZ;
        cp_async16(Ds + r * LW + w - w0,
                   in ? dt + (long)(f0 + r) * WZ + w : dt, in);
      }
      const B16* zc = zq + (long)c * ttp * Fp + f0;
      for (int k = threadIdx.x; k < 8 * NP * (T2_FC / 8); k += TC_NT1) {
        const int t = k / (T2_FC / 8), o = 8 * (k % (T2_FC / 8));
        const bool in = t < TG && t0 + t < ttp;
        cp_async16(Zs + t * LZ + o, in ? zc + (long)(t0 + t) * Fp + o : zc,
                   in);
      }
    }
    cp_async_commit();
  };

  float acc[NT8][4] = {};
#pragma unroll
  for (int s = 0; s < T2_FSTAGES - 1; ++s) load(s);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<T2_FSTAGES - 2>();
    __syncthreads();
    load(i + T2_FSTAGES - 1);  // into the buffer computed at i - 1
    const B16* Ds = sm + (size_t)(i % T2_FSTAGES) * STAGE;
    const B16* Zs = Ds + T2_FC * LW;
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < T2_FC; kk += 16) {
        unsigned bf[NT8 + 1][2], a[4];
        load_b<NT8>(bf, Zs, LZ, kk, lane);
        const int m = lane >> 3;
        ldsm_x4_t(a, Ds + (kk + (lane & 7) + (m >> 1) * 8) * LW + 16 * warp +
                         (m & 1) * 8);
#pragma unroll
        for (int j = 0; j < NT8; ++j) mma_bf16(acc[j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  if (!busy) return;
  B16* zo = zT + q * ZW * ttp;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = w0 + 16 * warp + (lane >> 2) + 8 * h;
      const int t = t0 + 8 * j + 2 * (lane & 3);
      if (w < ZW && t < ttp)
        *reinterpret_cast<__nv_bfloat162*>(zo + (long)w * ttp + t) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

// The transposed tap product on the tensor cores, one contraction over
// K = (tb, d, t) with u as the M dimension and n as N:
//   x2[p, pl, b*nb + n, u] = sum_{tb: plane = pl} sum_d sum_t
//       zT[p, tb, b][u + D2-1-d, t] * WtT[p % PT, b, d, tb*tt + t, n].
// The zT window of an angle block is staged [w][t] once, so tap d is a row
// offset of the ldmatrix A operand. K runs in units of 8 slots, unit
// j = d * C8 + c (slots 8c..8c+7, C8 = ttp / 8), and a k16 step pairs units
// 2s and 2s + 1: with 8-slot angle blocks that is taps d and d + 1, the
// second half one window row up. The taps stream through a cp.async ring in
// stages of 128 / NT8 units, staged [unit][8 slots][n] and read through
// ldmatrix.trans as B. Per stage the block marks which (k16 step, 8 n)
// tiles hold a nonzero (64 a stage, one bit each) and the warps run the
// MMAs of those only (a zero tile adds exact zeros for finite zbar; a NaN
// in a real slot still reaches every row, since each row has a nonzero tap
// in every real slot). Block: (u tile of BU = 128*MT, n group of 8*NT8,
// (p, pl, b)); warp w owns u rows [16*MT*w, 16*MT*(w+1)) and all n of the
// group. The block writes every element of its tile once, zeros where no
// angle block reads the plane. The K order is fixed, so no sum depends on
// the tiling or on the row blocks a call carries.
template <int MT, int NT8>
__global__ void __launch_bounds__(TC_NT1)
skew_tap_t_tc(const B16* __restrict__ zT, const B16* __restrict__ wtt,
              const int* __restrict__ plane, float* __restrict__ x2, int PT,
              int NB, int D2, int Tp, int nb, int TB, int WS, int ZW, int ttp,
              int vec) {
  constexpr int BU = 16 * MT * TC_WARPS1, WU = 16 * MT, BN = 8 * NT8;
  constexpr int KS = 64 / NT8, UNITS = 2 * KS;  // k16 steps, units a stage
  constexpr int LN = odd_ld(BN), SROWS = 8 * UNITS;
  static_assert(NT8 % 2 == 0, "B fragments are loaded in n8 tile pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned smask[TC_WARPS1];
  __shared__ int tbl[T2_MAX_TB];
  const int LW = odd_ld(ttp), RW = BU + D2 - 1;
  B16* Xs = reinterpret_cast<B16*>(smem);  // [RW][LW]
  B16* Ws = Xs + (size_t)RW * LW;          // [T2_STAGES][SROWS][LN]
  const int tt = Tp / TB, C8 = ttp / 8, N = NB * nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = blockIdx.x * BU, n0 = blockIdx.y * BN;
  const int b = blockIdx.z % NB, pl = (blockIdx.z / NB) % 2;
  const int p = blockIdx.z / (NB * 2), pt = p % PT;
  const bool active = u0 + WU * warp < WS;  // warp-uniform
  // Lane bases of the fragments: A rows u + D2 - 1 (tap d subtracts d rows),
  // B rows k (lane & 15) of n8 tile pair 2 * (lane >> 4).
  const B16* xa = Xs + (size_t)(WU * warp + (lane & 15) + D2 - 1) * LW;
  const int wl = (lane & 15) * LN + 8 * (lane >> 4);
  // tap (d, slot t, row n) of angle block tb at w[(d * Tp + tb * tt + t) * nb + n]
  const B16* w = wtt + (long)(pt * NB + b) * D2 * Tp * nb + n0;
  const int nunits = D2 * C8, spt = cdiv(nunits, UNITS);  // stages a tb
  // U / C8 as (U * MC) >> 16, exact while U * C8 < 65536 (the host checks)
  const unsigned MC = (65536u + C8 - 1) / C8;
  int ntb = 0;
  for (int tb = 0; tb < TB; ++tb)
    if (plane[pt * TB + tb] == pl) {
      if (threadIdx.x == 0) tbl[ntb] = tb;
      ++ntb;
    }
  __syncthreads();
  const int total = ntb * spt;
  float acc[MT][NT8][4] = {};

  // This thread's tap pieces of a stage: rows rb + j * RSTEP, 8 n at qn.
  constexpr int RSTEP = TC_NT1 / NT8, PER = SROWS / RSTEP;
  const int qn = 8 * (threadIdx.x % NT8), rb = threadIdx.x / NT8;
  const bool nin = n0 + qn < nb;
  auto load_taps = [&](int i) {
    if (i < total) {
      const int tb = tbl[i / spt], U0 = (i % spt) * UNITS + rb / 8;
      B16* dst = Ws + (size_t)(i % T2_STAGES) * SROWS * LN + rb * LN + qn;
      const B16* wt = w + tb * tt * nb + qn;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int U = U0 + j * (RSTEP / 8);
        const int d = (int)((U * MC) >> 16), t = 8 * (U - d * C8) + rb % 8;
        const bool in = nin && U < nunits && t < tt;
        const B16* src = wt + (d * Tp + t) * nb;
        B16* o = dst + j * RSTEP * LN;
        if (vec) {
          cp_async16(o, in ? src : wtt, in);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = in && n0 + qn + e < nb ? src[e] : __float2bfloat16_rn(0.f);
        }
      }
    }
    cp_async_commit();
  };
  auto load_window = [&](int tb) {
    const B16* src = zT + ((long)(p * TB + tb) * NB + b) * ZW * ttp;
    for (int k = threadIdx.x; k < RW * C8; k += TC_NT1) {
      const int r = k / C8, o = 8 * (k % C8), wr = u0 + r;
      const bool in = wr < ZW;
      cp_async16(Xs + (size_t)r * LW + o, in ? src + (long)wr * ttp + o : src,
                 in);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < T2_STAGES - 1; ++s) load_taps(s);
  for (int i = 0; i < total; ++i) {
    const int s = i % spt;
    if (s == 0) {  // a new angle block's window, once every warp is done
      __syncthreads();
      load_window(tbl[i / spt]);
      cp_async_wait<0>();
    } else {
      cp_async_wait<T2_STAGES - 2>();
    }
    __syncthreads();
    load_taps(i + T2_STAGES - 1);  // into the buffer computed at i - 1
    const B16* Wb = Ws + (size_t)(i % T2_STAGES) * SROWS * LN;
    {  // 4 threads a tile, 4 of its 16 rows each
      const int tile = threadIdx.x >> 2, sub = threadIdx.x & 3;
      const B16* r = Wb + (16 * (tile / NT8) + 4 * sub) * LN + 8 * (tile % NT8);
      unsigned o = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint4 x = *reinterpret_cast<const uint4*>(r + e * LN);
        o |= x.x | x.y | x.z | x.w;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, o != 0u);
      if (lane == 0) {
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) bits |= (((bal >> (4 * j)) & 0xfu) != 0u) << j;
        smask[warp] = bits;  // tiles 8 * warp + j
      }
    }
    __syncthreads();
    if (!active) continue;
    unsigned long long mask = 0;
#pragma unroll
    for (int j = 0; j < TC_WARPS1; ++j)
      mask |= (unsigned long long)smask[j] << (8 * j);
    constexpr unsigned long long JM = (1ull << NT8) - 1;
    if (!mask) continue;
    // Walk the k16 steps with a nonzero tile, loading the next step's A
    // and B fragments before the MMAs of this one.
    const int Us = (i % spt) * UNITS + (lane >> 4);
    const B16* Wl = Ws + (size_t)(i % T2_STAGES) * SROWS * LN + wl;
    auto load_ab = [&](int ks, unsigned (&a)[MT][4], unsigned (&bf)[NT8][2]) {
      // this lane's unit: 2 ks (k 0-7) or 2 ks + 1 (k 8-15)
      const int U = Us + 2 * ks, dq = (int)((U * MC) >> 16);
      const int d = min(dq, D2 - 1);  // past D2: zero taps
      const B16* pa = xa + 8 * (U - dq * C8) - d * LW;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldsm_x4(a[mi], pa + 16 * mi * LW);
#pragma unroll
      for (int j = 0; j < NT8; j += 2) {
        unsigned r[4];
        ldsm_x4_t(r, Wl + 16 * ks * LN + 8 * j);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
    };
    int ks = (__ffsll(mask) - 1) / NT8;
    unsigned a[MT][4], bf[NT8][2];
    load_ab(ks, a, bf);
    while (true) {
      const unsigned bits = (unsigned)((mask >> (NT8 * ks)) & JM);
      mask &= ~(JM << (NT8 * ks));
      const int kn = mask ? (__ffsll(mask) - 1) / NT8 : -1;
      unsigned an[MT][4], bn[NT8][2];
      if (kn >= 0) load_ab(kn, an, bn);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        if (!((bits >> j) & 1u)) continue;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma_bf16(acc[mi][j], a[mi], bf[j][0], bf[j][1]);
      }
      if (kn < 0) break;
      ks = kn;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mi][e] = an[mi][e];
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        bf[j][0] = bn[j][0];
        bf[j][1] = bn[j][1];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // acc -> [n][u] through shared memory, then 16-byte stores of x2's rows.
  constexpr int LO = BU + 4;
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = WU * warp + 16 * mi + (lane >> 2) + (e >> 1) * 8;
        Os[(8 * j + 2 * (lane & 3) + (e & 1)) * LO + u] = acc[mi][j][e];
      }
  __syncthreads();
  float* xo = x2 + ((long)(p * 2 + pl) * N + (long)b * nb) * WS;
  for (int k = threadIdx.x; k < BN * (BU / 4); k += TC_NT1) {
    const int nl = k / (BU / 4), ul = 4 * (k % (BU / 4));
    const int n = n0 + nl, u = u0 + ul;
    if (n >= nb || u >= WS) continue;
    const float* src = Os + nl * LO + ul;
    float* dst = xo + (long)n * WS + u;
    if (WS % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && u + e < WS; ++e) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// K3 with f32 tables, launch 1: phase product and PhiD contraction of the
// eval tail on the CUDA cores (f32 tables round nowhere).
//   R[p,b,t,z] = sum_f A[t,f] PhiDre[z,f] - sum_f B[t,f] PhiDim[z,f]
//   A = g_re*TE_re - g_im*TE_im,  B = g_re*TE_im + g_im*TE_re  (TE[p%PT,b])
// Block: (z tile, t tile, (p, b)).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
eval_fwd(const float* __restrict__ gre, const float* __restrict__ gim,
         const float* __restrict__ tere, const float* __restrict__ teim,
         const float* __restrict__ phre, const float* __restrict__ phim,
         float* __restrict__ R, int PT, int DB, int Tp, int D2p, int F) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BM][BK + 1];
  __shared__ float Pr[BK][BN + 1];  // padded: filled along k (PhiD is [z, f])
  __shared__ float Pi[BK][BN + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int z0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int b = blockIdx.z % DB, p = blockIdx.z / DB, pt = p % PT;
  float aa[4] = {0.f, 0.f, 0.f, 0.f}, ab[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int k = i % BK, t = i / BK;
      float va = 0.f, vb = 0.f;
      if (t0 + t < Tp && k0 + k < F) {
        const long go = ((long)p * Tp + t0 + t) * F + k0 + k;
        const long eo = ((long)(pt * DB + b) * Tp + t0 + t) * F + k0 + k;
        const float g_r = gre[go], g_i = gim[go];
        const float er = tere[eo], ei = teim[eo];
        va = g_r * er - g_i * ei;
        vb = g_r * ei + g_i * er;
      }
      As[t][k] = va;
      Bs[t][k] = vb;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i % BK, zz = i / BK;
      float vr = 0.f, vi = 0.f;
      if (k0 + k < F && z0 + zz < D2p) {
        const long o = (long)(z0 + zz) * F + k0 + k;
        vr = phre[o];
        vi = phim[o];
      }
      Pr[k][zz] = vr;
      Pi[k][zz] = vi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float a = As[ty][k], bb = Bs[ty][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        aa[j] += a * Pr[k][tx + TX * j];
        ab[j] += bb * Pi[k][tx + TX * j];
      }
    }
    __syncthreads();
  }
  const int tg = t0 + ty;
  if (tg >= Tp) return;
  float* ro = R + ((long)(p * DB + b) * Tp + tg) * D2p;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int zz = z0 + tx + TX * j;
    if (zz < D2p) ro[zz] = aa[j] - ab[j];
  }
}

// ---------------------------------------------------------------------------
// K3 with bf16 tables, launch 1: the R stage on the tensor cores, the TPU
// kernel's MXU products. A/B are formed in f32 from g and TE[p%PT, b] and
// rounded to bf16; PhiD is read in f32 and rounded to bf16 here (the
// caller's cast in the JAX package); both products are bf16 mma.sync
// m16n8k16 with f32 accumulators, M = 16 angle rows t, N = z, K = f in
// chunks of EV_BF (zero past F; the k16 steps wholly past F are skipped).
// R leaves in f32. Block: (64 z, 16 t, (p, a pair of detector blocks b)),
// 8 warps of one n8 tile; each f chunk of PhiD and g is read once for both
// of the pair's b (the last pair holds one b when DB is odd). What bounds it is the L2 traffic of those reads (every
// block reads its z rows of PhiD again, in f32); each thread starts all
// loads of a chunk before it converts and stores any. The K order of every
// element is fixed (f ascending), whatever the grid.
// ---------------------------------------------------------------------------
constexpr int EV_BT = 16;          // angle rows t of a block (one m16 tile)
constexpr int EV_BZ = 64;          // z of a block (8 warps x one n8 tile)
constexpr int EV_BF = 64;          // f chunk
constexpr int EV_LD = EV_BF + 8;   // row stride of the staged tiles (bf16)
constexpr int EV_NT = 256;
constexpr int EV_RS = EV_NT / EV_BF;          // rows a pass of the threads
constexpr int EV_JG = EV_BT / EV_RS;          // g / TE rows a thread
constexpr int EV_JP = EV_BZ / EV_RS;          // PhiD rows a thread
constexpr int EV_NB = 2;                      // detector blocks b of a block

__global__ void __launch_bounds__(EV_NT)
eval_r_tc(const float* __restrict__ gre, const float* __restrict__ gim,
          const float* __restrict__ tere, const float* __restrict__ teim,
          const float* __restrict__ phre, const float* __restrict__ phim,
          float* __restrict__ R, int PT, int DB, int Tp, int D2p, int F) {
  __shared__ __align__(16) B16 As[EV_NB][EV_BT][EV_LD];
  __shared__ __align__(16) B16 Bs[EV_NB][EV_BT][EV_LD];
  __shared__ __align__(16) B16 Pr[EV_BZ][EV_LD];
  __shared__ __align__(16) B16 Pi[EV_BZ][EV_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z0 = blockIdx.x * EV_BZ, t0 = blockIdx.y * EV_BT;
  const int nbg = cdiv(DB, EV_NB), p = blockIdx.z / nbg;
  const int b0 = blockIdx.z % nbg * EV_NB, nb = min(EV_NB, DB - b0);
  const int pt = p % PT;
  // Thread tid's elements of a chunk: rows r0 + EV_RS j, column k.
  const int k = tid % EV_BF, r0 = tid / EV_BF;
  const long go = ((long)p * Tp + t0) * F;
  float ca[EV_NB][4] = {}, cb[EV_NB][4] = {};
  for (int f0 = 0; f0 < F; f0 += EV_BF) {
    const bool fin = f0 + k < F;
    float vg[EV_JG][2], ve[EV_NB][EV_JG][2], vp[EV_JP][2];
#pragma unroll
    for (int j = 0; j < EV_JG; ++j) {
      const int t = r0 + j * EV_RS;
      const bool in = fin && t0 + t < Tp;
      const long o = go + (long)t * F + f0 + k;
      vg[j][0] = in ? gre[o] : 0.f;
      vg[j][1] = in ? gim[o] : 0.f;
    }
#pragma unroll
    for (int bb = 0; bb < EV_NB; ++bb)
#pragma unroll
      for (int j = 0; j < EV_JG; ++j) {
        const int t = r0 + j * EV_RS;
        const bool in = bb < nb && fin && t0 + t < Tp;
        const long o =
            ((long)(pt * DB + b0 + bb) * Tp + t0 + t) * F + f0 + k;
        ve[bb][j][0] = in ? tere[o] : 0.f;
        ve[bb][j][1] = in ? teim[o] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < EV_JP; ++j) {
      const int zz = r0 + j * EV_RS;
      const bool in = fin && z0 + zz < D2p;
      const long o = (long)(z0 + zz) * F + f0 + k;
      vp[j][0] = in ? phre[o] : 0.f;
      vp[j][1] = in ? phim[o] : 0.f;
    }
#pragma unroll
    for (int bb = 0; bb < EV_NB; ++bb)
#pragma unroll
      for (int j = 0; j < EV_JG; ++j) {
        const float g_r = vg[j][0], g_i = vg[j][1];
        const float er = ve[bb][j][0], ei = ve[bb][j][1];
        As[bb][r0 + j * EV_RS][k] = __float2bfloat16_rn(g_r * er - g_i * ei);
        Bs[bb][r0 + j * EV_RS][k] = __float2bfloat16_rn(g_r * ei + g_i * er);
      }
#pragma unroll
    for (int j = 0; j < EV_JP; ++j) {
      Pr[r0 + j * EV_RS][k] = __float2bfloat16_rn(vp[j][0]);
      Pi[r0 + j * EV_RS][k] = __float2bfloat16_rn(vp[j][1]);
    }
    __syncthreads();
    const int nks = cdiv(min(EV_BF, F - f0), 16);
    for (int ks = 0; ks < nks; ++ks) {
      unsigned q[4];
      // matrices: Pr k 0-7, Pr k 8-15, Pi k 0-7, Pi k 8-15 of the warp's z
      ldsm_x4(q, &((lane >> 4) ? Pi : Pr)[warp * 8 + (lane & 7)]
                                         [ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int bb = 0; bb < EV_NB; ++bb) {
        if (bb >= nb) break;
        unsigned a[4], bv[4];
        ldsm_x4(a, &As[bb][lane & 15][ks * 16 + (lane >> 4) * 8]);
        ldsm_x4(bv, &Bs[bb][lane & 15][ks * 16 + (lane >> 4) * 8]);
        mma_bf16(ca[bb], a, q[0], q[1]);
        mma_bf16(cb[bb], bv, q[2], q[3]);
      }
    }
    __syncthreads();
  }
  // Accumulator (b, e): row t0 + lane/4 (+8 for e >= 2), column z of the
  // warp's n8 tile at 2 (lane % 4) + e % 2. D2p is a multiple of 16.
  const int tr = t0 + (lane >> 2), z = z0 + warp * 8 + 2 * (lane & 3);
  if (z >= D2p) return;
#pragma unroll
  for (int bb = 0; bb < EV_NB; ++bb) {
    if (bb >= nb) break;
    float* rp = R + (long)(p * DB + b0 + bb) * Tp * D2p;
    if (tr < Tp)
      *reinterpret_cast<float2*>(rp + (long)tr * D2p + z) =
          make_float2(ca[bb][0] - cb[bb][0], ca[bb][1] - cb[bb][1]);
    if (tr + 8 < Tp)
      *reinterpret_cast<float2*>(rp + (long)(tr + 8) * D2p + z) =
          make_float2(ca[bb][2] - cb[bb][2], ca[bb][3] - cb[bb][3]);
  }
}

// ---------------------------------------------------------------------------
// The Wd passes of K3 and K4, either table type: a stream over the dense
// Wd [PT, DB, Tp, D2p, db] (98.96% zeros at 256^2/8, but a NaN in R or in
// the cotangent must reach every element of its row, as in the plain
// version's dense einsum, so no tap is skipped). A lane owns 8 consecutive
// d of a chunk of at most 8 * 16 d, read as one 16-byte (bf16) or 32-byte
// (f32) load when db is a multiple of 8.
// ---------------------------------------------------------------------------
constexpr int WD_NT = 256;
constexpr int WD_ZG = 16;   // z groups of the K3 epilogue

__device__ __forceinline__ void ld8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = c.x; w[5] = c.y; w[6] = c.z; w[7] = c.w;
}
__device__ __forceinline__ void ld8(const B16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// n (<= 8) elements at p as f32, zeros past n, element by element (db not
// a multiple of 8: the rows are not 16-byte aligned).
template <typename T>
__device__ __forceinline__ void ldw(const T* p, int n, float (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = i < n ? ld<T>(p, i) : 0.f;
}

template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ B16 to_t<B16>(float v) {
  return __float2bfloat16_rn(v);
}

// K3, launch 2: out[p, t, b*db + d] = sum_z R[p,b,t,z] * Wd[p%PT,b,t,z,d]
// in f32. A row (p, b, t) is read by 16 z groups of L lanes (L = the d
// chunk's width / 8): group g sums its D2p / 16 consecutive z in ascending
// order; the 16 partials are added in ascending g through shared memory.
// Block: RB = 16 / L rows of one d chunk of 8 L d. VEC: db % 8 == 0, each
// lane's 8 d one vector load, no branch between a thread's loads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WD_NT)
eval_wd_fwd(const float* __restrict__ R, const T* __restrict__ wd,
            float* __restrict__ out, int PT, int DB, int Tp, int D2p, int db,
            long rows, int L, int RB) {
  __shared__ float part[WD_ZG][8 * WD_ZG];
  const int per = WD_ZG * L, W = 8 * L;
  const int lr = threadIdx.x / per, g = threadIdx.x % per / L;
  const int l = threadIdx.x % L;
  const int d0 = blockIdx.y * W, zpg = D2p / WD_ZG;
  const long row = (long)blockIdx.x * RB + lr;  // (p * DB + b) * Tp + t
  if (row < rows) {
    const int t = (int)(row % Tp), b = (int)(row / Tp % DB);
    const int p = (int)(row / Tp / DB), pt = p % PT;
    const int n = min(8, db - d0 - l * 8);
    const T* w = wd + (((long)(pt * DB + b) * Tp + t) * D2p +
                       (long)g * zpg) * db + d0 + l * 8;
    const float* r = R + row * D2p + g * zpg;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n > 0) {
#pragma unroll 4
      for (int z = 0; z < zpg; ++z) {
        float wv[8];
        if (VEC)
          ld8(w + (long)z * db, wv);
        else
          ldw(w + (long)z * db, n, wv);
        const float rz = __ldg(r + z);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(rz, wv[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) part[g][lr * W + l * 8 + i] = acc[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < RB * W; e += blockDim.x) {
    const long row2 = (long)blockIdx.x * RB + e / W;
    const int d = d0 + e % W;
    if (row2 >= rows || d >= db) continue;
    float s = part[0][e];
#pragma unroll
    for (int gg = 1; gg < WD_ZG; ++gg) s += part[gg][e];
    const int t = (int)(row2 % Tp), b = (int)(row2 / Tp % DB);
    const int p = (int)(row2 / Tp / DB);
    out[((long)p * Tp + t) * DB * db + (long)b * db + d] = s;
  }
}

// K4, launch 1: Rbar[p,b,t,z] = sum_d ob[p,t,b*db+d] * Wd[p%PT,b,t,z,d] in
// f32, rounded to the table type. Block: one row (p, b, t); a z is read by
// L2 lanes (L2 = L rounded up to a power of two; lanes past L add zeros),
// each lane sums its d chunks in ascending order, and the lanes' partials
// are added by a fixed shuffle tree (offsets 1, 2, 4, ...). 4 z a thread
// are in flight at once (past D2p a thread reads row D2p - 1 again and
// drops the sum). VEC: db % 8 == 0, as in eval_wd_fwd.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WD_NT, 4)
eval_wd_t(const float* __restrict__ ob, const T* __restrict__ wd,
          T* __restrict__ rbar, int PT, int DB, int Tp, int D2p, int db,
          int L, int L2) {
  const long row = blockIdx.x;  // (p * DB + b) * Tp + t
  const int t = (int)(row % Tp), b = (int)(row / Tp % DB);
  const int p = (int)(row / Tp / DB), pt = p % PT;
  const int l = threadIdx.x % L2, zi = threadIdx.x / L2, zs = WD_NT / L2;
  const int W = 8 * L;
  const float* o = ob + ((long)p * Tp + t) * DB * db + (long)b * db;
  const T* w = wd + ((long)(pt * DB + b) * Tp + t) * D2p * db;
  for (int z0 = 0; z0 < D2p; z0 += 4 * zs) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; l < L && c < db; c += W) {
      const int dl = c + l * 8, n = min(8, db - dl);
      if (n <= 0) continue;
      float ov[8], wv[4][8];
      if (VEC) {
        ld8(o + dl, ov);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ld8(w + (long)min(z0 + u * zs + zi, D2p - 1) * db + dl, wv[u]);
      } else {
        ldw(o + dl, n, ov);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ldw(w + (long)min(z0 + u * zs + zi, D2p - 1) * db + dl, n, wv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[u] = fmaf(ov[i], wv[u][i], s[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      for (int off = 1; off < L2; off <<= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      const int z = z0 + u * zs + zi;
      if (l == 0 && z < D2p) rbar[row * D2p + z] = to_t<T>(s[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 with f32 tables, launch 2: the transpose after the Wd pre-contraction
// Rbar, on the CUDA cores.
//   Abar = Rbar_b @ PhiDre,  Bbar = -(Rbar_b @ PhiDim)
//   g_re = sum_b Abar*TE_re + Bbar*TE_im,  g_im = sum_b -Abar*TE_im + Bbar*TE_re
// Block: (f tile, t tile, p); it loops over the DB detector blocks.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
eval_t(const float* __restrict__ rbar, const float* __restrict__ tere,
       const float* __restrict__ teim, const float* __restrict__ phre,
       const float* __restrict__ phim, float* __restrict__ gre,
       float* __restrict__ gim, int PT, int DB, int Tp, int D2p, int F) {
  __shared__ float Rs[BM][BK + 1];
  __shared__ float Pr[BK][BN];
  __shared__ float Pi[BK][BN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int f0 = blockIdx.x * BN, t0 = blockIdx.y * BM, p = blockIdx.z;
  const int pt = p % PT;
  const int tg = t0 + ty;
  float gr[4] = {0.f, 0.f, 0.f, 0.f}, gi[4] = {0.f, 0.f, 0.f, 0.f};

  for (int b = 0; b < DB; ++b) {
    const float* rb = rbar + (long)(p * DB + b) * Tp * D2p;
    float aa[4] = {0.f, 0.f, 0.f, 0.f}, ab[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D2p; k0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int k = i % BK, t = i / BK;
        float val = 0.f;
        if (t0 + t < Tp && k0 + k < D2p) val = rb[(long)(t0 + t) * D2p + k0 + k];
        Rs[t][k] = val;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int f = i % BN, k = i / BN;
        float vr = 0.f, vi = 0.f;
        if (k0 + k < D2p && f0 + f < F) {
          const long o = (long)(k0 + k) * F + f0 + f;
          vr = phre[o];
          vi = phim[o];
        }
        Pr[k][f] = vr;
        Pi[k][f] = vi;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float r = Rs[ty][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          aa[j] += r * Pr[k][tx + TX * j];
          ab[j] += r * Pi[k][tx + TX * j];
        }
      }
      __syncthreads();
    }
    if (tg < Tp) {
      const long eo = ((long)(pt * DB + b) * Tp + tg) * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx + TX * j;
        if (f < F) {
          const float er = tere[eo + f], ei = teim[eo + f];
          const float A = aa[j], B = -ab[j];
          gr[j] += A * er + B * ei;
          gi[j] += -A * ei + B * er;
        }
      }
    }
  }
  if (tg >= Tp) return;
  const long go = ((long)p * Tp + tg) * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = f0 + tx + TX * j;
    if (f < F) {
      gre[go + f] = gr[j];
      gim[go + f] = gi[j];
    }
  }
}

// ---------------------------------------------------------------------------
// K4 with bf16 tables, launch 2: Abar/Bbar on the tensor cores, then the
// phase combine. M = 32 angle rows t (two m16 tiles), K = z (D2p / 16 k16
// steps), N = f: the bf16 Rbar tile [t][z] arrives by cp.async; PhiD
// [z][f] is read in f32 for the block's f chunk over every z, rounded to
// bf16 once and read through ldmatrix.trans. Block: (64 f, 32 t, p), 8
// warps of one n8 tile each (32 rows: 216 blocks at 256^2/8, which three
// to an SM take in one wave); it loops over the DB detector blocks in
// ascending b and writes every g element once.
// ---------------------------------------------------------------------------
constexpr int ET_BT = 32;          // angle rows t of a block
constexpr int ET_BF = 64;          // f of a block (8 warps x 8)
constexpr int ET_LD = ET_BF + 8;   // row stride of the staged PhiD (bf16)
constexpr int ET_NT = 256;

size_t eval_t_tc_smem(int D2p) {
  return (size_t)(2 * D2p * ET_LD + ET_BT * (D2p + 8)) * sizeof(B16);
}

__global__ void __launch_bounds__(ET_NT)
eval_t_tc(const B16* __restrict__ rbar, const float* __restrict__ tere,
          const float* __restrict__ teim, const float* __restrict__ phre,
          const float* __restrict__ phim, float* __restrict__ gre,
          float* __restrict__ gim, int PT, int DB, int Tp, int D2p, int F) {
  extern __shared__ __align__(16) unsigned char et_smem[];
  B16* Pr = reinterpret_cast<B16*>(et_smem);  // [D2p][ET_LD]
  B16* Pi = Pr + D2p * ET_LD;
  B16* Rs = Pi + D2p * ET_LD;                 // [ET_BT][D2p + 8]
  const int LR = D2p + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * ET_BF, t0 = blockIdx.y * ET_BT, p = blockIdx.z;
  const int pt = p % PT;
  {
    const int k = tid % ET_BF, zr = ET_NT / ET_BF;
    const bool in = f0 + k < F;
#pragma unroll 16
    for (int z = tid / ET_BF; z < D2p; z += zr) {
      const long o = (long)z * F + f0 + k;
      Pr[z * ET_LD + k] = __float2bfloat16_rn(in ? phre[o] : 0.f);
      Pi[z * ET_LD + k] = __float2bfloat16_rn(in ? phim[o] : 0.f);
    }
  }
  // Accumulator (m, e): row t0 + 16 m + lane/4 (+8 for e >= 2), column
  // f0 + 8 warp + 2 (lane % 4) + e % 2.
  const int fc = f0 + warp * 8 + 2 * (lane & 3), tr = t0 + (lane >> 2);
  float gr[2][4] = {}, gi[2][4] = {};
  const int pieces = D2p / 8;  // 16-byte pieces of an Rbar row
  for (int b = 0; b < DB; ++b) {
    const B16* rb = rbar + ((long)(p * DB + b) * Tp + t0) * D2p;
    for (int i = tid; i < ET_BT * pieces; i += ET_NT) {
      const int t = i / pieces, c = i % pieces;
      const bool full = t0 + t < Tp;
      cp_async16(Rs + t * LR + c * 8, full ? rb + (long)t * D2p + c * 8 : rb,
                 full);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float ca[2][4] = {}, cb[2][4] = {};
    for (int ks = 0; ks < D2p / 16; ++ks) {
      unsigned a[2][4], q[4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4(a[m], Rs + (16 * m + (lane & 15)) * LR + ks * 16 +
                          (lane >> 4) * 8);
      // matrices: Pr rows k 0-7, Pr rows k 8-15, Pi rows k 0-7, Pi 8-15
      ldsm_x4_t(q, ((lane >> 4) ? Pi : Pr) +
                       (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ET_LD +
                       warp * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(ca[m], a[m], q[0], q[1]);
        mma_bf16(cb[m], a[m], q[2], q[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + 16 * m + (e >> 1) * 8, f = fc + (e & 1);
        if (t < Tp && f < F) {
          const long o = ((long)(pt * DB + b) * Tp + t) * F + f;
          const float er = tere[o], ei = teim[o];
          const float A = ca[m][e], B = -cb[m][e];
          gr[m][e] += A * er + B * ei;
          gi[m][e] += -A * ei + B * er;
        }
      }
    __syncthreads();  // Rs is staged again for the next b
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tr + 16 * m + (e >> 1) * 8, f = fc + (e & 1);
      if (t < Tp && f < F) {
        gre[((long)p * Tp + t) * F + f] = gr[m][e];
        gim[((long)p * Tp + t) * F + f] = gi[m][e];
      }
    }
}

// ---------------------------------------------------------------------------
// K7: the fft_shear row stage on the two spectrum planes.
//   S_b[t,d,f] = sum_n Wt[p,b,tb*tt+t,d,n] * r[b*nb+n, f]   (re and im)
//   g[p,tb*tt+t,f] = sum_b E_b[t,f] * sum_d Phi[d,f] * S_b[t,d,f]
// with r = rre2/rim2[p, plane[p,tb]] rounded to the table type and
// E_b = SE[p,b,tb*tt+t,f]. Block: (f tile, t tile, (p, tb)).
// ---------------------------------------------------------------------------
constexpr int SX = 16;           // threads along f
constexpr int SY = 8;            // threads along t (K7) or n (K8)
constexpr int SN = SX * SY;
constexpr int S_MF = 4;          // frequencies per thread
constexpr int S_BF = SX * S_MF;  // f tile
constexpr int K7_MT = 1;         // angles per thread
constexpr int K7_BT = SY * K7_MT;
constexpr int K7_DC = 8;         // taps per chunk (their S in registers)
constexpr int K7_NC = 32;        // rows per chunk
constexpr int K8_MN = 4;         // rows per thread
constexpr int K8_BN = SY * K8_MN;
constexpr int K8_TC = 4;         // angles per chunk
constexpr int K8_DC = 8;         // taps per chunk
constexpr int K8_KC = K8_TC * K8_DC;

template <typename T>
__global__ void __launch_bounds__(SN)
shear_fwd(const float* __restrict__ rre2, const float* __restrict__ rim2,
          const T* __restrict__ wt, const float* __restrict__ sere,
          const float* __restrict__ seim, const float* __restrict__ phre,
          const float* __restrict__ phim, const int* __restrict__ plane,
          float* __restrict__ gre, float* __restrict__ gim, int PT, int NB,
          int Tp, int D2, int nb, int TB, int F, int nsrc) {
  __shared__ float Ws[K7_DC][K7_BT][K7_NC + 1];
  __shared__ float Xr[K7_NC][S_BF];
  __shared__ float Xi[K7_NC][S_BF];
  const int tt = Tp / TB, N = NB * nb;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SX + tx;
  const int f0 = blockIdx.x * S_BF, t0 = blockIdx.y * K7_BT;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  // Source spectrum: the angle block's plane (K7) or its own slot (K9).
  const int pl = plane ? plane[pt * TB + tb] : tb;
  float gr[K7_MT][S_MF] = {}, gi[K7_MT][S_MF] = {};

  for (int b = 0; b < NB; ++b) {
    const long xo = ((long)(p * nsrc + pl) * N + (long)b * nb) * F;
    // Wt[pt, b, tb*tt:(tb+1)*tt] as [tt, D2, nb]
    const T* w = wt + ((long)(pt * NB + b) * Tp + tb * tt) * D2 * nb;
    float tr[K7_MT][S_MF] = {}, ti[K7_MT][S_MF] = {};
    for (int d0 = 0; d0 < D2; d0 += K7_DC) {
      float sr[K7_DC][K7_MT][S_MF] = {}, si[K7_DC][K7_MT][S_MF] = {};
      for (int n0 = 0; n0 < nb; n0 += K7_NC) {
        for (int i = tid; i < K7_DC * K7_BT * K7_NC; i += SN) {
          const int n = i % K7_NC, t = (i / K7_NC) % K7_BT;
          const int dl = i / (K7_NC * K7_BT);
          const int d = d0 + dl, tg = t0 + t, ng = n0 + n;
          float val = 0.f;
          if (d < D2 && tg < tt && ng < nb)
            val = ld<T>(w, ((long)tg * D2 + d) * nb + ng);
          Ws[dl][t][n] = val;
        }
        for (int i = tid; i < K7_NC * S_BF; i += SN) {
          const int f = i % S_BF, n = i / S_BF;
          float vr = 0.f, vi = 0.f;
          if (n0 + n < nb && f0 + f < F) {
            const long o = xo + (long)(n0 + n) * F + f0 + f;
            vr = rnd<T>(rre2[o]);
            vi = rnd<T>(rim2[o]);
          }
          Xr[n][f] = vr;
          Xi[n][f] = vi;
        }
        __syncthreads();
#pragma unroll 4
        for (int n = 0; n < K7_NC; ++n) {
          float xr[S_MF], xi[S_MF];
#pragma unroll
          for (int j = 0; j < S_MF; ++j) {
            xr[j] = Xr[n][tx + SX * j];
            xi[j] = Xi[n][tx + SX * j];
          }
#pragma unroll
          for (int dl = 0; dl < K7_DC; ++dl) {
#pragma unroll
            for (int i = 0; i < K7_MT; ++i) {
              const float a = Ws[dl][ty + SY * i][n];
#pragma unroll
              for (int j = 0; j < S_MF; ++j) {
                sr[dl][i][j] += a * xr[j];
                si[dl][i][j] += a * xi[j];
              }
            }
          }
        }
        __syncthreads();
      }
      // The chunk's S is complete: apply Phi[d, f] and sum over the taps.
#pragma unroll
      for (int dl = 0; dl < K7_DC; ++dl) {
        const int d = d0 + dl;
        if (d >= D2) break;
#pragma unroll
        for (int j = 0; j < S_MF; ++j) {
          const int f = f0 + tx + SX * j;
          if (f >= F) continue;
          const float pr = phre[(long)d * F + f], pi = phim[(long)d * F + f];
#pragma unroll
          for (int i = 0; i < K7_MT; ++i) {
            tr[i][j] += sr[dl][i][j] * pr - si[dl][i][j] * pi;
            ti[i][j] += sr[dl][i][j] * pi + si[dl][i][j] * pr;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K7_MT; ++i) {
      const int tg = t0 + ty + SY * i;
      if (tg >= tt) continue;
      const long eo = ((long)(pt * NB + b) * Tp + tb * tt + tg) * F;
#pragma unroll
      for (int j = 0; j < S_MF; ++j) {
        const int f = f0 + tx + SX * j;
        if (f >= F) continue;
        const float er = sere[eo + f], ei = seim[eo + f];
        gr[i][j] += tr[i][j] * er - ti[i][j] * ei;
        gi[i][j] += tr[i][j] * ei + ti[i][j] * er;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K7_MT; ++i) {
    const int tg = t0 + ty + SY * i;
    if (tg >= tt) continue;
    const long go = ((long)p * Tp + tb * tt + tg) * F;
#pragma unroll
    for (int j = 0; j < S_MF; ++j) {
      const int f = f0 + tx + SX * j;
      if (f < F) {
        gre[go + f] = gr[i][j];
        gim[go + f] = gi[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8: transpose of K7 into the two spectrum planes.
//   rbar[p,pl,b*nb+n,f] = sum_{tb: plane[p,tb]=pl} sum_t sum_d
//                         Wt[p,b,tb*tt+t,d,n] * S[t,d,f]   (re and im)
//   T = conj(E_b) gbar:  Tre = g_re*E_re + g_im*E_im, Tim = g_im*E_re - g_re*E_im
//   S = conj(Phi) T:     Sre = Tre*Phire + Tim*Phiim, Sim = Tim*Phire - Tre*Phiim
// with S rounded to the table type. Block: (f tile, n tile, (p, pl, b)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(SN)
shear_t(const float* __restrict__ gre, const float* __restrict__ gim,
        const T* __restrict__ wt, const float* __restrict__ sere,
        const float* __restrict__ seim, const float* __restrict__ phre,
        const float* __restrict__ phim, const int* __restrict__ plane,
        float* __restrict__ rre2, float* __restrict__ rim2, int PT, int NB,
        int Tp, int D2, int nb, int TB, int F, int nsrc) {
  __shared__ float Tr[K8_TC][S_BF];
  __shared__ float Ti[K8_TC][S_BF];
  __shared__ float Ws[K8_KC][K8_BN];
  __shared__ float Sr[K8_KC][S_BF];
  __shared__ float Si[K8_KC][S_BF];
  const int tt = Tp / TB, N = NB * nb;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SX + tx;
  const int f0 = blockIdx.x * S_BF, n0 = blockIdx.y * K8_BN;
  const int b = blockIdx.z % NB, pl = (blockIdx.z / NB) % nsrc;
  const int p = blockIdx.z / (NB * nsrc), pt = p % PT;
  float ar[K8_MN][S_MF] = {}, ai[K8_MN][S_MF] = {};

  for (int tb = 0; tb < TB; ++tb) {
    // Uniform over the block: the angle blocks on this plane (K8), or the
    // one angle block of this slot (K10).
    if ((plane ? plane[pt * TB + tb] : tb) != pl) continue;
    const T* w = wt + ((long)(pt * NB + b) * Tp + tb * tt) * D2 * nb;
    for (int s0 = 0; s0 < tt; s0 += K8_TC) {
      for (int i = tid; i < K8_TC * S_BF; i += SN) {
        const int f = i % S_BF, tl = i / S_BF, tg = s0 + tl;
        float vr = 0.f, vi = 0.f;
        if (tg < tt && f0 + f < F) {
          const long go = ((long)p * Tp + tb * tt + tg) * F + f0 + f;
          const long eo =
              ((long)(pt * NB + b) * Tp + tb * tt + tg) * F + f0 + f;
          const float g_r = gre[go], g_i = gim[go];
          const float er = sere[eo], ei = seim[eo];
          vr = g_r * er + g_i * ei;
          vi = g_i * er - g_r * ei;
        }
        Tr[tl][f] = vr;
        Ti[tl][f] = vi;
      }
      __syncthreads();
      for (int d0 = 0; d0 < D2; d0 += K8_DC) {
        for (int i = tid; i < K8_KC * K8_BN; i += SN) {
          const int n = i % K8_BN, k = i / K8_BN;
          const int tg = s0 + k / K8_DC, d = d0 + k % K8_DC, ng = n0 + n;
          float val = 0.f;
          if (tg < tt && d < D2 && ng < nb)
            val = ld<T>(w, ((long)tg * D2 + d) * nb + ng);
          Ws[k][n] = val;
        }
        for (int i = tid; i < K8_KC * S_BF; i += SN) {
          const int f = i % S_BF, k = i / S_BF;
          const int tl = k / K8_DC, d = d0 + k % K8_DC;
          float vr = 0.f, vi = 0.f;
          if (d < D2 && f0 + f < F) {
            const long o = (long)d * F + f0 + f;
            const float pr = phre[o], pi = phim[o];
            const float a = Tr[tl][f], c = Ti[tl][f];
            vr = rnd<T>(a * pr + c * pi);
            vi = rnd<T>(c * pr - a * pi);
          }
          Sr[k][f] = vr;
          Si[k][f] = vi;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < K8_KC; ++k) {
          float wv[K8_MN], xr[S_MF], xi[S_MF];
#pragma unroll
          for (int i = 0; i < K8_MN; ++i) wv[i] = Ws[k][ty + SY * i];
#pragma unroll
          for (int j = 0; j < S_MF; ++j) {
            xr[j] = Sr[k][tx + SX * j];
            xi[j] = Si[k][tx + SX * j];
          }
#pragma unroll
          for (int i = 0; i < K8_MN; ++i) {
#pragma unroll
            for (int j = 0; j < S_MF; ++j) {
              ar[i][j] += wv[i] * xr[j];
              ai[i][j] += wv[i] * xi[j];
            }
          }
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K8_MN; ++i) {
    const int ng = n0 + ty + SY * i;
    if (ng >= nb) continue;
    const long ro = ((long)(p * nsrc + pl) * N + (long)b * nb + ng) * F;
#pragma unroll
    for (int j = 0; j < S_MF; ++j) {
      const int f = f0 + tx + SX * j;
      if (f < F) {
        rre2[ro + f] = ar[i][j];
        rim2[ro + f] = ai[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7-K10 with bf16 tables, on the tensor cores (bf16 mma.sync m16n8k16, f32
// accumulators). Two launches each: the tap-tile mask of Wt, then the tap
// product over the tiles it marks. The scratch is the mask (see
// dip_shear_scratch).
// ---------------------------------------------------------------------------
constexpr int SH_MAXCH = 8;    // 16-row chunks of a row block: nb <= 128
constexpr int SH_MT7 = 4;      // K7: frequency m-tiles (16 f) of a block
constexpr int SH_AL7 = 2;      // K7: angle lanes of a block
constexpr int SH_NT7 = 32 * SH_MT7 * SH_AL7;
constexpr int SH_MAXTG = 16;   // K7: angles of a block, at most
constexpr int SH_MT8 = 4;      // K8: frequency m-tiles of a block
constexpr int SH_NH8 = 2;      // K8: 64-row halves of a block
constexpr int SH_NT8 = 32 * SH_MT8 * SH_NH8;

// Two f32 values rounded to bf16 and packed (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// The tap-tile mask of Wt [rows = PT*NB*Tp][D2][nb] (bf16, 16-byte rows of
// nb % 8 == 0 elements): word mask[row * DT + j] (DT = D2 / 8) has bit q set
// when the 8 x 8 tile of taps 8j..8j+7 and rows 8q..8q+7 holds a nonzero
// bit pattern (-0 and NaN count: a marked tile is computed exactly). One
// block per row; dynamic shared memory of DT * nb / 8 flags.
__global__ void __launch_bounds__(256)
shear_mask(const B16* __restrict__ wt, unsigned* __restrict__ mask, int D2,
           int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = nb / 8, DT = D2 / 8;
  const uint4* w =
      reinterpret_cast<const uint4*>(wt + (long)blockIdx.x * D2 * nb);
  for (int i = threadIdx.x; i < DT * Q; i += 256) smem[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < D2 * Q; i += 256) {  // row d = i / Q
    const uint4 v = __ldg(w + i);
    if (v.x | v.y | v.z | v.w) smem[(i / (8 * Q)) * Q + i % Q] = 1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < DT; j += 256) {
    unsigned m = 0;
    for (int q = 0; q < Q; ++q) m |= (unsigned)smem[j * Q + q] << q;
    mask[(long)blockIdx.x * DT + j] = m;
  }
}

// Phi [D2, F] f32 (re, im) for the block's BF frequencies from f0, into
// Ps [D2][LDP] as (re, im) pairs (zero past F).
template <int BF, int LDP, int NTH>
__device__ __forceinline__ void stage_phi(float2* Ps, const float* phre,
                                          const float* phim, int D2, int F,
                                          int f0) {
#pragma unroll 4
  for (int i = threadIdx.x; i < D2 * BF; i += NTH) {
    const int d = i / BF, fl = i % BF, f = f0 + fl;
    const long o = (long)d * F + f;
    Ps[d * LDP + fl] = f < F ? make_float2(phre[o], phim[o])
                             : make_float2(0.f, 0.f);
  }
}

// A group of SH_GW warps shares each step's B tiles: one cp.async ring of
// SH_R steps in shared memory, SH_STEP bf16 a step, that the group fills
// SH_R - 1 steps ahead of the step it multiplies and syncs by a named
// barrier (id 1 + group).
constexpr int SH_GW = 4;         // warps of a group
constexpr int SH_GT = 32 * SH_GW;
constexpr int SH_R = 3;          // steps of the ring
constexpr int SH_STEP = 16 * 64; // bf16 of a step's B: 16 8 x 8 tiles
static_assert(SH_MT7 == SH_GW && SH_MT8 == SH_GW,
              "a group is the warps of a block's m-tiles");

__device__ __forceinline__ void bar_group(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(SH_GT) : "memory");
}
// 4 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
// ldmatrix .x2 (plain and .trans) at a shared-memory address.
__device__ __forceinline__ void ldsm_x2_at(unsigned& r0, unsigned& r1,
                                           unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t_at(unsigned& r0, unsigned& r1,
                                             unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

// K7 (K9: plane null, angle block tb reads slot tb) on the tensor cores:
//   S_b[t,d,f] = sum_n Wt[t,d,n] bf16(r_b[n,f]) as C[f][d] += A[f][n] B[n][d]
// with M = 16 frequencies, N = 8 taps d of one angle, K = 16 rows n; then
//   g[t,f] = sum_b E_b[t,f] * sum_d Phi[d,f] S_b[t,d,f].
// Block: (BF = 64 frequencies, TG angles, (p, tb)), two groups of four
// warps; warp w owns m-tile w % SH_MT7, its group the angles tl = w /
// SH_MT7 (mod SH_AL7). A group walks the steps (b, tl, 8-tap tile j) that
// the mask marks, in that order, from a list compacted once per block; a
// step's B is its 8 x 8 tiles (row d, 16 bytes of rows n), one cp.async
// each into the group's ring (zero-filled where the mask marks none), read
// back by ldmatrix. Per row block a warp holds its A fragments (the rounded
// spectra of its 16 frequencies, all nb rows) in registers. The Phi
// combine runs on each step's C in f32 (Phi staged once per block), the
// quad's partial sums meet by a fixed shuffle tree, and each (t, f) is
// multiplied by E_b and added to its slot in Gs in ascending b.
__global__ void __launch_bounds__(SH_NT7, 2)
shear_fwd_tc(const float* __restrict__ rre2, const float* __restrict__ rim2,
             const B16* __restrict__ wt, const unsigned* __restrict__ mask,
             const float* __restrict__ sere, const float* __restrict__ seim,
             const float* __restrict__ phre, const float* __restrict__ phim,
             const int* __restrict__ plane, float* __restrict__ gre,
             float* __restrict__ gim, int PT, int NB, int Tp, int D2, int nb,
             int TB, int F, int nsrc, int TG) {
  constexpr int BF = 16 * SH_MT7, LDP = BF + 4;  // LDP: two wavefronts
  extern __shared__ __align__(16) unsigned char smem[];
  B16* ring = reinterpret_cast<B16*>(smem);  // [SH_AL7][SH_R][SH_STEP]
  float2* Ps = reinterpret_cast<float2*>(ring + SH_AL7 * SH_R * SH_STEP);
  float* Gs = reinterpret_cast<float*>(Ps + D2 * LDP);  // [TG][2][BF]
  const int tt = Tp / TB, N = NB * nb, DT = D2 / 8;
  const int LS = NB * ((TG + SH_AL7 - 1) / SH_AL7) * DT;  // steps a group
  unsigned* Ls = reinterpret_cast<unsigned*>(Gs + TG * 2 * BF);  // [SH_AL7][LS]
  int* Ns = reinterpret_cast<int*>(Ls + SH_AL7 * LS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int mt = warp % SH_MT7, al = warp / SH_MT7;
  const int gi = threadIdx.x % SH_GT;  // thread of the group
  const int f0 = blockIdx.x * BF, t0 = blockIdx.y * TG;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  const int src = plane ? plane[pt * TB + tb] : tb;
  const int nt = min(TG, tt - t0);
  const int fl = 16 * mt + g8, fa = f0 + fl;  // C rows fa, fa + 8
  const int h = q & 1, fe = fa + 8 * h;       // this lane's g: see below
  const long rb0 = (long)pt * NB * Tp + tb * tt + t0;  // row of (b 0, tl 0)

  stage_phi<BF, LDP, SH_NT7>(Ps, phre, phim, D2, F, f0);
  for (int i = threadIdx.x; i < TG * 2 * BF; i += SH_NT7) Gs[i] = 0.f;
  __syncthreads();

  // The group's marked steps (b, tl, j) in that order, as words m | j << 16
  // | tl << 21 | b << 25 (m the mask word; D2 <= 256, TG <= 16 and NB <=
  // 128, which the launcher checks), compacted by its first warp.
  const int ntl = (nt - al + SH_AL7 - 1) / SH_AL7;  // angles of the group
  unsigned* steps = Ls + al * LS;
  if (mt == 0) {
    int n = 0;
#pragma unroll 4
    for (int base = 0; base < NB * ntl * DT; base += 32) {
      const int k = base + lane, j = k % DT, tl = al + SH_AL7 * (k / DT % ntl);
      const int b = k / (DT * ntl);
      const unsigned m = k < NB * ntl * DT
                             ? mask[(rb0 + (long)b * Tp + tl) * DT + j]
                             : 0u;
      const unsigned bal = __ballot_sync(0xffffffffu, m != 0u);
      if (m)
        steps[n + __popc(bal & ((1u << lane) - 1u))] =
            m | (unsigned)(j << 16 | tl << 21 | b << 25);
      n += __popc(bal);
    }
    if (lane == 0) Ns[al] = n;
  }
  bar_group(1 + al);
  const int ns = Ns[al];
  // Thread gi fills row gi % 8 of step k's 8 x 8 tile gi / 8 (rows n
  // 8 (gi / 8)..) in its ring slot: a copy of Wt if the mask marks the
  // tile, zeros if not. Offsets within Wt fit an int (the wrapper checks).
  const int tile = gi >> 3;
  const B16* wq = wt + (rb0 * D2 + (gi & 7)) * nb + 8 * tile;
  const unsigned rs = smem_u32(ring + al * SH_R * SH_STEP);  // the ring
  auto issue = [&](int k) {
    if (k < ns) {
      const unsigned e = steps[k];
      const int o = (((int)(e >> 25) * Tp + (int)(e >> 21 & 15)) * D2 +
                     8 * (int)(e >> 16 & 31)) * nb;
      const bool on = (e >> tile) & 1u;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       rs + (k % SH_R) * SH_STEP * 2 + gi * 16),
                   "l"(on ? wq + o : wq), "r"(on ? 16 : 0)
                   : "memory");
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < SH_R - 1; ++k) issue(k);

  // ldmatrix rows of this lane: tiles 2c + (lane >> 3 & 1), row lane & 7.
  const unsigned lb = rs + ((((lane >> 3) & 1) * 8 + (lane & 7)) * 8) * 2;
  unsigned ar[SH_MAXCH][4], ai[SH_MAXCH][4];
  float tr0 = 0.f, tr1 = 0.f, ti0 = 0.f, ti1 = 0.f;  // T at fa, fa + 8
  float er = 0.f, ei = 0.f;                          // E_b at fe
  int cb = -1;
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<SH_R - 2>();
    bar_group(1 + al);
    issue(k + SH_R - 1);
    const unsigned e = steps[k], m = e & 0xffffu;
    const int j = e >> 16 & 31, tl = e >> 21 & 15, b = e >> 25;
    const bool first = k == 0 || steps[k - 1] >> 21 != e >> 21;
    const bool last = k == ns - 1 || steps[k + 1] >> 21 != e >> 21;
    const long row = rb0 + (long)b * Tp + tl;
    if (b != cb) {  // a new row block: its A fragments
      cb = b;
      const long xo = ((long)(p * nsrc + src) * N + (long)b * nb) * F;
#pragma unroll
      for (int c = 0; c < SH_MAXCH; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows f + 8 (r & 1), k n + 8 (r >> 1)
          const int n = 16 * c + 2 * q + 8 * (r >> 1), f = fa + 8 * (r & 1);
          const bool in = n < nb && f < F;  // nb % 8 == 0: so is n + 1
          const long o = xo + (long)n * F + f;
          ar[c][r] = in ? pack_bf16(rre2[o], rre2[o + F]) : 0u;
          ai[c][r] = in ? pack_bf16(rim2[o], rim2[o + F]) : 0u;
        }
    }
    if (first) {
      tr0 = tr1 = ti0 = ti1 = 0.f;
      if (fe < F) {
        er = sere[row * F + fe];
        ei = seim[row * F + fe];
      }
    }
    const unsigned ls = lb + (k % SH_R) * SH_STEP * 2;
    float cr[4] = {0.f, 0.f, 0.f, 0.f}, ci[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < SH_MAXCH; ++c)
      if ((m >> (2 * c)) & 3u) {  // tiles 2c, 2c + 1: rows n 16c..
        unsigned b0, b1;
        ldsm_x2_at(b0, b1, ls + c * 256);
        mma_bf16(cr, ar[c], b0, b1);
        mma_bf16(ci, ai[c], b0, b1);
      }
    // C element x: f = fa + 8 (x >> 1), d = 8j + 2q + (x & 1).
    const float2* ph = Ps + (8 * j + 2 * q) * LDP + fl;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 v = ph[(x & 1) * LDP + 8 * (x >> 1)];
      const float ur = cr[x] * v.x - ci[x] * v.y;
      const float ui = cr[x] * v.y + ci[x] * v.x;
      if (x < 2) {
        tr0 += ur;
        ti0 += ui;
      } else {
        tr1 += ur;
        ti1 += ui;
      }
    }
    if (!last) continue;  // the angle has more steps in this row block
#pragma unroll
    for (int x = 1; x <= 2; x *= 2) {
      tr0 += __shfl_xor_sync(0xffffffffu, tr0, x);
      tr1 += __shfl_xor_sync(0xffffffffu, tr1, x);
      ti0 += __shfl_xor_sync(0xffffffffu, ti0, x);
      ti1 += __shfl_xor_sync(0xffffffffu, ti1, x);
    }
    // Lane q of the quad: frequency fe = fa + 8 (q & 1), g's re (q < 2) or
    // im. Angles with no marked step keep the zeros of Gs.
    if (fe < F) {
      const float u = h ? tr1 : tr0, w = h ? ti1 : ti0;
      Gs[(tl * 2 + (q >> 1)) * BF + fl + 8 * h] +=
          q < 2 ? u * er - w * ei : u * ei + w * er;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < nt * BF; i += SH_NT7) {
    const int tl = i / BF, f = f0 + i % BF;
    if (f < F) {
      const long go = ((long)p * Tp + tb * tt + t0 + tl) * F + f;
      gre[go] = Gs[tl * 2 * BF + i % BF];
      gim[go] = Gs[(tl * 2 + 1) * BF + i % BF];
    }
  }
}

// K8 (K10: plane null, slot tb from angle block tb alone) on the tensor
// cores, K7 transposed:
//   rbar[n,f] = sum_{tb on the plane} sum_t sum_d Wt[t,d,n] S[t,d,f]
// as C[f][n] += A[f][d] B[d][n], M = 16 frequencies, N = 8 rows n, K = 16
// taps d of one angle, with S = bf16(conj(Phi) conj(E_b) gbar) formed in
// f32 in the TPU kernel's order, in registers, for the (t, k16) steps the
// mask marks only. Block: (BF = 64 frequencies, (p, plane, b)), two groups
// of four warps; warp w owns m-tile w % SH_MT8, its group the rows
// [64 h, 64 h + 64), h = w / SH_MT8, as eight n8 tiles of accumulators. A
// group walks the steps (tb on the plane, t, J) that the mask marks for
// its rows, from a list compacted once per block; a step's B is its 8 x 8
// tiles (row d, 16 bytes of rows n), one cp.async each into the group's
// ring (zero-filled where the mask marks none), read back by
// ldmatrix.trans, and the first step of an angle also carries that
// angle's cotangent and E_b. K runs tb ascending,
// then t, then d; every output element is written once by its block,
// zeros for a plane no angle block reads.
__global__ void __launch_bounds__(SH_NT8)
shear_t_tc(const float* __restrict__ gre, const float* __restrict__ gim,
           const B16* __restrict__ wt, const unsigned* __restrict__ mask,
           const float* __restrict__ sere, const float* __restrict__ seim,
           const float* __restrict__ phre, const float* __restrict__ phim,
           const int* __restrict__ plane, float* __restrict__ rre2,
           float* __restrict__ rim2, int PT, int NB, int Tp, int D2, int nb,
           int TB, int F, int nsrc) {
  constexpr int BF = 16 * SH_MT8, LDP = BF + 4;
  constexpr int STG = SH_STEP + 8 * BF;  // bf16: B, then 4 x BF f32
  extern __shared__ __align__(16) unsigned char smem[];
  B16* ring = reinterpret_cast<B16*>(smem);  // [SH_NH8][SH_R][STG]
  float2* Ps = reinterpret_cast<float2*>(ring + SH_NH8 * SH_R * STG);
  const int tt = Tp / TB, N = NB * nb, DT = D2 / 8, KJ = D2 / 16;
  // The groups' steps [SH_NH8][Tp * KJ] (see below) and their counts.
  unsigned* Ls = reinterpret_cast<unsigned*>(Ps + D2 * LDP);
  int* Ns = reinterpret_cast<int*>(Ls + SH_NH8 * Tp * KJ);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int mt = warp % SH_MT8, nh = warp / SH_MT8;
  const int gi = threadIdx.x % SH_GT;  // thread of the group
  const int f0 = blockIdx.x * BF;
  const int b = blockIdx.y % NB, pl = (blockIdx.y / NB) % nsrc;
  const int p = blockIdx.y / (NB * nsrc), pt = p % PT;
  const int fl = 16 * mt + g8, fa = f0 + fl;  // A rows fa, fa + 8
  const long rb = (long)(pt * NB + b) * Tp;   // row of angle 0

  stage_phi<BF, LDP, SH_NT8>(Ps, phre, phim, D2, F, f0);
  __syncthreads();

  // The group's marked steps (angle a = tb * tt + t on this plane (K8) or
  // slot (K10), k16 step J) in that order, as words m | J << 16 | a << 20
  // (m: this half's 8 x 8 tiles of taps 16J.., and those of 16J + 8.. << 8;
  // D2 <= 256 and Tp <= 4096, which the launcher checks), compacted by its
  // first warp.
  unsigned* steps = Ls + nh * Tp * KJ;
  if (mt == 0) {
    int n = 0;
#pragma unroll 4
    for (int base = 0; base < Tp * KJ; base += 32) {
      const int k = base + lane, J = k % KJ, a = k / KJ;
      unsigned m = 0u;
      if (k < Tp * KJ && (plane ? plane[pt * TB + a / tt] : a / tt) == pl) {
        const unsigned* mw = mask + (rb + a) * DT + 2 * J;
        m = (mw[0] >> (8 * nh) & 0xffu) | (mw[1] >> (8 * nh) & 0xffu) << 8;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, m != 0u);
      if (m)
        steps[n + __popc(bal & ((1u << lane) - 1u))] =
            m | (unsigned)(J << 16 | a << 20);
      n += __popc(bal);
    }
    if (lane == 0) Ns[nh] = n;
  }
  bar_group(1 + nh);
  const int ns = Ns[nh];
  // Thread gi fills tap row gi % 16 of step k's row tile gi / 16 in its
  // ring slot: a copy of Wt if the mask marks its 8 x 8 half, zeros if not;
  // a step that starts an angle also brings its cotangent and E_b at the
  // block's frequencies (4 bytes each, zero past F). Offsets within Wt fit
  // an int (the wrapper checks).
  const int tile = gi >> 4, bit = tile + (gi & 8);
  const B16* wq = wt + (rb * D2 + (gi & 15)) * nb + 64 * nh + 8 * tile;
  B16* rg = ring + nh * SH_R * STG;
  const unsigned rs = smem_u32(rg);
  auto issue = [&](int k) {
    if (k < ns) {
      const unsigned e = steps[k];
      const int a = e >> 20;
      const int o = (a * D2 + 16 * (int)(e >> 16 & 15)) * nb;
      const bool on = (e >> bit) & 1u;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       rs + (k % SH_R) * STG * 2 + gi * 16),
                   "l"(on ? wq + o : wq), "r"(on ? 16 : 0)
                   : "memory");
      if (k == 0 || steps[k - 1] >> 20 != e >> 20) {
        float* x = reinterpret_cast<float*>(rg + (k % SH_R) * STG + SH_STEP);
        for (int i = gi; i < 4 * BF; i += SH_GT) {  // [4][BF]
          const int c = i / BF, f = f0 + i % BF;
          const float* base = c == 0 ? gre : c == 1 ? gim : c == 2 ? sere
                                                                    : seim;
          const long o2 = (c < 2 ? (long)p * Tp + a : rb + a) * F + f;
          cp_async4(x + i, f < F ? base + o2 : base, f < F);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < SH_R - 1; ++k) issue(k);

  // ldmatrix.trans rows of this lane: tap row lane & 15 of row tile i.
  const unsigned lb = rs + (lane & 15) * 16;
  float acr[8][4] = {}, aci[8][4] = {};
  float tr0 = 0.f, tr1 = 0.f, ti0 = 0.f, ti1 = 0.f;  // T = conj(E_b) gbar
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<SH_R - 2>();
    bar_group(1 + nh);
    issue(k + SH_R - 1);
    const unsigned e = steps[k];
    if (k == 0 || steps[k - 1] >> 20 != e >> 20) {  // T at fa + 8h, the
      const float* x =                                  // TPU kernel's order
          reinterpret_cast<const float*>(rg + (k % SH_R) * STG + SH_STEP);
      const float g0r = x[fl], g0i = x[BF + fl];
      const float e0r = x[2 * BF + fl], e0i = x[3 * BF + fl];
      const float g1r = x[fl + 8], g1i = x[BF + fl + 8];
      const float e1r = x[2 * BF + fl + 8], e1i = x[3 * BF + fl + 8];
      tr0 = g0r * e0r + g0i * e0i;
      ti0 = g0i * e0r - g0r * e0i;
      tr1 = g1r * e1r + g1i * e1i;
      ti1 = g1i * e1r - g1r * e1i;
    }
    // A element (f = fa + 8 (r & 1), d = 16J + 2q + 8 (r >> 1) + x).
    const float2* ph = Ps + (16 * (int)(e >> 16 & 15) + 2 * q) * LDP + fl;
    unsigned sr[4], si[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float vr[2], vi[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float2 v = ph[(8 * (r >> 1) + x) * LDP + 8 * (r & 1)];
        const float u = r & 1 ? tr1 : tr0, w = r & 1 ? ti1 : ti0;
        vr[x] = u * v.x + w * v.y;
        vi[x] = w * v.x - u * v.y;
      }
      sr[r] = pack_bf16(vr[0], vr[1]);
      si[r] = pack_bf16(vi[0], vi[1]);
    }
    const unsigned ls = lb + (k % SH_R) * STG * 2;
    const unsigned mm = (e | e >> 8) & 0xffu;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((mm >> i) & 1u) {
        unsigned b0, b1;  // taps 16J.. and 16J + 8.. of rows 8i..
        ldsm_x2_t_at(b0, b1, ls + i * 256);
        mma_bf16(acr[i], sr, b0, b1);
        mma_bf16(aci[i], si, b0, b1);
      }
  }
  cp_async_wait<0>();
  const long ro = ((long)(p * nsrc + pl) * N + (long)b * nb) * F;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int n = 64 * nh + 8 * i + 2 * q + (x & 1), f = fa + 8 * (x >> 1);
      if (n < nb && f < F) {
        rre2[ro + (long)n * F + f] = acr[i][x];
        rim2[ro + (long)n * F + f] = aci[i][x];
      }
    }
}

// K7-K10 with f32 tables, on the CUDA cores.
cudaError_t launch_shear(bool fwd, const float* a_re, const float* a_im,
                         const void* wt, const float* sere, const float* seim,
                         const float* phre, const float* phim,
                         const int* plane, float* o_re, float* o_im, int PB,
                         int PT, int NB, int Tp, int D2, int nb, int TB, int F,
                         cudaStream_t s) {
  // K7/K8 read and write the two planes of a plane table; K9/K10 (plane
  // null) the TB slots.
  const int nsrc = plane ? 2 : TB;
  const dim3 blk(SX, SY);
  const float* w = static_cast<const float*>(wt);
  if (fwd) {
    const dim3 g(cdiv(F, S_BF), cdiv(Tp / TB, K7_BT), PB * TB);
    shear_fwd<float><<<g, blk, 0, s>>>(a_re, a_im, w, sere, seim, phre, phim,
                                       plane, o_re, o_im, PT, NB, Tp, D2, nb,
                                       TB, F, nsrc);
  } else {
    const dim3 g(cdiv(F, S_BF), cdiv(nb, K8_BN), PB * nsrc * NB);
    shear_t<float><<<g, blk, 0, s>>>(a_re, a_im, w, sere, seim, phre, phim,
                                     plane, o_re, o_im, PT, NB, Tp, D2, nb,
                                     TB, F, nsrc);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_skew_fwd(const float* rows2, const void* wtt,
                            const float* sere, const float* seim,
                            const void* dre, const void* dim, const int* plane,
                            float* z, float* gre, float* gim, int PB, int PT,
                            int NB, int D2, int Tp, int nb, int TB, int WS,
                            int WZ, int F, cudaStream_t s) {
  const int tt = Tp / TB;
  const dim3 blk(TX, TY);
  const dim3 g1(cdiv(WZ, BN), cdiv(tt, BM), PB * TB * NB);
  const dim3 g2(cdiv(F, BN), cdiv(tt, BM), PB * TB);
  skew_tap_fwd<T><<<g1, blk, 0, s>>>(rows2, static_cast<const T*>(wtt), plane,
                                     z, PT, NB, D2, Tp, nb, TB, WS, WZ);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  skew_dft_fwd<T><<<g2, blk, 0, s>>>(z, sere, seim, static_cast<const T*>(dre),
                                     static_cast<const T*>(dim), gre, gim, PT,
                                     NB, Tp, TB, WZ, F);
  return cudaGetLastError();
}

// The t group (in n8 tiles) the DFT-back takes for tt slots, and the next
// smaller one it instantiates.
int nt8_for(int tt) { return cdiv(tt, 8) >= 5 ? 6 : cdiv(tt, 8); }
int nt8_down(int n) { return n == 6 ? 3 : n == 4 || n == 3 ? 2 : 1; }

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Launch with the kernel's dynamic shared memory limit raised to at least
// smem (raised: the limit set so far for this kernel).
template <typename K, typename... A>
cudaError_t launch_big(K kernel, dim3 g, int threads, size_t smem,
                       cudaStream_t s, size_t& raised, A... args) {
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  kernel<<<g, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// The layout of K7-K10's bf16 scratch: the tap-tile mask, in words.
long shear_scratch(int PT, int NB, int Tp, int D2) {
  return (long)PT * NB * Tp * (D2 / 8);
}

// K7-K10 with bf16 tables: the mask, then the tap product. K7's block takes
// TG = 16 angles (each group 8, its warps' A fragments loaded once per row
// block for them), halved while the grid has fewer blocks than two per SM:
// at 256^2/8, 9 x 3 x 16 = 432 blocks of 64 frequencies; K8's block takes
// 64 frequencies of one (image, plane, row block): 9 x 32 = 288 blocks.
// Both fit two blocks an SM at 256^2/8 and 512^2/8 (shared memory: Phi
// ~78 KB, the rings ~19 KB, the step lists). Every Wt byte is read from HBM
// once, by the mask pass; the tap products re-read only the marked tiles,
// which the blocks of one angle block, adjacent in the grid, find in L2.
// The grid does not change a sum's order.
cudaError_t launch_shear_tc(bool fwd, const float* a_re, const float* a_im,
                            const void* wt, const float* sere,
                            const float* seim, const float* phre,
                            const float* phim, const int* plane,
                            void* scratch, float* o_re, float* o_im, int PB,
                            int PT, int NB, int Tp, int D2, int nb, int TB,
                            int F, cudaStream_t s) {
  const int nsrc = plane ? 2 : TB, tt = Tp / TB;
  const B16* w = static_cast<const B16*>(wt);
  unsigned* mask = static_cast<unsigned*>(scratch);
  if (nb % 8 || nb > 8 * 2 * SH_MAXCH || D2 % 16 || D2 > 256 || Tp > 4096 ||
      NB > 128 || reinterpret_cast<unsigned long long>(wt) % 16)
    return cudaErrorInvalidValue;
  shear_mask<<<(unsigned)((long)PT * NB * Tp), 256, (D2 / 8) * (nb / 8), s>>>(
      w, mask, D2, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (fwd) {
    const long sms = sm_count();
    int tg = SH_MAXTG;
    auto blocks = [&] {
      return (long)cdiv(F, 16 * SH_MT7) * cdiv(tt, tg) * PB * TB;
    };
    while (blocks() < 2 * sms && tg > SH_AL7) tg /= 2;
    const size_t smem =
        sizeof(B16) * SH_AL7 * SH_R * SH_STEP +
        sizeof(float) * (2 * (size_t)D2 * (16 * SH_MT7 + 4) +
                         2 * (size_t)tg * 16 * SH_MT7) +
        sizeof(unsigned) * SH_AL7 * NB * cdiv(tg, SH_AL7) * (D2 / 8) +
        sizeof(int) * SH_AL7;
    static size_t raised = 0;
    return launch_big(shear_fwd_tc,
                      dim3(cdiv(F, 16 * SH_MT7), cdiv(tt, tg), PB * TB),
                      SH_NT7, smem, s, raised, a_re, a_im, w,
                      (const unsigned*)mask, sere, seim, phre, phim, plane,
                      o_re, o_im, PT, NB, Tp, D2, nb, TB, F, nsrc, tg);
  }
  const size_t smem =
      sizeof(B16) * SH_NH8 * SH_R * (SH_STEP + 8 * 16 * SH_MT8) +
      sizeof(float) * 2 * (size_t)D2 * (16 * SH_MT8 + 4) +
      sizeof(unsigned) * SH_NH8 * Tp * (D2 / 16) + sizeof(int) * SH_NH8;
  static size_t raised = 0;
  return launch_big(shear_t_tc, dim3(cdiv(F, 16 * SH_MT8), PB * nsrc * NB),
                    SH_NT8, smem, s, raised, a_re, a_im, w,
                    (const unsigned*)mask, sere, seim, phre, phim, plane,
                    o_re, o_im, PT, NB, Tp, D2, nb, TB, F, nsrc);
}

// K1 with bf16 tables. The tap product takes all v of an angle block in one
// block (BV = 512) where that still gives a block for every other SM, else
// halves the v tile: 256^2/8, 192 blocks of 512 v x 8 slots, each tap read
// once; fan (8 images on one table set), 96 blocks of 512 v; a 2 x 2 mesh
// rank's shard, 96 blocks of 256 v (the fewer, wider blocks measured
// faster on an H100 than a block per SM). The DFT-back takes the whole
// angle block as its t group, smaller groups only to reach a block per SM.
// None of it changes a sum's order.
cudaError_t launch_skew_fwd_tc(const float* rows2, const void* wtt,
                               const float* sere, const float* seim,
                               const void* dre, const void* dim,
                               const int* plane, void* scratch, float* gre,
                               float* gim, int PB, int PT, int NB, int D2,
                               int Tp, int nb, int TB, int WS, int WZ, int F,
                               cudaStream_t s) {
  const B16* w = static_cast<const B16*>(wtt);
  const int tt = Tp / TB;
  const SkewScratch sc = skew_scratch(PB, TB, NB, tt, nb, D2, WS, F);
  B16* z = static_cast<B16*>(scratch);
  B16* xT = z + sc.x_off;
  B16* dp = z + sc.d_off;
  const int vec =
      nb % 8 == 0 && reinterpret_cast<unsigned long long>(wtt) % 16 == 0;
  const long tri = (long)PB * TB * NB, sms = sm_count();

  skew_prep_x<<<dim3(cdiv(WS, 32), cdiv(sc.nbp, 32), PB * 2 * NB),
                dim3(32, 8), 0, s>>>(rows2, xT, NB, nb, sc.nbp, WS);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  skew_prep_d<<<(unsigned)cdiv(sc.ZS * sc.Fp, 256), 256, 0, s>>>(
      static_cast<const B16*>(dre), static_cast<const B16*>(dim), dp, WZ, F,
      sc.ZS, sc.Fp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int mt = 4;
  auto blocks1 = [&] { return cdiv(sc.ZS, 128 * mt) * (long)cdiv(tt, 8) * tri; };
  while (2 * blocks1() < sms && mt > 1) mt /= 2;
  const int LD = sc.NCH + TC_PAD, BV = 128 * mt;
  const size_t win =
      (size_t)(BV + D2 - 1) * LD + (size_t)TC_STAGES * TC_DS * 8 * LD;
  const size_t epi = (size_t)8 * (BV + 8);
  const size_t smem = 2 * (win > epi ? win : epi);
  if (smem + sizeof(unsigned) * TC_WARPS1 > (size_t)TC_MAX_SMEM)
    return cudaErrorInvalidValue;
  const dim3 g1(cdiv(sc.ZS, BV), cdiv(tt, 8), (unsigned)tri);
  static size_t raised1[3] = {0, 0, 0};
#define DIP_TAP(M, I)                                                         \
  case M:                                                                     \
    e = launch_big(skew_tap_fwd_tc<M>, g1, TC_NT1, smem, s, raised1[I], xT, w, \
                   plane, z, PT, NB, D2, Tp, nb, TB, WS, sc.ZS, sc.NCH,       \
                   sc.nbp, vec);                                              \
    break;
  switch (mt) { DIP_TAP(1, 0) DIP_TAP(2, 1) default: DIP_TAP(4, 2) }
#undef DIP_TAP
  if (e != cudaSuccess) return e;

  int nt2 = nt8_for(tt);
  auto blocks2 = [&] { return cdiv(F, 64) * (long)cdiv(tt, 8 * nt2) * PB * TB; };
  while (blocks2() < sms && nt2 > 1) nt2 = nt8_down(nt2);
  const dim3 g2(cdiv(F, 64), cdiv(tt, 8 * nt2), PB * TB);
  const size_t smem2 = 2 * (size_t)TC_DSTAGES *
                       (2 * TC_KC * (64 + TC_PAD) +
                        8 * ((nt2 + 1) / 2 * 2) * (TC_KC + TC_PAD));
  static size_t raised2[5] = {0, 0, 0, 0, 0};
#define DIP_DFT(N, I)                                                       \
  case N:                                                                   \
    e = launch_big(skew_dft_fwd_tc<N>, g2, TC_NT, smem2, s, raised2[I], z,  \
                   sere, seim, (const B16*)dp, gre, gim, PT, NB, Tp, TB,    \
                   sc.ZS, sc.Fp, F);                                        \
    break;
  switch (nt2) { DIP_DFT(1, 0) DIP_DFT(2, 1) DIP_DFT(3, 2) DIP_DFT(4, 3) default: DIP_DFT(6, 4) }
#undef DIP_DFT
  return e;
}

template <typename T>
cudaError_t launch_skew_t(const float* gre, const float* gim, const void* wtt,
                          const float* sere, const float* seim,
                          const void* dret, const void* dimt, const int* plane,
                          float* zbar, float* x2, int PB, int PT, int NB,
                          int D2, int Tp, int nb, int TB, int WS, int WZ,
                          int F, cudaStream_t s) {
  const int tt = Tp / TB;
  const dim3 blk(TX, TY);
  const dim3 g1(cdiv(WZ, BN), cdiv(tt, BM), PB * TB * NB);
  const dim3 g2(cdiv(WS, BN), cdiv(nb, BM), PB * 2 * NB);
  skew_dft_t<T><<<g1, blk, 0, s>>>(gre, gim, sere, seim,
                                   static_cast<const T*>(dret),
                                   static_cast<const T*>(dimt), zbar, PT, NB,
                                   Tp, TB, WZ, F);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  skew_tap_t<T><<<g2, blk, 0, s>>>(zbar, static_cast<const T*>(wtt), plane, x2,
                                   PT, NB, D2, Tp, nb, TB, WS, WZ);
  return cudaGetLastError();
}

// K2 with bf16 tables. The DFT-forward takes the whole angle block as its t
// group, smaller groups only to reach a block per SM; the tap product takes
// 256 u x 32 n a block (each tap read once), halving n, then u, while the
// grid has fewer blocks than every other SM: 256^2/8 and the fan, 128
// blocks of 256 u x 32 n; a fan shard, 128 of 256 u x 16 n; a 2 x 2 mesh
// rank's shard, 128 of 128 u x 16 n (a wider u tile reads each tap fewer
// times; a narrower n group visits fewer k16 steps). None of it changes a
// sum's order.
cudaError_t launch_skew_t_tc(const float* gre, const float* gim,
                             const void* wtt, const float* sere,
                             const float* seim, const void* dret,
                             const void* dimt, const int* plane,
                             void* scratch, float* x2, int PB, int PT, int NB,
                             int D2, int Tp, int nb, int TB, int WS, int WZ,
                             int F, cudaStream_t s) {
  const int tt = Tp / TB;
  const SkewTScratch sc = skew_t_scratch(PB, TB, NB, tt, D2, WS, F);
  const unsigned long long al =
      reinterpret_cast<unsigned long long>(dret) |
      reinterpret_cast<unsigned long long>(dimt);
  const long C8 = sc.ttp / 8;
  if (sc.ttp > T2_MAX_TTP || TB > T2_MAX_TB || WZ % 8 != 0 || al % 16 != 0 ||
      (D2 * C8 + 128) * C8 >= 65536)
    return cudaErrorInvalidValue;
  B16* zT = static_cast<B16*>(scratch);
  B16* zph = zT + sc.z_off;
  const long Q = (long)PB * TB * NB, sms = sm_count();

  skew_phase_t<<<dim3(cdiv(sc.Fp, 256), sc.ttp, (unsigned)Q), 256, 0, s>>>(
      gre, gim, sere, seim, zph, PT, NB, Tp, TB, F, sc.ttp, sc.Fp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int nt = nt8_for(tt);
  auto blocks1 = [&] {
    return cdiv(sc.ZW, 16 * TC_WARPS1) * (long)cdiv(sc.ttp, 8 * nt) * Q;
  };
  while (blocks1() < sms && nt > 1) nt = nt8_down(nt);
  const dim3 g1(cdiv(sc.ZW, 16 * TC_WARPS1), cdiv(sc.ttp, 8 * nt), (unsigned)Q);
  const size_t smem1 =
      2 * (size_t)T2_FSTAGES *
      (T2_FC * odd_ld(16 * TC_WARPS1) + 8 * ((nt + 1) / 2 * 2) * odd_ld(T2_FC));
  static size_t raised1[5] = {0, 0, 0, 0, 0};
#define DIP_DFT_T(N, I)                                                     \
  case N:                                                                   \
    e = launch_big(skew_dft_t_tc<N>, g1, TC_NT1, smem1, s, raised1[I],      \
                   (const B16*)zph, static_cast<const B16*>(dret),          \
                   static_cast<const B16*>(dimt), zT, WZ, F, sc.ttp, sc.ZW, \
                   sc.Fp);                                                  \
    break;
  switch (nt) { DIP_DFT_T(1, 0) DIP_DFT_T(2, 1) DIP_DFT_T(3, 2) DIP_DFT_T(4, 3) default: DIP_DFT_T(6, 4) }
#undef DIP_DFT_T
  if (e != cudaSuccess) return e;

  int mt = 2, nt2 = 4;
  auto blocks2 = [&] {
    return cdiv(WS, 16 * mt * TC_WARPS1) * (long)cdiv(nb, 8 * nt2) * PB * 2 * NB;
  };
  while (2 * blocks2() < sms && (mt > 1 || nt2 > 2)) {
    if (nt2 > 2)
      nt2 = 2;
    else
      mt = 1;
  }
  const int BU = 16 * mt * TC_WARPS1, BN = 8 * nt2;
  const size_t win = (size_t)(BU + D2 - 1) * odd_ld(sc.ttp) +
                     (size_t)T2_STAGES * 8 * (128 / nt2) * odd_ld(BN);
  const size_t epi = 2 * (size_t)BN * (BU + 4);  // f32 tile, in bf16 units
  const size_t smem2 = 2 * (win > epi ? win : epi);
  if (smem2 + sizeof(unsigned) * TC_WARPS1 + sizeof(int) * T2_MAX_TB >
      (size_t)TC_MAX_SMEM)
    return cudaErrorInvalidValue;
  const int vec =
      nb % 8 == 0 && reinterpret_cast<unsigned long long>(wtt) % 16 == 0;
  const dim3 g2(cdiv(WS, BU), cdiv(nb, BN), (unsigned)(PB * 2 * NB));
  static size_t raised2[4] = {0, 0, 0, 0};
#define DIP_TAP_T(M, N, I)                                                    \
  case 10 * M + N:                                                            \
    e = launch_big(skew_tap_t_tc<M, N>, g2, TC_NT1, smem2, s, raised2[I],     \
                   (const B16*)zT, static_cast<const B16*>(wtt), plane, x2,   \
                   PT, NB, D2, Tp, nb, TB, WS, sc.ZW, sc.ttp, vec);           \
    break;
  switch (10 * mt + nt2) {
    DIP_TAP_T(1, 2, 0) DIP_TAP_T(1, 4, 1) DIP_TAP_T(2, 2, 2) default: DIP_TAP_T(2, 4, 3)
  }
#undef DIP_TAP_T
  return e;
}

// Launches K3's Wd epilogue (eval_wd_fwd) with the table type T.
template <typename T>
void launch_wd_fwd(const float* R, const void* wd, float* out, int PB, int PT,
                   int DB, int Tp, int D2p, int db, cudaStream_t s) {
  const int L = cdiv(db, 8) < WD_ZG ? cdiv(db, 8) : WD_ZG, RB = WD_ZG / L;
  const long rows = (long)PB * DB * Tp;
  const dim3 g(static_cast<unsigned>((rows + RB - 1) / RB), cdiv(db, 8 * L));
  const int nt = RB * WD_ZG * L;
  const T* w = static_cast<const T*>(wd);
  if (db % 8 == 0)
    eval_wd_fwd<T, true><<<g, nt, 0, s>>>(R, w, out, PT, DB, Tp, D2p, db,
                                          rows, L, RB);
  else
    eval_wd_fwd<T, false><<<g, nt, 0, s>>>(R, w, out, PT, DB, Tp, D2p, db,
                                           rows, L, RB);
}

// Launches K4's Wd pre-contraction (eval_wd_t) with the table type T.
template <typename T>
void launch_wd_t(const float* ob, const void* wd, void* rbar, int PB, int PT,
                 int DB, int Tp, int D2p, int db, cudaStream_t s) {
  const int L = cdiv(db, 8) < WD_ZG ? cdiv(db, 8) : WD_ZG;
  int L2 = 1;
  while (L2 < L) L2 *= 2;
  const unsigned rows = static_cast<unsigned>((long)PB * DB * Tp);
  const T* w = static_cast<const T*>(wd);
  T* rb = static_cast<T*>(rbar);
  if (db % 8 == 0)
    eval_wd_t<T, true><<<rows, WD_NT, 0, s>>>(ob, w, rb, PT, DB, Tp, D2p, db,
                                              L, L2);
  else
    eval_wd_t<T, false><<<rows, WD_NT, 0, s>>>(ob, w, rb, PT, DB, Tp, D2p,
                                               db, L, L2);
}

}  // namespace

extern "C" {

// Elements of K1's bf16 scratch (bf16 tables) at these shapes.
int dip_skew_fwd_scratch(int PB, int TB, int NB, int tt, int nb, int D2,
                         int WS, int F) {
  return static_cast<int>(skew_scratch(PB, TB, NB, tt, nb, D2, WS, F).total);
}

// z: the wrapper's scratch, [PB, TB, NB, tt, WZ] f32 with f32 tables, and
// dip_skew_fwd_scratch's count of bf16 elements with bf16 ones.
int dip_skew_fwd(const float* rows2, const void* wtt, const float* sere,
                 const float* seim, const void* dre, const void* dim,
                 const int* plane, void* z, float* gre, float* gim, int PB,
                 int PT, int NB, int D2, int Tp, int nb, int TB, int WS,
                 int WZ, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_skew_fwd_tc(rows2, wtt, sere, seim, dre, dim, plane, z,
                                gre, gim, PB, PT, NB, D2, Tp, nb, TB, WS, WZ,
                                F, s)
           : launch_skew_fwd<float>(rows2, wtt, sere, seim, dre, dim, plane,
                                    static_cast<float*>(z), gre, gim, PB, PT,
                                    NB, D2, Tp, nb, TB, WS, WZ, F, s));
}

// Elements of K2's bf16 scratch (bf16 tables) at these shapes.
int dip_skew_t_scratch(int PB, int TB, int NB, int tt, int D2, int WS,
                       int F) {
  return static_cast<int>(skew_t_scratch(PB, TB, NB, tt, D2, WS, F).total);
}

// zbar: the wrapper's scratch, [PB, TB, NB, tt, WZ] f32 with f32 tables, and
// dip_skew_t_scratch's count of bf16 elements with bf16 ones.
int dip_skew_t(const float* gre, const float* gim, const void* wtt,
               const float* sere, const float* seim, const void* dret,
               const void* dimt, const int* plane, void* zbar, float* x2,
               int PB, int PT, int NB, int D2, int Tp, int nb, int TB, int WS,
               int WZ, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_skew_t_tc(gre, gim, wtt, sere, seim, dret, dimt, plane,
                              zbar, x2, PB, PT, NB, D2, Tp, nb, TB, WS, WZ, F,
                              s)
           : launch_skew_t<float>(gre, gim, wtt, sere, seim, dret, dimt, plane,
                                  static_cast<float*>(zbar), x2, PB, PT, NB,
                                  D2, Tp, nb, TB, WS, WZ, F, s));
}

// K3: R (the wrapper's scratch, [PB, DB, Tp, D2p] f32) and out
// [PB, Tp, DB * db]. Two launches: the R stage (bf16 tensor cores with bf16
// tables, CUDA cores with f32 ones), then the Wd epilogue.
int dip_eval_fwd(const float* gre, const float* gim, const void* wd,
                 const float* tere, const float* teim, const float* phre,
                 const float* phim, float* R, float* out, int PB, int PT,
                 int DB, int Tp, int D2p, int db, int F, int bf16,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const dim3 g(cdiv(D2p, EV_BZ), cdiv(Tp, EV_BT), PB * cdiv(DB, EV_NB));
    eval_r_tc<<<g, EV_NT, 0, s>>>(gre, gim, tere, teim, phre, phim, R, PT,
                                  DB, Tp, D2p, F);
  } else {
    const dim3 g(cdiv(D2p, BN), cdiv(Tp, BM), PB * DB);
    eval_fwd<<<g, dim3(TX, TY), 0, s>>>(gre, gim, tere, teim, phre, phim, R,
                                        PT, DB, Tp, D2p, F);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bf16)
    launch_wd_fwd<B16>(R, wd, out, PB, PT, DB, Tp, D2p, db, s);
  else
    launch_wd_fwd<float>(R, wd, out, PB, PT, DB, Tp, D2p, db, s);
  return static_cast<int>(cudaGetLastError());
}

// K4: rbar (the wrapper's scratch, [PB, DB, Tp, D2p] of the table type)
// and g [PB, Tp, F]. Two launches: the Wd pre-contraction, then the phase
// products (bf16 tensor cores with bf16 tables, CUDA cores with f32 ones).
// The bf16 launch 2 holds PhiD's f chunk for every z in shared memory: a
// D2p above 656 exceeds the card's 227 KB and the launch is refused.
int dip_eval_t(const float* ob, const void* wd, const float* tere,
               const float* teim, const float* phre, const float* phim,
               void* rbar, float* gre, float* gim, int PB, int PT, int DB,
               int Tp, int D2p, int db, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_wd_t<B16>(ob, wd, rbar, PB, PT, DB, Tp, D2p, db, s);
  else
    launch_wd_t<float>(ob, wd, rbar, PB, PT, DB, Tp, D2p, db, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bf16) {
    static size_t raised = 0;
    return static_cast<int>(launch_big(
        eval_t_tc, dim3(cdiv(F, ET_BF), cdiv(Tp, ET_BT), PB), ET_NT,
        eval_t_tc_smem(D2p), s, raised, static_cast<const B16*>(rbar), tere,
        teim, phre, phim, gre, gim, PT, DB, Tp, D2p, F));
  }
  eval_t<<<dim3(cdiv(F, BN), cdiv(Tp, BM), PB), dim3(TX, TY), 0, s>>>(
      static_cast<const float*>(rbar), tere, teim, phre, phim, gre, gim, PT,
      DB, Tp, D2p, F);
  return static_cast<int>(cudaGetLastError());
}

// Elements (int32) of K7-K10's scratch with bf16 tables: the tap-tile mask.
int dip_shear_scratch(int PT, int NB, int Tp, int D2) {
  return static_cast<int>(shear_scratch(PT, NB, Tp, D2));
}

// K7/K9 (plane null): scratch is dip_shear_scratch's count of int32 with
// bf16 tables (two launches: the mask, the tensor-core tap product) and
// unused with f32 tables (one launch on the CUDA cores).
int dip_shear_fwd(const float* rre2, const float* rim2, const void* wt,
                  const float* sere, const float* seim, const float* phre,
                  const float* phim, const int* plane, void* scratch,
                  float* gre, float* gim, int PB, int PT, int NB, int Tp,
                  int D2, int nb, int TB, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_shear_tc(true, rre2, rim2, wt, sere, seim, phre, phim,
                             plane, scratch, gre, gim, PB, PT, NB, Tp, D2, nb,
                             TB, F, s)
           : launch_shear(true, rre2, rim2, wt, sere, seim, phre, phim,
                          plane, gre, gim, PB, PT, NB, Tp, D2, nb, TB, F, s));
}

// K8/K10 (plane null): the scratch as for dip_shear_fwd.
int dip_shear_t(const float* gre, const float* gim, const void* wt,
                const float* sere, const float* seim, const float* phre,
                const float* phim, const int* plane, void* scratch,
                float* rre2, float* rim2, int PB, int PT, int NB, int Tp,
                int D2, int nb, int TB, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_shear_tc(false, gre, gim, wt, sere, seim, phre, phim,
                             plane, scratch, rre2, rim2, PB, PT, NB, Tp, D2,
                             nb, TB, F, s)
           : launch_shear(false, gre, gim, wt, sere, seim, phre, phim, plane,
                          rre2, rim2, PB, PT, NB, Tp, D2, nb, TB, F, s));
}

}  // extern "C"
