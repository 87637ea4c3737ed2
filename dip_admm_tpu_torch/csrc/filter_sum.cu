// Hopper (sm_90a) kernels of the fft_pallas and fft_grouped projectors: the
// filter-sums of dip_admm_tpu/ops/pallas/filter_sum.py, written again for
// CUDA.
//
//   K11 dip_sel_fwd <- filter_sum_sel       (_fwd_sel_pallas, _fwd_sel_kernel)
//   K12 dip_sel_t   <- filter_sum_sel_t     (_t_sel_pallas, _t_sel_kernel)
//   K13 dip_grp_fwd <- filter_sum_grouped   (_fwd_grp_pallas, _fwd_grp_kernel)
//   K14 dip_grp_t   <- filter_sum_grouped_t (_t_grp_pallas, _t_grp_kernel)
//
// K11: g[p,t,f] = sum_n r[p,sel(t),n,f] * H[p%PT,t,n,f]
// K12: rbar[p,o,n,f] = sum_{t: sel(t) = o} conj(H[p%PT,t,n,f]) * gbar[p,t,f]
// K13: g[p,t,f] = sum_n r_s[p,blk(t),n,f] * H[p%PT,t,n,f]
// K14: rbar_s[p,b,n,f] = sum_{t in block b} conj(H[p%PT,t,n,f]) * gbar[p,t,f]
// as complex products carried in re/im planes. sel(t) = sel[p%PT,t] > 0.5
// picks the spectrum plane of angle t (0 = image rows, 1 = transposed
// image rows; the tables hold 0 or 1). The spectra, g and their cotangents
// are f32; H is f32 or bf16, upcast on load; accumulation is f32. The image
// batch PB is a multiple of the table batch PT and image p reads table set
// p % PT (the JAX kernels' vmap rule): the fan-beam path runs its PB = P
// node images against one shared table set.
//
// What bounds them on an H100: memory. A block does 8 FLOPs per H element
// pair it loads (4 B in bf16), far below the card's ratio of compute to
// bandwidth, and tensor cores buy nothing: where PT = PB each H element is
// used once, and at the fan shapes the FLOPs (~0.4 GFLOP) are a few us at
// f32 rates. At the parallel 512^2/8 shapes H is 1.6 GB per plane in bf16,
// each table set read by one image: ~3.2 GB from HBM per call, a bound of
// ~1 ms (a kernel that only streams those bytes in 16-byte loads and sums
// them takes 1.00-1.04 ms of device time on an H100 80GB HBM3 at 700 W,
// scripts/torch_filter_stream.py). At the fan 256^2/8 shapes of K13/K14 H
// is one table set of ~12.6 MB per plane in bf16, read by 8 images, so it
// sits in the 50 MB L2; the HBM traffic is r_s (f32, [PB, TB, N, F]), K13's
// input and K14's output, and what the kernels move between L2 and the SMs
// is what they spend.
//
// Design, simple and deterministic (no atomics, two calls agree bit for
// bit): the TPU grid's sequential accumulation axis becomes a loop inside
// the block that owns the output.
// - All four stream H as 16-byte loads: each thread owns 8 consecutive
//   frequencies and reads them from a table row with one load (two in
//   f32). That needs rows on 16 bytes: the fft_pallas and fft_grouped
//   tables are stored with a row pitch padded with zeros to a multiple of 8
//   elements (1032 at F = 1025, 520 at F = 513), and so are the spectra
//   (K11's r and K13's r_s, from row-DFT columns of that pitch) and the
//   cotangents gbar (K12's and K14's input, from irfft rows of that padded
//   F). With two-byte loads and an odd pitch the same sums ran at 34% of
//   the bound; K12 reading a dense gbar with scalar loads was ~12% slower,
//   and its first form, staging gbar through shared memory behind block
//   barriers, slower than that. The f tiles split the F / 8 groups evenly
//   (at F = 1025: five tiles of 26 groups), so the ragged edge is a few
//   idle lanes in every tile, not a tile of its own; K11 with its threads
//   over (group, row phase) instead, 91% of them live in place of 81%,
//   took 1.3% more device time (scripts/torch_filter_stream.py), so the
//   idle lanes are not what holds K11 below the stream ceiling.
// - K11: one block per (image p, chunk of S_TC = 4 angles, f tile). Its 8
//   warps split the row loop (warp w takes rows n = w mod 8), each thread
//   keeps 4 angles x 8 frequencies of complex sums in registers (one
//   block of 128 registers, two blocks an SM: 64 KB of loads in flight an
//   SM), and the 8 partial sums are added in warp order through shared
//   memory. It reads only the plane each angle selects (both where a chunk
//   straddles the branch switch), where the TPU kernel reads both and
//   blends them by sel.
// - K12: one block per (image p, row tile of 8 x ST_NR rows, f tile). Each
//   thread owns ST_NR rows x 8 frequencies of one plane at a time: it walks
//   plane 0's angles in ascending t (a warp ballot over sel picks them 32
//   angles at a time), writes plane 0, then does the same for plane 1, so
//   only one plane's sums are live; a plane that no angle selects is
//   written as zeros. The 8 warps of a block read the same gbar rows (L1).
//   It writes the pad columns of its pitched output as zeros.
// - K13 and K14 take K = 2 images that share a table set (p = k PT + pt
//   for two consecutive k) in one thread where PB / PT is even, else one:
//   each H segment a thread loads is applied to both images from
//   registers, so H is read (PB / PT) / 2 times, not PB / PT times, and a
//   row step loads every image's operand before its first product. The
//   register budget of K11/K12 (64 f32 sums a thread at most) fixes the
//   product of the images and the slots (K13: 4 / K slots) or rows (K14:
//   2) a thread owns. At the fan shapes (PT = 1, PB = 8) H sits in L2
//   either way and a call is bound by the latency of its row steps, not by
//   bytes: K = 2 measured no slower than K = 1 and K = 4 (one slot or row
//   a thread) 20-35% slower (scripts/torch_filter_stream.py --grouped
//   --fan; H100 80GB HBM3, 700 W). At PT = PB (512^2) K = 1: the plain
//   stream.
// - K13: one block per (chunk of 4 / K slots of slot block tb, f tile,
//   (K-image group, tb)), 8 warps splitting the rows as K11's do, the 8
//   partial sums added in warp order through shared memory. The chunks of
//   one slot block are the fastest grid index, so the blocks that read the
//   same r_s rows (tt / (4 / K) of them) run side by side and r_s comes
//   from HBM once per slot block, from L2 to the others.
// - K14: one block per (f tile, row tile of 8 x ST_NR rows, (K-image
//   group, slot block)). Each thread owns ST_NR rows x 8 frequencies of K
//   images and sums the block's tt slots in ascending t: a pure map, each
//   output element written once, pad columns as zeros.
// - Every complex product is four fmaf in a fixed order (re: + r a, - i b;
//   im: + r b, + i a for K13, the conjugate for K14), so a sum's rounding
//   does not depend on K, PB or PT: K13's order over n is fixed (8 row
//   phases in ascending n, added in phase order), K14's over t ascending,
//   and a node slice of the batch gives the whole batch's rows bit for
//   bit.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// K11 and K12: streams over the pitched table, eight frequencies a thread.
// ---------------------------------------------------------------------------

constexpr int VEC = 8;    // frequencies per thread (one 16-byte bf16 load)
constexpr int S_NG = 8;   // warps per K11 block
constexpr int S_TC = 4;   // angles per K11 block (per thread)
constexpr int ST_NG = 8;  // warps per K12 block
constexpr int ST_NR = 2;  // rows per K12 thread: row tile ST_NG * ST_NR
static_assert(S_NG == 2 * S_TC, "K11's combine: warp w sums angle w / 2, "
                                "half w % 2 of its eight frequencies");

// Eight consecutive table values of a 16-byte aligned row segment, read
// through the read-only path (ld.global.nc) and kept raw until used.
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int k) const {
    const unsigned w = (k >> 1) == 0 ? v.x : (k >> 1) == 1 ? v.y
                     : (k >> 1) == 2 ? v.z : v.w;
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float operator[](int k) const {
    const float4& q = k < 4 ? a : b;
    const int c = k & 3;
    return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
  }
};

// Eight consecutive f32 spectrum values (16-byte aligned), cached.
__device__ __forceinline__ void ld8f(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---------------------------------------------------------------------------
// K11. Block: (f tile of JT eight-frequency groups, chunk of S_TC angles,
// image p). Warp w sums rows n = w mod S_NG; lane l owns group j0 + l.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(32 * S_NG, 2)
sel_fwd(const float* __restrict__ rre, const float* __restrict__ rim,
        const T* __restrict__ hre, const T* __restrict__ him,
        const float* __restrict__ sel, float* __restrict__ gre,
        float* __restrict__ gim, int PT, int T_, int N, int F, int JT,
        int hp, int rp) {
  __shared__ float part[S_NG][S_TC * VEC][32];  // [warp][angle, f][lane]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * JT;
  const bool live = tx < min(JT, cdiv(F, VEC) - j0);
  const int f0 = (j0 + tx) * VEC;
  const int t0 = blockIdx.y * S_TC, nt = min(S_TC, T_ - t0);
  const int p = blockIdx.z, pt = p % PT;
  // Bit i set: angle t0 + i reads plane 1.
  unsigned one = 0;
  for (int i = 0; i < nt; ++i)
    if (sel[(long)pt * T_ + t0 + i] > 0.5f) one |= 1u << i;
  float ar[S_TC][VEC], ai[S_TC][VEC];
#pragma unroll
  for (int i = 0; i < S_TC; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) ar[i][k] = ai[i][k] = 0.f;

  if (live) {
    const long hs = (long)N * hp;  // angle stride of H
    const T* h_r = hre + ((long)pt * T_ + t0) * hs + f0;
    const T* h_i = him + ((long)pt * T_ + t0) * hs + f0;
    const float* x_r = rre + (long)p * 2 * N * rp + f0;
    const float* x_i = rim + (long)p * 2 * N * rp + f0;
    for (int n = ty; n < N; n += S_NG) {
      const long o = (long)n * hp;
      Row8<T> hr[S_TC], hi[S_TC];
#pragma unroll
      for (int i = 0; i < S_TC; ++i) {
        if (i < nt) {
          hr[i].load(h_r + i * hs + o);
          hi[i].load(h_i + i * hs + o);
        }
      }
      // One plane's spectrum row at a time: the angles of plane 0, then
      // those of plane 1 (a chunk that straddles the switch reads both).
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const unsigned mine = pl ? one : ~one & ((1u << nt) - 1u);
        if (!mine) continue;
        float vr[VEC], vi[VEC];
        const long xo = ((long)pl * N + n) * rp;
        ld8f(x_r + xo, vr);
        ld8f(x_i + xo, vi);
#pragma unroll
        for (int i = 0; i < S_TC; ++i) {
          if ((mine >> i) & 1u) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float a = hr[i][k], b = hi[i][k];
              ar[i][k] += vr[k] * a - vi[k] * b;
              ai[i][k] += vr[k] * b + vi[k] * a;
            }
          }
        }
      }
    }
  }
  // The S_NG row partials, added in warp order: re, then im.
  const int i = ty >> 1, kh = (ty & 1) * (VEC / 2);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int a = 0; a < S_TC; ++a)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        part[ty][a * VEC + k][tx] = c ? ai[a][k] : ar[a][k];
    __syncthreads();
    if (live && i < nt) {
      float* out = (c ? gim : gre) + ((long)p * T_ + t0 + i) * F;
#pragma unroll
      for (int kk = 0; kk < VEC / 2; ++kk) {
        const int k = kh + kk;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < S_NG; ++w) v += part[w][i * VEC + k][tx];
        if (f0 + k < F) out[f0 + k] = v;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K12. Block: (f tile of JT groups, row tile of ST_NG * ST_NR rows, image p).
// Thread (lane l, warp w) owns rows n0 + w + ST_NG * q of group j0 + l; it
// walks plane 0's angles in ascending t, writes plane 0, then plane 1's.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(32 * ST_NG, 3)
sel_t(const float* __restrict__ gre, const float* __restrict__ gim,
      const T* __restrict__ hre, const T* __restrict__ him,
      const float* __restrict__ sel, float* __restrict__ rre,
      float* __restrict__ rim, int PT, int T_, int N, int F, int JT, int hp,
      int gp, int rp) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * JT;
  const bool live = tx < min(JT, cdiv(F, VEC) - j0);
  const int f0 = (j0 + tx) * VEC;
  const int n0 = blockIdx.y * (ST_NG * ST_NR) + ty;
  const int p = blockIdx.z, pt = p % PT;
  const long hs = (long)N * hp;
  const T* h_r = hre + (long)pt * T_ * hs + f0;
  const T* h_i = him + (long)pt * T_ * hs + f0;
  // g rows in their pitch, read by every warp of the block (cached in L1).
  const float* g_r = gre + (long)p * T_ * gp + f0;
  const float* g_i = gim + (long)p * T_ * gp + f0;
  const float* s = sel + (long)pt * T_;

  for (int pl = 0; pl < 2; ++pl) {
    float ar[ST_NR][VEC], ai[ST_NR][VEC];
#pragma unroll
    for (int q = 0; q < ST_NR; ++q)
#pragma unroll
      for (int k = 0; k < VEC; ++k) ar[q][k] = ai[q][k] = 0.f;
    for (int w0 = 0; w0 < T_; w0 += 32) {
      // The angles of this plane among w0 .. w0 + 31, in ascending t.
      const bool in = w0 + tx < T_;
      const unsigned m1 = __ballot_sync(0xffffffffu, in && s[w0 + tx] > 0.5f);
      const unsigned m = pl ? m1 : __ballot_sync(0xffffffffu, in) & ~m1;
      if (!live) continue;
      for (unsigned mm = m; mm; mm &= mm - 1u) {
        const int t = w0 + __ffs(mm) - 1;
        Row8<T> hr[ST_NR], hi[ST_NR];
#pragma unroll
        for (int q = 0; q < ST_NR; ++q) {
          const int n = n0 + ST_NG * q;
          if (n < N) {
            hr[q].load(h_r + t * hs + (long)n * hp);
            hi[q].load(h_i + t * hs + (long)n * hp);
          }
        }
        float gr[VEC], gi[VEC];
        ld8f(g_r + (long)t * gp, gr);
        ld8f(g_i + (long)t * gp, gi);
#pragma unroll
        for (int q = 0; q < ST_NR; ++q) {
          if (n0 + ST_NG * q < N) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float a = hr[q][k], b = hi[q][k];
              ar[q][k] += gr[k] * a + gi[k] * b;
              ai[q][k] += gi[k] * a - gr[k] * b;
            }
          }
        }
      }
    }
    // Plane pl of the rows: 16-byte stores over the pitch, zeros past F.
    if (live) {
#pragma unroll
      for (int q = 0; q < ST_NR; ++q) {
        const int n = n0 + ST_NG * q;
        if (n >= N) continue;
        const long ro = ((long)(p * 2 + pl) * N + n) * rp + f0;
        float vr[VEC], vi[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          vr[k] = f0 + k < F ? ar[q][k] : 0.f;
          vi[k] = f0 + k < F ? ai[q][k] : 0.f;
        }
        float4* orr = reinterpret_cast<float4*>(rre + ro);
        float4* ori = reinterpret_cast<float4*>(rim + ro);
        orr[0] = make_float4(vr[0], vr[1], vr[2], vr[3]);
        orr[1] = make_float4(vr[4], vr[5], vr[6], vr[7]);
        ori[0] = make_float4(vi[0], vi[1], vi[2], vi[3]);
        ori[1] = make_float4(vi[4], vi[5], vi[6], vi[7]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K13 and K14: streams over the pitched table, eight frequencies and K
// images a thread.
// ---------------------------------------------------------------------------

constexpr int G_NG = 8;     // warps per K13 block: row phases n = w mod 8
constexpr int G_PAIRS = 4;  // (slot, image) pairs a K13 thread sums
static_assert(G_NG == 2 * G_PAIRS, "K13's combine: warp w sums pair w / 2, "
                                   "half w % 2 of its eight frequencies");

// (acc + x y) + z w as two fmaf, in this order, whatever the kernel's
// shape: one complex product term of a sum (the caller signs z).
__device__ __forceinline__ float fma2(float acc, float x, float y, float z,
                                      float w) {
  return fmaf(z, w, fmaf(x, y, acc));
}

// ---------------------------------------------------------------------------
// K13. Block: (chunk of A = G_PAIRS / K slots, f tile of JT groups,
// (K-image group, slot block tb)). Warp w sums rows n = w mod G_NG; lane l
// owns group j0 + l of images p = (k0 + k) PT + pt, k < K.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(32 * G_NG, 2)
grp_fwd(const float* __restrict__ rre, const float* __restrict__ rim,
        const T* __restrict__ hre, const T* __restrict__ him,
        float* __restrict__ gre, float* __restrict__ gim, int PT, int TB,
        int Tp, int N, int F, int JT, int hp, int rp) {
  constexpr int A = G_PAIRS / K;
  __shared__ float part[G_NG][G_PAIRS * VEC][32];  // [warp][pair, f][lane]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.y * JT;
  const bool live = tx < min(JT, cdiv(F, VEC) - j0);
  const int f0 = (j0 + tx) * VEC;
  const int tt = Tp / TB, tb = blockIdx.z % TB, q = blockIdx.z / TB;
  const int pt = q % PT, k0 = (q / PT) * K;
  const int c0 = blockIdx.x * A, na = min(A, tt - c0);
  const int t0 = tb * tt + c0;  // first slot of the chunk
  float ar[A][K][VEC], ai[A][K][VEC];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) ar[a][k][v] = ai[a][k][v] = 0.f;

  if (live) {
    const long hs = (long)N * hp;  // slot stride of H
    const long xs = (long)PT * TB * N * rp;  // stride of k in r_s
    const T* h_r = hre + ((long)pt * Tp + t0) * hs + f0;
    const T* h_i = him + ((long)pt * Tp + t0) * hs + f0;
    const long x0 = ((long)(k0 * PT + pt) * TB + tb) * N * rp + f0;
    for (int n = ty; n < N; n += G_NG) {
      const long o = (long)n * hp;
      Row8<T> hr[A], hi[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a < na) {
          hr[a].load(h_r + a * hs + o);
          hi[a].load(h_i + a * hs + o);
        }
      }
      // Every image's row segment is loaded before the first product, so a
      // row step waits on one round of loads, not K.
      float vr[K][VEC], vi[K][VEC];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long xo = x0 + k * xs + (long)n * rp;
        ld8f(rre + xo, vr[k]);
        ld8f(rim + xo, vi[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (a < na) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float b = hr[a][v], c = hi[a][v];
              ar[a][k][v] = fma2(ar[a][k][v], vr[k][v], b, -vi[k][v], c);
              ai[a][k][v] = fma2(ai[a][k][v], vr[k][v], c, vi[k][v], b);
            }
          }
        }
      }
    }
  }
  // The G_NG row partials, added in warp order: re, then im. Warp w writes
  // pair w / 2 (slot a = pair / K, image k = pair % K), half w % 2.
  const int s = ty >> 1, kh = (ty & 1) * (VEC / 2);
  const int a = s / K, k = s % K;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int aa = 0; aa < A; ++aa)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          part[ty][(aa * K + kk) * VEC + v][tx] =
              c ? ai[aa][kk][v] : ar[aa][kk][v];
    __syncthreads();
    if (live && a < na) {
      const long p = (long)(k0 + k) * PT + pt;
      float* out = (c ? gim : gre) + (p * Tp + t0 + a) * F;
#pragma unroll
      for (int u = 0; u < VEC / 2; ++u) {
        const int v = kh + u;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < G_NG; ++w) sum += part[w][s * VEC + v][tx];
        if (f0 + v < F) out[f0 + v] = sum;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K14. Block: (f tile of JT groups, row tile of ST_NG * R rows, (K-image
// group, slot block tb)), R = ST_NR. Thread (lane l, warp w) owns rows
// n0 + w + ST_NG * j (j < R) of group j0 + l for images p = (k0 + k) PT +
// pt, and sums the slot block's tt slots in ascending t.
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(32 * ST_NG, K == 1 ? 3 : 2)
grp_t(const float* __restrict__ gre, const float* __restrict__ gim,
      const T* __restrict__ hre, const T* __restrict__ him,
      float* __restrict__ rre, float* __restrict__ rim, int PT, int TB,
      int Tp, int N, int F, int JT, int hp, int gp, int rp) {
  constexpr int R = ST_NR;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * JT;
  if (tx >= min(JT, cdiv(F, VEC) - j0)) return;  // no barrier below
  const int f0 = (j0 + tx) * VEC;
  const int n0 = blockIdx.y * (ST_NG * R) + ty;
  const int tt = Tp / TB, tb = blockIdx.z % TB, q = blockIdx.z / TB;
  const int pt = q % PT, k0 = (q / PT) * K;
  const long hs = (long)N * hp;
  const T* h_r = hre + ((long)pt * Tp + tb * tt) * hs + f0;
  const T* h_i = him + ((long)pt * Tp + tb * tt) * hs + f0;
  // gbar rows in their pitch, read by every warp of the block (L1).
  const long gs = (long)PT * Tp * gp;  // stride of k in gbar
  const long g0 = ((long)(k0 * PT + pt) * Tp + tb * tt) * gp + f0;
  float ar[K][R][VEC], ai[K][R][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) ar[k][j][v] = ai[k][j][v] = 0.f;

  for (int t = 0; t < tt; ++t) {
    Row8<T> hr[R], hi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = n0 + ST_NG * j;
      if (n < N) {
        hr[j].load(h_r + t * hs + (long)n * hp);
        hi[j].load(h_i + t * hs + (long)n * hp);
      }
    }
    float gr[K][VEC], gi[K][VEC];  // every image's, before any product
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ld8f(gre + g0 + k * gs + (long)t * gp, gr[k]);
      ld8f(gim + g0 + k * gs + (long)t * gp, gi[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (n0 + ST_NG * j < N) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float b = hr[j][v], c = hi[j][v];
            ar[k][j][v] = fma2(ar[k][j][v], gr[k][v], b, gi[k][v], c);
            ai[k][j][v] = fma2(ai[k][j][v], gi[k][v], b, -gr[k][v], c);
          }
        }
      }
    }
  }
  // 16-byte stores over the pitch, zeros past F.
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = n0 + ST_NG * j;
      if (n >= N) continue;
      const long p = (long)(k0 + k) * PT + pt;
      const long ro = ((p * TB + tb) * N + n) * rp + f0;
      float vr[VEC], vi[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        vr[v] = f0 + v < F ? ar[k][j][v] : 0.f;
        vi[v] = f0 + v < F ? ai[k][j][v] : 0.f;
      }
      float4* orr = reinterpret_cast<float4*>(rre + ro);
      float4* ori = reinterpret_cast<float4*>(rim + ro);
      orr[0] = make_float4(vr[0], vr[1], vr[2], vr[3]);
      orr[1] = make_float4(vr[4], vr[5], vr[6], vr[7]);
      ori[0] = make_float4(vi[0], vi[1], vi[2], vi[3]);
      ori[1] = make_float4(vi[4], vi[5], vi[6], vi[7]);
    }
  }
}

// K11/K12/K13/K14 f tile: cdiv(J, 32) tiles of equal width (J = cdiv(F, 8)
// groups), so the ragged edge is spread over the tiles' lanes, not a tile
// of its own.
int sel_tile(int F) {
  const int J = cdiv(F, VEC);
  return cdiv(J, cdiv(J, 32));
}

template <typename T, int K>
void launch_grp_fwd(const float* rre, const float* rim, const void* hre,
                    const void* him, float* gre, float* gim, int PB, int PT,
                    int TB, int Tp, int N, int F, int hp, int rp,
                    cudaStream_t s) {
  const int JT = sel_tile(F);
  const dim3 g(cdiv(Tp / TB, G_PAIRS / K), cdiv(cdiv(F, VEC), JT),
               TB * (PB / K));
  grp_fwd<T, K><<<g, dim3(32, G_NG), 0, s>>>(
      rre, rim, static_cast<const T*>(hre), static_cast<const T*>(him), gre,
      gim, PT, TB, Tp, N, F, JT, hp, rp);
}

template <typename T, int K>
void launch_grp_t(const float* gre, const float* gim, const void* hre,
                  const void* him, float* rre, float* rim, int PB, int PT,
                  int TB, int Tp, int N, int F, int hp, int gp, int rp,
                  cudaStream_t s) {
  const int JT = sel_tile(F);
  const dim3 g(cdiv(cdiv(F, VEC), JT), cdiv(N, ST_NG * ST_NR),
               TB * (PB / K));
  grp_t<T, K><<<g, dim3(32, ST_NG), 0, s>>>(
      gre, gim, static_cast<const T*>(hre), static_cast<const T*>(him), rre,
      rim, PT, TB, Tp, N, F, JT, hp, gp, rp);
}

template <typename T, typename... Args>
void grp_fwd_k(int K, Args... args) {
  if (K == 2) launch_grp_fwd<T, 2>(args...);
  else launch_grp_fwd<T, 1>(args...);
}

template <typename T, typename... Args>
void grp_t_k(int K, Args... args) {
  if (K == 2) launch_grp_t<T, 2>(args...);
  else launch_grp_t<T, 1>(args...);
}

}  // namespace

extern "C" {

int dip_sel_fwd(const float* rre, const float* rim, const void* hre,
                const void* him, const float* sel, float* gre, float* gim,
                int PB, int PT, int T_, int N, int F, int hp, int rp,
                int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int JT = sel_tile(F);
  const dim3 blk(32, S_NG);
  const dim3 g(cdiv(cdiv(F, VEC), JT), cdiv(T_, S_TC), PB);
  if (bf16) {
    using T = __nv_bfloat16;
    sel_fwd<T><<<g, blk, 0, s>>>(rre, rim, static_cast<const T*>(hre),
                                 static_cast<const T*>(him), sel, gre, gim, PT,
                                 T_, N, F, JT, hp, rp);
  } else {
    sel_fwd<float><<<g, blk, 0, s>>>(rre, rim, static_cast<const float*>(hre),
                                     static_cast<const float*>(him), sel, gre,
                                     gim, PT, T_, N, F, JT, hp, rp);
  }
  return static_cast<int>(cudaGetLastError());
}

int dip_sel_t(const float* gre, const float* gim, const void* hre,
              const void* him, const float* sel, float* rre, float* rim,
              int PB, int PT, int T_, int N, int F, int hp, int gp, int rp,
              int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int JT = sel_tile(F);
  const dim3 blk_t(32, ST_NG);
  const dim3 g(cdiv(cdiv(F, VEC), JT), cdiv(N, ST_NG * ST_NR), PB);
  if (bf16) {
    using T = __nv_bfloat16;
    sel_t<T><<<g, blk_t, 0, s>>>(gre, gim, static_cast<const T*>(hre),
                                 static_cast<const T*>(him), sel, rre, rim,
                                 PT, T_, N, F, JT, hp, gp, rp);
  } else {
    sel_t<float><<<g, blk_t, 0, s>>>(
        gre, gim, static_cast<const float*>(hre),
        static_cast<const float*>(him), sel, rre, rim, PT, T_, N, F, JT, hp,
        gp, rp);
  }
  return static_cast<int>(cudaGetLastError());
}

int dip_grp_fwd(const float* rre, const float* rim, const void* hre,
                const void* him, float* gre, float* gim, int PB, int PT,
                int TB, int Tp, int N, int F, int hp, int rp, int K, int bf16,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((K != 1 && K != 2) || (PB / PT) % K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    grp_fwd_k<__nv_bfloat16>(K, rre, rim, hre, him, gre, gim, PB, PT, TB, Tp,
                             N, F, hp, rp, s);
  else
    grp_fwd_k<float>(K, rre, rim, hre, him, gre, gim, PB, PT, TB, Tp, N, F,
                     hp, rp, s);
  return static_cast<int>(cudaGetLastError());
}

int dip_grp_t(const float* gre, const float* gim, const void* hre,
              const void* him, float* rre, float* rim, int PB, int PT, int TB,
              int Tp, int N, int F, int hp, int gp, int rp, int K, int bf16,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((K != 1 && K != 2) || (PB / PT) % K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    grp_t_k<__nv_bfloat16>(K, gre, gim, hre, him, rre, rim, PB, PT, TB, Tp, N,
                           F, hp, gp, rp, s);
  else
    grp_t_k<float>(K, gre, gim, hre, him, rre, rim, PB, PT, TB, Tp, N, F, hp,
                   gp, rp, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
