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
// What bounds them on an H100: reading H. A block does 8 FLOPs per H element
// pair it loads (4 B in bf16), far below the card's ratio of compute to
// bandwidth. At the parallel 512^2/8 shapes of K11/K12 H is 1.6 GB per plane
// in bf16, each table set read by one image: 3.2 GB from HBM per call, a
// bound of ~1 ms (a kernel that only streams those bytes in 16-byte loads
// and sums them takes 1.00-1.04 ms of device time on an H100 80GB HBM3 at
// 700 W, scripts/torch_filter_stream.py). At the fan 256^2/8 shapes of
// K13/K14 H is one table set of ~12.6 MB per plane in bf16, read by 8
// images, so it sits in the 50 MB L2 after the first image; r_s (f32, [PB,
// TB, N, F]) is read from HBM once per angle chunk in K13, and written once
// in K14.
//
// Design, simple and deterministic (no atomics, two calls agree bit for
// bit): the TPU grid's sequential accumulation axis becomes a loop inside
// the block that owns the output.
// - K11/K12 stream H as 16-byte loads: each thread owns 8 consecutive
//   frequencies and reads them from a table row with one load (two in
//   f32). That needs rows on 16 bytes: the fft_pallas tables are stored
//   with a row pitch padded with zeros to a multiple of 8 elements (1032 at
//   F = 1025), and so are the spectra r (K11's input, from row-DFT columns
//   of that pitch) and the cotangents gbar (K12's input, from irfft rows of
//   that padded F). With two-byte loads and an odd pitch the same sums ran
//   at 34% of the bound; K12 reading a dense gbar with scalar loads was
//   ~12% slower, and its first form, staging gbar through shared memory
//   behind block barriers, slower than that. The f tiles split the F / 8
//   groups evenly (at F = 1025: five tiles of 26 groups), so the ragged
//   edge is a few idle lanes in every tile, not a tile of its own; K11
//   with its threads over (group, row phase) instead, 91% of them live in
//   place of 81%, took 1.3% more device time (scripts/torch_filter_stream.py),
//   so the idle lanes are not what holds K11 below the stream ceiling.
//   Tensor cores do not help: each H element is used once.
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
// - K13/K14 keep the layout of their tables (dense F):
// - K13: one block per (image p, chunk of TC angles, FT frequency
//   columns), its NG warps splitting the row loop as K11's do, one
//   frequency per lane, the NG partial sums added in a fixed order through
//   shared memory.
// - K14: one block per (image p, slot block, NG*NR row tile, FT frequency
//   columns). Each thread owns NR rows of one column and sums the block's
//   tt slots in order: a pure map, each output element written once.
// Warps read consecutive frequencies (coalesced). No tile needs to divide
// N, F or T: the ragged edge is masked, so the JAX package's _tiles and
// _grp_tn have no counterpart. Walking the images inside one K13/K14 block
// (one H read for all of them) and the pitch for K13/K14 are later work.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;  // frequency columns per block (one per lane)
constexpr int NG = 8;   // warps per block (row groups)
constexpr int TC = 8;   // angles (slots) per K11/K13 block
constexpr int NR = 4;   // rows per K12/K14 thread: row tile NG * NR
static_assert(NG == TC, "K11/K13: warp i sums angle i of the chunk");

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

// ---------------------------------------------------------------------------
// K13. Block: (f tile, (slot block tb, slot chunk c), image p).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(FT * NG)
grp_fwd(const float* __restrict__ rre, const float* __restrict__ rim,
        const T* __restrict__ hre, const T* __restrict__ him,
        float* __restrict__ gre, float* __restrict__ gim, int PT, int TB,
        int Tp, int N, int F) {
  __shared__ float sr[NG][TC][FT];
  __shared__ float si[NG][TC][FT];
  const int tt = Tp / TB, nchunk = cdiv(tt, TC);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * FT + tx;
  const int tb = blockIdx.y / nchunk, c = blockIdx.y % nchunk;
  const int p = blockIdx.z, pt = p % PT;
  const int t0 = tb * tt + c * TC;          // first slot of the chunk
  const int nt = min(TC, tt - c * TC);      // slots in the chunk
  const long NF = (long)N * F;
  float ar[TC], ai[TC];
#pragma unroll
  for (int i = 0; i < TC; ++i) ar[i] = ai[i] = 0.f;

  if (f < F) {
    const float* xr = rre + (long)(p * TB + tb) * NF + f;
    const float* xi = rim + (long)(p * TB + tb) * NF + f;
    const T* h_r = hre + ((long)pt * Tp + t0) * NF + f;
    const T* h_i = him + ((long)pt * Tp + t0) * NF + f;
    for (int n = ty; n < N; n += NG) {
      const long o = (long)n * F;
      const float vr = xr[o], vi = xi[o];
#pragma unroll
      for (int i = 0; i < TC; ++i) {
        if (i < nt) {
          const float hr = ld<T>(h_r, i * NF + o), hi = ld<T>(h_i, i * NF + o);
          ar[i] += vr * hr - vi * hi;
          ai[i] += vr * hi + vi * hr;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    sr[ty][i][tx] = ar[i];
    si[ty][i][tx] = ai[i];
  }
  __syncthreads();
  const int i = ty;  // this thread's output slot of the chunk
  if (f >= F || i >= nt) return;
  float vr = 0.f, vi = 0.f;
  for (int g = 0; g < NG; ++g) {
    vr += sr[g][i][tx];
    vi += si[g][i][tx];
  }
  const long go = ((long)p * Tp + t0 + i) * F + f;
  gre[go] = vr;
  gim[go] = vi;
}

// ---------------------------------------------------------------------------
// K14. Block: (f tile, row tile, (image p, slot block tb)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(FT * NG)
grp_t(const float* __restrict__ gre, const float* __restrict__ gim,
      const T* __restrict__ hre, const T* __restrict__ him,
      float* __restrict__ rre, float* __restrict__ rim, int PT, int TB,
      int Tp, int N, int F) {
  const int tt = Tp / TB;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * FT + tx, n0 = blockIdx.y * (NG * NR) + ty;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  if (f >= F) return;
  const long NF = (long)N * F;
  const float* g_r = gre + ((long)p * Tp + tb * tt) * F + f;
  const float* g_i = gim + ((long)p * Tp + tb * tt) * F + f;
  const T* h_r = hre + ((long)pt * Tp + tb * tt) * NF + f;
  const T* h_i = him + ((long)pt * Tp + tb * tt) * NF + f;
  float ar[NR], ai[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) ar[j] = ai[j] = 0.f;

  for (int t = 0; t < tt; ++t) {
    const float gr = g_r[(long)t * F], gi = g_i[(long)t * F];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int n = n0 + NG * j;
      if (n < N) {
        const long o = t * NF + (long)n * F;
        const float hr = ld<T>(h_r, o), hi = ld<T>(h_i, o);
        ar[j] += gr * hr + gi * hi;
        ai[j] += gi * hr - gr * hi;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int n = n0 + NG * j;
    if (n < N) {
      const long ro = ((long)(p * TB + tb) * N + n) * F + f;
      rre[ro] = ar[j];
      rim[ro] = ai[j];
    }
  }
}

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

}  // namespace

extern "C" {

// K11/K12 grid: cdiv(J, 32) f tiles of equal width (J = cdiv(F, 8) groups),
// so the ragged edge is spread over the tiles' lanes, not a tile of its own.
static int sel_tile(int F) {
  const int J = cdiv(F, VEC);
  return cdiv(J, cdiv(J, 32));
}

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
                int TB, int Tp, int N, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blk(FT, NG);
  const dim3 g(cdiv(F, FT), TB * cdiv(Tp / TB, TC), PB);
  if (bf16) {
    using T = __nv_bfloat16;
    grp_fwd<T><<<g, blk, 0, s>>>(rre, rim, static_cast<const T*>(hre),
                                 static_cast<const T*>(him), gre, gim, PT, TB,
                                 Tp, N, F);
  } else {
    grp_fwd<float><<<g, blk, 0, s>>>(rre, rim, static_cast<const float*>(hre),
                                     static_cast<const float*>(him), gre, gim,
                                     PT, TB, Tp, N, F);
  }
  return static_cast<int>(cudaGetLastError());
}

int dip_grp_t(const float* gre, const float* gim, const void* hre,
              const void* him, float* rre, float* rim, int PB, int PT, int TB,
              int Tp, int N, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blk(FT, NG);
  const dim3 g(cdiv(F, FT), cdiv(N, NG * NR), PB * TB);
  if (bf16) {
    using T = __nv_bfloat16;
    grp_t<T><<<g, blk, 0, s>>>(gre, gim, static_cast<const T*>(hre),
                               static_cast<const T*>(him), rre, rim, PT, TB,
                               Tp, N, F);
  } else {
    grp_t<float><<<g, blk, 0, s>>>(gre, gim, static_cast<const float*>(hre),
                                   static_cast<const float*>(him), rre, rim,
                                   PT, TB, Tp, N, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
