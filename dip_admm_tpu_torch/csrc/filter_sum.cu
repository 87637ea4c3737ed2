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
// bound of ~1 ms. At the fan 256^2/8 shapes of K13/K14 H is one table set of
// ~12.6 MB per plane in bf16, read by 8 images, so it sits in the 50 MB L2
// after the first image; r_s (f32, [PB, TB, N, F]) is read from HBM once per
// angle chunk in K13, and written once in K14.
//
// Design, simple and deterministic (no atomics, two calls agree bit for
// bit): the TPU grid's sequential accumulation axis becomes a loop inside
// the block that owns the output.
// - K11/K13: one block per (image p, chunk of TC angles, FT frequency
//   columns). Its NG warps split the row loop (warp w takes rows
//   n = w mod NG), each thread keeps TC complex sums in registers, and the
//   NG partial sums are added in a fixed order through shared memory. K11
//   reads only the planes its chunk's angles select (one, except where a
//   chunk straddles the branch switch), where the TPU kernel reads both and
//   blends them by sel.
// - K12: one block per (image p, NG*NR row tile, FT frequency columns).
//   Each thread owns NR rows of one column in both planes and loops over
//   all T angles in order, adding each angle's term to the plane it
//   selects (sel is uniform over the block, so no divergence); a plane
//   that no angle selects is written as zeros.
// - K14: one block per (image p, slot block, NG*NR row tile, FT frequency
//   columns). Each thread owns NR rows of one column and sums the block's
//   tt slots in order: a pure map, each output element written once.
// Warps read FT consecutive frequencies (coalesced). No tile needs to divide
// N, F or T: the ragged edge is masked, so the JAX package's _tiles and
// _grp_tn have no counterpart. Tensor cores, vector loads and walking the
// images inside one block (one H read for all of them) are later work.
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
// K11. Block: (f tile, angle chunk c, image p).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(FT * NG)
sel_fwd(const float* __restrict__ rre, const float* __restrict__ rim,
        const T* __restrict__ hre, const T* __restrict__ him,
        const float* __restrict__ sel, float* __restrict__ gre,
        float* __restrict__ gim, int PT, int T_, int N, int F) {
  __shared__ float sr[NG][TC][FT];
  __shared__ float si[NG][TC][FT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * FT + tx;
  const int t0 = blockIdx.y * TC, nt = min(TC, T_ - t0);
  const int p = blockIdx.z, pt = p % PT;
  const long NF = (long)N * F;
  // Bit i set: angle t0 + i reads plane 1.
  unsigned one = 0;
  for (int i = 0; i < nt; ++i)
    if (sel[(long)pt * T_ + t0 + i] > 0.5f) one |= 1u << i;
  const bool need0 = one != (1u << nt) - 1u, need1 = one != 0u;
  float ar[TC], ai[TC];
#pragma unroll
  for (int i = 0; i < TC; ++i) ar[i] = ai[i] = 0.f;

  if (f < F) {
    const float* x0r = rre + (long)p * 2 * NF + f;
    const float* x0i = rim + (long)p * 2 * NF + f;
    const T* h_r = hre + ((long)pt * T_ + t0) * NF + f;
    const T* h_i = him + ((long)pt * T_ + t0) * NF + f;
    for (int n = ty; n < N; n += NG) {
      const long o = (long)n * F;
      float v0r = 0.f, v0i = 0.f, v1r = 0.f, v1i = 0.f;
      if (need0) {
        v0r = x0r[o];
        v0i = x0i[o];
      }
      if (need1) {
        v1r = x0r[NF + o];
        v1i = x0i[NF + o];
      }
#pragma unroll
      for (int i = 0; i < TC; ++i) {
        if (i < nt) {
          const bool s1 = (one >> i) & 1u;
          const float vr = s1 ? v1r : v0r, vi = s1 ? v1i : v0i;
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
  const int i = ty;  // this thread's output angle of the chunk
  if (f >= F || i >= nt) return;
  float vr = 0.f, vi = 0.f;
  for (int g = 0; g < NG; ++g) {
    vr += sr[g][i][tx];
    vi += si[g][i][tx];
  }
  const long go = ((long)p * T_ + t0 + i) * F + f;
  gre[go] = vr;
  gim[go] = vi;
}

// ---------------------------------------------------------------------------
// K12. Block: (f tile, row tile, image p).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(FT * NG)
sel_t(const float* __restrict__ gre, const float* __restrict__ gim,
      const T* __restrict__ hre, const T* __restrict__ him,
      const float* __restrict__ sel, float* __restrict__ rre,
      float* __restrict__ rim, int PT, int T_, int N, int F) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * FT + tx, n0 = blockIdx.y * (NG * NR) + ty;
  const int p = blockIdx.z, pt = p % PT;
  if (f >= F) return;
  const long NF = (long)N * F;
  const float* g_r = gre + (long)p * T_ * F + f;
  const float* g_i = gim + (long)p * T_ * F + f;
  const float* s = sel + (long)pt * T_;
  const T* h_r = hre + (long)pt * T_ * NF + f;
  const T* h_i = him + (long)pt * T_ * NF + f;
  float a0r[NR], a0i[NR], a1r[NR], a1i[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) a0r[j] = a0i[j] = a1r[j] = a1i[j] = 0.f;

  for (int t = 0; t < T_; ++t) {
    const float gr = g_r[(long)t * F], gi = g_i[(long)t * F];
    const bool s1 = s[t] > 0.5f;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int n = n0 + NG * j;
      if (n < N) {
        const long o = t * NF + (long)n * F;
        const float hr = ld<T>(h_r, o), hi = ld<T>(h_i, o);
        const float cr = gr * hr + gi * hi, ci = gi * hr - gr * hi;
        if (s1) {
          a1r[j] += cr;
          a1i[j] += ci;
        } else {
          a0r[j] += cr;
          a0i[j] += ci;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int n = n0 + NG * j;
    if (n < N) {
      const long ro = (long)p * 2 * NF + (long)n * F + f;
      rre[ro] = a0r[j];
      rim[ro] = a0i[j];
      rre[ro + NF] = a1r[j];
      rim[ro + NF] = a1i[j];
    }
  }
}

}  // namespace

extern "C" {

int dip_sel_fwd(const float* rre, const float* rim, const void* hre,
                const void* him, const float* sel, float* gre, float* gim,
                int PB, int PT, int T_, int N, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blk(FT, NG);
  const dim3 g(cdiv(F, FT), cdiv(T_, TC), PB);
  if (bf16) {
    using T = __nv_bfloat16;
    sel_fwd<T><<<g, blk, 0, s>>>(rre, rim, static_cast<const T*>(hre),
                                 static_cast<const T*>(him), sel, gre, gim, PT,
                                 T_, N, F);
  } else {
    sel_fwd<float><<<g, blk, 0, s>>>(rre, rim, static_cast<const float*>(hre),
                                     static_cast<const float*>(him), sel, gre,
                                     gim, PT, T_, N, F);
  }
  return static_cast<int>(cudaGetLastError());
}

int dip_sel_t(const float* gre, const float* gim, const void* hre,
              const void* him, const float* sel, float* rre, float* rim,
              int PB, int PT, int T_, int N, int F, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blk(FT, NG);
  const dim3 g(cdiv(F, FT), cdiv(N, NG * NR), PB);
  if (bf16) {
    using T = __nv_bfloat16;
    sel_t<T><<<g, blk, 0, s>>>(gre, gim, static_cast<const T*>(hre),
                               static_cast<const T*>(him), sel, rre, rim, PT,
                               T_, N, F);
  } else {
    sel_t<float><<<g, blk, 0, s>>>(gre, gim, static_cast<const float*>(hre),
                                   static_cast<const float*>(him), sel, rre,
                                   rim, PT, T_, N, F);
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
