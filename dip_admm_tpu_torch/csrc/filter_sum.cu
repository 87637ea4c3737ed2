// Hopper (sm_90a) kernels of the fft_grouped projector: the branch-grouped
// filter-sum of dip_admm_tpu/ops/pallas/filter_sum.py, written again for
// CUDA.
//
//   K13 dip_grp_fwd <- filter_sum_grouped   (_fwd_grp_pallas, _fwd_grp_kernel)
//   K14 dip_grp_t   <- filter_sum_grouped_t (_t_grp_pallas, _t_grp_kernel)
//
// K13: g[p,t,f] = sum_n r_s[p,blk(t),n,f] * H[p%PT,t,n,f]
// K14: rbar_s[p,b,n,f] = sum_{t in block b} conj(H[p%PT,t,n,f]) * gbar[p,t,f]
// as complex products carried in re/im planes. r_s, g and their cotangents
// are f32; H is f32 or bf16, upcast on load; accumulation is f32. The image
// batch PB is a multiple of the table batch PT and image p reads table set
// p % PT (the JAX kernels' vmap rule): the fan-beam path runs its PB = P
// node images against one shared table set.
//
// What bounds them on an H100: reading H. A block does 8 FLOPs per H element
// pair it loads (4 B in bf16), far below the card's ratio of compute to
// bandwidth. At the fan 256^2/8 shapes H is one table set of ~12.6 MB per
// plane in bf16, read by 8 images, so it sits in the 50 MB L2 after the
// first image; r_s (f32, [PB, TB, N, F]) is read from HBM once per angle
// chunk in K13, and written once in K14.
//
// Design, simple and deterministic (no atomics, two calls agree bit for
// bit): the TPU grid's sequential accumulation axis becomes a loop inside
// the block that owns the output.
// - K13: one block per (image p, chunk of TC slots of one slot block, FT
//   frequency columns). Its NG warps split the row loop (warp w takes rows
//   n = w mod NG), each thread keeps TC complex sums in registers, and the
//   NG partial sums are added in a fixed order through shared memory.
// - K14: one block per (image p, slot block, NG*NR row tile, FT frequency
//   columns). Each thread owns NR rows of one column and sums the block's
//   tt slots in order: a pure map, each output element written once.
// Warps read FT consecutive frequencies (coalesced). Neither tile needs to
// divide N or F: the ragged edge is masked, so the JAX package's _grp_tn
// has no counterpart. Tensor cores, vector loads and walking the images
// inside one block (one H read for all of them) are later work.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;  // frequency columns per block (one per lane)
constexpr int NG = 8;   // warps per block (row groups)
constexpr int TC = 8;   // slots per K13 block
constexpr int NR = 4;   // rows per K14 thread: row tile NG * NR
static_assert(NG == TC, "K13 sums slot i = threadIdx.y over the row groups");

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

}  // namespace

extern "C" {

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
