// Hopper (sm_90a) kernels of the fft_mxu projector: the filter-sum of
// dip_admm_tpu/ops/pallas/filter_mxu.py and its transpose, written again for
// CUDA.
//
//   K15 dip_mxu_fwd <- filter_sum_mxu   (_fwd_pallas, _fwd_kernel)
//   K16 dip_mxu_t   <- filter_sum_mxu_t (_adj_pallas, _adj_kernel)
//
// K15: g[p,t,f] = sum_n r_s[p,blk(t),n,f] * H[p%PT,t,n,f]
// K16: rbar_s[p,b,n,f] = sum_{t in block b} conj(H[p%PT,t,n,f]) * gbar[p,t,f]
// as complex products carried in re/im planes, on the table in its tiled
// layout H_t[pt, f/128, n/tn, t, (n%tn)*128 + f%128] (tn rows of one
// 128-frequency tile contiguous), read in place. The spectra r_s
// [PB, TB, N, Fpad], g and their cotangents are f32; H is f32 or bf16,
// upcast on load. As in the TPU kernels, K15 rounds r_s to the table type
// before the product (the TPU kernel casts its eye-expanded spectra to the
// table dtype for the MXU) and K16 stays f32. Accumulation is f32. The image
// batch PB is a multiple of the table batch PT; image p reads table set
// p % PT. Padded frequencies (F..Fpad) and slack slots hold zero table
// entries and come out zero.
//
// What bounds them on an H100: reading H, 8 FLOPs per complex H element
// (4 B in bf16). At 256^2/8 the bf16 pair is 0.50 GB, a bound of ~0.16 ms.
// The TPU kernel's eye-expanded right-hand side (128x the useful FLOPs, a
// device of the MXU) has no counterpart: these compute the contraction.
//
// Design, simple and deterministic (no atomics, two calls agree bit for
// bit): each thread owns 8 consecutive frequencies of a 128-frequency tile
// and reads them with 16-byte loads (one per bf16 table row, two per f32
// row); 16 threads cover the tile.
// - K15: one block per (image p, chunk of TC slots of one slot block, f
//   tile). Its NG thread rows split the row loop (row n goes to thread row
//   n mod NG), each thread keeps TC x 8 complex sums in registers, and the
//   NG partial sums are added in a fixed order through shared memory.
// - K16: one block per (image p, slot block, NG*NR row tile, f tile). Each
//   thread owns NR rows x 8 frequencies and sums the block's slots in order:
//   a pure map, each output element written once.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FW = 128;          // frequencies per tile (the table's layout)
constexpr int VEC = 8;           // frequencies per thread
constexpr int LANES = FW / VEC;  // threads along a tile
constexpr int NG = 8;            // thread rows
constexpr int TC = 4;            // slots per K15 block
constexpr int NR = 4;            // rows per K16 thread: row tile NG * NR
static_assert(LANES * NG == FW, "K15's reduction: one thread per frequency");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Eight consecutive values as f32 (16-byte aligned).
template <typename T> __device__ __forceinline__ void ld8(const T* p, float* v);
template <>
__device__ __forceinline__ void ld8<float>(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void ld8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                   float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void st8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Round an f32 value to the table type's precision (identity for f32).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// K15. Block: (f tile fb, (slot block tb, slot chunk c), image p).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(LANES * NG)
mxu_fwd(const float* __restrict__ rre, const float* __restrict__ rim,
        const T* __restrict__ hre, const T* __restrict__ him,
        float* __restrict__ gre, float* __restrict__ gim, int PT, int TB,
        int Tp, int N, int tn, int FB) {
  __shared__ float sr[NG][TC][FW];
  __shared__ float si[NG][TC][FW];
  const int tt = Tp / TB, nchunk = cdiv(tt, TC);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int fb = blockIdx.x, tb = blockIdx.y / nchunk, c = blockIdx.y % nchunk;
  const int p = blockIdx.z, pt = p % PT;
  const int t0 = tb * tt + c * TC;      // first slot of the chunk
  const int nt = min(TC, tt - c * TC);  // slots in the chunk
  const int Fpad = FB * FW, L = tn * FW, NBt = N / tn;
  float ar[TC][VEC], ai[TC][VEC];
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ar[i][e] = ai[i][e] = 0.f;

  const long xo = (long)(p * TB + tb) * N * Fpad + fb * FW + tx * VEC;
  const long hb = ((long)pt * FB + fb) * NBt * Tp * L + tx * VEC;
  for (int n = ty; n < N; n += NG) {
    float vr[VEC], vi[VEC];
    ld8<float>(rre + xo + (long)n * Fpad, vr);
    ld8<float>(rim + xo + (long)n * Fpad, vi);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      vr[e] = rnd<T>(vr[e]);
      vi[e] = rnd<T>(vi[e]);
    }
    const long ho = hb + ((long)(n / tn) * Tp + t0) * L + (n % tn) * FW;
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (i < nt) {
        float hr[VEC], hi[VEC];
        ld8<T>(hre + ho + (long)i * L, hr);
        ld8<T>(him + ho + (long)i * L, hi);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ar[i][e] += vr[e] * hr[e] - vi[e] * hi[e];
          ai[i][e] += vr[e] * hi[e] + vi[e] * hr[e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sr[ty][i][tx * VEC + e] = ar[i][e];
      si[ty][i][tx * VEC + e] = ai[i][e];
    }
  __syncthreads();
  const int fl = ty * LANES + tx;  // this thread's frequency of the tile
  for (int i = 0; i < nt; ++i) {
    float vr = 0.f, vi = 0.f;
    for (int g = 0; g < NG; ++g) {
      vr += sr[g][i][fl];
      vi += si[g][i][fl];
    }
    const long go = ((long)p * Tp + t0 + i) * Fpad + fb * FW + fl;
    gre[go] = vr;
    gim[go] = vi;
  }
}

// ---------------------------------------------------------------------------
// K16. Block: (f tile fb, row tile, (image p, slot block tb)).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(LANES * NG)
mxu_t(const float* __restrict__ gre, const float* __restrict__ gim,
      const T* __restrict__ hre, const T* __restrict__ him,
      float* __restrict__ rre, float* __restrict__ rim, int PT, int TB,
      int Tp, int N, int tn, int FB) {
  const int tt = Tp / TB;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int fb = blockIdx.x, n0 = blockIdx.y * (NG * NR) + ty;
  const int tb = blockIdx.z % TB, p = blockIdx.z / TB, pt = p % PT;
  const int Fpad = FB * FW, L = tn * FW, NBt = N / tn;
  float ar[NR][VEC], ai[NR][VEC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ar[r][e] = ai[r][e] = 0.f;

  const long go = ((long)p * Tp + tb * tt) * Fpad + fb * FW + tx * VEC;
  const long hb = (((long)pt * FB + fb) * NBt * Tp + tb * tt) * L + tx * VEC;
  for (int t = 0; t < tt; ++t) {
    float gr[VEC], gi[VEC];
    ld8<float>(gre + go + (long)t * Fpad, gr);
    ld8<float>(gim + go + (long)t * Fpad, gi);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int n = n0 + NG * r;
      if (n < N) {
        const long o = hb + ((long)(n / tn) * Tp + t) * L + (n % tn) * FW;
        float hr[VEC], hi[VEC];
        ld8<T>(hre + o, hr);
        ld8<T>(him + o, hi);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ar[r][e] += hr[e] * gr[e] + hi[e] * gi[e];
          ai[r][e] += hr[e] * gi[e] - hi[e] * gr[e];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = n0 + NG * r;
    if (n < N) {
      const long ro = ((long)(p * TB + tb) * N + n) * Fpad + fb * FW + tx * VEC;
      st8(rre + ro, ar[r]);
      st8(rim + ro, ai[r]);
    }
  }
}

template <typename T>
cudaError_t launch_mxu(bool fwd, const float* a_re, const float* a_im,
                       const void* hre, const void* him, float* o_re,
                       float* o_im, int PB, int PT, int TB, int Tp, int N,
                       int tn, int FB, cudaStream_t s) {
  const dim3 blk(LANES, NG);
  const T* h_r = static_cast<const T*>(hre);
  const T* h_i = static_cast<const T*>(him);
  if (fwd) {
    const dim3 g(FB, TB * cdiv(Tp / TB, TC), PB);
    mxu_fwd<T><<<g, blk, 0, s>>>(a_re, a_im, h_r, h_i, o_re, o_im, PT, TB, Tp,
                                 N, tn, FB);
  } else {
    const dim3 g(FB, cdiv(N, NG * NR), PB * TB);
    mxu_t<T><<<g, blk, 0, s>>>(a_re, a_im, h_r, h_i, o_re, o_im, PT, TB, Tp,
                               N, tn, FB);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dip_mxu_fwd(const float* rre, const float* rim, const void* hre,
                const void* him, float* gre, float* gim, int PB, int PT,
                int TB, int Tp, int N, int tn, int FB, int bf16,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_mxu<__nv_bfloat16>(true, rre, rim, hre, him, gre, gim, PB,
                                       PT, TB, Tp, N, tn, FB, s)
           : launch_mxu<float>(true, rre, rim, hre, him, gre, gim, PB, PT, TB,
                               Tp, N, tn, FB, s));
}

int dip_mxu_t(const float* gre, const float* gim, const void* hre,
              const void* him, float* rre, float* rim, int PB, int PT, int TB,
              int Tp, int N, int tn, int FB, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_mxu<__nv_bfloat16>(false, gre, gim, hre, him, rre, rim, PB,
                                       PT, TB, Tp, N, tn, FB, s)
           : launch_mxu<float>(false, gre, gim, hre, him, rre, rim, PB, PT, TB,
                               Tp, N, tn, FB, s));
}

}  // extern "C"
