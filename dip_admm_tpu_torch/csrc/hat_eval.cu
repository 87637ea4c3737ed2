// Hopper (sm_90a) kernels of the projector's hat-evaluation tail: the Pallas
// kernels of dip_admm_tpu/ops/pallas/hat_eval.py, written again for CUDA.
//
//   K17 dip_hat_fwd <- hat_eval   (_fwd_pallas, _fwd_kernel)
//   K18 dip_hat_t   <- hat_eval_t (_t_pallas, _t_kernel)
//
// With the 2-tap hat w(x) = max(0, 1 - |x|):
// K17: out[p,t,d]  = s[q,t] * sum_v w(pc[q,t,d] - v) * g[p,t,v]
// K18: gbar[p,t,v] = sum_d w(pc[q,t,d] - v) * (s[q,t] * ob[p,t,d])
// with q = p % PT: the image batch PB is a multiple of the geometry batch PT
// (the JAX kernels' vmap rule). Everything is f32. The scale multiplies
// where the TPU kernels put it: after the sum in K17, before it in K18.
//
// What bounds them on an H100: bytes, and few of them. Per output a handful
// of FLOPs; at the parallel 512^2/8 shapes (PB = PT = 8, T = 192, D = 512,
// Np = 2048) g and gbar are 12.6 MB and pc, ob and out 3.1 MB each, a bound
// of a few microseconds. The TPU kernels rebuild w from iota arithmetic over
// whole v (or d) tiles and reduce it, 4*Np FLOPs per output, because the
// vector unit has no gather; here each output reads only what carries
// weight.
//
// Design, deterministic (no atomics, two calls agree bit for bit):
// - K17: one thread per (p, t, d). Only v = floor(pc) and floor(pc) + 1 can
//   carry weight; each weight is computed as the TPU kernel computes it
//   (1 - |pc - v| in f32) and every other term of its sum is an exact zero.
//   Taps outside [0, Np) contribute nothing.
// - K18: one block per (p, t) row, which stages pc and s*ob of the row in
//   shared memory; one thread per v sums the detectors d with
//   |pc - v| < 1 in ascending d. The evaluation coordinates of the
//   projectors are monotone in d (an affine detector grid, or the fan
//   rebin's sorted one), so the block checks that its row is monotone and
//   then bounds each thread's scan by two binary searches; a row that is not
//   monotone is scanned whole. Both forms add the same nonzero terms in the
//   same order, so they agree bit for bit.
//
// C interface for ctypes: pointers and the stream as void*, sizes as int.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float hat(float x, float v) {
  return fmaxf(0.f, 1.f - fabsf(x - v));
}

// ---------------------------------------------------------------------------
// K17. One thread per (p, t, d).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
hat_fwd(const float* __restrict__ g, const float* __restrict__ pc,
        const float* __restrict__ s, float* __restrict__ out, int PB, int PT,
        int T, int D, int Np) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long)PB * T * D) return;
  const int d = (int)(i % D);
  const long pt_row = i / D;  // p * T + t
  const int t = (int)(pt_row % T), p = (int)(pt_row / T);
  const long q_row = (long)(p % PT) * T + t;
  const float x = pc[q_row * D + d];
  const float* gr = g + pt_row * Np;
  const float fl = floorf(x);
  float acc = 0.f;
  if (fl >= -1.f && fl < (float)Np) {  // false for NaN too
    const int v0 = (int)fl;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = v0 + k;
      if (v >= 0 && v < Np) acc += hat(x, (float)v) * gr[v];
    }
  }
  out[i] = s[q_row] * acc;
}

// ---------------------------------------------------------------------------
// K18. One block per (p, t) row; dynamic shared memory: pc and s*ob [2, D].
// ---------------------------------------------------------------------------
// First index d in [0, D) at which pred(x[d]) holds, for a pred that is false
// on a prefix of x and true after it.
template <typename Pred>
__device__ __forceinline__ int first_true(const float* x, int D, Pred pred) {
  int lo = 0, hi = D;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(x[mid])) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(NT)
hat_t(const float* __restrict__ ob, const float* __restrict__ pc,
      const float* __restrict__ s, float* __restrict__ gbar, int PT, int T,
      int D, int Np) {
  extern __shared__ float sh[];
  float* xs = sh;       // pc of the row
  float* ys = sh + D;   // s * ob of the row
  const long row = blockIdx.x;  // p * T + t
  const int t = (int)(row % T), p = (int)(row / T);
  const long q_row = (long)(p % PT) * T + t;
  const float sc = s[q_row];
  bool up = true, down = true;  // this thread's pairs are nondecreasing / ...
  for (int d = threadIdx.x; d < D; d += NT) {
    xs[d] = pc[q_row * D + d];
    ys[d] = sc * ob[row * D + d];
  }
  __syncthreads();
  for (int d = threadIdx.x; d + 1 < D; d += NT) {
    up = up && !(xs[d + 1] < xs[d]);
    down = down && !(xs[d + 1] > xs[d]);
  }
  const bool rising = __syncthreads_and(up);
  const bool falling = !rising && __syncthreads_and(down);

  for (int v = threadIdx.x; v < Np; v += NT) {
    const float fv = (float)v;
    int lo = 0, hi = D;
    if (rising) {  // terms where fv - 1 < pc < fv + 1
      lo = first_true(xs, D, [=](float x) { return x > fv - 1.f; });
      hi = first_true(xs, D, [=](float x) { return x >= fv + 1.f; });
    } else if (falling) {
      lo = first_true(xs, D, [=](float x) { return x < fv + 1.f; });
      hi = first_true(xs, D, [=](float x) { return x <= fv - 1.f; });
    }
    float acc = 0.f;
    for (int d = lo; d < hi; ++d) {
      const float w = hat(xs[d], fv);
      if (w > 0.f) acc += w * ys[d];
    }
    gbar[row * Np + v] = acc;
  }
}

}  // namespace

extern "C" {

int dip_hat_fwd(const float* g, const float* pc, const float* s, float* out,
                int PB, int PT, int T, int D, int Np, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long n = (long)PB * T * D;
  hat_fwd<<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(g, pc, s, out, PB, PT,
                                                         T, D, Np);
  return static_cast<int>(cudaGetLastError());
}

int dip_hat_t(const float* ob, const float* pc, const float* s, float* gbar,
              int PB, int PT, int T, int D, int Np, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)D * sizeof(float);
  hat_t<<<(unsigned)((long)PB * T), NT, smem, st>>>(ob, pc, s, gbar, PT, T, D,
                                                    Np);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
