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
// - K17 (redesigned): one thread per four consecutive detectors d of one
//   (p, t) row. Only v = floor(pc) and floor(pc) + 1 can carry weight; each
//   weight is computed as the TPU kernel computes it (1 - |pc - v| in f32)
//   and every other term of its sum is an exact zero. Taps outside [0, Np)
//   contribute nothing, and s multiplies after the sum. A NaN coordinate
//   gives NaN, as the TPU kernel's max(0, 1 - |NaN - v|) does at every v;
//   it fails the tap range test, so only detectors outside the range test
//   for it.
//   A thread reads its four pc in one 16-byte load, s[q, t] once, its taps
//   of g through the read-only path, and writes its four outputs in one
//   16-byte store; where D % 4 != 0 or a row's start is not 16-byte aligned
//   it loads and stores its detectors one by one (the ragged tail of a row
//   included). Each output is the same expression as in the first design
//   (one thread per detector), so the two agree bit for bit. Its device time
//   was at 66% of its bound; the rest of a call was the host's dispatch,
//   which the wrapper's lean launch path (ops/kernels/_launch.py) trims.
// - K18 (redesigned): one warp per (p, t) row, four rows per block, each
//   warp staging its row's pc and s*ob in shared memory; each v sums the
//   detectors d with |pc - v| < 1 in ascending d. The evaluation
//   coordinates of the projectors are monotone in d (an affine detector
//   grid, or the fan rebin's sorted one). The first design (one 256-thread
//   block per row, two block barriers, two binary searches of ~log2(D)
//   dependent shared-memory loads for each of the Np = 2048 v, scalar
//   stores) was 1.12x slower per call than grid_sample's backward at
//   512^2/8. Now the warp checks that its row is monotone and builds the
//   ranges of all v in one pass over the D + 1 boundaries between
//   detectors (a boundary table, each v written by exactly one boundary,
//   no atomics), so a v costs two table reads and its one or two terms;
//   the runs of v outside the row's span are written as zeros with
//   16-byte stores. A row that is not monotone sums every d, the general
//   case. Each v adds the same nonzero terms in the same order as the
//   searched ranges gave, so on rows without a NaN the two designs agree
//   bit for bit. A row holding a NaN coordinate is NaN at every v, as in
//   the TPU kernel's transpose, where every v takes a NaN term: the warp
//   looks for one on the rows that are not monotone (a NaN makes a row of
//   D >= 2 neither rising nor falling) and writes NaN over the row. What
//   bounds it now: its bytes (its device time is at that bound); a single
//   call's time is mostly the host's dispatch.
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
// K17. One thread per four consecutive detectors of one (p, t) row.
// ---------------------------------------------------------------------------
// The sum of one detector's two taps, as the first design wrote it.
__device__ __forceinline__ float hat_taps(float x, const float* __restrict__ gr,
                                          int Np) {
  const float fl = floorf(x);
  float acc = 0.f;
  if (fl >= -1.f && fl < (float)Np) {  // false for NaN
    const int v0 = (int)fl;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = v0 + k;
      if (v >= 0 && v < Np) acc += hat(x, (float)v) * __ldg(gr + v);
    }
  } else if (isnan(x)) {
    acc = x;
  }
  return acc;
}

__global__ void __launch_bounds__(NT)
hat_fwd(const float* __restrict__ g, const float* __restrict__ pc,
        const float* __restrict__ s, float* __restrict__ out, int PT, int T,
        int D, int Np, int quads, long n) {
  const long i = (long)blockIdx.x * NT + threadIdx.x;  // (p, t, quad)
  if (i >= n) return;
  const int d0 = 4 * (int)(i % quads);
  const long pt_row = i / quads;  // p * T + t
  const int t = (int)(pt_row % T), p = (int)(pt_row / T);
  const long q_row = (long)(p % PT) * T + t;
  const float* xr = pc + q_row * D + d0;
  float* o = out + pt_row * D + d0;
  const float* gr = g + pt_row * Np;
  const float sc = __ldg(s + q_row);
  if (d0 + 4 <= D &&
      ((reinterpret_cast<size_t>(xr) | reinterpret_cast<size_t>(o)) & 15) == 0) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(xr));
    float4 r;
    r.x = sc * hat_taps(x.x, gr, Np);
    r.y = sc * hat_taps(x.y, gr, Np);
    r.z = sc * hat_taps(x.z, gr, Np);
    r.w = sc * hat_taps(x.w, gr, Np);
    *reinterpret_cast<float4*>(o) = r;
  } else {
    for (int k = 0; k < 4 && d0 + k < D; ++k)
      o[k] = sc * hat_taps(__ldg(xr + k), gr, Np);
  }
}

// ---------------------------------------------------------------------------
// K18. One warp per (p, t) row, HT_WARPS rows per block, no block barrier.
// Each warp stages in its own shared memory the row's pc and s*ob [D] and
// two boundary tables lo, hi [Np] (row_bytes in all).
// ---------------------------------------------------------------------------
constexpr int HT_WARPS = 4;
constexpr int HT_MAX_SMEM = 232448;

// pc clamped to [-4, Np + 4]: for the integers v - 1 and v + 1 of v in
// [0, Np) every comparison with the clamped value agrees with the original.
__device__ __forceinline__ float clamp_pc(float x, int Np) {
  return fminf(fmaxf(x, -4.f), (float)Np + 4.f);
}

__global__ void __launch_bounds__(32 * HT_WARPS)
hat_t(const float* __restrict__ ob, const float* __restrict__ pc,
      const float* __restrict__ s, float* __restrict__ gbar, int PT, int T,
      int D, int Np, long rows, int row_bytes) {
  extern __shared__ __align__(16) unsigned char sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // p * T + t
  if (row >= rows) return;  // warp-uniform
  float* xs = reinterpret_cast<float*>(sh + (size_t)warp * row_bytes);
  float* ys = xs + D;
  unsigned short* lo = reinterpret_cast<unsigned short*>(ys + D);
  unsigned short* hi = lo + Np;
  const int t = (int)(row % T), p = (int)(row / T);
  const long q_row = (long)(p % PT) * T + t;
  const float sc = s[q_row];
  for (int d = lane; d < D; d += 32) {
    xs[d] = pc[q_row * D + d];
    ys[d] = sc * ob[row * D + d];
  }
  __syncwarp();
  bool up = true, down = true;  // NaN makes a row of D >= 2 neither
  for (int d = lane; d + 1 < D; d += 32) {
    up = up && xs[d + 1] >= xs[d];
    down = down && xs[d + 1] <= xs[d];
  }
  const bool rising = __all_sync(0xffffffffu, up);
  const bool mono = rising || __all_sync(0xffffffffu, down);
  float* out = gbar + row * Np;
  if (!mono || D == 1) {  // the only rows that can hold a NaN; warp-uniform
    bool nan = false;
    for (int d = lane; d < D; d += 32) nan = nan || isnan(xs[d]);
    if (__any_sync(0xffffffffu, nan)) {
      for (int v = lane; v < Np; v += 32) out[v] = __int_as_float(0x7fffffff);
      return;
    }
  }

  // A monotone row: v can carry weight only inside [vs, ve), and there the
  // detectors with |pc - v| < 1 are d in [lo[v], hi[v]): for a rising row
  // lo[v] is the first d with pc > v - 1 and hi[v] the first with
  // pc >= v + 1 (falling: pc < v + 1, pc <= v - 1). Boundary d in [0, D],
  // between detectors d - 1 and d, writes lo[v] = d for the v with
  // pc[d-1] <= v - 1 < pc[d] (rising), and likewise hi; each v is written
  // by exactly one d. A row that is not monotone sums every d.
  int vs = 0, ve = Np;
  if (mono) {
    const float mn = clamp_pc(rising ? xs[0] : xs[D - 1], Np);
    const float mx = clamp_pc(rising ? xs[D - 1] : xs[0], Np);
    vs = max(0, (int)floorf(mn) - 1);
    ve = min(Np, (int)ceilf(mx) + 2);
    for (int d = lane; d <= D; d += 32) {
      const float a = d > 0 ? clamp_pc(xs[d - 1], Np) : 0.f;
      const float c = d < D ? clamp_pc(xs[d], Np) : 0.f;
      int l0, l1, h0, h1;  // lo[v] = d on [l0, l1), hi[v] = d on [h0, h1)
      if (rising) {
        l0 = d > 0 ? (int)ceilf(a) + 1 : vs;
        l1 = d < D ? (int)ceilf(c) + 1 : ve;
        h0 = d > 0 ? (int)floorf(a) : vs;
        h1 = d < D ? (int)floorf(c) : ve;
      } else {
        l0 = d < D ? (int)floorf(c) : vs;
        l1 = d > 0 ? (int)floorf(a) : ve;
        h0 = d < D ? (int)ceilf(c) + 1 : vs;
        h1 = d > 0 ? (int)ceilf(a) + 1 : ve;
      }
      for (int v = max(l0, vs); v < min(l1, ve); ++v) lo[v] = (unsigned short)d;
      for (int v = max(h0, vs); v < min(h1, ve); ++v) hi[v] = (unsigned short)d;
    }
    __syncwarp();
  }
  // The nonzero terms of v in ascending d, as the binary-searched ranges of
  // the CUDA kernel before gave them.
  auto value = [&](int v) -> float {
    if (v < vs || v >= ve) return 0.f;
    const int d0 = mono ? lo[v] : 0, d1 = mono ? hi[v] : D;
    const float fv = (float)v;
    float acc = 0.f;
    for (int d = d0; d < d1; ++d) {
      const float w = hat(xs[d], fv);
      if (w > 0.f) acc += w * ys[d];
    }
    return acc;
  };
  if ((Np & 3) == 0) {  // 16-byte stores; runs outside [vs, ve) are zeros
    for (int v = 4 * lane; v < Np; v += 128) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v + 4 > vs && v < ve)
        o = make_float4(value(v), value(v + 1), value(v + 2), value(v + 3));
      *reinterpret_cast<float4*>(out + v) = o;
    }
  } else {
    for (int v = lane; v < Np; v += 32) out[v] = value(v);
  }
}

}  // namespace

extern "C" {

int dip_hat_fwd(const float* g, const float* pc, const float* s, float* out,
                int PB, int PT, int T, int D, int Np, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int quads = (D + 3) / 4;
  const long n = (long)PB * T * quads;
  hat_fwd<<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(g, pc, s, out, PT, T,
                                                         D, Np, quads, n);
  return static_cast<int>(cudaGetLastError());
}

int dip_hat_t(const float* ob, const float* pc, const float* s, float* gbar,
              int PB, int PT, int T, int D, int Np, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Per row: pc and s*ob (f32) and the two boundary tables (u16), in 16s.
  const size_t row_bytes = (8 * (size_t)D + 4 * (size_t)Np + 15) / 16 * 16;
  if (row_bytes > (size_t)HT_MAX_SMEM || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int wpb = HT_WARPS;
  while (wpb > 1 && wpb * row_bytes > (size_t)HT_MAX_SMEM) --wpb;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        hat_t, cudaFuncAttributeMaxDynamicSharedMemorySize, HT_MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const long rows = (long)PB * T;
  hat_t<<<(unsigned)((rows + wpb - 1) / wpb), 32 * wpb, wpb * row_bytes,
          st>>>(ob, pc, s, gbar, PT, T, D, Np, rows, (int)row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
