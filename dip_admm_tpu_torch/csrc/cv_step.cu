// Hopper (sm_90a) kernels of the Condat-Vu inner step of the node solver
// (dip_admm_tpu_torch/core/node_solver.py, cv, fcv and pcv): the step's
// image-sized elementwise and stencil work, which the JAX package leaves to
// XLA's fusion and PyTorch runs as some fifty separate passes. They replace
// no Pallas kernel.
//
//   dip_cv_grad    d = adj + rho (D x - bc) + K^T u
//   dip_cv_update  x+ = x - s y,  xb = 2 x+ - x,
//                  u+ = Proj_{|.| <= lam}(u + sig K xb)
//
// over P images of N x N pixels, row-major, one node a image, in float32,
// float64 or bfloat16 (every field one dtype). K is the forward-difference
// gradient of ops/tv.py (gx[i,j] = x[i+1,j] - x[i,j], gy[i,j] = x[i,j+1] -
// x[i,j], zero on the last row / column) and K^T its adjoint; y is the
// metric's output between the two launches (cv, pcv: y = d; fcv:
// y = M^-1 d, cuFFT), s the step (cv: tau; fcv: tk; pcv: T) and sig the
// dual step. rho and lam are per node: a [P] array (stride 1), one value on
// the card (stride 0), or a value the host passes (a null pointer), so no
// host scalar is copied to the card in a step. s and sig are per node too,
// or per pixel (stride 2: pcv's [P, N, N] fields).
//
// The same numbers: every output is the plain step's expression in its
// order of evaluation, each operation rounded on its own as its own torch
// op rounds it (float32: __fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn, so
// nvcc contracts no FMA across them; float64: the __d*_rn forms; bfloat16:
// float arithmetic, torch's opmath, rounded to bfloat16 after each op), so
// the kernels equal the PyTorch composition bit for bit, signed zeros
// included (a zero pad enters as the same 0 operand). A host value enters
// as torch reads a host scalar on the card: converted to the arithmetic's
// type; a tensor operand as the fields' dtype. NaN travels as torch carries
// it: the clamps keep a NaN (torch.clamp does; fmaxf alone would drop it),
// and a radius that is 0 or NaN projects to zero
// (torch.where(r > 0, ..., 0)).
//
// What bounds them on an H100: bytes. Per pixel a dozen flops against 7
// fields each (grad: adj, x, D, bc, ux, uy read, d written; update: x, y,
// ux, uy read, x+, ux+, uy+ written; pcv's update reads s and sig besides),
// 7 x 4 bytes a pixel in float32; at 8.4M pixels (the fan cell's
// [32, 512, 512], the batch cell's [128, 256, 256]) 235 MB a kernel, 70 us
// at 3.35 TB/s.
//
// Design: a thread takes a 16-byte run of a row (four float32, two
// float64, eight bfloat16 pixels; a warp's loads coalesced) down a strip of
// R rows, so the stencil's other row comes from the previous iteration's
// registers: grad keeps ux of row i-1, update computes xb of row i+1 before
// it needs it. A strip reads one row outside it again (grad: the row above,
// update: the row below), mostly from L2. The column neighbours (uy[i, j-1]
// for grad; x and y at [i, j+V] for update) and pcv's per-pixel s and sig
// are scalar loads that the warp's own 16-byte loads bring into L1. The
// host picks the shortest R whose grid the card holds in one wave
// (occupancy from the runtime, once a kernel and device): a second,
// part-filled wave streams at a fraction of the rate (the first design,
// about 1024 threads an SM, left 48 of 576 update blocks to a second wave:
// 68-71% of the bound against grad's 84%). Where N is no multiple of the
// run or a base pointer is not 16-byte aligned, the same kernels take one
// pixel a thread (the ragged path); its outputs are the same bits. Outputs
// are new buffers: the inputs (the solver's rollback point and a frozen
// group's state among them) keep their values.
//
// C interface for ctypes: pointers and the stream as void*, sizes and the
// dtype code (0 float32, 1 float64, 2 bfloat16) as int, host scalars as
// double. Every entry launches on the given stream, does not synchronise
// and returns cudaGetLastError() (0 = launched; cudaErrorInvalidValue for
// an unknown dtype code).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAX_STRIP = 16;  // rows a thread walks at most

// The arithmetic of a storage type T: values held as Op (torch's opmath
// type), each result rounded to T as a torch op of T rounds it.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using Op = float;
  static __device__ __forceinline__ Op in(float v) { return v; }
  static __device__ __forceinline__ float out(Op v) { return v; }
  static __device__ __forceinline__ Op add(Op a, Op b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ Op sub(Op a, Op b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ Op mul(Op a, Op b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ Op div(Op a, Op b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ Op sqrt(Op a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ Op rnd(Op a) { return a; }
};

template <>
struct Num<double> {
  using Op = double;
  static __device__ __forceinline__ Op in(double v) { return v; }
  static __device__ __forceinline__ double out(Op v) { return v; }
  static __device__ __forceinline__ Op add(Op a, Op b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ Op sub(Op a, Op b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ Op mul(Op a, Op b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ Op div(Op a, Op b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ Op sqrt(Op a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ Op rnd(Op a) { return a; }
};

template <>
struct Num<__nv_bfloat16> {
  using Op = float;
  static __device__ __forceinline__ Op in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // torch's float -> bfloat16 on sm_80 and later (round to nearest even).
  static __device__ __forceinline__ __nv_bfloat16 out(Op v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ Op rnd(Op a) { return in(out(a)); }
  static __device__ __forceinline__ Op add(Op a, Op b) {
    return rnd(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ Op sub(Op a, Op b) {
    return rnd(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ Op mul(Op a, Op b) {
    return rnd(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ Op div(Op a, Op b) {
    return rnd(__fdiv_rn(a, b));
  }
  static __device__ __forceinline__ Op sqrt(Op a) { return rnd(__fsqrt_rn(a)); }
};

// Pixels a thread takes on the vector path: one 16-byte run.
template <typename T>
constexpr int kRun = 16 / sizeof(T);

// A per-node (or, for s and sig, per-pixel) scalar operand.
template <typename T>
struct Scalar {
  const T* p;  // null: the host value v
  typename Num<T>::Op v;
  int stride;  // 2: one a pixel; 1: one a node; 0: one for all
};

// The operand's value for node ``node`` (a per-pixel operand reads
// through ``pixel`` instead).
template <typename T>
__device__ __forceinline__ typename Num<T>::Op at(const Scalar<T>& s,
                                                  int node) {
  return s.p ? Num<T>::in(s.p[s.stride == 1 ? node : 0]) : s.v;
}

// The operand at pixel offset ``o`` where it is per pixel (only kernels
// instantiated with PIX look), else the node's value ``node_v``.
template <typename T, bool PIX>
__device__ __forceinline__ typename Num<T>::Op pixel(
    const Scalar<T>& s, typename Num<T>::Op node_v, long o) {
  if constexpr (PIX) {
    if (s.stride == 2) return Num<T>::in(s.p[o]);
  }
  return node_v;
}

// torch.clamp(v, min=lo): a NaN stays NaN.
template <typename Op>
__device__ __forceinline__ Op clamp_min(Op v, Op lo) {
  return (v != v || !(v < lo)) ? v : lo;
}

template <typename T, int V>
__device__ __forceinline__ void load(typename Num<T>::Op (&a)[V],
                                     const T* p) {
  T t[V];
  if constexpr (V * sizeof(T) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    memcpy(t, &q, 16);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = p[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = Num<T>::in(t[v]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p,
                                      const typename Num<T>::Op (&a)[V]) {
  T t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = Num<T>::out(a[v]);
  if constexpr (V * sizeof(T) == 16) {
    uint4 q;
    memcpy(&q, t, 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = t[v];
  }
}

// A thread's place: node p, its strip's rows [i0, i1), its first column j0.
struct Place {
  int p, i0, i1, j0;
};

template <int V>
__device__ __forceinline__ bool place(Place& w, int N, int R, int strips,
                                      long threads) {
  const long t = (long)blockIdx.x * NT + threadIdx.x;
  if (t >= threads) return false;
  const int cols = N / V;
  const long rest = t / cols;
  w.j0 = (int)(t - rest * cols) * V;
  const int strip = (int)(rest % strips);
  w.p = (int)(rest / strips);
  w.i0 = strip * R;
  w.i1 = min(w.i0 + R, N);
  return true;
}

// d = (adj + rho * (D * x - bc)) + ktu, with
// ktu = ((ux[i-1,j] - ux[i,j]) + uy[i,j-1]) - uy[i,j]: tv.grad_adjoint's
// order, each term 0 where its pad puts a zero.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
    cv_grad(const T* __restrict__ adj, const T* __restrict__ x,
            const T* __restrict__ D, const T* __restrict__ bc,
            const T* __restrict__ ux, const T* __restrict__ uy,
            Scalar<T> rho_s, T* __restrict__ d, int N, int R, int strips,
            long threads) {
  using M = Num<T>;
  using Op = typename M::Op;
  Place w;
  if (!place<V>(w, N, R, strips, threads)) return;
  const Op rho = at(rho_s, w.p);
  const long img = (long)w.p * N * N;
  Op up[V];  // ux of the row above
  if (w.i0 > 0) {
    load<T, V>(up, ux + img + (long)(w.i0 - 1) * N + w.j0);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) up[v] = Op(0);
  }
  for (int i = w.i0; i < w.i1; ++i) {
    const long o = img + (long)i * N + w.j0;
    Op a[V], xv[V], dv[V], b[V], u[V], q[V], out[V];
    load<T, V>(a, adj + o);
    load<T, V>(xv, x + o);
    load<T, V>(dv, D + o);
    load<T, V>(b, bc + o);
    load<T, V>(u, ux + o);
    load<T, V>(q, uy + o);
    const Op left = w.j0 > 0 ? M::in(uy[o - 1]) : Op(0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = w.j0 + v;
      const Op ta = i > 0 ? up[v] : Op(0);
      const Op tb = i < N - 1 ? u[v] : Op(0);
      const Op tc = j > 0 ? (v == 0 ? left : q[v > 0 ? v - 1 : 0]) : Op(0);
      const Op te = j < N - 1 ? q[v] : Op(0);
      const Op ktu = M::sub(M::add(M::sub(ta, tb), tc), te);
      const Op g =
          M::add(a[v], M::mul(rho, M::sub(M::mul(dv[v], xv[v]), b[v])));
      out[v] = M::add(g, ktu);
      up[v] = u[v];
    }
    store<T, V>(d + o, out);
  }
}

// x+ = x - s * y and xb = 2 * x+ - x of one row's V pixels, and xb of the
// pixel right of them (0 past the last column, where gy is 0 anyway).
template <typename T, int V, bool PIX>
__device__ __forceinline__ void row_xb(const T* __restrict__ x,
                                       const T* __restrict__ y, long o,
                                       int j0, int N, const Scalar<T>& s_s,
                                       typename Num<T>::Op s,
                                       typename Num<T>::Op (&xn)[V],
                                       typename Num<T>::Op (&xb)[V + 1]) {
  using M = Num<T>;
  using Op = typename M::Op;
  const Op two = Op(2);
  Op xv[V], yv[V];
  load<T, V>(xv, x + o);
  load<T, V>(yv, y + o);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    xn[v] = M::sub(xv[v], M::mul(pixel<T, PIX>(s_s, s, o + v), yv[v]));
    xb[v] = M::sub(M::mul(two, xn[v]), xv[v]);
  }
  if (j0 + V < N) {
    const Op xr = M::in(x[o + V]);
    const Op nr =
        M::sub(xr, M::mul(pixel<T, PIX>(s_s, s, o + V), M::in(y[o + V])));
    xb[V] = M::sub(M::mul(two, nr), xr);
  } else {
    xb[V] = Op(0);
  }
}

// u+ = Proj(u + sig * gx, uy + sig * gy) as tv.project_l2_ball computes it:
// factor = where(r > 0, 1 / clamp(|.| / clamp(r, 1e-30), 1), 0).
template <typename T, int V, bool PIX>
__global__ void __launch_bounds__(NT)
    cv_update(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ ux, const T* __restrict__ uy,
              Scalar<T> s_s, Scalar<T> sig_s, Scalar<T> lam_s,
              T* __restrict__ x_new, T* __restrict__ ux_new,
              T* __restrict__ uy_new, int N, int R, int strips,
              long threads) {
  using M = Num<T>;
  using Op = typename M::Op;
  Place w;
  if (!place<V>(w, N, R, strips, threads)) return;
  const Op s = at(s_s, w.p), sig = at(sig_s, w.p), r = at(lam_s, w.p);
  // torch.clamp rounds its result to T, as the kernels' other ops do
  const Op safe_r = M::rnd(clamp_min(r, Op(1e-30)));
  const bool inside = r > Op(0);
  const long img = (long)w.p * N * N;
  Op xn[V], xb[V + 1];
  row_xb<T, V, PIX>(x, y, img + (long)w.i0 * N + w.j0, w.j0, N, s_s, s, xn,
                    xb);
  for (int i = w.i0; i < w.i1; ++i) {
    const long o = img + (long)i * N + w.j0;
    Op xn2[V], xb2[V + 1];
    if (i + 1 < N) {
      row_xb<T, V, PIX>(x, y, o + N, w.j0, N, s_s, s, xn2, xb2);
    } else {
#pragma unroll
      for (int v = 0; v <= V; ++v) xb2[v] = Op(0);
#pragma unroll
      for (int v = 0; v < V; ++v) xn2[v] = Op(0);
    }
    Op u[V], q[V], ou[V], oq[V];
    load<T, V>(u, ux + o);
    load<T, V>(q, uy + o);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = w.j0 + v;
      const Op sg = pixel<T, PIX>(sig_s, sig, o + v);
      const Op gx = i < N - 1 ? M::sub(xb2[v], xb[v]) : Op(0);
      const Op gy = j < N - 1 ? M::sub(xb[v + 1], xb[v]) : Op(0);
      const Op pu = M::add(u[v], M::mul(sg, gx));
      const Op pq = M::add(q[v], M::mul(sg, gy));
      const Op mag = M::sqrt(M::add(M::mul(pu, pu), M::mul(pq, pq)));
      const Op c = clamp_min(M::div(mag, safe_r), Op(1));
      const Op f = inside ? M::div(Op(1), c) : Op(0);
      ou[v] = M::mul(pu, f);
      oq[v] = M::mul(pq, f);
    }
    store<T, V>(x_new + o, xn);
    store<T, V>(ux_new + o, ou);
    store<T, V>(uy_new + o, oq);
#pragma unroll
    for (int v = 0; v < V; ++v) xn[v] = xn2[v];
#pragma unroll
    for (int v = 0; v <= V; ++v) xb[v] = xb2[v];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Names one kernel (which entry, T, V, PIX) for resident_blocks' cache.
template <typename T, int V, int Which>
struct Key {};

// The blocks of ``kernel`` the card holds at once (its SMs times the blocks
// an SM holds), once a device; 0 where the runtime cannot say. ``K`` keys
// the cache, so each kernel keeps its own count.
template <typename K, typename F>
int resident_blocks(F kernel) {
  static int slots[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!slots[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      0) != cudaSuccess)
      return 0;
    slots[dev] = sms * per_sm;
  }
  return slots[dev];
}

// The grid of P images of N rows, cols threads a row, strips of R rows.
struct Grid {
  int R, strips;
  long threads;
  unsigned blocks;
};

Grid grid_of(int P, int N, int cols, int R) {
  Grid g;
  g.R = R;
  g.strips = (N + R - 1) / R;
  g.threads = (long)P * g.strips * cols;
  g.blocks = (unsigned)((g.threads + NT - 1) / NT);
  return g;
}

// The shortest strips whose grid the card holds in one wave, so every
// block streams at once and no second, part-filled wave trails the first;
// MAX_STRIP where no strip length fits (many waves).
Grid grid(int P, int N, int cols, int slots) {
  for (int R = 1; R < MAX_STRIP; ++R) {
    const Grid g = grid_of(P, N, cols, R);
    if (slots > 0 && g.blocks <= (unsigned)slots) return g;
  }
  return grid_of(P, N, cols, MAX_STRIP);
}

template <typename T, int V>
void grad_launch(const void* adj, const void* x, const void* D,
                 const void* bc, const void* ux, const void* uy,
                 Scalar<T> rho, void* d, int P, int N, cudaStream_t st) {
  const Grid g = grid(P, N, N / V,
                      resident_blocks<Key<T, V, 0>>(cv_grad<T, V>));
  cv_grad<T, V><<<g.blocks, NT, 0, st>>>(
      static_cast<const T*>(adj), static_cast<const T*>(x),
      static_cast<const T*>(D), static_cast<const T*>(bc),
      static_cast<const T*>(ux), static_cast<const T*>(uy), rho,
      static_cast<T*>(d), N, g.R, g.strips, g.threads);
}

template <typename T>
void grad_of(const void* adj, const void* x, const void* D, const void* bc,
             const void* ux, const void* uy, const void* rho_p, double rho_v,
             int rho_stride, void* d, int P, int N, cudaStream_t st) {
  using Op = typename Num<T>::Op;
  const Scalar<T> rho{static_cast<const T*>(rho_p), static_cast<Op>(rho_v),
                      rho_stride};
  const bool vec = N % kRun<T> == 0 && aligned16(adj) && aligned16(x) &&
                   aligned16(D) && aligned16(bc) && aligned16(ux) &&
                   aligned16(uy) && aligned16(d);
  if (vec)
    grad_launch<T, kRun<T>>(adj, x, D, bc, ux, uy, rho, d, P, N, st);
  else
    grad_launch<T, 1>(adj, x, D, bc, ux, uy, rho, d, P, N, st);
}

template <typename T, int V, bool PIX>
void update_launch(const void* x, const void* y, const void* ux,
                   const void* uy, Scalar<T> s, Scalar<T> sig, Scalar<T> lam,
                   void* x_new, void* ux_new, void* uy_new, int P, int N,
                   cudaStream_t st) {
  const Grid g = grid(P, N, N / V,
                      resident_blocks<Key<T, V, 1 + PIX>>(
                          cv_update<T, V, PIX>));
  cv_update<T, V, PIX><<<g.blocks, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(ux), static_cast<const T*>(uy), s, sig, lam,
      static_cast<T*>(x_new), static_cast<T*>(ux_new),
      static_cast<T*>(uy_new), N, g.R, g.strips, g.threads);
}

template <typename T, int V>
void update_pix(const void* x, const void* y, const void* ux, const void* uy,
                Scalar<T> s, Scalar<T> sig, Scalar<T> lam, void* x_new,
                void* ux_new, void* uy_new, int P, int N, cudaStream_t st) {
  if (s.stride == 2 || sig.stride == 2)
    update_launch<T, V, true>(x, y, ux, uy, s, sig, lam, x_new, ux_new,
                              uy_new, P, N, st);
  else
    update_launch<T, V, false>(x, y, ux, uy, s, sig, lam, x_new, ux_new,
                               uy_new, P, N, st);
}

template <typename T>
void update_of(const void* x, const void* y, const void* ux, const void* uy,
               const void* s_p, double s_v, int s_stride, const void* sig_p,
               double sig_v, int sig_stride, const void* lam_p, double lam_v,
               int lam_stride, void* x_new, void* ux_new, void* uy_new, int P,
               int N, cudaStream_t st) {
  using Op = typename Num<T>::Op;
  const Scalar<T> s{static_cast<const T*>(s_p), static_cast<Op>(s_v),
                    s_stride},
      sig{static_cast<const T*>(sig_p), static_cast<Op>(sig_v), sig_stride},
      lam{static_cast<const T*>(lam_p), static_cast<Op>(lam_v), lam_stride};
  const bool vec = N % kRun<T> == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(ux) && aligned16(uy) && aligned16(x_new) &&
                   aligned16(ux_new) && aligned16(uy_new);
  if (vec)
    update_pix<T, kRun<T>>(x, y, ux, uy, s, sig, lam, x_new, ux_new, uy_new,
                           P, N, st);
  else
    update_pix<T, 1>(x, y, ux, uy, s, sig, lam, x_new, ux_new, uy_new, P, N,
                     st);
}

}  // namespace

extern "C" {

int dip_cv_grad(const void* adj, const void* x, const void* D,
                const void* bc, const void* ux, const void* uy,
                const void* rho_p, double rho_v, int rho_stride, void* d,
                int P, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || N < 1) return 0;
  switch (dtype) {
    case 0:
      grad_of<float>(adj, x, D, bc, ux, uy, rho_p, rho_v, rho_stride, d, P,
                     N, st);
      break;
    case 1:
      grad_of<double>(adj, x, D, bc, ux, uy, rho_p, rho_v, rho_stride, d, P,
                      N, st);
      break;
    case 2:
      grad_of<__nv_bfloat16>(adj, x, D, bc, ux, uy, rho_p, rho_v, rho_stride,
                             d, P, N, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dip_cv_update(const void* x, const void* y, const void* ux,
                  const void* uy, const void* s_p, double s_v, int s_stride,
                  const void* sig_p, double sig_v, int sig_stride,
                  const void* lam_p, double lam_v, int lam_stride,
                  void* x_new, void* ux_new, void* uy_new, int P, int N,
                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || N < 1) return 0;
  switch (dtype) {
    case 0:
      update_of<float>(x, y, ux, uy, s_p, s_v, s_stride, sig_p, sig_v,
                       sig_stride, lam_p, lam_v, lam_stride, x_new, ux_new,
                       uy_new, P, N, st);
      break;
    case 1:
      update_of<double>(x, y, ux, uy, s_p, s_v, s_stride, sig_p, sig_v,
                        sig_stride, lam_p, lam_v, lam_stride, x_new, ux_new,
                        uy_new, P, N, st);
      break;
    case 2:
      update_of<__nv_bfloat16>(x, y, ux, uy, s_p, s_v, s_stride, sig_p,
                               sig_v, sig_stride, lam_p, lam_v, lam_stride,
                               x_new, ux_new, uy_new, P, N, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
