#!/usr/bin/env python3
"""The select filter-sums K11 (``filter_sum_sel``) and K12
(``filter_sum_sel_t``) of the PyTorch port at 512^2/8 with bf16 tables,
beside the stream ceiling of their table on one GPU.

    python3 scripts/torch_filter_stream.py [ROOT] [--N 512]

builds the ``fft_pallas`` tables of the 512^2/8 cell (Shepp-Logan's
geometry: 8 nodes, 1536 angles) from the checkout at ROOT (default: this
one), then prints for K11 and K12 the line ``chip_smoke.py`` prints for
them (``_stream_checks``: per-call time, median of 20 CUDA event timings
after 3 warm-ups; device time from ``torch.profiler`` by launch; the
launches the profile recorded against the launches made; GB/s over the
bytes the function must move; a bitwise repeat). Then it builds a
throwaway stream kernel (``nvcc`` into ``build/stream/``, not part of the
package) that reads the table storage of H (re and im) with 16-byte
loads, converts and sums it, and times it the same way, with a plain ``ld.global.nc`` and with the
streaming ``ld.global.cs``: the practical bound on this card for any
kernel that reads H once. The card's name and power limit come last.
"""

import ctypes
import os
import subprocess
import sys

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(ARGS[0]) if ARGS else os.getcwd()
N = int(sys.argv[sys.argv.index("--N") + 1]) if "--N" in sys.argv else 512
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STREAM_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool CS>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  if (CS) return __ldcs(p);
  return __ldg(p);
}

__device__ __forceinline__ float sum8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    s += __uint_as_float(w[k] << 16) + __uint_as_float(w[k] & 0xffff0000u);
  return s;
}

// Each thread reads U 16-byte units a step, grid-stride; one partial a
// block (lane 0 of warp 0 after a fixed-order block sum).
template <bool CS>
__global__ void __launch_bounds__(256) stream_sum(const uint4* __restrict__ a,
                                                  long n, float* out) {
  constexpr int U = 4;
  __shared__ float part[8];
  const long stride = (long)gridDim.x * blockDim.x;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  for (; i + (U - 1) * stride < n; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = ld16<CS>(a + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) s += sum8(v[u]);
  }
  for (; i < n; i += stride) s += sum8(ld16<CS>(a + i));
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += part[w];
    out[blockIdx.x] = t;
  }
}

extern "C" int stream_sum16(const void* a, long n16, float* out, int blocks,
                            int cs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* p = static_cast<const uint4*>(a);
  if (cs)
    stream_sum<true><<<blocks, 256, 0, s>>>(p, n16, out);
  else
    stream_sum<false><<<blocks, 256, 0, s>>>(p, n16, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def _stream_lib():
    from dip_admm_tpu_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "stream")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "stream_sum.cu")
    lib = os.path.join(out, "libstream_sum.so")
    with open(src, "w") as f:
        f.write(STREAM_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    so.stream_sum16.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    so.stream_sum16.restype = ctypes.c_int
    return so


def _storage(x):
    """The whole storage under ``x`` (its pad columns included) as a flat
    uint8 tensor."""
    st = x.untyped_storage()
    return torch.empty(0, dtype=torch.uint8, device=x.device).set_(
        st, 0, (st.nbytes(),))


def main() -> int:
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    if not torch.cuda.is_available():
        print("torch_filter_stream: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    dev = torch.device("cuda", 0)
    cfg = cs._bench_cfg("bfloat16", N=N)
    geo = cfg.geometry
    a, v, _ = radon.node_angles(geo)
    t = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), "fft_pallas")
    PT, T, Nn, F = t["Hre"].shape
    gen = torch.Generator(device=dev).manual_seed(5)
    imgs = torch.randn((PT, geo.N, geo.N), generator=gen, device=dev)
    r = radon_fft._plane_spectra(imgs, t)
    g = radon_fft._eval_tail_t(
        torch.randn((PT, T, t["p"].shape[-1]), generator=gen, device=dev), t)
    H, sel = (t["Hre"], t["Him"]), t["sel"]
    print(f"{ROOT} shapes: PB={PT} T={T} N={Nn} F={F} H={H[0].dtype} "
          f"H_stride={H[0].stride()} r_stride={r[0].stride()} "
          f"g_stride={g[0].stride()}", flush=True)
    failures = []
    for name, kern, args in (
            ("filter_sum_sel", fs.filter_sum_sel, (*r, *H, sel)),
            ("filter_sum_sel_t", fs.filter_sum_sel_t, (*g, *H, sel))):
        got = kern(*args)
        cs._stream_checks(torch, name, kern, args, got,
                          cs._time_ms(torch, lambda: kern(*args)), failures,
                          f"[{N}^2/8]")
        del got
    lib = _stream_lib()
    flat = [_storage(h) for h in H]
    nbytes = sum(f.numel() for f in flat)
    blocks = 132 * 8
    out = torch.empty(blocks, device=dev)
    for cs_hint in (0, 1):
        def run(_c=cs_hint):
            s = torch.cuda.current_stream().cuda_stream
            for f in flat:
                rc = lib.stream_sum16(f.data_ptr(), f.numel() // 16,
                                      out.data_ptr(), blocks, _c, s)
                if rc:
                    raise RuntimeError(f"stream_sum16: CUDA error {rc}")
        ms = cs._time_ms(torch, run)
        dev_ms = cs._device_ms(torch, run)[0]
        print(f"{ROOT} stream_ceiling[{'ld.global.cs' if cs_hint else 'ld.global.nc'}]: "
              f"bytes={nbytes} ms={ms} device_ms={dev_ms} "
              f"GB_per_s={nbytes / ms / 1e6} "
              f"device_GB_per_s={nbytes / dev_ms / 1e6}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
