#!/usr/bin/env python3
"""The select filter-sums K11 (``filter_sum_sel``) and K12
(``filter_sum_sel_t``), or the grouped ones K13 (``filter_sum_grouped``)
and K14 (``filter_sum_grouped_t``), of the PyTorch port with bf16 tables,
beside the stream ceiling of the bytes they must move, on one GPU.

    python3 scripts/torch_filter_stream.py [ROOT] [--N 512]
    python3 scripts/torch_filter_stream.py [ROOT] --grouped [--fan]

builds, from the checkout at ROOT (default: this one), the ``fft_pallas``
tables of the 512^2/8 cell (Shepp-Logan's geometry: 8 nodes, 1536 angles;
``--N`` another size), or with ``--grouped`` its ``fft_grouped`` tables
(with ``--fan``: the shared tables of the fan 256^2/8 cell, 768 fan angles
rebinned to 48 parallel ones), then prints for the two kernels the line
``chip_smoke.py`` prints for them (``_stream_checks``: per-call time,
median of 20 CUDA event timings after 3 warm-ups; device time from
``torch.profiler`` by launch; the launches the profile recorded against
the launches made; GB/s over the bytes the function must move; a bitwise
repeat), on the spectra and cotangents the checkout's projector makes.
Then it builds a throwaway stream kernel (``nvcc`` into ``build/stream/``,
not part of the package) that reads the storage of H (re and im) with
16-byte loads, converts and sums it, and times it the same way, with a
plain ``ld.global.nc`` and with the streaming ``ld.global.cs``: the
practical bound on this card for any kernel that reads H once. With
``--grouped`` it also streams H and K13's slot spectra r_s together (as
bf16 words; the bytes are what counts), the least K13 and K14 must move,
and runs K13 and K14 with each count of images a thread may take (1, and
2 where it divides PB / PT) in place of ``filter_sum.grouped_images``'s
pick: device time, and whether the result equals the pick's bit for bit. The
card's name and power limit come last.
"""

import ctypes
import os
import subprocess
import sys

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(ARGS[0]) if ARGS else os.getcwd()
GROUPED = "--grouped" in sys.argv
FAN = "--fan" in sys.argv
N = (int(sys.argv[sys.argv.index("--N") + 1]) if "--N" in sys.argv
     else 256 if FAN else 512)
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


def _operands(dev):
    """(tag, kernels as (name, wrapper, arguments), tensors to stream)."""
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    cfg = cs._bench_cfg("bfloat16", fan_beam=FAN, N=N)
    geo = cfg.geometry
    a, v, _ = radon.node_angles(geo)
    t = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev),
        "fft_grouped" if GROUPED else "fft_pallas")
    t = t["shared"]["par"] if FAN else t
    P = geo.num_nodes
    gen = torch.Generator(device=dev).manual_seed(5)
    imgs = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
    sinos = torch.randn((P, *t["p"].shape[1:]), generator=gen, device=dev)
    tag = f"[{'fan ' if FAN else ''}{N}^2/8]"
    if not GROUPED:
        r = radon_fft._plane_spectra(imgs, t)
        g = radon_fft._eval_tail_t(sinos, t)
        H, sel = (t["Hre"], t["Him"]), t["sel"]
        return tag, (("filter_sum_sel", fs.filter_sum_sel, (*r, *H, sel)),
                     ("filter_sum_sel_t", fs.filter_sum_sel_t,
                      (*g, *H, sel))), {"H": H}
    r = radon_fft._slot_spectra(imgs, t)
    g = radon_fft._slot_tail_t(sinos, t)
    H, TB = (t["Hre_g"], t["Him_g"]), t["onehot"].shape[1]
    return tag, (("filter_sum_grouped", fs.filter_sum_grouped, (*r, *H)),
                 ("filter_sum_grouped_t", fs.filter_sum_grouped_t,
                  (*g, *H, TB))), {"H": H, "H+r_s": (*H, *r)}


def _each_grouping(name, kern, args, got, tag, failures) -> None:
    """``kern`` (K13 or K14) with each count K of images a thread may take
    forced in place of ``grouped_images``'s pick: its device time a call
    and whether its result equals ``got`` bit for bit (a failure if
    not)."""
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    if not hasattr(fs, "grouped_images"):
        return  # a checkout whose kernels take one image a thread
    PB, PT = args[0].shape[0], args[2].shape[0]
    pick = fs.grouped_images
    try:
        for K in (1, 2):
            if (PB // PT) % K:
                continue
            fs.grouped_images = lambda PB, PT, _K=K: _K
            again = kern(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(again, got))
            if not same:
                failures.append(f"{name}{tag}: {K} images a thread differ "
                                "from the pick's bits")
            dev_ms = cs._device_ms(torch, lambda: kern(*args))[0]
            print(f"{ROOT} {tag} {name} images_a_thread={K} "
                  f"device_ms={dev_ms} equals_chosen={same}", flush=True)
    finally:
        fs.grouped_images = pick


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_filter_stream: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    dev = torch.device("cuda", 0)
    tag, kernels, streams = _operands(dev)
    args0 = kernels[0][2]
    print(f"{ROOT} {tag} shapes: H={tuple(args0[2].shape)} "
          f"H_dtype={args0[2].dtype} H_stride={args0[2].stride()} "
          f"x_stride={args0[0].stride()} "
          f"g_stride={kernels[1][2][0].stride()}", flush=True)
    failures = []
    for name, kern, args in kernels:
        got = kern(*args)
        cs._stream_checks(torch, name, kern, args, got,
                          cs._time_ms(torch, lambda: kern(*args)), failures,
                          tag)
        if GROUPED:
            _each_grouping(name, kern, args, got, tag, failures)
        del got
    lib = _stream_lib()
    blocks = 132 * 8
    out = torch.empty(blocks, device=dev)
    for what, xs in streams.items():
        flat = [_storage(x) for x in xs]
        nbytes = sum(f.numel() for f in flat)
        for cs_hint in (0, 1):
            def run(_c=cs_hint, _f=flat):
                s = torch.cuda.current_stream().cuda_stream
                for f in _f:
                    rc = lib.stream_sum16(f.data_ptr(), f.numel() // 16,
                                          out.data_ptr(), blocks, _c, s)
                    if rc:
                        raise RuntimeError(f"stream_sum16: CUDA error {rc}")
            ms = cs._time_ms(torch, run)
            dev_ms = cs._device_ms(torch, run)[0]
            hint = "ld.global.cs" if cs_hint else "ld.global.nc"
            print(f"{ROOT} {tag} stream_ceiling[{what}, {hint}]: "
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
