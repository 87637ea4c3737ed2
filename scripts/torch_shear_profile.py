#!/usr/bin/env python3
"""Where K7's and K8's tensor-core tap products spend their cycles on the
card.

    python3 scripts/torch_shear_profile.py

builds a copy of ``dip_admm_tpu_torch/csrc/shear_sum.cu`` with clock64
counters in ``shear_fwd_tc`` (K7) and ``shear_t_tc`` (K8) into
``build/profile/`` and runs ``dip_shear_fwd`` and ``dip_shear_t`` (bf16
tables) ten times each on the ``fft_shear`` tables at 256^2/8 and 512^2/8.
For each it prints, from thread 0 of every block (warp 0, lane 0): a
block's cycles and those of its prologue (Phi staged, the step list
compacted), the steps of warp 0's group (K7: a row block, an angle and 8
taps; K8: an angle and 16 taps of a 64-row half), and per step the cycles
waiting for the step's ring slot (cp.async wait and group barrier),
issuing the copies of the step SH_R - 1 ahead, and then K7: issuing the
MMAs (ldmatrix of the step's tiles) and the Phi combine (which waits for
them); K8: forming T and S, then issuing the MMAs. The counters' own
atomics add a little to each phase. The repository's sources are not
changed.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

N7, N8 = 8, 8  # counters of each kernel
ADD = "if (threadIdx.x == 0) atomicAdd(&{a}[{i}], (unsigned long long)({v}));"


def _add(a, i, v):
    return ADD.format(a=a, i=i, v=v)


# (anchor in the source, its replacement): the counters. K7: 0 block, 1
# prologue, 2 waiting for the step's ring slot (cp.async wait and group
# barrier), 3 issuing the step SH_R - 1 ahead, 4 the MMAs issued (ldmatrix
# of the marked tiles), 5 the Phi combine (waits for the MMAs), 6 steps, 7
# blocks. K8: 0-3 as K7's, 4 T and S formed, 5 the MMAs issued (ldmatrix
# of the marked tiles; they wait for the last step's MMAs), 6 steps, 7
# blocks.
PATCHES = [
    ("constexpr int SH_MAXCH = ",
     f"__device__ unsigned long long g_k7[{N7}], g_k8[{N8}];\n"
     "constexpr int SH_MAXCH = "),
    ("  stage_phi<BF, LDP, SH_NT7>(Ps, phre, phim, D2, F, f0);\n",
     "  const long long k0 = clock64();\n"
     "  stage_phi<BF, LDP, SH_NT7>(Ps, phre, phim, D2, F, f0);\n"),
    ("  const int ns = Ns[al];\n",
     "  const int ns = Ns[al];\n"
     "  " + _add("g_k7", 1, "clock64() - k0") + "\n"),
    ("  for (int k = 0; k < ns; ++k) {\n"
     "    cp_async_wait<SH_R - 2>();\n    bar_group(1 + al);\n"
     "    issue(k + SH_R - 1);\n",
     "  for (int k = 0; k < ns; ++k) {\n"
     "    const long long c0 = clock64();\n"
     "    cp_async_wait<SH_R - 2>();\n    bar_group(1 + al);\n"
     "    const long long c1 = clock64();\n"
     "    issue(k + SH_R - 1);\n"
     "    const long long c2 = clock64();\n"),
    ("    const unsigned ls = lb + (k % SH_R) * SH_STEP * 2;\n",
     "    const long long c3 = clock64();\n"
     "    const unsigned ls = lb + (k % SH_R) * SH_STEP * 2;\n"),
    ("    // C element x: f = fa + 8 (x >> 1), d = 8j + 2q + (x & 1).\n",
     "    const long long c4 = clock64();\n"
     "    // C element x: f = fa + 8 (x >> 1), d = 8j + 2q + (x & 1).\n"),
    ("    if (!last) continue;  // the angle has more steps in this row block"
     "\n",
     "    " + _add("g_k7", 2, "c1 - c0") + "\n"
     "    " + _add("g_k7", 3, "c2 - c1") + "\n"
     "    " + _add("g_k7", 4, "c4 - c3") + "\n"
     "    " + _add("g_k7", 5, "clock64() - c4") + "\n"
     "    " + _add("g_k7", 6, "1") + "\n"
     "    if (!last) continue;  // the angle has more steps in this row block"
     "\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n"
     "  for (int i = threadIdx.x; i < nt * BF; i += SH_NT7) {\n",
     "  cp_async_wait<0>();\n  __syncthreads();\n"
     "  " + _add("g_k7", 0, "clock64() - k0") + "\n"
     "  " + _add("g_k7", 7, "1") + "\n"
     "  for (int i = threadIdx.x; i < nt * BF; i += SH_NT7) {\n"),
    ("  stage_phi<BF, LDP, SH_NT8>(Ps, phre, phim, D2, F, f0);\n",
     "  const long long k0 = clock64();\n"
     "  stage_phi<BF, LDP, SH_NT8>(Ps, phre, phim, D2, F, f0);\n"),
    ("  const int ns = Ns[nh];\n",
     "  const int ns = Ns[nh];\n"
     "  " + _add("g_k8", 1, "clock64() - k0") + "\n"),
    ("  for (int k = 0; k < ns; ++k) {\n"
     "    cp_async_wait<SH_R - 2>();\n    bar_group(1 + nh);\n",
     "  for (int k = 0; k < ns; ++k) {\n"
     "    const long long c0 = clock64();\n"
     "    cp_async_wait<SH_R - 2>();\n    bar_group(1 + nh);\n"
     "    const long long c1 = clock64();\n"),
    ("    const unsigned e = steps[k];\n"
     "    if (k == 0 || steps[k - 1] >> 20 != e >> 20) {  // T at fa + 8h, the\n",
     "    const long long c2 = clock64();\n"
     "    const unsigned e = steps[k];\n"
     "    if (k == 0 || steps[k - 1] >> 20 != e >> 20) {  // T at fa + 8h, the\n"),
    ("    const unsigned ls = lb + (k % SH_R) * STG * 2;\n",
     "    const long long c3 = clock64();\n"
     "    const unsigned ls = lb + (k % SH_R) * STG * 2;\n"),
    ("        mma_bf16(aci[i], si, b0, b1);\n      }\n  }\n"
     "  cp_async_wait<0>();\n",
     "        mma_bf16(aci[i], si, b0, b1);\n      }\n"
     "    " + _add("g_k8", 2, "c1 - c0") + "\n"
     "    " + _add("g_k8", 3, "c2 - c1") + "\n"
     "    " + _add("g_k8", 4, "c3 - c2") + "\n"
     "    " + _add("g_k8", 5, "clock64() - c3") + "\n"
     "    " + _add("g_k8", 6, "1") + "\n"
     "  }\n  cp_async_wait<0>();\n"
     "  " + _add("g_k8", 0, "clock64() - k0") + "\n"
     "  " + _add("g_k8", 7, "1") + "\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int dip_cycles(unsigned long long* h, int reset) {\n"
     "  if (reset) {\n"
     f"    const unsigned long long z[{N7}] = {{}};\n"
     "    cudaMemcpyToSymbol(g_k7, z, sizeof z);\n"
     "    return cudaMemcpyToSymbol(g_k8, z, sizeof z);\n"
     "  }\n"
     f"  cudaMemcpyFromSymbol(h, g_k7, sizeof(unsigned long long) * {N7});\n"
     f"  return cudaMemcpyFromSymbol(h + {N7}, g_k8,\n"
     f"                              sizeof(unsigned long long) * {N8});\n"
     "}\n"),
]


def build():
    from dip_admm_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "shear_sum.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(
                f"anchor not found once in shear_sum.cu: {old!r}")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "build", "profile")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "shear_sum_k78.cu"), os.path.join(
        out, "libshear_sum_k78.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES["shear_sum"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.dip_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def profile(lib, kern, args, calls=10):
    """Runs ``kern`` (K7 or K8 of shear_sum.py) on ``args`` through ``lib``,
    to which the wrappers' bound entries point for these calls; returns (K7
    line, K8 line) of the counters of these calls."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    entries = (ss._SHEAR_PLANES, ss._SHEAR_PLANES_T, ss._SHEAR_SCRATCH)
    bound = [e._c for e in entries]
    for e in entries:
        e._c = getattr(lib, e.fn)
    try:
        kern(*args)
        torch.cuda.synchronize()
        lib.dip_cycles(None, 1)
        for _ in range(calls):
            kern(*args)
        torch.cuda.synchronize()
    finally:
        for e, c in zip(entries, bound):
            e._c = c
    h = (ctypes.c_ulonglong * (N7 + N8))()
    lib.dip_cycles(ctypes.addressof(h), 0)
    k7, k8 = h[:N7], h[N7:]
    k, tag = (k7, "k7") if k7[7] else (k8, "k8")
    b, n = max(k[7], 1), max(k[6], 1)
    phases = (("wait", "issue", "mma", "phi") if tag == "k7" else
              ("wait", "issue", "s_formation", "mma"))
    return (f"blocks={b // calls} cycles_per_block={k[0] / b:.0f} "
            f"prologue={k[1] / b:.0f} steps_per_block={n / b:.1f} "
            "cycles_per_step: " + " ".join(
                f"{ph}={k[2 + i] / n:.0f}" for i, ph in enumerate(phases)))


def main() -> int:
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    if not torch.cuda.is_available():
        print("torch_shear_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    for N in (256, 512):
        _, t = cs._tables_at(torch, dev, "bfloat16", N, "fft_shear")
        P = t["Wt"].shape[0]
        for name, kern, _, args in cs._shear_cases(torch, dev, t, P, gen):
            print(f"{name} {N}^2/8: {profile(lib, kern, args)}", flush=True)
        del t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
