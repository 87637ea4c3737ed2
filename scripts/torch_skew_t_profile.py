#!/usr/bin/env python3
"""Where K2's tap product spends its cycles on the card.

    python3 scripts/torch_skew_t_profile.py

builds a copy of ``dip_admm_tpu_torch/csrc/shear_sum.cu`` with clock64
counters in the tensor-core tap product (``skew_tap_t_tc``) into
``build/profile/`` and runs ``dip_skew_t`` (bf16 tables) ten times at the
256^2/8 bench shapes, row shard 0 of 2 of a 2 x 2 mesh rank's node block
(K6), the fan shapes and fan row shard 0 of 2. For each it prints, from
thread 0 of every block: the tap stages a block runs, and per stage the
cycles spent waiting for its taps (cp.async wait and barrier), marking the
nonzero tiles (the next stage's loads issued, the ballot and its barrier)
and walking the MMAs of warp 0, the k16 steps that walk visits and the
nonzero (k16 step, 8 n) tiles it multiplies; and the cycles of a whole
block. The counters' own atomics add a little to each phase. The
repository's sources are not changed.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (anchor in the source, its replacement): the counters.
PATCHES = [
    ("constexpr int T2_FC = ",
     "__device__ unsigned long long g_cyc[8];\nconstexpr int T2_FC = "),
    ("  const int nunits = D2 * C8, spt = cdiv(nunits, UNITS);  // stages a tb\n",
     "  const int nunits = D2 * C8, spt = cdiv(nunits, UNITS);  // stages a tb\n"
     "  const long long k0 = clock64();\n"),
    ("    const int s = i % spt;\n",
     "    const int s = i % spt;\n    const long long c0 = clock64();\n"),
    ("    load_taps(i + T2_STAGES - 1);  // into the buffer computed at i - 1\n",
     "    const long long c1 = clock64();\n"
     "    load_taps(i + T2_STAGES - 1);  // into the buffer computed at i - 1\n"),
    ("    if (!active) continue;\n    unsigned long long mask = 0;",
     "    const long long c2 = clock64();\n"
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&g_cyc[0], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&g_cyc[1], (unsigned long long)(c2 - c1));\n"
     "      atomicAdd(&g_cyc[5], 1ull);\n"
     "    }\n"
     "    if (!active) continue;\n    unsigned long long mask = 0;"),
    ("      mask &= ~(JM << (NT8 * ks));\n",
     "      mask &= ~(JM << (NT8 * ks));\n"
     "      if (threadIdx.x == 0) {\n"
     "        atomicAdd(&g_cyc[6], 1ull);\n"
     "        atomicAdd(&g_cyc[7], (unsigned long long)__popc(bits));\n"
     "      }\n"),
    ("    }\n  }\n  cp_async_wait<0>();\n  __syncthreads();\n  // acc -> [n][u]",
     "    }\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(&g_cyc[2], (unsigned long long)(clock64() - c2));\n"
     "  }\n  cp_async_wait<0>();\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&g_cyc[3], (unsigned long long)(clock64() - k0));\n"
     "    atomicAdd(&g_cyc[4], 1ull);\n"
     "  }\n  // acc -> [n][u]"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int dip_cycles(unsigned long long* h, int reset) {\n"
     "  if (reset) {\n"
     "    const unsigned long long z[8] = {};\n"
     "    return cudaMemcpyToSymbol(g_cyc, z, sizeof z);\n"
     "  }\n"
     "  return cudaMemcpyFromSymbol(h, g_cyc, sizeof(unsigned long long) * 8);\n"
     "}\n"),
]


def build():
    from dip_admm_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "shear_sum.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in shear_sum.cu: {old!r}")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "build", "profile")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "shear_sum_cycles.cu"), os.path.join(
        out, "libshear_sum_cycles.so")
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


def cases(dev):
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.parallel.mesh import slice_tables

    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, fan in (("bench", False), ("fan", True)):
        cfg = cs._bench_cfg("bfloat16", fan_beam=fan)
        t = loader.build_problem(cfg, dev).fft_tables
        t = t["shared"]["par"] if fan else t
        P = cfg.geometry.num_nodes
        _, NB, _, Tp, nb = t["WtT"].shape
        g = [torch.randn((P, Tp, t["SEre"].shape[-1]), generator=gen,
                         device=dev) for _ in range(2)]
        sh = t["shared"]
        yield tag, (g, t["WtT"], t["SEre"], t["SEim"], sh["DreT"],
                    sh["DimT"], t["plane"], NB * nb)
        nodes = slice(None) if fan else slice(P // 2, P)
        loc = slice_tables(t, P, nodes, (0, 2))
        yield f"{tag} row shard 0 of 2", (
            [v[nodes].contiguous() for v in g], loc["WtT"], loc["SEre"],
            loc["SEim"], sh["DreT"], sh["DimT"], loc["plane"], NB * nb)


def profile(lib, case, dev, calls=10):
    g, WtT, SEre, SEim, DreT, DimT, plane, WS = case
    PT, NB, D2, Tp, nb = WtT.shape
    PB, TB = g[0].shape[0], plane.shape[1]
    F, WZ = DreT.shape
    scratch = torch.empty(lib.dip_skew_t_scratch(PB, TB, NB, Tp // TB, D2, WS,
                                                 F),
                          dtype=torch.bfloat16, device=dev)
    x2 = torch.empty((PB, 2, NB * nb, WS), device=dev)
    ptrs = [t.data_ptr() for t in (*g, WtT, SEre, SEim, DreT, DimT, plane,
                                   scratch, x2)]
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)

    def call():
        rc = lib.dip_skew_t(*ptrs, PB, PT, NB, D2, Tp, nb, TB, WS, WZ, F, 1,
                            stream)
        if rc:
            raise RuntimeError(f"dip_skew_t failed with error {rc}")

    call()
    torch.cuda.synchronize()
    lib.dip_cycles(None, 1)
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    h = (ctypes.c_ulonglong * 8)()
    lib.dip_cycles(ctypes.addressof(h), 0)
    blocks, stages = max(h[4], 1), max(h[5], 1)
    return (f"blocks={h[4] // calls} stages_per_block={h[5] / blocks} "
            f"cycles_per_stage: wait={h[0] / stages:.0f} "
            f"mark={h[1] / stages:.0f} mma_walk={h[2] / stages:.0f} "
            f"k16_steps_visited_per_stage={h[6] / stages:.2f} "
            f"nonzero_tiles_per_stage={h[7] / stages:.2f} "
            f"cycles_per_block={h[3] / blocks:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_skew_t_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
        flush=True)
    lib = build()
    for tag, case in cases(dev):
        print(f"skew_tap_t_tc {tag}: {profile(lib, case, dev)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
