#!/usr/bin/env python3
"""What a call of K5 (both forms, both fusions), K17 and K18 costs on one
GPU and its host, for comparing two checkouts in one call on one card: the
repo's one tool for a wrapper's per-call cost across checkouts and its host
split (``chip_smoke.py`` prints the same per-call figures for its own
checkout).

    python3 scripts/torch_call_cost.py ROOT [--split]

From the checkout at ROOT (its own kernels, built from its ``csrc/``), on
seeded inputs at the main-path shapes (K5: the 256^2/8 edge state [8, 8,
65536], its sharded form at a 2 x 2 mesh rank's block [4, 8, 32768], and
where the checkout's K5 takes a batch, a batch of four [4, 8, 8, 65536]; K17
and K18: the 512^2/8 eval tail, PB = PT = 8, T = 192, D = 512, Np = 2048,
rising and falling detector coordinates; both also at D = 509 with
coordinates below 0, above Np - 1 and NaN), one line a kernel:

- ``call_ms``: the median of 20 CUDA-event timings of one call after 3
  warm-ups (``chip_smoke._time_ms``);
- ``host_us_per_call``: the host's wall clock over 200 back-to-back calls
  with no sync between them, over 200 (one sync after, as
  ``chip_smoke._host_us``); where the host is slower than the device, the
  host's cost of a call;
- ``device_ms`` and ``device_launches_per_call`` (``torch.profiler`` over
  10 calls, ``chip_smoke._device_ms``);
- ``sha1``: a hash of each output's bytes (two checkouts' kernels agree bit
  for bit on an output where its hashes are equal), and ``equal_plain``:
  whether each output equals the plain version's bit for bit (NaN where it
  is NaN). K17 is also held bit for bit to its formula evaluated in torch
  with the second tap's product and sum rounded apart
  (``formula_equal_mul_add``) and fused (``formula_equal_fma``, the product
  exact in f64). K17 and K18 print their NaN outputs beside the plain
  version's (``nan_outputs``, ``plain_nan_outputs``).

With ``--split`` (a checkout whose ``ops/kernels/_launch.py`` holds the
wrappers' helpers), the host's cost of each step of the K17, K18 and K5
wrappers, as their first designs took them and as the lean launch path
takes them (checks, allocations,
``_build.load`` and attribute lookup, the pointers and stream, the ctypes
call alone on a C function that returns at once, the launch alone of an
empty kernel), in microseconds a call, and K17's and K18's whole wrappers
both ways, each the median of 7 rounds that time the two ways in turns. The empty
functions are built with nvcc into ``build/call_cost/``. Alternate the
checkouts, e.g. with the parent unpacked by ``git archive`` into
``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_call_cost.py $PWD/$r; done
"""

import ctypes
import hashlib
import os
import statistics
import subprocess
import sys
import time

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(ARGS[0]) if ARGS else os.getcwd()
SPLIT = "--split" in sys.argv
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SPLIT_CALLS = 2000
ROUNDS = 7


def host_us(fn, calls=200) -> float:
    """``chip_smoke._host_us``, kept here because a parent checkout's
    ``chip_smoke.py`` may predate it: the host's wall clock of ``calls``
    back-to-back calls over ``calls``, in microseconds; one sync after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def _sha1(outs) -> list:
    """A hash of each output's bytes."""
    return [hashlib.sha1(o.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes()).hexdigest()[:12] for o in outs]


def _hat_inputs(gen, PB, PT, T, D, Np, edge=False):
    """pc [PT, T, D]: affine detector coordinates inside [0, Np), rising
    along d, falling in every other row; with ``edge`` a fifth of them
    below 0 or above Np - 1 and a few NaN. s [PT, T, 1], g, ob."""
    dev = "cuda"
    slope = 0.5 + 0.5 * torch.rand((PT, T, 1), generator=gen, device=dev)
    d = torch.arange(D, device=dev, dtype=torch.float32) - D / 2
    pc = Np / 2 + slope * d + 3 * torch.rand((PT, T, 1), generator=gen,
                                             device=dev)
    pc[:, ::2] = pc[:, ::2].flip(-1)
    if edge:
        pick = torch.rand((PT, T, D), generator=gen, device=dev)
        pc = torch.where(pick < 0.1, -pc / Np - 0.5, pc)
        pc = torch.where(pick > 0.9, pc + Np, pc)
        pc[..., 7::97] = float("nan")
    s = 0.5 + torch.rand((PT, T, 1), generator=gen, device=dev)
    g = torch.randn((PB, T, Np), generator=gen, device=dev)
    ob = torch.randn((PB, T, D), generator=gen, device=dev)
    return pc.contiguous(), s, g, ob


def hat_formula(g, pc, s, fused: bool):
    """K17's arithmetic in torch: v0 = floor(pc), the taps v0 and v0 + 1
    inside [0, Np) in that order, hat(x, v) = max(0, 1 - |x - v|) in f32,
    s after the sum; the second tap's term added to the first rounded apart
    or, with ``fused``, as one fused multiply-add (the product exact in
    f64, one rounding of the sum). A NaN coordinate gives NaN."""
    PB, T, Np = g.shape
    x = pc.repeat(PB // pc.shape[0], 1, 1)
    fl = torch.floor(x)
    ok = (fl >= -1) & (fl < Np)
    v0 = torch.where(ok, fl, torch.zeros_like(fl))
    acc = torch.zeros_like(x)
    for k in (0, 1):
        v = v0 + k
        live = ok & (v >= 0) & (v < Np)
        h = torch.clamp(1.0 - torch.abs(x - v), min=0.0)
        gv = torch.gather(g, 2, v.long().clamp(0, Np - 1))
        if fused:
            new = (h.double() * gv.double() + acc.double()).float()
        else:
            new = acc + h * gv
        acc = torch.where(live, new, acc)
    acc = torch.where(torch.isnan(x), x, acc)
    return s.repeat(PB // pc.shape[0], 1, 1) * acc


def _same(u, v) -> bool:
    """Bit-equal values, NaN where the other is NaN."""
    return (torch.equal(torch.isnan(u), torch.isnan(v))
            and torch.equal(u.nan_to_num(), v.nan_to_num()))


def cases():
    """(label, kernel, plain, args, kwargs) at the main-path shapes."""
    from dip_admm_tpu_torch.ops.kernels import consensus as cons
    from dip_admm_tpu_torch.ops.kernels import hat_eval as he

    gen = torch.Generator(device="cuda").manual_seed(0)
    P, n = 8, 65536
    a, y, z = (torch.randn((P, P, n), generator=gen, device="cuda")
               for _ in range(3))
    adjm = (torch.rand((P, P), generator=gen, device="cuda") > 0.5).float()
    adjm = torch.maximum(adjm, adjm.T).fill_diagonal_(0.0)
    w = torch.rand((P, n), generator=gen, device="cuda") + 0.1
    rows, cols = slice(P // 2, P), slice(n // 2, n)
    blk = [v[rows][..., cols].contiguous()
           for v in (a, y, z, a.transpose(0, 1))]
    m_blk = adjm[rows].contiguous()
    w_own, w_all = w[rows, cols].contiguous(), w[:, cols].contiguous()
    out = []
    for fusion in ("midpoint", "weighted"):
        out.append((f"consensus_update[{fusion}]", cons.consensus_update,
                    cons.consensus_update_ref, (a, y, z, adjm, w, fusion),
                    {}))
        kw = dict(fusion=fusion, a_t=blk[3], w_own=w_own, w_all=w_all)
        out.append((f"consensus_update_sharded[{fusion}]",
                    cons.consensus_update, cons.consensus_update_ref,
                    (*blk[:3], m_blk), kw))
    from dip_admm_tpu_torch.ops.kernels import _build
    if len(_build.SIGNATURES["consensus"]["dip_consensus"]) == 14:
        # a checkout whose K5 takes a batch count: the batched_256 phase's
        # [4, 8, 8, 65536] edge state (its own generator, so that the
        # other cases' inputs are the same in every checkout)
        gb = torch.Generator(device="cuda").manual_seed(1)
        ab, yb, zb = (torch.randn((4, P, P, n), generator=gb, device="cuda")
                      for _ in range(3))
        out.append(("consensus_update[batch 4, midpoint]",
                    cons.consensus_update, cons.consensus_update_ref,
                    (ab, yb, zb, adjm, None, "midpoint"), {}))
    pc, s, g, ob = _hat_inputs(gen, 8, 8, 192, 512, 2048)
    out.append(("hat_eval", he.hat_eval, he.hat_eval_ref, (g, pc, s), {}))
    out.append(("hat_eval_t", he.hat_eval_t, he.hat_eval_t_ref,
                (ob, pc, s, 2048), {}))
    pc, s, g, ob = _hat_inputs(gen, 8, 8, 192, 509, 2048, edge=True)
    out.append(("hat_eval[D=509, edges]", he.hat_eval, he.hat_eval_ref,
                (g, pc, s), {}))
    out.append(("hat_eval_t[D=509, edges]", he.hat_eval_t,
                he.hat_eval_t_ref, (ob, pc, s, 2048), {}))
    return out


def measure() -> None:
    for label, kern, ref, args, kw in cases():
        def call():
            return kern(*args, **kw)

        got = call()
        got = got if isinstance(got, tuple) else (got,)
        want = ref(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        extra = ""
        if label.startswith("hat_eval"):
            extra = (f"nan_outputs={int(torch.isnan(got[0]).sum())} "
                     f"plain_nan_outputs={int(torch.isnan(want[0]).sum())} ")
        if label.startswith("hat_eval") and not label.startswith("hat_eval_t"):
            extra += " ".join(
                f"formula_equal_{k}={_same(got[0], hat_formula(*args, f))}"
                for k, f in (("mul_add", False), ("fma", True)))
        equal = [_same(u, v) for u, v in zip(got, want)]
        digest = _sha1(got)
        del got, want
        ms = cs._time_ms(torch, call)
        hu = host_us(call)
        dev_ms, by, launches = cs._device_ms(torch, call)
        print(f"call_cost: {label} call_ms={ms} host_us_per_call={hu} "
              f"device_ms={dev_ms} device_launches_per_call={launches} "
              f"sha1={','.join(digest)} equal_plain={equal} {extra} by_kernel={by}",
              flush=True)


# ---------------------------------------------------------------------------
# The host split
# ---------------------------------------------------------------------------

# (name, pointers before the ints, ints): the C entries' argument lists of
# the first designs of K17 (dip_hat_fwd, 10 arguments) and K5
# (dip_consensus, 15; dip_consensus_sharded, 18) and of the lean ones
# (dip_consensus, 14 with its batch count; dip_consensus_sharded, 16), each
# ending in the stream.
NOOPS = (("noop_hat", 4, 5), ("noop_cons_old", 10, 4),
         ("noop_cons_sharded_old", 12, 5), ("noop_cons", 9, 4),
         ("noop_cons_sharded", 11, 4))


def _noop_lib():
    from dip_admm_tpu_torch.ops.kernels import _build

    src = ["#include <cuda_runtime.h>",
           "__global__ void empty_kernel() {}",
           'extern "C" int launch_empty(int blocks, void* stream) {',
           "  empty_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>();",
           "  return (int)cudaGetLastError();", "}"]
    for name, n_p, n_i in NOOPS:
        params = ([f"void* p{k}" for k in range(n_p)]
                  + [f"int i{k}" for k in range(n_i)] + ["void* stream"])
        src.append(f'extern "C" int {name}({", ".join(params)}) '
                   "{ return 0; }")
    out = os.path.join(ROOT, "build", "call_cost")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "noop.cu"), os.path.join(out, "libnoop.so")
    with open(cu, "w") as f:
        f.write("\n".join(src) + "\n")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, n_p, n_i in NOOPS:
        getattr(lib, name).argtypes = [P] * n_p + [I] * n_i + [P]
    lib.launch_empty.argtypes = [I, P]
    return lib


def per_call_us(fn, calls=SPLIT_CALLS) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e6 * (time.perf_counter() - t0) / calls


def interleaved(fns: dict, time_one=per_call_us) -> dict:
    """The median over ROUNDS of ``time_one(fn)`` for each fn of ``fns``,
    the fns timed in turns, so that a drift of the host's speed falls on
    all of them alike."""
    res = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, fn in fns.items():
            res[k].append(time_one(fn))
    return {k: statistics.median(v) for k, v in res.items()}


def split() -> None:
    """The host's cost of each step of the K17, K18 and K5 wrappers, as the
    first design took them and as the lean path takes them, timed in turns;
    and K17's and K18's whole wrappers both ways (the C entries are the
    same)."""
    from dip_admm_tpu_torch.ops.kernels import _build
    from dip_admm_tpu_torch.ops.kernels import consensus as cons
    from dip_admm_tpu_torch.ops.kernels import hat_eval as he
    from dip_admm_tpu_torch.ops.kernels._launch import (
        _batches, _check, _raise_if, _shape, _stream,
    )

    lib = _noop_lib()
    st = _stream()
    gen = torch.Generator(device="cuda").manual_seed(0)
    PB, PT, T, D, Np = 8, 8, 192, 512, 2048
    pc, s, g, ob = _hat_inputs(gen, PB, PT, T, D, Np)
    P, n = 8, 65536
    a, y, z = (torch.randn((P, P, n), generator=gen, device="cuda")
               for _ in range(3))
    adjm = torch.ones((P, P), device="cuda")

    def on_cpu(t):  # the first designs' device test
        if t.device.type == "cpu":
            return True
        if t.device.type != "cuda":
            raise ValueError(t.device)
        return False

    def hat_checks(name, x, last):  # the first K17/K18 wrappers' checks
        on_cpu(x)
        PT_, T_, D_ = pc.shape
        _shape(name, s, (PT_, T_, 1), "s")
        PB_ = x.shape[0]
        k = "g" if name == "hat_eval" else "ob"
        _check(name, {k: x, "pc": pc, "s": s}, x.device, torch.float32)
        _batches(name, PB_, PT_)
        _shape(name, x, (PB_, T_, last), k)
        if name == "hat_eval_t" and he._row_smem(D_, Np) > he._MAX_SMEM:
            raise ValueError(name)
        return PB_, PT_, T_, D_

    def hat_first(name, x, width):  # the first K17/K18 wrapper, step for step
        PB_, PT_, T_, D_ = hat_checks(name, x, x.shape[-1])
        o = torch.empty((PB_, T_, width), dtype=torch.float32,
                        device=x.device)
        fn = getattr(_build.load("hat_eval"),
                     "dip_hat_fwd" if name == "hat_eval" else "dip_hat_t")
        _raise_if(fn(*(t.data_ptr() for t in (x, pc, s, o)), PB_, PT_, T_,
                     D_, Np, _stream()), name)
        return o

    def cons_checks():  # the first K5 wrapper's, midpoint, single device
        on_cpu(a)
        P_loc, P_, n_ = a.shape
        tensors = dict(a=a, y=y, z=z, adjm=adjm)
        shapes = dict(a=(P_loc, P_, n_), y=(P_loc, P_, n_),
                      z=(P_loc, P_, n_), a_t=(P_loc, P_, n_),
                      adjm=(P_loc, P_), w=(P_, n_), w_own=(P_loc, n_),
                      w_all=(P_, n_))
        for k, t in tensors.items():
            if t.device != a.device:
                raise ValueError(k)
            if t.dtype != torch.float32:
                raise TypeError(k)
            if not t.is_contiguous():
                raise ValueError(k)
            if tuple(t.shape) != shapes[k]:
                raise ValueError(k)

    def cons_allocs():  # zn, yn, part, pri, dz2
        return (torch.empty_like(a), torch.empty_like(a),
                torch.empty((2, P * P, 32), dtype=torch.float32,
                            device=a.device),
                torch.empty((P, P), dtype=torch.float32, device=a.device),
                torch.empty((P, P), dtype=torch.float32, device=a.device))

    def hat_steps(name, x, width, lean_checks):
        out = x.new_empty((PB, T, width))
        entry = "dip_hat_fwd" if name == "hat_eval" else "dip_hat_t"
        ptrs = lambda: (*(t.data_ptr() for t in (x, pc, s, out)), _stream())
        ctypes_call = lambda: lib.noop_hat(1, 2, 3, 4, PB, PT, T, D, Np, st)
        return (
            ("checks", lambda: hat_checks(name, x, x.shape[-1]),
             lambda: (he._on_cpu(x), lean_checks())),
            ("allocs", lambda: torch.empty((PB, T, width),
                                           dtype=torch.float32,
                                           device=x.device),
             lambda: x.new_empty((PB, T, width))),
            ("load", lambda: getattr(_build.load("hat_eval"), entry), None),
            ("pointers", ptrs, ptrs),
            ("ctypes", ctypes_call, ctypes_call),
        )

    # (step, first design, lean path) for each wrapper; None: no such step.
    steps = {
        "hat_eval": hat_steps("hat_eval", g, D,
                              lambda: he._fwd_checks(g, pc, s)),
        "hat_eval_t": hat_steps("hat_eval_t", ob, Np,
                                lambda: he._t_checks(ob, pc, s, Np)),
        "consensus_update[midpoint]": (
            ("checks", cons_checks,
             lambda: (cons._on_cpu(a), cons._checks(
                 a, y, z, adjm, None, "midpoint", None, None, None))),
            ("allocs", cons_allocs,
             lambda: (torch.empty_like(a), torch.empty_like(a),
                      torch.empty_like(adjm), torch.empty_like(adjm))),
            ("allocs_two_and_unbind", None,
             lambda: (a.new_empty((2, P, P, n)).unbind(),
                      a.new_empty((2, P, P)).unbind())),
            ("load", lambda: getattr(_build.load("consensus"),
                                     "dip_consensus"), None),
            ("pointers",
             lambda: (*(t.data_ptr() for t in (a, y, z, adjm, a, a, a, adjm,
                                                adjm)), _stream()),
             lambda: (*(t.data_ptr() for t in (a, y, z, adjm, a, a, adjm,
                                                adjm)), _stream())),
            ("ctypes", lambda: lib.noop_cons_old(*range(1, 11), 8, 65536,
                                                 2048, 0, st),
             lambda: lib.noop_cons(*range(1, 10), 1, 8, 65536, 0, st)),
        ),
    }
    launch = interleaved({"one": lambda: lib.launch_empty(768, st)},
                         host_us)["one"]
    for name, rows in steps.items():
        first, lean = {}, {}
        for step, f_old, f_new in rows:
            fns = {k: f for k, f in (("first", f_old), ("lean", f_new)) if f}
            got = interleaved(fns)
            if f_old:
                first[step] = got["first"]
            if f_new:
                lean[step] = got["lean"]
        k5 = name.startswith("consensus")
        first["launch"] = 2 * launch if k5 else launch
        lean["launch"] = launch
        for design, v in (("first_design", first), ("lean", lean)):
            total = sum(u for k, u in v.items()
                        if k != "allocs_two_and_unbind")
            print(f"call_cost_split: {name} {design} " + " ".join(
                f"{p}_us={u}" for p, u in v.items()) + f" sum_us={total}",
                flush=True)
    for name, x, width, lean_call in (
            ("hat_eval", g, D, lambda: he.hat_eval(g, pc, s)),
            ("hat_eval_t", ob, Np, lambda: he.hat_eval_t(ob, pc, s, Np))):
        whole = interleaved({"first_design": lambda: hat_first(name, x,
                                                               width),
                             "lean": lean_call}, host_us)
        print(f"call_cost_split: {name} whole_wrapper_host_us " + " ".join(
            f"{k}={u}" for k, u in whole.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_call_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"call_cost: root={ROOT} gpu="
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    cs.phase_build()
    measure()
    if SPLIT and os.path.exists(os.path.join(
            ROOT, "dip_admm_tpu_torch", "ops", "kernels", "_launch.py")):
        split()
    return 0


if __name__ == "__main__":
    sys.exit(main())
