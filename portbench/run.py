"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: load the cell's kernel libraries (built on a checkout's first run
into ``build/kernels/``), make the inputs from the seed on the device,
build the problem and warm its shapes with one 2-outer reconstruction.
The window: reconstructions back to back, one caller, from the first
timed one to the end of the last one that started before ``--seconds``
had passed; every rate is over all of that span. With ``--trace 1`` a
few whole reconstructions run under the profiler instead, and the
per-layer metrics are read. Either way a sample of the window's
reconstructions, drawn from the seed, is then held to the plain
reference, and the last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel and compile caches of the run stay inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# Modules that must not be loaded in the process that prints the result.
FORBIDDEN = ("jax", "jaxlib", "flax", "dip_admm_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What the traced run gathered, for the per-layer readers of
    ``metrics/``; the costlier measurements run when a reader asks."""

    def __init__(self, program, trace, image_outers, counters, build_s,
                 kernel_load_s, device):
        self.program, self.trace = program, trace
        self.image_outers, self.counters = image_outers, counters
        self.build_s, self.kernel_load_s = build_s, kernel_load_s
        self.device = device
        self._pair = self._calls = None

    def _images(self):
        from portbench import inputs

        p = self.program
        return 100.0 * inputs.normal((len(p.scales) * p.P, p.n), p.seed, 4,
                                     device=self.device)

    def pair_ms(self) -> float:
        import torch

        if self._pair is None:
            imgs = self._images()
            for _ in range(3):
                self.program.apply_pair(imgs)
            torch.cuda.synchronize(self.device)
            times = []
            for _ in range(20):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                self.program.apply_pair(imgs)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            self._pair = statistics.median(times)
        return self._pair

    def kernel_calls(self) -> list | None:
        """Each kernel wrapper call of one apply pair: {"name", "role",
        "ms", "bound_ms", "by"}. The ms are the device's: the pair's calls
        are replayed REPS times on the arguments they had, each call after
        a write that flushes the L2 cache and between two CUDA events, all
        queued behind a sleep kernel so that no host time falls between
        the events; each call's ms is the median of its REPS. None where
        the queue ran dry before every call was queued."""
        import torch

        from portbench import program, roofline

        if self._calls is not None:
            return self._calls or None
        counts = kernel_wrappers()
        imgs = self._images()
        calls = program.capture_calls({k: v[1] for k, v in counts.items()},
                                      lambda: self.program.apply_pair(imgs))
        ms = _held_ms([(counts[name][1], args, kwargs)
                       for name, args, kwargs, _ in calls], self.device)
        pk = roofline.peaks(torch.cuda.get_device_name(self.device))
        out = []
        for (name, args, kwargs, res), t in zip(calls, ms or []):
            mod = counts[name][0]
            bound, by = (None, None) if pk is None else roofline.bound_ms(
                *mod.work(args, kwargs, res), pk)
            out.append({"name": name, "role": mod.ROLE, "ms": t,
                        "bound_ms": bound, "by": by})
        self._calls = out
        return out or None


# Replays of a pair's kernel calls, and the bytes written to flush the L2
# cache (50 MiB on an H100) before each call.
REPS, FLUSH_BYTES = 10, 256 << 20
# Cycles of the first sleep that holds the queue (about 0.1 s at 2 GHz);
# it is made four times longer while the host falls behind it.
SLEEP_CYCLES = 2 * 10**8


def _held_ms(calls: list, device) -> list | None:
    """The device's ms of each call (fn, args, kwargs): the median over
    REPS replays of the sequence, each call timed between CUDA events
    behind an L2 flush, the whole queued behind ``torch.cuda._sleep``."""
    import torch

    if not calls:
        return None
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def replay(events=None):
        for i, (fn, args, kwargs) in enumerate(calls):
            flush.zero_()
            if events is not None:
                events[2 * i].record()
            fn(*args, **kwargs)
            if events is not None:
                events[2 * i + 1].record()

    for _ in range(3):
        replay()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        ev = [[torch.cuda.Event(enable_timing=True)
               for _ in range(2 * len(calls))] for _ in range(REPS)]
        torch.cuda.synchronize(device)
        torch.cuda._sleep(cycles)
        held = torch.cuda.Event()
        held.record()
        for events in ev:
            replay(events)
        dry = held.query()
        torch.cuda.synchronize(device)
        if not dry:
            return [statistics.median(e[2 * i].elapsed_time(e[2 * i + 1])
                                      for e in ev)
                    for i in range(len(calls))]
        cycles *= 4
    return None


def kernel_wrappers() -> dict:
    """{name: (count module, the program's wrapper)} for each file of
    ``counts/``; a wrapper the program lacks raises."""
    out = {}
    for f in sorted((ROOT / "portbench" / "counts").glob("[!_]*.py")):
        mod = importlib.import_module(f"portbench.counts.{f.stem}")
        mname, fname = mod.WRAPPER.split(":")
        out[f.stem] = (mod, getattr(importlib.import_module(mname), fname))
    return out


def _sample(rng: random.Random, kept: list, k: int, item: dict, seen: int):
    """Reservoir sampling of k reconstructions out of those seen."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(seen)
        if j < k:
            kept[j] = item


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             log=print) -> dict:
    """One run of a cell (``spec`` as ``portbench.spec.cell`` gives it) on
    ``device``; returns the result object. ``log`` takes the lines for
    standard error."""
    import torch

    from portbench import check, inputs, program
    from portbench.program import sync

    conf, mix = spec["config"], spec["mix"]
    t_start = time.perf_counter()
    kernel_load_s = program.load_kernels(
        conf["libraries"] if device.type == "cuda" else [])
    t_kernels = time.perf_counter()
    prog = program.Program(conf, mix, seed, device)
    t_problem = time.perf_counter()
    warm_cfg = program.port_config(conf, mix, max_iters=2).admm
    prog.reconstruct(0, warm_cfg)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = random.Random(inputs.stream(seed, 5))
    k = 1  # reconstructions held to the reference
    kept, psnrs, finite, outers = [], [], [], []
    notes, res, ctx = {}, None, None
    t0 = time.perf_counter()
    setup_s = t0 - T_PROCESS
    notes["setup_parts"] = {
        "imports": t_start - T_PROCESS, "kernel_load": kernel_load_s,
        "inputs_and_build": t_problem - t_kernels, "build": prog.build_s,
        "warm_reconstruction": t0 - t_problem}
    if trace:
        n_tr = int(mix["trace"]["recons"])
        one = time.perf_counter()
        for r in range(1, 1 + n_tr):
            prog.reconstruct(r)
        sync(device)
        untraced_s = time.perf_counter() - one
        program.reset_launch_counts()
        done = []

        def window():
            for r in range(1 + n_tr, 1 + 2 * n_tr):
                done.append(prog.reconstruct(r))

        from portbench import tracing

        w0 = time.perf_counter()
        tr = tracing.traced(window, device, untraced_s) \
            if device.type == "cuda" else window()
        counters = program.launch_counts()
        for i, res in enumerate(done):
            _sample(rng, kept, k, res, i + 1)
            outers.append(res["outers"])
            finite.append(torch.isfinite(res["x"]).flatten(1).all(1))
        done.clear()
        window_s = tr.window_s if tr else time.perf_counter() - w0
        notes["untraced_s"] = untraced_s
        notes["profiler_overhead"] = window_s / untraced_s - 1.0
        notes["counters_per_outer"] = {
            name: c / max(1, int(sum(int(o) for o in outers)))
            for name, c in counters.items() if c}
        if tr is not None:
            notes["trace_launches"] = {
                "made": tr.launches, "unrecorded": tr.unrecorded,
                "counted": sum(counters.values())}
    else:
        n, last, recon_s = 0, t0, []
        while True:
            res = prog.reconstruct(n + 1)
            sync(device)
            n += 1
            now = time.perf_counter()
            recon_s.append(now - last)
            last = now
            psnrs.append(res["psnr"])
            finite.append(torch.isfinite(res["x"]).flatten(1).all(1))
            outers.append(res["outers"])
            _sample(rng, kept, k, res, n)
            if now - t0 >= seconds:
                break
        window_s = last - t0
        notes["recon_s"] = recon_s
    image_outers = int(sum(int(o) for o in outers))
    attempted = len(outers) * len(prog.scales)
    failed = int(sum(int((~f).sum()) for f in finite))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics, device_info, breakdown = {}, {}, None
    if trace:
        ctx = Context(prog, tr, image_outers, counters, prog.build_s,
                      kernel_load_s, device)
        for m in spec["per_layer"]:
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(ctx) if tr is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        if ctx._calls:
            notes["kernel_calls"] = ctx._calls
    else:
        ps = torch.cat([p.reshape(-1) for p in psnrs]).cpu()
        values = {"recon_it_per_s": image_outers / window_s,
                  "psnr_db": float(ps.mean()), "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    notes.update(window_s=window_s, recons=len(outers),
                 image_outers=image_outers,
                 sampled=[s["r"] for s in kept])

    # The check: the program's state is freed first, so that the
    # reference sets no peak and has the card's memory.
    samples = [{"r": s["r"], "x": s["x"], "Z": s["Z"]} for s in kept]
    del kept, prog, res, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers = check.compare(samples, conf, mix, seed, device)
    notes["check_s"] = time.perf_counter() - c0
    notes["numbers"] = numbers
    correct, checked = check.verdict(numbers, spec["limits"])
    for name, v in checked.items():
        log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    props = {"platform": "gpu" if device.type == "cuda" else "cpu",
             "kind": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
             "count": 1, "memory_peak_bytes": peak, **device_info}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": props, "notes": notes}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(line):
        print(line, file=sys.stderr, flush=True)

    try:
        import torch
    except ImportError:
        log("portbench: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("portbench: no CUDA device; the benchmark runs on the card only")
        return 2
    try:
        from portbench import spec
        cell = spec.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        log(f"portbench: {e}")
        return 2
    chips = int(cell["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    try:
        import dip_admm_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"portbench: cannot import the program ({e}); run from the root "
            "of a checkout")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, log)
    except RuntimeError as e:
        log(f"portbench: {e}")
        return 1
    # Everything this process runs has run: the check, the readers and
    # the modules they loaded.
    leaked = forbidden_modules()
    if leaked:
        log(f"portbench: forbidden modules loaded: {leaked}")
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
