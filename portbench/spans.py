"""The program's own spans and counters joined with the device trace.

``dip_admm_tpu_torch.utils.profiling`` records spans (the consensus loop's
outers, the node solve, the projector's calls, each host sync, the fcv
build) on the clock of ``torch.profiler``'s records. ``joined(ctx)`` runs
the mix's traced reconstructions once more, after the traced window, with
the recorder and the profiler both on, and puts down to the innermost span
open on the host:

- each device record, at the time of the host call that launched it
  (matched by correlation id);
- each host kernel-launch call, at its own time;
- each idle gap of the device, at the gap's start.

Time outside any span is ``none``: the harness's glue between and around
reconstructions. The join is trusted only where the clocks agree: the
share of ``sync`` spans that hold the host's runtime record of their own
copy or stream sync (``span_alignment``) must reach ALIGNED, and every
launch must have its device record. A program without the recorder gives
nothing to read.

    python3 -m portbench.spans --workload <cell> --seed <n>

runs the cell's ``--trace 1`` run with the join's notes, then one
reconstruction with the synchronizing calls reported, one under the
profiler with Python stacks, and the mix's traced reconstructions with
recording off and on in turns (the profiler off); the last line of
standard output is all of it as one JSON object, and a summary goes to
standard error.
"""

from __future__ import annotations

import bisect
import statistics
import time

# Host runtime calls that copy to or wait for the device.
SYNC_CALLS = ("cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize")
# The least share of sync spans that must hold their runtime record.
ALIGNED = 0.99
# Time outside every span.
NONE = "none"
# Traced windows the join runs at most, until one can be trusted, and the
# launches that pad each window inside the profiler's session.
TRIES, PAD = 4, 1024


def _launch_calls():
    from portbench.tracing import LAUNCH_CALLS

    return LAUNCH_CALLS


class Records:
    """The profiler's records of one window [t0, t1], on its epoch clock
    (ns): ``host`` [(start, end, name, correlation id)], the runtime calls
    made in it, and ``device`` [(start, end, name, correlation ids)], the
    records those calls launched (or, launched by none, that began in
    it)."""

    def __init__(self, device, host, t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        # The host start of each call, by correlation id.
        call_at = {h[3]: h[0] for h in host if h[3]}

        def inside(d):  # launched in the window, or run in it unlaunched
            at = [call_at[i] for i in d[3] if i in call_at]
            return t0 <= (at[0] if at else d[0]) <= t1

        self.host = sorted(h for h in host if t0 <= h[0] <= t1)
        self.device = sorted(d for d in device if inside(d))
        self.call_at = {h[3]: h[0] for h in self.host if h[3]}
        launch = set(_launch_calls())
        self.launches = [h for h in self.host if h[2] in launch]
        recorded = set()
        for d in self.device:
            recorded.update(d[3])
        # Launch calls whose device record the trace lacks.
        self.lost = [h for h in self.launches if h[3] not in recorded]
        self.unrecorded = len(self.lost)

    @classmethod
    def from_events(cls, events, t0: int, t1: int) -> "Records":
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in events:
            a = e.start_ns()
            rec = (a, a + e.duration_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                ids = {e.correlation_id(), e.linked_correlation_id()} - {0}
                dev.append(rec + (tuple(sorted(ids)),))
            else:
                host.append(rec + (e.correlation_id(),))
        return cls(dev, host, t0, t1)

    def complete(self) -> bool:
        """Every kernel launch has its device record."""
        return bool(self.launches) and self.unrecorded == 0

    def launched_at(self, rec) -> int | None:
        """The host time of the call that launched device record ``rec``."""
        for i in rec[3]:
            if i in self.call_at:
                return self.call_at[i]
        return None

    def busy(self) -> list:
        """The union of the device's intervals, clipped to the window."""
        out = []
        for a, b, *_ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def gaps(self) -> list:
        """[(start, end)] of the window's idle time."""
        out, end = [], self.t0
        for a, b in self.busy():
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            out.append((end, self.t1))
        return out


def innermost(spans, times) -> list:
    """For each time, the innermost of ``spans`` (profiling.Span records,
    properly nested) open at it ([t0, t1)), or None."""
    bounds = []
    for s in spans:
        bounds.append((s.t0_ns, 1, s.id, s))
        bounds.append((s.t1_ns, 0, -s.id, s))
    bounds.sort(key=lambda b: b[:3])
    order = sorted(range(len(times)), key=lambda i: times[i])
    out, stack, j = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while j < len(bounds) and bounds[j][0] <= t:
            _, opens, _, s = bounds[j]
            if opens:
                stack.append(s)
            else:
                k = len(stack) - 1
                while k >= 0 and stack[k] is not s:
                    k -= 1
                if k >= 0:
                    del stack[k]
            j += 1
        out[i] = stack[-1] if stack else None
    return out


class Joined:
    """One traced window's records joined with the spans and counts the
    program recorded in it. ``image_outers``: the window's image-outers
    (a batch of B counts B an outer); ``untraced_s``: the host seconds of
    as many reconstructions with the profiler off, ``device_idle_pct``'s
    base."""

    def __init__(self, records: Records, spans, counts: dict,
                 image_outers: int, untraced_s: float):
        self.records, self.counts = records, dict(counts)
        self.spans = sorted(spans, key=lambda s: s.id)
        self.image_outers, self.untraced_s = image_outers, untraced_s
        self.by_id = {s.id: s for s in self.spans}
        r = records
        self._dev_spans = innermost(
            self.spans, [r.launched_at(d) or d[0] for d in r.device])
        self._launch_spans = innermost(self.spans, [h[0] for h in r.launches])
        self.gaps = r.gaps()
        self._gap_spans = innermost(self.spans, [g[0] for g in self.gaps])
        self.attempts: list = []  # the windows run to get this one

    # -- the span tree ----------------------------------------------------
    def chain(self, s) -> list:
        """The names from ``s`` up to its root, innermost first."""
        out = []
        while s is not None:
            out.append(s.name)
            s = self.by_id.get(s.parent)
        return out

    def path(self, s) -> str:
        return NONE if s is None else "/".join(reversed(self.chain(s)))

    def alignment(self) -> float | None:
        """The share of sync spans holding a runtime copy or stream-sync
        record; None without sync spans."""
        syncs = [s for s in self.spans if s.name == "sync"]
        if not syncs:
            return None
        calls = sorted(h[0] for h in self.records.host
                       if h[2] in SYNC_CALLS)
        held = 0
        for s in syncs:
            i = bisect.bisect_left(calls, s.t0_ns)
            held += i < len(calls) and calls[i] <= s.t1_ns
        return held / len(syncs)

    def sync_misses(self, top: int = 10) -> list:
        """Up to ``top`` sync spans without their runtime record: [site,
        span us, us from the span's start to the nearest such record]."""
        calls = sorted(h[0] for h in self.records.host
                       if h[2] in SYNC_CALLS)
        out = []
        for s in self.spans:
            if s.name != "sync":
                continue
            i = bisect.bisect_left(calls, s.t0_ns)
            if i < len(calls) and calls[i] <= s.t1_ns:
                continue
            near = [calls[k] - s.t0_ns for k in (i - 1, i)
                    if 0 <= k < len(calls)]
            out.append([s.attrs.get("site"), 1e-3 * (s.t1_ns - s.t0_ns),
                        1e-3 * min(near, key=abs) if near else None])
        return out[:top]

    def trusted(self) -> bool:
        a = self.alignment()
        return self.records.complete() and a is not None and a >= ALIGNED

    # -- attributions -----------------------------------------------------
    @staticmethod
    def _add(by: dict, key: str, v) -> None:
        by[key] = by.get(key, 0) + v

    def idle_by_span(self) -> dict:
        """Idle seconds by the innermost span open at each gap's start."""
        by: dict = {}
        for (a, b), s in zip(self.gaps, self._gap_spans):
            self._add(by, NONE if s is None else s.name, 1e-9 * (b - a))
        return by

    def device_by_span(self, key=None) -> dict:
        """Device seconds (self time) by the innermost span open when each
        record was launched; ``key(span)`` names the span (its name)."""
        key = key or (lambda s: NONE if s is None else s.name)
        by: dict = {}
        for d, s in zip(self.records.device, self._dev_spans):
            self._add(by, key(s), 1e-9 * (d[1] - d[0]))
        return by

    def lost_by_span(self) -> dict:
        """{"<span> <call>": n} of the launches that lack a device record."""
        by: dict = {}
        lost = self.records.lost
        for h, s in zip(lost, innermost(self.spans, [h[0] for h in lost])):
            self._add(by, f"{NONE if s is None else s.name} {h[2]}", 1)
        return by

    def launches_by_span(self) -> dict:
        by: dict = {}
        for s in self._launch_spans:
            self._add(by, NONE if s is None else s.name, 1)
        return by

    def device_ops_by_path(self, top: int = 12) -> list:
        """The ``top`` device operations by time, each split by the path of
        the span that launched it: [[name, seconds, {path: seconds}]]."""
        by: dict = {}
        for d, s in zip(self.records.device, self._dev_spans):
            name = d[2][:120]
            tot, paths = by.setdefault(name, [0.0, {}])
            by[name][0] = tot + 1e-9 * (d[1] - d[0])
            self._add(paths, self.path(s), 1e-9 * (d[1] - d[0]))
        ranked = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
        return [[n, t, dict(sorted(p.items(), key=lambda kv: -kv[1]))]
                for n, (t, p) in ranked]

    # -- the metrics ------------------------------------------------------
    def syncs_per_outer(self) -> float | None:
        if not self.image_outers:
            return None
        return self.counts.get("sync", 0) / self.image_outers

    def _idle_pct(self, keep) -> float | None:
        if not self.trusted() or self.untraced_s <= 0:
            return None
        s = sum(b - a for (a, b), sp in zip(self.gaps, self._gap_spans)
                if sp is not None and keep(self.chain(sp)))
        return 100.0 * 1e-9 * s / self.untraced_s

    def sync_idle_pct(self) -> float | None:
        """Idle time in gaps that begin inside a sync span, in % of the
        untraced seconds."""
        return self._idle_pct(lambda c: c[0] == "sync")

    def solve_idle_pct(self) -> float | None:
        """The same for gaps that begin inside ``node.solve`` but outside
        its sync spans."""
        return self._idle_pct(lambda c: c[0] != "sync" and "node.solve" in c)

    def fcv_build_ms(self) -> float | None:
        """The median over the window's ``admm.fcv_build`` spans of the ms
        from the span's start to the later of its end and the device's end
        of the last record launched inside it."""
        if not self.trusted():
            return None
        builds = [s for s in self.spans if s.name == "admm.fcv_build"]
        if not builds:
            return None
        end = {s.id: s.t1_ns for s in builds}
        for d, s in zip(self.records.device, self._dev_spans):
            while s is not None and s.id not in end:
                s = self.by_id.get(s.parent)
            if s is not None:
                end[s.id] = max(end[s.id], d[1])
        return statistics.median(1e-6 * (end[s.id] - s.t0_ns)
                                 for s in builds)

    def proj_ms_per_outer(self) -> float | None:
        """Device ms of the records launched inside ``proj.*`` spans that
        lie inside ``admm.outer`` spans, over the image-outers."""
        if not self.trusted() or not self.image_outers:
            return None
        ns = 0
        for d, s in zip(self.records.device, self._dev_spans):
            if s is None:
                continue
            c = self.chain(s)
            if "admm.outer" in c and any(n.startswith("proj.") for n in c):
                ns += d[1] - d[0]
        return 1e-6 * ns / self.image_outers

    def notes(self) -> dict:
        """What the join found, for the notes of a traced run."""
        outers = sorted((s for s in self.spans if s.name == "admm.outer"),
                        key=lambda s: s.t0_ns)
        io = max(1, self.image_outers)
        return {
            "span_alignment": self.alignment(),
            "sync_misses": self.sync_misses(),
            "idle_by_span": self.idle_by_span(),
            "device_by_span": self.device_by_span(),
            "launches_by_span": self.launches_by_span(),
            "program_counts_per_outer": {k: v / io for k, v in
                                         sorted(self.counts.items())},
            "outer_ms": [1e-6 * (s.t1_ns - s.t0_ns) for s in outers],
            "device_by_path": self.device_by_span(self.path),
            "device_ops_by_path": self.device_ops_by_path(),
            "window_s": 1e-9 * (self.records.t1 - self.records.t0),
            # What the profiler and the recorder add to the window: the
            # idle above adds up to device_idle_pct's idle plus this.
            "profiler_excess_s": 1e-9 * (self.records.t1 - self.records.t0)
            - self.untraced_s,
            "busy_s": 1e-9 * sum(b - a for a, b in self.records.busy()),
            "launches": len(self.records.launches),
            "unrecorded": self.records.unrecorded,
            "attempts": self.attempts,
            "image_outers": self.image_outers,
        }


def _recons(ctx) -> int:
    """The number of reconstructions in the traced window."""
    p = ctx.program
    per = p.cfg.admm.max_iters * len(p.scales)
    return max(1, round(ctx.image_outers / per))


def _pad(device) -> None:
    """PAD launches, then the device drained and a pause. The records the
    profiler loses are a session's first or last ones: padding on both
    sides of the window takes their place."""
    import torch

    pad = torch.zeros(1, device=device)
    for _ in range(PAD):
        pad.add_(1.0)
    torch.cuda.synchronize(device)
    time.sleep(0.05)


def window(ctx) -> Joined | None:
    """The mix's traced reconstructions once more, after the traced
    window, under the profiler with the program's recorder on; None where
    the program has no recorder or there is no device. The profiler now
    and then loses a few device records at a session's start or end: the
    window is padded on both sides, and one that still cannot be trusted
    is run again, with the next reconstructions, up to TRIES times; the
    last one is returned all the same, its ``attempts`` listing each
    window's (unrecorded launches, alignment, the spans they were made in,
    ms from the first of them to the window's end)."""
    import torch

    try:
        from dip_admm_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    n = _recons(ctx)
    first = 1 + 2 * n  # after the untraced and the traced window's
    attempts = []
    for _ in range(TRIES):
        done = []
        torch.cuda.synchronize(ctx.device)
        with recording() as rec:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _pad(ctx.device)
                w0 = time.perf_counter_ns()
                for r in range(first, first + n):
                    done.append(ctx.program.reconstruct(r))
                torch.cuda.synchronize(ctx.device)
                w1 = time.perf_counter_ns()
                _pad(ctx.device)
        first += n
        outers = sum(int(d["outers"]) for d in done)
        recs = Records.from_events(prof.profiler.kineto_results.events(),
                                   w0 + rec.offset_ns, w1 + rec.offset_ns)
        j = Joined(recs, rec.spans, rec.counts, outers, ctx.trace.untraced_s)
        attempts.append((recs.unrecorded, j.alignment(), j.lost_by_span(),
                         [1e-6 * (recs.t1 - h[0]) for h in recs.lost[:1]]))
        j.attempts = attempts
        if j.trusted():
            break
    return j


def joined(ctx) -> Joined | None:
    """``window(ctx)``, once a context: the readers share it."""
    if not hasattr(ctx, "_spans_joined"):
        ctx._spans_joined = window(ctx)
    return ctx._spans_joined


def trusted(ctx) -> Joined | None:
    """The join where it can be trusted, else None. The join reads its own
    window, not the traced window: that window's completeness is
    ``device_idle_pct``'s concern, and this one's is checked here."""
    j = joined(ctx)
    return j if j is not None and j.trusted() else None


# -- the diagnostic run ---------------------------------------------------

def _sync_sites(prog, r: int) -> dict:
    """{"<port frames>": calls} of the synchronizing calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports over reconstruction
    ``r``, each named by its innermost three frames in the program."""
    import traceback
    import warnings
    from pathlib import Path

    import torch

    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f"{Path(f.filename).name}:{f.lineno}"
                  for f in traceback.extract_stack()[:-1]
                  if "dip_admm_tpu_torch" in f.filename
                  or "portbench" in f.filename][-3:]
        key = " < ".join(reversed(frames)) or f"{filename}:{lineno}"
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            prog.reconstruct(r)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def _stacks(prog, r: int, cfg, top: int = 25) -> list:
    """The ``top`` torch operations by self device time over one
    reconstruction ``r`` under ``cfg``, with their Python call sites."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # Python stacks reach the torch operations' records only when verbose.
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, experimental_config=verbose) as prof:
        prog.reconstruct(r, cfg)
        torch.cuda.synchronize()
    rows = prof.key_averages(group_by_stack_n=5)

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    return [{"op": e.key, "self_device_ms": 1e-3 * dev(e), "count": e.count,
             "stack": list(e.stack)[:5]}
            for e in sorted(rows, key=lambda e: -dev(e))[:top]]


def _cost(prog, n: int, rounds: int) -> dict:
    """Host seconds of the mix's n traced reconstructions with recording
    off and on, in turns off, on, on, off, the profiler off."""
    import torch

    from dip_admm_tpu_torch.utils.profiling import recording

    def timed(on: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on:
            with recording():
                for r in range(n):
                    prog.reconstruct(1000 + r)
        else:
            for r in range(n):
                prog.reconstruct(1000 + r)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    off, on = [], []
    for _ in range(rounds):
        off.append(timed(False))
        on.append(timed(True))
        on.append(timed(True))
        off.append(timed(False))
    return {"off_s": off, "on_s": on,
            "on_over_off": statistics.median(on) / statistics.median(off)}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from portbench import program, run, spec
    from portbench import spans as this
    from dip_admm_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost-rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)

    # Set-up with the recorder on; the join captured as the readers make it.
    setup, got = [], []
    load_kernels, Program, join = (program.load_kernels, program.Program,
                                   this.joined)

    def recorded(fn):
        def call(*a, **kw):
            with profiling.recording() as rec:
                out = fn(*a, **kw)
            setup.append(rec)
            return out
        return call

    def capture(ctx):
        j = join(ctx)
        if not got:
            got.append(j)
        return j

    # The readers import this file as portbench.spans, not as __main__.
    program.load_kernels = recorded(load_kernels)
    program.Program = recorded(Program)
    this.joined = capture
    try:
        line = run.run_cell(cell, args.seed, args.seconds, True, device,
                            lambda s: print(s, file=sys.stderr, flush=True))
    finally:
        program.load_kernels, program.Program = load_kernels, Program
        this.joined = join
    j = got[0] if got else None
    out = {"cell": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device), "line": line,
           "join": j.notes() if j is not None else None,
           "build_spans": [
               {"name": s.name, "ms": 1e-6 * (s.t1_ns - s.t0_ns),
                "attrs": s.attrs}
               for rec in setup for s in sorted(rec.spans, key=lambda s: s.id)
               if s.name.startswith(("loader.", "kernels."))],
           "build_counts": [rec.counts for rec in setup]}
    if j is not None:
        out["join"]["metrics"] = {
            "syncs_per_outer": j.syncs_per_outer(),
            "sync_idle_pct": j.sync_idle_pct(),
            "solve_idle_pct": j.solve_idle_pct(),
            "fcv_build_ms": j.fcv_build_ms(),
            "proj_ms_per_outer": j.proj_ms_per_outer()}

    conf, mix = cell["config"], cell["mix"]
    prog = Program(conf, mix, args.seed, device)
    prog.reconstruct(0, program.port_config(conf, mix, max_iters=2).admm)
    out["sync_sites"] = _sync_sites(prog, 900)
    out["stacks"] = _stacks(prog, 901, program.port_config(
        conf, mix, max_iters=3).admm)
    out["cost"] = (_cost(prog, int(mix["trace"]["recons"]), args.cost_rounds)
                   if args.cost_rounds else None)
    short = {k: out[k] for k in ("cell", "seed", "card", "sync_sites",
                                 "cost")}
    short["metrics"] = {k: v["value"] for k, v in line["metrics"].items()}
    if j is not None:
        short.update({k: out["join"][k] for k in (
            "metrics", "span_alignment", "idle_by_span", "device_by_span",
            "launches_by_span", "program_counts_per_outer", "busy_s",
            "window_s", "profiler_excess_s", "launches", "unrecorded")})
    short["untraced_s"] = line["notes"].get("untraced_s")
    print(json.dumps(short), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
