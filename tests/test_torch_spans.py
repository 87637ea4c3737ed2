"""The port's spans and counters (``utils/profiling.py``) on the CPU: the
span tree of ``run_admm`` and ``run_admm_batched`` at 32²/4 with fcv, in
parallel and in fan beam (the fan projector's ``proj.rebin`` inside each
``proj.fwd``/``proj.adj``), the exact counts of syncs, projector calls and
inner steps, results and launch counters unchanged by recording, and
spans closed on an exception."""

import pytest
import torch

from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm, node_solver
from dip_admm_tpu_torch.data import loader
from dip_admm_tpu_torch.ops.kernels import (
    consensus, filter_mxu, filter_sum, hat_eval, shear_sum,
)
from dip_admm_tpu_torch.utils import profiling

torch.set_num_threads(2)

N, P, OUTERS, B = 32, 4, 3, 2
# fcv's operator pairs while it builds its metric: the PSF and 25 Lanczos
# steps (node_solver.build_fourier_precond).
FCV_PAIRS = 26
ENTRIES = ("single", "batched")
# The same entries on the fan-beam problem.
FAN_ENTRIES = ("fan_single", "fan_batched")
# Fan beam: 12 source angles a node (the rebin needs an even count), the
# detector wide enough that the fan covers the inscribed disc.
FAN = {"fan_beam": True, "angles_total": 48, "det_width_factor": 2.1}


def _cfg(max_inner=5, check_every=5, fan=False):
    node = tcfg.NodeSolverConfig(algorithm="fcv", max_inner=max_inner,
                                 check_every=check_every, eps0=0.0,
                                 plateau_tol=0.0)
    geo = {"angles_total": 96, **(FAN if fan else {})}
    return tcfg.ProblemConfig(
        geometry=tcfg.GeometryConfig(N=N, num_nodes=P, **geo),
        admm=tcfg.AdmmConfig(max_iters=OUTERS, eps_pri=0.0, eps_dual=0.0,
                             relax_alpha=1.8, use_pallas=True, node=node))


@pytest.fixture(scope="module")
def problem():
    return loader.build_problem(_cfg(), "cpu", mode="fft_skew")


@pytest.fixture(scope="module")
def fan_problem():
    return loader.build_problem(_cfg(fan=True), "cpu", mode="fft_skew")


@pytest.fixture
def pick(problem, fan_problem):
    """``pick(entry)``: (the problem, the entry point) of an entry of
    ENTRIES or FAN_ENTRIES."""
    def on(entry):
        if entry.startswith("fan_"):
            return fan_problem, entry[len("fan_"):]
        return problem, entry
    return on


def _run(problem, entry, cfg=None, lanes=B):
    """One reconstruction through ``entry`` (``lanes`` slices a batch):
    (x, Z, Y, hist)."""
    cfg = problem.cfg.admm if cfg is None else cfg
    if entry == "single":
        res = admm.run_admm(problem, cfg)
    else:
        b = torch.stack([(1.0 + 0.05 * j) * problem.b for j in range(lanes)])
        res = admm.run_admm_batched(problem, b, cfg=cfg)
    return res.x, res.state.Z, res.state.Y, res.history


def _children(rec, parent):
    return [s for s in rec.spans if s.parent == parent.id]


def _launches():
    out = {}
    for m in (consensus, filter_mxu, filter_sum, hat_eval, shear_sum):
        out.update(m.launch_counts())
    return out


def test_off_is_one_shared_no_op():
    a, b = profiling.span("admm.outer", k=0), profiling.span("proj.fwd")
    assert a is b
    with a as inner:
        inner.attrs["built"] = True
    profiling.count("sync")
    assert profiling._REC is None


@pytest.mark.parametrize("entry", ENTRIES + FAN_ENTRIES)
def test_off_records_nothing(pick, entry):
    with profiling.recording() as rec:
        pass
    _run(*pick(entry))
    assert rec.spans == [] and rec.counts == {}


@pytest.mark.parametrize("entry", ENTRIES + FAN_ENTRIES)
def test_span_tree(pick, entry):
    problem, entry = pick(entry)
    fan = problem.cfg.geometry.fan_beam
    with profiling.recording() as rec:
        _run(problem, entry)
        _run(problem, entry)
    assert not rec._stack
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    runs = [s for s in rec.spans if s.name == "admm.run"]
    assert len(runs) == 2 and all(r.parent is None for r in runs)
    assert runs[0].attrs == {"B": 1 if entry == "single" else B, "P": P,
                             "N": N}
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            assert s.run == p.run
    for run in runs:
        assert run.run == run.id
        kids = _children(rec, run)
        assert [s.name for s in kids if s.name == "admm.fcv_build"] == [
            "admm.fcv_build"]
        outers = [s for s in kids if s.name == "admm.outer"]
        assert [s.attrs["k"] for s in outers] == list(range(OUTERS))
        for outer in outers:
            names = sorted(s.name for s in _children(rec, outer)
                           if s.name != "sync")
            assert names == ["admm.consensus", "admm.history",
                             "admm.neighbours", "node.solve"]
    # The fan projector's own work, once inside every projector call.
    for s in rec.spans:
        if s.name in ("proj.fwd", "proj.adj"):
            kids = [c.name for c in _children(rec, s)]
            assert kids == (["proj.rebin"] if fan else []), kids
        if s.name == "proj.rebin":
            assert by_id[s.parent].name in ("proj.fwd", "proj.adj")
    assert any(s.name == "proj.rebin" for s in rec.spans) == fan


@pytest.mark.parametrize("entry", ENTRIES + FAN_ENTRIES)
@pytest.mark.parametrize("max_inner,check_every", [(5, 5), (10, 5)])
def test_counts_are_exact(pick, entry, max_inner, check_every):
    problem, entry = pick(entry)
    cfg = _cfg(max_inner, check_every).admm
    with profiling.recording() as rec:
        _run(problem, entry, cfg)
    checks = max_inner // check_every
    # Per outer: a sync per check, the residual's inf test, the stop flag
    # (the running set of a batch), the TV radius copied to the device in
    # each inner step, the target's decay and the history's rho; once a
    # call fcv's eigvalsh, and run_admm's rho scale. Each inner step
    # applies a pair, each check one more; the node objective and the
    # history a forward each.
    single = entry == "single"
    per_outer = (checks * ["node.check"] + max_inner * ["tv.radius"]
                 + ["node.isinf", "admm.stop" if single else "admm.running",
                    "admm.decay", "admm.rho"])
    per_call = ["fcv.eigvalsh"] + (["admm.init"] if single else [])
    proj = {"proj.fwd": FCV_PAIRS + OUTERS * (max_inner + checks + 2),
            "proj.adj": FCV_PAIRS + OUTERS * (max_inner + checks)}
    if problem.cfg.geometry.fan_beam:  # a rebin in every projector call
        proj["proj.rebin"] = proj["proj.fwd"] + proj["proj.adj"]
    assert rec.counts == {
        "sync": OUTERS * len(per_outer) + len(per_call),
        "inner_steps": OUTERS * max_inner, **proj,
    }
    sites = sorted(s.attrs["site"] for s in rec.spans if s.name == "sync")
    assert sites == sorted(per_call + OUTERS * per_outer)
    by_id = {s.id: s for s in rec.spans}

    def outer_of(s):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == "admm.outer":
                return s.attrs["k"]
        return None

    for name, per_outer in (("proj.fwd", max_inner + checks + 2),
                            ("proj.adj", max_inner + checks)):
        ks = [outer_of(s) for s in rec.spans if s.name == name]
        assert ks.count(None) == FCV_PAIRS
        assert all(ks.count(k) == per_outer for k in range(OUTERS))


@pytest.mark.parametrize("entry,lanes,per_image_outer", [
    ("single", 1, 20.1), ("batched", 16, 401 / 320),
    ("fan_single", 1, 20.1)])
def test_sync_count_of_the_cells_recipe(pick, entry, lanes,
                                        per_image_outer):
    # The benchmark's mixes: fcv at 15 inner steps checked once, 20
    # outers; one slice a run_admm call, or sixteen a run_admm_batched
    # call (syncs_per_outer reads the same counter on the card).
    node = tcfg.NodeSolverConfig(algorithm="fcv", max_inner=15,
                                 check_every=15, eps0=2.0,
                                 gamma_decay=0.005, plateau_tol=0.01)
    cfg = tcfg.AdmmConfig(max_iters=20, eps_pri=0.0, eps_dual=0.0,
                          relax_alpha=1.8, node=node)
    with profiling.recording() as rec:
        _run(*pick(entry), cfg, lanes)
    assert rec.counts["sync"] / (20 * lanes) == pytest.approx(
        per_image_outer, rel=1e-12)


@pytest.mark.parametrize("entry", ENTRIES + FAN_ENTRIES)
def test_results_and_launches_unchanged(pick, entry):
    problem, entry = pick(entry)
    for m in (consensus, filter_mxu, filter_sum, hat_eval, shear_sum):
        m.reset_launch_counts()
    off = _run(problem, entry)
    launches_off = _launches()
    for m in (consensus, filter_mxu, filter_sum, hat_eval, shear_sum):
        m.reset_launch_counts()
    with profiling.recording() as rec:
        on = _run(problem, entry)
    assert rec.spans
    assert _launches() == launches_off
    for a, b in zip(off[:3], on[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(off[3]) == set(on[3])
    for name in off[3]:
        torch.testing.assert_close(off[3][name], on[3][name], rtol=0, atol=0,
                                   equal_nan=True)


def test_any_attribute_name():
    with profiling.recording() as rec:
        with profiling.span("kernels.load", name="lib") as sp:
            sp.attrs["built"] = False
    assert rec.spans[0].attrs == {"name": "lib", "built": False}


def test_exception_closes_spans():
    with pytest.raises(ValueError):
        with profiling.recording() as rec:
            with profiling.span("outer"):
                with profiling.span("inner", site="x"):
                    raise ValueError("inside")
    assert not rec._stack
    (inner, outer) = rec.spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and inner.t1_ns <= outer.t1_ns


def test_solver_error_closes_node_solve(problem):
    cfg = tcfg.NodeSolverConfig(algorithm="nope")
    x = torch.zeros((P, N * N))
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="unknown inner algorithm"):
            node_solver.solve_nodes(
                problem.forward, problem.adjoint, problem.b, x, x,
                torch.zeros(P), 0.02, 2.0, torch.ones(P),
                node_solver.init_state(P, N, problem.m_flat, "cpu"),
                torch.tensor(1.0), cfg, N)
    assert [s.name for s in rec.spans] == ["node.solve"]
    assert not rec._stack


def test_spans_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("outer"):
                with record_function("mark"):
                    torch.ones(64).sum()
    (sp,) = rec.spans
    (mark,) = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "mark"]
    # The profiler's record lies inside the span, to the clocks' grain.
    slack = 50_000  # ns
    assert sp.t0_ns - slack <= mark.start_ns()
    assert mark.start_ns() + mark.duration_ns() <= sp.t1_ns + slack


def test_nested_recorders_and_other_threads():
    import threading

    with profiling.recording() as outer:
        with profiling.span("a"):
            pass
        with profiling.recording() as inner:
            with profiling.span("b"):
                pass
            t = threading.Thread(target=lambda: profiling.span("c")
                                 .__enter__())
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with profiling.span("d"):
            pass
    assert [s.name for s in outer.spans] == ["a", "d"]
    assert [s.name for s in inner.spans] == ["b"]
    assert profiling._REC is None
