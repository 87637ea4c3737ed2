"""The port's run artifacts (``utils/artifacts.py``), its bindings of the
native writers and its profiling hooks, against the JAX package on the CPU.

The same numpy history, images and graph go through both packages'
writers: the same file names, the ``.npy`` arrays equal bit for bit, and
``run_parameters.txt`` equal apart from its date line. Without matplotlib
the port still writes every array and the node images (native writer) and
names each plot it could not draw: exactly the PNGs the JAX package draws.
"""

import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core.admm import HISTORY_FIELDS
from dip_admm_tpu.ops import tv as jtv
from dip_admm_tpu.utils import artifacts as jart
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.ops import tv as ttv
from dip_admm_tpu_torch.utils import _native
from dip_admm_tpu_torch.utils import artifacts as tart
from dip_admm_tpu_torch.utils import native_artifacts as na
from dip_admm_tpu_torch.utils import profiling

torch.set_num_threads(2)

T, P, N = 7, 3, 8


def _history():
    rng = np.random.default_rng(0)
    h = {name: rng.uniform(0.1, 2.0, (T, P) if per_node else (T,))
         .astype(np.float32) for name, per_node in HISTORY_FIELDS}
    h["rho"][:] = 2.0
    h["rho"][4:] = 4.0  # a moving rho draws its curve
    return h


def _files(d) -> dict:
    return {str(p.relative_to(d)): p for p in Path(d).rglob("*")
            if p.is_file()}


def _write_all(mod, out, h, x, adj):
    mod.save_history_artifacts(h, 5, str(out), "run", m_per_node=np.full(
        P, 4.0), N=N)
    mod.save_recons(x, N, str(out), "run")
    mod.save_union_graph(adj, str(out / "union_figs"), "run")
    mod.save_mse_curves({"a": h["primal"], "b": h["g_norm"]},
                        str(out / "mse"))
    mod.flush_async()


def test_artifact_files_match_jax(tmp_path):
    h = _history()
    x = np.random.default_rng(1).standard_normal((P, N * N)).astype(
        np.float32)
    adj = ~np.eye(P, dtype=bool)
    _write_all(jart, tmp_path / "jax", h, x, adj)
    _write_all(tart, tmp_path / "port", {k: torch.as_tensor(v)
                                         for k, v in h.items()},
               torch.as_tensor(x), torch.as_tensor(adj))
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert set(ft) == set(fj)
    assert "run_rho_hist.png" in ft and "run_node_2.png" in ft
    for name, p in ft.items():
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(p), np.load(fj[name]),
                                          err_msg=name)
        else:
            assert p.stat().st_size > 0, name
    assert tart.take_skipped() == []


def test_run_parameters_match_jax(tmp_path):
    extra = {"num_nodes": 5, "connected": True}
    pj = jart.save_run_parameters(str(tmp_path / "j"), jcfg.ProblemConfig(),
                                  extra)
    pt = tart.save_run_parameters(str(tmp_path / "t"), tcfg.ProblemConfig(),
                                  extra)

    def lines(p):
        return [ln for ln in Path(p).read_text().splitlines()
                if not ln.startswith("Date-Time")]

    assert lines(pt) == lines(pj)


def test_edge_map_matches_jax(tmp_path):
    x = np.random.default_rng(2).standard_normal((N, N)).astype(np.float32)
    got = ttv.edge_map(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtv.edge_map(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    path = tmp_path / "edge.png"
    tart.save_edge_map(x.reshape(-1), N, str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_without_matplotlib_plots_are_named_not_dropped(tmp_path,
                                                        monkeypatch):
    h = _history()
    x = np.random.default_rng(1).standard_normal((P, N * N)).astype(
        np.float32)
    adj = ~np.eye(P, dtype=bool)
    _write_all(jart, tmp_path / "jax", h, x, adj)
    monkeypatch.setattr(tart, "_pyplot", lambda: None)
    _write_all(tart, tmp_path / "port", h, x, adj)
    tart.save_edge_map(x[0], N, str(tmp_path / "port" / "edge.png"))
    skipped = {str(Path(p).relative_to(tmp_path / "port"))
               for p in tart.take_skipped()}
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert set(ft) | skipped == set(fj) | {"edge.png"}
    assert not set(ft) & skipped
    assert all(s.endswith(".png") for s in skipped)
    assert {n for n in fj if n.endswith(".npy")} <= set(ft)
    if na.available():  # the node images come from the native writer
        assert "run_node_0.png" in ft
    assert tart.take_skipped() == []


def test_native_writer_builds_outside_the_sources(tmp_path):
    """The port builds native/artifact_writer.cpp into build/native/ (a
    name with its source's hash) and writes a numpy-readable .npy and a
    valid grayscale PNG."""
    if not na.available():
        pytest.skip("no g++ or zlib on this host")
    lib = _native.lib_path("artifact_writer")
    assert lib.parent == _native.BUILD_DIR and lib.exists()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    na.save_npy(str(tmp_path / "a.npy"), a)
    na.save_png_gray(str(tmp_path / "a.png"), a)
    na.flush()
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), a)
    png = (tmp_path / "a.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", png[16:26])
    assert (w, h, depth, color) == (4, 3, 8, 0)
    idat = png.index(b"IDAT")
    (size,) = struct.unpack(">I", png[idat - 4:idat])
    rows = zlib.decompress(png[idat + 4:idat + 4 + size])
    assert len(rows) == 3 * (1 + 4)


def test_profiling_trace_holds_program_spans(tmp_path):
    import json

    from dip_admm_tpu_torch.core import admm as tadmm
    from dip_admm_tpu_torch.data import loader as tloader

    cfg = tcfg.ProblemConfig(
        geometry=tcfg.GeometryConfig(N=16, num_nodes=3, angles_total=24),
        admm=tcfg.AdmmConfig(max_iters=2, eps_pri=0.0, eps_dual=0.0,
                             node=tcfg.NodeSolverConfig(max_inner=4,
                                                        check_every=2)))
    problem = tloader.build_problem(cfg, "cpu", mode="dense")
    with profiling.trace(str(tmp_path / "prof")):
        tadmm.run_admm(problem)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ev = doc["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "program_span"]
    names = [e["name"] for e in spans]
    assert names.count("admm.run") == 1 and names.count("admm.outer") == 2
    assert names.count("node.solve") == 2 and "sync" in names
    assert {e["tid"] for e in spans} == {profiling.SPAN_TID}
    # On the trace's time base: the run's span holds the torch ops it ran.
    (run,) = [e for e in spans if e["name"] == "admm.run"]
    ops = [e for e in ev if e.get("ph") == "X"
           and e["name"].startswith("aten::")
           and run["ts"] <= e["ts"] <= run["ts"] + run["dur"]]
    assert len(ops) > 10