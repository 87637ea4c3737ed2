"""The plain fan-beam reference (``reference/fan.py``) against the program's
fan projectors, and the parallel and fan references kept bit for bit: on
the CPU, at N = 32 with 4 nodes of 10 fan angles each."""

import hashlib

import pytest
import torch

from portbench import check
from portbench.reference.fan import FanProjector
from portbench.reference.projector import Projector

N, P, ANGLES = 32, 4, 40
# Relative to the largest magnitude of the reference's output. With float32
# tables the program's forward and adjoint read at most 3.2e-6 off the
# reference (the float32 rebin DFTs and table phases); with bfloat16
# tables at least 4.6e-4 (fft_grouped's adjoint at width 1.0), 3.7e-3 on
# fft_skew's forward. 1e-4 is 31 times the one and under a fifth of the
# other.
TOL_OP = 1e-4
# The program's exact column norms, summed in float32 over the angle
# blocks, read at most 1.8e-6 off the reference's float64 sums of its
# stored float32 entries; they come from the geometry, not the tables, so
# bfloat16 tables do not move them.
TOL_W = 2e-5
# <Ax, y> against <x, A^T y> on the reference alone: float32 sparse
# products of a few thousand terms a row read at most 5.8e-7.
TOL_ADJOINT = 1e-5


def _port(mode, width, table_dtype):
    """The program's fan (forward, adjoint) and column norms [P, n]."""
    from dip_admm_tpu_torch.config import GeometryConfig
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fan

    geo = GeometryConfig(N=N, num_nodes=P, angles_total=ANGLES,
                         det_pixels=N, det_width_factor=width, fan_beam=True)
    a, v, _ = radon.node_angles(geo)
    beta, valid = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v)
    pre = {"fft_skew": radon_fan.precompute_fan_skew,
           "fft_grouped": radon_fan.precompute_fan_grouped}[mode]
    fwd, adj = loader.make_node_ops(mode, geo,
                                    pre(geo, beta, valid, table_dtype))
    W = radon_fan.colnorms_sq_nodes(geo, beta, valid).reshape(P, -1)
    return fwd, adj, W


def _gaps(mode, width, table_dtype):
    fwd, adj, W = _port(mode, width, table_dtype)
    ref = FanProjector(N, P, ANGLES, N, width, 4.0, 4.0)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((P, ref.n), generator=gen)
    y = torch.randn((P, ref.m), generator=gen)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    return {"fwd": rel(fwd(x), ref.fwd(x)), "adj": rel(adj(y), ref.adj(y)),
            "W": rel(W, ref.colnorms())}


@pytest.mark.parametrize("width", [1.0, 2.1])
@pytest.mark.parametrize("mode", ["fft_skew", "fft_grouped"])
def test_program_fan_matches_reference(mode, width):
    g = _gaps(mode, width, torch.float32)
    assert g["fwd"] <= TOL_OP and g["adj"] <= TOL_OP, g
    assert g["W"] <= TOL_W, g


@pytest.mark.parametrize("mode", ["fft_skew", "fft_grouped"])
def test_bfloat16_tables_fail_the_tolerance(mode):
    g = _gaps(mode, 1.0, torch.bfloat16)
    assert g["fwd"] > TOL_OP and g["adj"] > TOL_OP, g


@pytest.mark.parametrize("width", [1.0, 2.1])
def test_reference_adjoint_identity(width):
    ref = FanProjector(N, P, ANGLES, N, width, 4.0, 4.0)
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((P, ref.n), generator=gen)
    y = torch.randn((P, ref.m), generator=gen)
    lhs = float(torch.sum(ref.fwd(x).double() * y.double()))
    rhs = float(torch.sum(x.double() * ref.adj(y).double()))
    assert abs(lhs - rhs) <= TOL_ADJOINT * abs(lhs)


def test_nodes_share_one_matrix():
    ref = FanProjector(N, P, ANGLES, N, 2.1, 4.0, 4.0)
    assert [nodes for nodes, *_ in ref.groups] == [list(range(P))]
    assert bool(ref.row_valid.all()) and ref.m == (ANGLES // P) * N


def test_odd_angle_count_is_refused():
    with pytest.raises(ValueError, match="even angle count"):
        FanProjector(N, 2, 18, N, 1.0, 4.0, 4.0)


def _geometry_conf(**geometry):
    return {"geometry": geometry,
            "graph": {"strategy": "knn", "q_mode": "arithmetic"},
            "admm": {"z_fusion": "midpoint"}}


# Counts 10, 10, 9, 9 and 11, 11, 10, 10: an uneven split leaves one count
# odd, so the reference, which gives each node the beta grid of its own
# count, refuses it rather than read a node at another node's count.
@pytest.mark.parametrize("total", [38, 42])
def test_uneven_split_is_refused(total):
    with pytest.raises(ValueError, match="even angle count"):
        FanProjector(N, P, total, N, 2.1, 4.0, 4.0)
    conf = _geometry_conf(N=N, num_nodes=P, angles_total=total,
                          det_pixels=N, det_width_factor=2.1, fan_beam=True,
                          src_radius=4.0, det_radius=4.0)
    with pytest.raises(ValueError, match="even angle count"):
        check.projector(conf, torch.device("cpu"))


def _digest(proj):
    h = hashlib.sha256()
    nnz = []
    for _, A, AT, W in proj.groups:
        for M in (A, AT):
            for t in (M.crow_indices(), M.col_indices(), M.values()):
                h.update(t.contiguous().numpy().tobytes())
        h.update(W.numpy().tobytes())
        nnz.append(A.values().numel())
    return nnz, h.hexdigest()


# Each case's (nnz a group, sha256 of every group's A and A^T indices and
# values and its column norms), taken from the reference before it took
# the detector positions as an argument.
PARALLEL = [
    ((32, 3, 96, 32, 1.0), None, [83400],
     "f57906068902acdb36e917db010b8e21063833118a28f95fc13d117ea04747b1"),
    ((32, 3, 96, 32, 1.0), torch.float8_e4m3fn, [83400],
     "81c787876ae5bf33864726ce065f45b9a50938a7a300c916f363e19802323360"),
    ((24, 4, 50, 40, 2.1), None, [16044, 14840],
     "2bdcd269a336fea328360ec1846728f3301ca37da6f4eb0aa4cfca2b9773a1b1"),
    ((24, 4, 50, 40, 2.1), torch.float8_e4m3fn, [16044, 14840],
     "68f648f182826ec21356199eb4c001085b832ab31bb6a58807e359cfd0be15d7"),
]


@pytest.mark.parametrize("args,taps,nnz,digest", PARALLEL)
def test_parallel_matrices_unchanged(args, taps, nnz, digest):
    assert _digest(Projector(*args, tap_dtype=taps)) == (nnz, digest)


# The same of the fan reference, taken when each fan row was gathered from
# its two parallel rows by hand, before the one sparse product R @ A_par.
FAN = [
    ((32, 4, 40, 32, 2.1, 4.0, 4.0), None, [47528],
     "239363772b0e690a81136431a5a499c64d6863b40a6ee9c84a79385d764cc8bf"),
    ((32, 4, 40, 32, 2.1, 4.0, 4.0), torch.float8_e4m3fn, [47528],
     "80d00b0827bf7a39526c14649ef0e431a0ddfce304b5b0159d00f770cda7a6fb"),
    ((24, 2, 20, 40, 1.0, 3.0, 5.0), None, [51720],
     "de193298f6998044471d00384b907be5f8ac496309d8e1336a5c408bd7bb8dba"),
]


@pytest.mark.parametrize("args,taps,nnz,digest", FAN)
def test_fan_matrices_unchanged(args, taps, nnz, digest):
    assert _digest(FanProjector(*args, tap_dtype=taps)) == (nnz, digest)


@pytest.mark.parametrize("fan", [False, True])
def test_check_picks_the_reference_by_geometry(fan):
    geometry = {"N": 16, "num_nodes": 2, "angles_total": 20,
                "det_pixels": 16, "det_width_factor": 2.1, "fan_beam": fan}
    if fan:
        geometry.update(src_radius=4.0, det_radius=4.0)
    conf = _geometry_conf(**geometry)
    proj = check.projector(conf, torch.device("cpu"))
    assert type(proj) is (FanProjector if fan else Projector)
    assert proj.m == 10 * 16
