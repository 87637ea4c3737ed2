"""The problem dtype (``ProblemConfig.dtype``, the CLI's ``--dtype``) in the
PyTorch port against the JAX package (without x64, as its tests run), on
the CPU at N = 16 with 2 nodes: each field's dtype after the build, the
projector tables', and the loop state's and history's after one outer;
mode ``fft`` refuses a half-precision problem with JAX's ValueError. The
values are not compared (JAX evaluates the geometry of half-precision
angles in that precision, the port in float32 from the rounded angles);
one outer's state is finite."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader

from test_torch_fan import _port_cfg

torch.set_num_threads(2)

FIELDS = ("angles", "b", "W", "Q", "x_true", "opnorm")


def _cfg(dtype):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(N=16, num_nodes=2),
        admm=jcfg.AdmmConfig(max_iters=1,
                             node=jcfg.NodeSolverConfig(max_inner=10)),
        dtype=dtype, phantom="shepp")


def _name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


@pytest.mark.parametrize("mode", ["dense", "joseph", "fft_skew"])
@pytest.mark.parametrize("dtype", ["float64", "bfloat16", "float16"])
def test_field_dtypes_match_jax(dtype, mode):
    cfg = _cfg(dtype)
    pj = jloader.build_problem(cfg, mode=mode)
    pt = tloader.build_problem(_port_cfg(cfg), "cpu", mode=mode)
    for k in FIELDS:
        assert _name(getattr(pt, k).dtype) == str(getattr(pj, k).dtype), k
    assert pt.keep.dtype == torch.bool and pt.adj.dtype == torch.bool
    if mode == "dense":
        assert _name(pt.A.dtype) == str(pj.A.dtype)
    if mode == "fft_skew":
        want = {str(np.asarray(v).dtype) for v in jax.tree.leaves(
            pj.fft_tables)}
        got = {_name(v.dtype) for v in _leaves(pt.fft_tables)}
        assert got == want
    res_j = jadmm.run_admm(pj, cfg.admm)
    res_t = tadmm.run_admm(pt, pt.cfg.admm)
    assert _name(res_t.x.dtype) == str(res_j.x.dtype)
    assert _name(res_t.state.Z.dtype) == str(res_j.state.Z.dtype)
    assert _name(res_t.history["primal"].dtype) == str(
        res_j.history["primal"].dtype)
    assert bool(torch.isfinite(res_t.x.float()).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fft_refuses_half_precision_as_jax(dtype):
    cfg = _cfg(dtype)
    with pytest.raises(ValueError, match="RFFT input must be float32") as ej:
        jloader.build_problem(cfg, mode="fft")
    with pytest.raises(ValueError, match="RFFT input must be float32") as et:
        tloader.build_problem(_port_cfg(cfg), "cpu", mode="fft")
    assert str(et.value) == str(ej.value)


def test_unknown_dtype_is_refused():
    cfg = dataclasses.replace(_port_cfg(_cfg("float32")), dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        tloader.build_problem(cfg, "cpu", mode="dense")
