"""The port's fan-beam reconstruction against the plain reference of the
benchmark (``portbench/reference``: ``FanProjector``, a sparse fan operator
built from rebinned parallel rows, and ``recon.py``, the ADMM from its
equations), from the same seeded inputs, on the CPU.

The problem is ``portbench/configs/fan512_p32.json`` (BASELINE config 5:
32 nodes, fan beam at width 2.1, ``fft_skew``) cut to N = 32 with 4 source
angles a node (the rebin needs an even count), under the ``fcv_single``
recipe for a few outers. x and Z are held to the reference's as the
benchmark's check holds them (``portbench.check.compare``): the widest
relative gap of a node's image and of the edge state."""

import json

import pytest
import torch

from portbench import check, program, spec

torch.set_num_threads(2)

N, ANGLES, OUTERS = 32, 128, 3
SEED = 2**31 + 24
# x_gap and z_gap with float32 tables read 1.94e-6-1.96e-6 and
# 1.92e-6-1.94e-6 (seeds 1, 2, 3 and SEED); with bfloat16 tables
# 4.13e-3-4.32e-3 and 3.95e-3-4.21e-3. 1e-4 is 50 times the one and a
# fortieth of the other.
TOL_STATE = 1e-4
# psnr_gap: 1.2e-6-1.3e-6 with float32 tables, 1.08e-3-1.20e-3 with
# bfloat16; 1e-4 is 75 times the one and a tenth of the other.
TOL_PSNR = 1e-4


def _cell(table_dtype):
    conf = json.loads((spec.HERE / "configs" / "fan512_p32.json").read_text())
    conf["geometry"].update(N=N, angles_total=ANGLES, det_pixels=N)
    conf["fft_table_dtype"] = table_dtype
    mix = json.loads((spec.HERE / "mixes" / "fcv_single.json").read_text())
    mix["recipe"]["max_iters"] = OUTERS
    return conf, mix


def _gaps(table_dtype):
    conf, mix = _cell(table_dtype)
    dev = torch.device("cpu")
    prog = program.Program(conf, mix, SEED, dev)
    assert prog.P == 32 and prog.problem.cfg.geometry.fan_beam
    res = prog.reconstruct(1)
    assert int(res["outers"]) == OUTERS
    assert tuple(res["Z"].shape) == (1, 32, 32, N * N)
    return check.compare([{"r": 1, "x": res["x"], "Z": res["Z"]}], conf,
                         mix, SEED, dev)


def test_float32_tables_match_the_reference():
    g = _gaps("float32")
    assert g["x_gap"] <= TOL_STATE and g["z_gap"] <= TOL_STATE, g
    assert g["psnr_gap"] <= TOL_PSNR, g


def test_bfloat16_tables_exceed_the_tolerance():
    # One precision step down the table type must show: the tolerance
    # resolves it.
    g = _gaps("bfloat16")
    assert g["x_gap"] > TOL_STATE and g["z_gap"] > TOL_STATE, g
    assert g["psnr_gap"] > TOL_PSNR, g
