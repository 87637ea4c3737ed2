"""The PyTorch port's configuration mirrors the JAX package's, and the port
imports neither JAX nor the JAX package."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

from dip_admm_tpu import config as jcfg
from dip_admm_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", [
    "GeometryConfig", "GraphConfig", "NodeSolverConfig", "AdmmConfig",
    "ProblemConfig",
])
def test_dataclass_fields_match(name):
    tc, jc = getattr(tcfg, name), getattr(jcfg, name)
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    assert tf == jf
    assert tc.__dataclass_params__.frozen and jc.__dataclass_params__.frozen
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
    for attr in ("n", "total_angles", "n_det"):
        if hasattr(jc, attr):
            assert getattr(tc(), attr) == getattr(jc(), attr)


@pytest.mark.parametrize("angles_total", [None, 31, 96])
def test_angles_per_node_match(angles_total):
    kw = dict(N=40, num_nodes=7, angles_total=angles_total)
    assert (tcfg.GeometryConfig(**kw).angles_per_node()
            == jcfg.GeometryConfig(**kw).angles_per_node())


def test_port_imports_without_jax():
    """Every port module imports with ``jax`` blocked, and none of them
    pulls in the JAX package."""
    import dip_admm_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(
        dip_admm_tpu_torch.__path__, "dip_admm_tpu_torch.")]
    assert "dip_admm_tpu_torch.ops.kernels.shear_sum" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dip_admm_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'triton')) "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
