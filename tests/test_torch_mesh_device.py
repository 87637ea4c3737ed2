"""The mesh entry points run where their caller says: ``mesh.launch`` has no
default device, and ``mesh.make_mesh`` under gloo with no device raises
instead of putting the rank on the CPU (the port runs on the card unless
asked for the CPU). A one-rank gloo world in this process, no spawn."""

import inspect

import pytest
import torch
import torch.distributed as dist

from dip_admm_tpu_torch.parallel import mesh


def test_launch_requires_a_device():
    param = inspect.signature(mesh.launch).parameters["device"]
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        mesh.launch(len, 1)  # refused before any rank is spawned


@pytest.fixture
def gloo_world(tmp_path, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.usefixtures("gloo_world")
def test_make_mesh_under_gloo_needs_a_device():
    with pytest.raises(ValueError, match="device"):
        mesh.make_mesh(1, 1)
    m = mesh.make_mesh(1, 1, "cpu")
    assert m.device == torch.device("cpu") and m.transport == "gloo"
