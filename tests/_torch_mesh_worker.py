"""Rank bodies of the port's mesh tests (``test_torch_sharded.py``,
``test_torch_rowshard.py`` and ``test_torch_mesh_segments.py``, run by
``parallel.mesh.launch``; ``test_torch_multihost.py`` starts
:func:`multihost_rank` in processes of its own). The ranks import this
module, which imports the port and never JAX."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dip_admm_tpu_torch.data import loader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import radon, radon_fan, radon_fft
from dip_admm_tpu_torch.parallel import admm_sharded
from dip_admm_tpu_torch.parallel import mesh as meshlib
from dip_admm_tpu_torch.parallel import multihost
from dip_admm_tpu_torch.runners import experiment


def over(admm_cfg, changes: dict):
    """``admm_cfg`` with the fields of ``changes`` replaced (``node`` holds
    node-solver fields)."""
    changes = dict(changes)
    node = dataclasses.replace(admm_cfg.node, **changes.pop("node", {}))
    return dataclasses.replace(admm_cfg, node=node, **changes)


def problem(spec: dict, device):
    """A JAX ``save_problem`` bundle (``spec["bundle"]``), or the port's own
    tables (``spec["row_block"]``) with the data arrays of ``spec["data"]``
    (a fan problem, whose bundle the port does not load)."""
    if "bundle" in spec:
        return tser.load_problem(spec["bundle"], device)
    cfg = tser.cfg_from_json(spec["cfg"])
    with np.load(spec["data"]) as z:
        data = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    a, v, _ = radon.node_angles(cfg.geometry)
    angles = torch.as_tensor(a, dtype=torch.float32, device=device)
    valid = torch.as_tensor(v, device=device)
    tables = loader.build_fft_tables(cfg, angles, valid, spec["mode"],
                                     spec["row_block"])
    return loader.Problem(cfg=cfg, mode=spec["mode"], angles=angles,
                          angle_valid=valid, fft_tables=tables, **data)


def _counted(calls: dict):
    """Count the calls of the row-sharded skew pair (the fan pair calls
    it too)."""
    for name in ("project_nodes_skew_rowshard",
                 "backproject_nodes_skew_rowshard"):
        orig = getattr(radon_fft, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        setattr(radon_fft, name, wrapped)


def _numpy(res) -> dict:
    return {"x": res.x.numpy(), "Z": res.state.Z.numpy(),
            "Y": res.state.Y.numpy(), "n_iters": res.n_iters,
            "history": {k: v.numpy() for k, v in res.history.items()}}


def admm_run(rank, device, spec, n_node, pixel, changes, lanczos_v0,
             split=None):
    """``run_admm_sharded`` of the problem ``spec`` on an n_node x pixel
    mesh; on rank 0 the gathered result, the row-sharded pair's call counts
    and, with ``split``, the gathered result of a run stopped after
    ``split`` outers and resumed."""
    calls: dict = {}
    _counted(calls)
    p = problem(spec, device)
    cfg = over(p.cfg.admm, changes)
    mesh = meshlib.make_mesh(n_node, pixel, device)
    v0 = None if lanczos_v0 is None else torch.as_tensor(lanczos_v0)
    res = admm_sharded.run_admm_sharded(p, cfg, mesh, lanczos_v0=v0)
    out = {"full": _numpy(admm_sharded.gather_result(res, mesh)),
           "calls": dict(calls),
           "pixel_compute": admm_sharded.pixel_compute(p, mesh)}
    if split is not None:
        part = admm_sharded.run_admm_sharded(p, cfg, mesh, until=split,
                                             lanczos_v0=v0)
        out["part_iters"] = part.n_iters
        rest = admm_sharded.run_admm_sharded(p, cfg, mesh, state=part.state,
                                             hist=part.history, lanczos_v0=v0)
        out["resumed"] = _numpy(admm_sharded.gather_result(rest, mesh))
    return out if rank == 0 else None


def rowshard_pair(rank, device, spec, x, y):
    """The row-sharded skew pair (parallel, or fan by ``spec``'s geometry)
    on a 1 x ``world`` pixel mesh, on the port's own f32 tables: on rank 0,
    A x and A^T y of the [P, N, N] images ``x`` and [P, T, D] sinograms
    ``y``, and the tables' row-block count."""
    cfg = tser.cfg_from_json(spec["cfg"])
    geo = cfg.geometry
    a, v, _ = radon.node_angles(geo)
    tables = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=device),
        torch.as_tensor(v, device=device), "fft_skew", spec["row_block"])
    mesh = meshlib.make_mesh(1, torch.distributed.get_world_size(), device)
    loc = meshlib.slice_tables(tables, geo.num_nodes,
                               slice(0, geo.num_nodes),
                               (mesh.pixel_index, mesh.pixel))
    shard = admm_sharded.row_shard(mesh)
    if geo.fan_beam:
        fwd = radon_fan.project_nodes_fan_skew_rowshard
        adj = radon_fan.backproject_nodes_fan_skew_rowshard
        nb_full = tables["shared"]["par"]["WtT"].shape[1]
    else:
        fwd = radon_fft.project_nodes_skew_rowshard
        adj = radon_fft.backproject_nodes_skew_rowshard
        nb_full = tables["WtT"].shape[1]
    Ax = fwd(geo, torch.as_tensor(x), loc, shard)
    Aty = adj(geo, torch.as_tensor(y), loc, shard)
    if rank:
        return None
    return {"Ax": Ax.numpy(), "Aty": Aty.numpy(), "NB": nb_full}


def segments(rank, device, bundle, root, jax_ckpt):
    """``run_one_strategy`` on a 2-node mesh over the bundle's problem (4
    outers): in checkpointed segments of 2; 2 outers, then a resume from
    their checkpoint; snapshots every 2; a resume from the JAX package's
    checkpoint ``jax_ckpt``. Each run writes under ``root/<name>``; rank 0
    returns each run's x."""
    p = tser.load_problem(bundle, device)
    mesh = meshlib.make_mesh(2, 1, device)

    def run(name, max_iters, **kw):
        cfg = dataclasses.replace(p.cfg, admm=dataclasses.replace(
            p.cfg.admm, max_iters=max_iters))
        x, _, _ = experiment.run_one_strategy(
            cfg, f"{root}/{name}", mesh=mesh, problem=p, device=device,
            write_artifacts=False, **kw)
        return x

    out = {
        "unbroken": run("unbroken", 4, checkpoint_every=2),
        "part": run("part", 2, checkpoint_every=2),
    }
    out["resumed"] = run("resumed", 4, checkpoint_every=2,
                         resume=f"{root}/part/knn_k1/checkpoint.npz")
    out["snapshots"] = run("snapshots", 4, snapshot_every=2)
    out["from_jax"] = run("from_jax", 4, checkpoint_every=2, resume=jax_ckpt)
    return out if rank == 0 else None


def multihost_rank(bundle: str, out: str) -> None:
    """One process of an environment rendezvous (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): ``multihost.initialize``,
    ``global_mesh`` on the CPU, ``distribute_problem`` (each per-node array
    held to the whole problem's node block, the ``"shared"`` tables and a
    shared probe leaf whose leading size is the node count kept whole), 3
    outers of
    ``run_admm_sharded`` on the distributed problem; rank 0 saves the
    gathered x, Z and Y to ``out``."""
    multihost.initialize()
    mesh = multihost.global_mesh(device="cpu")
    p = tser.load_problem(bundle, "cpu")
    P = p.num_nodes
    probe = torch.arange(P * 3).reshape(P, 3)
    shared = {**p.fft_tables.get("shared", {}), "probe": probe}
    whole = dataclasses.replace(p, fft_tables={**p.fft_tables,
                                               "shared": shared})
    dp = multihost.distribute_problem(whole, mesh)
    P_loc = P // mesh.n_node
    nodes = slice(mesh.node_index * P_loc, (mesh.node_index + 1) * P_loc)
    assert dp.node_block == (nodes.start, nodes.stop)
    for name in ("angles", "angle_valid", "b", "W", "Q", "keep", "adj",
                 "opnorm"):
        assert torch.equal(getattr(dp, name), getattr(p, name)[nodes]), name
    assert torch.equal(dp.x_true, p.x_true)
    for k, v in p.fft_tables.items():
        if k == "shared":  # fan mode fft: one table set, whole on each rank
            for s, w in v.items():
                assert torch.equal(dp.fft_tables[k][s], w), s
        else:
            assert torch.equal(dp.fft_tables[k], v[nodes]), k
    assert torch.equal(dp.fft_tables["shared"].pop("probe"), probe)
    if not dp.fft_tables["shared"]:
        del dp.fft_tables["shared"]
    cfg = dataclasses.replace(p.cfg.admm, max_iters=3)
    res = admm_sharded.gather_result(
        admm_sharded.run_admm_sharded(dp, cfg, mesh), mesh)
    if mesh.rank == 0:
        np.savez(out, x=res.x.numpy(), Z=res.state.Z.numpy(),
                 Y=res.state.Y.numpy(), n_iters=res.n_iters,
                 world=torch.distributed.get_world_size())
    torch.distributed.destroy_process_group()
