"""Processes on several hosts for the node mesh.

The mesh of ``parallel/mesh.py`` runs over the default process group of
``torch.distributed``; the sharded loop (``parallel/admm_sharded.py``) does
not care where the ranks live. This module holds the host-side plumbing of
the JAX package's ``parallel/multihost.py``:

- :func:`initialize` joins the process group (coordinator from its
  arguments or from ``MASTER_ADDR``/``MASTER_PORT``, the world from
  ``WORLD_SIZE``/``RANK``); a no-op in a single process.
- :func:`global_mesh` puts every rank, host-major, on a one-dimensional
  node mesh.
- :func:`problem_shardings` and :func:`distribute_problem` keep each rank's
  node block of every per-node array (the JAX package places the global
  arrays with their shardings; a torch rank holds only its own block).

The transport is the mesh's: NCCL when every rank of a host has a card of
its own, gloo otherwise (``mesh.pick_backend``).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from dip_admm_tpu_torch.data.loader import Problem
from dip_admm_tpu_torch.ops.kernels.filter_sum import padded, pitched_zeros
from dip_admm_tpu_torch.parallel.mesh import (
    NODE_AXIS, Mesh, make_mesh, pick_backend, shards_for, table_specs,
)

# The Problem fields split over the node axis; x_true is replicated.
_NODE_FIELDS = ("angles", "angle_valid", "b", "W", "Q", "keep", "adj",
                "opnorm")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the default process group, once per process, before any mesh.

    ``coordinator_address`` is "host:port" (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``) and ``process_id`` this rank (default ``RANK``). With
    neither a coordinator nor a world size, or with the group already up,
    it does nothing (a single process). The transport is
    ``mesh.pick_backend``'s for this host's ranks (``LOCAL_WORLD_SIZE``,
    else the whole world)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize: a multi-process run needs the "
                         "coordinator address, the number of processes and "
                         "this process's id (arguments or MASTER_ADDR/"
                         "MASTER_PORT, WORLD_SIZE and RANK)")
    backend = pick_backend(num_processes,
                           int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    # Gloo binds to the host name's interface unless told otherwise.
    if backend == "gloo" and coordinator_address.split(":")[0] in (
            "127.0.0.1", "localhost"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def check_host_major(hosts: list) -> None:
    """Raise ValueError unless each host's ranks are consecutive: the node
    mesh takes the ranks in order, so consecutive node blocks then share a
    host first (the JAX package's device order)."""
    seen: list = []
    for h in hosts:
        if seen and h == seen[-1]:
            continue
        if h in seen:
            raise ValueError(f"global_mesh: the ranks of host {h!r} are not "
                             f"consecutive ({hosts}); number the ranks host "
                             "by host (RANK)")
        seen.append(h)


def global_mesh(n_devices: Optional[int] = None,
                device: torch.device | str | None = None) -> Mesh:
    """A one-dimensional node mesh over every rank of the default group,
    host-major (:func:`check_host_major`). In a single process without a
    group it makes a world of one over an in-process store. ``n_devices``,
    if given, must be the world size (a mesh spans every rank).
    ``device`` is this rank's (default: its card, ``cuda:<LOCAL_RANK>``)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"global_mesh: {n_devices} ranks asked, the world "
                         f"has {world}; a mesh spans every rank")
    hosts: list = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    check_host_major(hosts)
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
    return make_mesh(world, 1, device)


def problem_shardings(problem: Problem, mesh: Mesh) -> dict:
    """Each Problem field's placement: ``NODE_AXIS`` (split by its leading
    node axis) or None (whole on every rank); ``fft_tables`` a tree of
    them by ``mesh.table_specs``, the rule the sharded loop slices by
    (leaves under ``"shared"`` whole, even where their leading size equals
    the node count)."""
    specs = {name: NODE_AXIS for name in _NODE_FIELDS}
    specs["x_true"] = None
    specs["fft_tables"] = table_specs(problem.fft_tables, problem.num_nodes)
    return specs


def _own(v: torch.Tensor) -> torch.Tensor:
    """A copy of ``v`` that owns its storage, pitched as ``v`` is
    (``filter_sum.pitched_zeros``), so that the whole it was cut from can
    be freed."""
    for dim in (-1, -2):
        if v.dim() >= 1 - dim and padded(v, dim) is not v:
            return pitched_zeros(v.shape, v.dtype, v.device, dim).copy_(v)
    return v.clone()


def distribute_problem(problem: Problem, mesh: Mesh) -> Problem:
    """This rank's node block of ``problem``, placed by
    :func:`problem_shardings`: every per-node array cut to the node block
    of the rank's node shard, the rest whole. ``run_admm_sharded`` takes it
    in place of the whole problem (it records the block in
    ``node_block``)."""
    if problem.node_block is not None:
        raise ValueError("distribute_problem: the problem is distributed "
                         "already")
    specs = problem_shardings(problem, mesh)
    P_loc = shards_for(problem.num_nodes, mesh)
    i0 = mesh.node_index * P_loc
    nodes = slice(i0, i0 + P_loc)

    def place(v, spec):
        if isinstance(v, dict):
            return {k: place(v[k], spec[k]) for k in v}
        return _own(v[nodes]) if spec == NODE_AXIS else v

    updates = {name: place(getattr(problem, name), spec)
               for name, spec in specs.items()}
    return dataclasses.replace(problem, node_block=(i0, i0 + P_loc),
                               **updates)
