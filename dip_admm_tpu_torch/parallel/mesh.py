"""The node x pixel device mesh on ``torch.distributed``, and its launcher.

A mesh of ``n_node * pixel`` ranks runs one process per rank over the
default process group, consecutive ranks on the pixel axis (as the JAX
package's ``parallel/mesh.py`` lays out its devices): rank r is node shard
r // pixel and pixel shard r % pixel. Graph nodes shard over the node axis;
the pixel axis shards the [P_loc, P, n] edge state along its pixels and,
under pixel compute, the skew projector's row blocks
(``parallel/admm_sharded.py``).

The transport is fixed when the mesh is made and the mesh records it:
NCCL when each rank has a card of its own, gloo otherwise. Under gloo the
payload of a collective on card tensors is copied to host memory, reduced
or exchanged there, and copied back: on a host with one card the ranks
share it, the compute stays on the card, and only the collectives' payloads
cross the host. No collective tries one transport and falls back to
another.

:func:`launch` starts the ranks itself (``torch.multiprocessing``, spawn)
and initialises the default process group in each from a rendezvous file.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

NODE_AXIS = "node"
PIXEL_AXIS = "pixel"
# The keys of a [P_loc, NB, ...] skew row-stage table that pixel compute
# splits along its row-block axis NB (dim 1).
ROW_TABLES = ("Wt", "WtT", "SEre", "SEim")

# torch >= 2.13 names it all_gather_single; older releases only have the
# deprecated name.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Mesh:
    """This rank's view of an ``n_node`` x ``pixel`` mesh: its shard
    indices, its device, the transport, and the collectives along each
    axis (``NODE_AXIS``, ``PIXEL_AXIS``, or None for the whole mesh)."""

    def __init__(self, n_node: int, pixel: int, device: torch.device,
                 transport: str, groups: dict):
        self.n_node, self.pixel = n_node, pixel
        self.rank = dist.get_rank()
        self.node_index, self.pixel_index = divmod(self.rank, pixel)
        self.device = device
        self.transport = transport
        self._groups = groups  # axis -> (process group, size)
        # Collectives run, their payload bytes in and their host seconds
        # (gloo: staging and exchange, after the device work queued before
        # them has finished).
        self.stats = {"collectives": 0, "bytes": 0, "seconds": 0.0}

    def _run(self, t: torch.Tensor, op: Callable[[torch.Tensor], Any]):
        """``op`` on a contiguous copy of ``t`` in the transport's memory:
        the card under NCCL, the host under gloo; the result on t's
        device."""
        gloo = self.transport == "gloo"
        if gloo and t.is_cuda:
            # The copy to the host would wait for it too; kept out of the
            # seconds counted.
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        if gloo:
            buf = t.detach().to("cpu", copy=True).contiguous()
        else:
            buf = t.detach().clone().contiguous()
        out = op(buf)
        out = (buf if out is None else out).to(t.device)
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def barrier(self) -> None:
        """Wait until every rank of the mesh has reached this point (rank
        0's files written before any rank reads them)."""
        if self._groups[None][1] > 1:
            dist.barrier(group=self._groups[None][0])

    def all_reduce(self, t: torch.Tensor, axis: str | None = None,
                   op: str = "sum") -> torch.Tensor:
        group, size = self._groups[axis]
        if size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run(t, lambda b: dist.all_reduce(b, red, group=group))

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The shards' ``t`` concatenated along ``dim`` in axis order."""
        group, size = self._groups[axis]
        if size == 1:
            return t
        dim = dim % t.dim()

        def op(b):
            out = torch.empty((size,) + tuple(b.shape), dtype=b.dtype,
                              device=b.device)
            _all_gather(out, b[None], group=group)
            return out

        out = self._run(t, op)  # [size, *t.shape]
        return out.movedim(0, dim).reshape(
            t.shape[:dim] + (size * t.shape[dim],) + t.shape[dim + 1:])

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk k of ``t`` along dim 0 goes to shard k of ``axis``; the
        chunks received come back concatenated along dim 0 in shard order."""
        group, size = self._groups[axis]
        if size == 1:
            return t

        def op(b):
            out = torch.empty_like(b)
            dist.all_to_all_single(out, b, group=group)
            return out

        return self._run(t, op)


def make_mesh(n_node: int, pixel: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over the default process group, whose world must be
    ``n_node * pixel`` ranks. ``device`` is this rank's device; under NCCL
    it defaults to ``cuda:<rank>``, under gloo it must be named (no CPU
    default: the port runs on the card unless asked for the CPU). Every
    rank must call it, in the same order as any other group creation."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group "
                           "first (or start the ranks with launch)")
    world = dist.get_world_size()
    if n_node < 1 or pixel < 1 or n_node * pixel != world:
        raise ValueError(f"make_mesh: a {n_node} x {pixel} mesh needs "
                         f"{n_node * pixel} ranks, the world has {world}")
    transport = dist.get_backend()
    if transport not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: unsupported backend {transport!r}")
    rank = dist.get_rank()
    if device is None:
        if transport != "nccl":
            raise ValueError("make_mesh: name this rank's device under gloo "
                             "(cuda or cpu); there is no default")
        device = f"cuda:{rank}"
    device = torch.device(device)
    if transport == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: NCCL needs each rank on its own card")
    groups = {None: (dist.group.WORLD, world)}
    # Every rank creates every subgroup, in one order.
    for j in range(pixel):
        g = dist.new_group([i * pixel + j for i in range(n_node)])
        if rank % pixel == j:
            groups[NODE_AXIS] = (g, n_node)
    for i in range(n_node):
        g = dist.new_group([i * pixel + j for j in range(pixel)])
        if rank // pixel == i:
            groups[PIXEL_AXIS] = (g, pixel)
    return Mesh(n_node, pixel, device, transport, groups)


def shards_for(num_nodes: int, mesh: Mesh) -> int:
    """Nodes per node shard; the node count must tile the node axis."""
    if num_nodes % mesh.n_node:
        raise ValueError(f"num_nodes={num_nodes} must be divisible by the "
                         f"node axis {mesh.n_node}")
    return num_nodes // mesh.n_node


def table_specs(tables: dict, num_nodes: int) -> dict:
    """The placement of each projector-table leaf (the JAX package's
    ``table_partition_specs``), the one rule :func:`slice_tables` and
    ``multihost.distribute_problem`` follow: ``NODE_AXIS`` for a per-node
    leaf (leading dim the node count), None for a leaf kept whole. Every
    leaf under a ``"shared"`` subtree is node-shared geometry and kept
    whole, even where its leading dim equals the node count."""
    def spec(tree, shared):
        return {k: spec(v, shared or k == "shared") if isinstance(v, dict)
                else (NODE_AXIS if not shared and v.dim() > 0
                      and v.shape[0] == num_nodes else None)
                for k, v in tree.items()}

    return spec(tables, False)


def slice_tables(tables: dict, num_nodes: int, nodes: slice,
                 rows: tuple[int, int] | None = None) -> dict:
    """The projector tables of the graph nodes ``nodes``: each leaf that
    :func:`table_specs` places on ``NODE_AXIS`` sliced along its node
    axis, the others whole. With ``rows`` = (shard, shards), the skew
    row-stage tables ``ROW_TABLES`` (top level on the parallel path, under
    ``shared.par`` on the fan path) keep only row-block shard ``shard`` of
    ``shards`` along their row-block axis NB. A node slice is a view that
    keeps its leaf's strides: the pitched ``fft_pallas`` and
    ``fft_grouped`` tables stay pitched (``filter_sum.pitched_zeros``; a
    copy by ``.contiguous()`` would drop the padding their kernels
    stream), and the slice of a contiguous leaf is contiguous."""
    def row_blocks(v):
        shard, shards = rows
        NB_loc = v.shape[1] // shards
        return v[:, shard * NB_loc:(shard + 1) * NB_loc].contiguous()

    def part(tree, specs):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = part(v, specs[k])
                continue
            if specs[k] == NODE_AXIS:
                v = v[nodes]
            if rows is not None and k in ROW_TABLES:
                v = row_blocks(v)
            out[k] = v
        return out

    return part(tables, table_specs(tables, num_nodes))


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def pick_backend(world: int, local_ranks: int | None = None,
                 on_cards: bool = True) -> str:
    """The transport of a world of ``world`` ranks, ``local_ranks`` of
    them on this host (default: all): NCCL when the ranks run on cards and
    this host has a card for each of its ranks, gloo otherwise (ranks
    sharing a card, or on the CPU). :func:`launch` and
    ``multihost.initialize`` both ask here."""
    local = world if local_ranks is None else local_ranks
    return ("nccl" if on_cards and world > 1 and torch.cuda.is_available()
            and torch.cuda.device_count() >= local else "gloo")


def _entry(rank, world, init_method, backend, device, threads, fn, args,
           results):
    try:
        # Gloo's rendezvous binds to the host name's interface unless told
        # otherwise; the loopback one is always there.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(threads)
        if backend == "nccl":
            device = f"cuda:{rank}"
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(rank, torch.device(device), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world: int, device: torch.device | str,
           args: tuple = (), init_file: str | None = None,
           threads: int = 1) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` spawned ranks with the
    default process group initialised, and return their results in rank
    order. ``fn`` must be importable by module and name (the ranks import
    it; they import nothing of the caller's ``__main__`` beyond that), and
    its result picklable. The backend is NCCL when ``device`` is a card and
    the host has one per rank (each rank on ``cuda:<rank>``), else gloo
    with every rank on ``device``. ``init_file`` is the rendezvous file
    (default: a fresh one in a temporary directory); ``threads`` the torch
    threads of each rank. A rank that raises or dies ends the launch: the
    others are stopped and its traceback or exit code is raised here."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    backend = pick_backend(world, on_cards=device.type == "cuda")
    tmp = None
    if init_file is None:
        tmp = tempfile.TemporaryDirectory()
        init_file = os.path.join(tmp.name, "rendezvous")
    elif os.path.exists(init_file) and os.path.getsize(init_file):
        # A file store left by an earlier world points at its dead ranks.
        raise ValueError(f"launch: the rendezvous file {init_file} is in use")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(
        rank, world, f"file://{os.path.abspath(init_file)}", backend,
        str(device), threads, fn, args, results), daemon=True)
        for rank in range(world)]
    for p in procs:
        p.start()
    out, error = {}, None
    try:
        while len(out) < world and error is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    error = f"rank {dead[0]} exited with code " \
                            f"{procs[dead[0]].exitcode}"
                continue
            if ok:
                out[rank] = val
            else:
                error = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join()
        if tmp is not None:
            tmp.cleanup()
    if error is not None:
        raise RuntimeError(f"launch: {error}")
    return [out[r] for r in range(world)]
