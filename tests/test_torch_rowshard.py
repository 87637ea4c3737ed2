"""The row-sharded ``fft_skew`` projector of the port against the JAX
package's, on the CPU, at N = 16 with ``row_block=8`` (NB = 2 row blocks,
one per shard of a 2-wide pixel axis).

- K6 (``skew_sum_planes_t_rows``), the port's plain version on each shard's
  row block against JAX's interpret-mode kernel, with f32 tables (1e-5 of
  the output's max) and bf16 tables (2e-3: sums in another order, and a
  bf16 rounding can land on the other side); the shards' outputs
  concatenated along the rows equal the port's K2 on all row blocks.
- ``row_block`` tables of the port's loader against JAX's, parallel and fan
  (f32, all O(1): 1e-5 absolute; integer fields equal).
- The row-sharded pair on a 2-rank gloo world (``parallel.mesh.launch``;
  the ranks import only the port) against JAX's pair under ``shard_map``
  on a 2-device pixel mesh, each on its own f32 tables (1e-4 of the
  output's max, as the port's other operator tests), and against the
  port's unsharded pair (1e-6: the same sums, the row blocks' spectra added
  in the same order by the pixel-axis sum).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import _torch_mesh_worker as worker
from dip_admm_tpu import config as jcfg
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.ops import radon_fan as jfan
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import shear_sum as jss
from dip_admm_tpu.parallel import mesh as jmesh
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fan as tfan
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import shear_sum as tss
from dip_admm_tpu_torch.parallel import mesh as tmesh
from test_torch_shear_sum import _close, _tables_to_torch

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
OP_RTOL = 1e-4
ROW_BLOCK = 8
N = 16
GEOS = {
    "parallel": dict(N=N, num_nodes=4, angles_total=16),
    "fan": dict(N=N, num_nodes=4, angles_total=32, fan_beam=True,
                det_width_factor=2.0),
}


def _geos(kind):
    t = tcfg.GeometryConfig(**GEOS[kind])
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_skew_sum_planes_t_rows_matches_jax(dtype_name):
    geo_t, geo_j = _geos("parallel")
    a, v, _ = tradon.node_angles(geo_t)
    tj = jfft.precompute_shear(geo_j, jnp.asarray(a, jnp.float32),
                               jnp.asarray(v), jnp.dtype(dtype_name),
                               nb=ROW_BLOCK)
    tt = _tables_to_torch(tj)
    P, NB, D2, Tp, nb = tt["WtT"].shape
    assert NB == 2
    F = tt["SEre"].shape[-1]
    rng = np.random.default_rng(2)
    gre, gim = (rng.standard_normal((P, Tp, F)).astype(np.float32)
                for _ in range(2))
    sh, jsh = tt["shared"], tj["shared"]
    vis = np.asarray(tj["pvisited"])[:, :, None, None] > 0
    shards = []
    for s in range(NB):
        rows = slice(s, s + 1)
        want = jss.skew_sum_planes_t_rows(
            jnp.asarray(gre), jnp.asarray(gim), tj["WtT"][:, rows],
            tj["SEre"][:, rows], tj["SEim"][:, rows], jsh["DreT"],
            jsh["DimT"], tj["plane"], tj["pfirst"], jnp.zeros((1, N)))
        got = tss.skew_sum_planes_t_rows(
            torch.as_tensor(gre), torch.as_tensor(gim),
            tt["WtT"][:, rows].contiguous(), tt["SEre"][:, rows].contiguous(),
            tt["SEim"][:, rows].contiguous(), sh["DreT"], sh["DimT"],
            tt["plane"], N)
        assert got.shape == (P, 2, nb, N)
        _close(got, np.where(vis, np.asarray(want), 0.0), RTOL[dtype_name])
        shards.append(got)
    whole = tss.skew_sum_planes_t(
        torch.as_tensor(gre), torch.as_tensor(gim), tt["WtT"], tt["SEre"],
        tt["SEim"], sh["DreT"], sh["DimT"], tt["plane"])
    _close(torch.cat(shards, dim=2), whole.numpy(), 1e-6)


@pytest.mark.parametrize("kind", list(GEOS))
def test_row_block_tables_match_jax(kind):
    """``build_fft_tables(..., row_block=8)`` against the JAX loader's
    ``row_block`` tables (parallel at top level, fan under shared.par)."""
    geo_t, geo_j = _geos(kind)
    cfg_j = jcfg.ProblemConfig(geometry=geo_j)
    cfg_t = tcfg.ProblemConfig(geometry=geo_t)
    a, v, _ = tradon.node_angles(geo_t)
    tj = jloader.build_fft_tables(cfg_j, jnp.asarray(a, jnp.float32),
                                  jnp.asarray(v), "fft_skew",
                                  row_block=ROW_BLOCK)
    tt = tloader.build_fft_tables(cfg_t, torch.as_tensor(a, dtype=torch.float32),
                                  torch.as_tensor(v), "fft_skew",
                                  row_block=ROW_BLOCK)
    if kind == "fan":
        tj, tt = tj["shared"]["par"], tt["shared"]["par"]
    assert tt["WtT"].shape == np.asarray(tj["WtT"]).shape
    assert tt["WtT"].shape[1] == 2
    for k in ("WtT", "SEre", "SEim", "Wd", "TEre", "TEim"):
        # Taps, phases and scales are O(1), some tables all zero at N = 16.
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(tj[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    for k in ("plane", "posfull", "pfirst"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("kind", list(GEOS))
def test_slice_tables_follows_jax_placement(kind):
    """``mesh.slice_tables`` at node shard 1 and pixel shard 1 of a 2 x 2
    mesh against the JAX tables cut as that shard holds them under
    pixel compute: ``table_partition_specs`` plus ``run_admm_sharded``'s
    row-block specs (same leaves, same shapes, 1e-5 absolute). Each node's
    angles are offset, so that the node blocks' tables differ."""
    geo_t, geo_j = _geos(kind)
    a, v, _ = tradon.node_angles(geo_t)
    P = geo_t.num_nodes
    a = a + 0.05 * np.arange(P)[:, None]
    tj = jloader.build_fft_tables(jcfg.ProblemConfig(geometry=geo_j),
                                  jnp.asarray(a, jnp.float32), jnp.asarray(v),
                                  "fft_skew", row_block=ROW_BLOCK)
    tt = tloader.build_fft_tables(tcfg.ProblemConfig(geometry=geo_t),
                                  torch.as_tensor(a, dtype=torch.float32),
                                  torch.as_tensor(v), "fft_skew",
                                  row_block=ROW_BLOCK)
    specs = jax.tree_util.tree_map(lambda s: s,
                                   jmesh.table_partition_specs(tj, P))
    rows = specs["shared"]["par"] if kind == "fan" else specs
    for k in ("Wt", "WtT", "SEre", "SEim"):
        if k in rows:
            rows[k] = PS(None if kind == "fan" else jmesh.NODE_AXIS,
                         jmesh.PIXEL_AXIS)

    def cut(leaf, spec):
        out = np.asarray(leaf)
        for dim, axis in enumerate(spec):
            if axis is not None:  # shard 1 of 2 on either axis
                size = out.shape[dim] // 2
                out = np.take(out, np.arange(size, 2 * size), axis=dim)
        return out

    want = dict(_leaves(jax.tree_util.tree_map(cut, tj, specs)))
    got = dict(_leaves(tmesh.slice_tables(tt, P, slice(P // 2, P), (1, 2))))
    common = set(want) & set(got)
    row_keys = {(("shared", "par") if kind == "fan" else ()) + (k,)
                for k in ("WtT", "SEre", "SEim")}
    assert row_keys <= common
    for path in sorted(common):
        w, g = want[path], got[path].float().numpy() \
            if got[path].is_floating_point() else got[path].numpy()
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=0, atol=1e-5,
                                   err_msg=str(path))


def _jax_rowshard_pair(kind, geo_j, x, y):
    """JAX's row-sharded pair under shard_map on a 1 x 2 (node x pixel)
    mesh, its row-stage tables split along NB over the pixel axis."""
    cfg_j = jcfg.ProblemConfig(geometry=geo_j)
    a, v, _ = tradon.node_angles(tcfg.GeometryConfig(
        **dataclasses.asdict(geo_j)))
    t = jloader.build_fft_tables(cfg_j, jnp.asarray(a, jnp.float32),
                                 jnp.asarray(v), "fft_skew",
                                 row_block=ROW_BLOCK)
    spec = jax.tree_util.tree_map(lambda _: PS(), t)
    rows = spec["shared"]["par"] if kind == "fan" else spec
    for k in ("WtT", "SEre", "SEim"):
        rows[k] = PS(None, jmesh.PIXEL_AXIS)
    if kind == "fan":
        fwd, adj = (jfan.project_nodes_fan_skew_rowshard,
                    jfan.backproject_nodes_fan_skew_rowshard)
    else:
        fwd, adj = (jfft.project_nodes_skew_rowshard,
                    jfft.backproject_nodes_skew_rowshard)
    mesh = jmesh.make_mesh(1, pixel=2)

    def on_mesh(f, arg):
        body = jax.shard_map(
            lambda u, tab: f(geo_j, u, tab, jmesh.PIXEL_AXIS), mesh=mesh,
            in_specs=(PS(), spec), out_specs=PS(), check_vma=False)
        return np.asarray(jax.jit(body)(jnp.asarray(arg), t))

    return on_mesh(fwd, x), on_mesh(adj, y)


@pytest.mark.parametrize("kind", list(GEOS))
def test_rowshard_pair_matches_jax_and_unsharded(kind, tmp_path):
    geo_t, geo_j = _geos(kind)
    a, v, _ = tradon.node_angles(geo_t)
    P, m = geo_t.num_nodes, a.shape[1]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((P, N, N)).astype(np.float32)
    y = rng.standard_normal((P, m, geo_t.n_det)).astype(np.float32)
    cfg_t = tcfg.ProblemConfig(geometry=geo_t)
    spec = {"cfg": json.dumps(dataclasses.asdict(cfg_t)),
            "row_block": ROW_BLOCK}
    got = tmesh.launch(worker.rowshard_pair, 2, "cpu", args=(spec, x, y),
                       init_file=str(tmp_path / "rendezvous"))[0]
    assert got["NB"] == 2
    Ax_j, Aty_j = _jax_rowshard_pair(kind, geo_j, x, y)
    _close(got["Ax"], Ax_j, OP_RTOL)
    _close(got["Aty"], Aty_j, OP_RTOL)
    t = tloader.build_fft_tables(cfg_t, torch.as_tensor(a, dtype=torch.float32),
                                 torch.as_tensor(v), "fft_skew",
                                 row_block=ROW_BLOCK)
    fwd, adj = ((tfan.project_nodes_fan_skew, tfan.backproject_nodes_fan_skew)
                if kind == "fan" else
                (tfft.project_nodes_skew, tfft.backproject_nodes_skew))
    _close(got["Ax"], fwd(geo_t, torch.as_tensor(x), t).numpy(), 1e-6)
    _close(got["Aty"], adj(geo_t, torch.as_tensor(y), t).numpy(), 1e-6)
