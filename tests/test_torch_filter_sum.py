"""The ``fft_grouped`` kernels K13/K14 of the PyTorch port against the JAX
package's Pallas kernels (interpret mode on the CPU), on the same seeded
inputs, with f32 and bf16 phase tables, with one table set per image
(PT = PB) and with one table set shared by all images (PT = 1, which the
JAX package reaches through ``jax.vmap``: its rule folds the image batch
into the node axis). Tolerance 1e-5 of the output's max for both table
types: a bf16 table is upcast exactly and every product and sum is f32 on
both sides, so only the order of the sums differs. On the CPU the wrappers
run their plain versions; the CUDA kernels are held against the same plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops.pallas import filter_sum as jfs
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs

torch.set_num_threads(2)

RTOL = 1e-5
TB, TT, N, F = 2, 8, 24, 65  # slot blocks, slots per block, rows, frequencies
TP = TB * TT


def _tables(dtype_name, PT, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((2, PT, TP, N, F)).astype(np.float32)
    Hj = jnp.asarray(H).astype(jnp.dtype(dtype_name))
    Ht = torch.as_tensor(H).to(getattr(torch, dtype_name))
    return (Hj[0], Hj[1]), (Ht[0], Ht[1])


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_matches_jax_per_image_tables(dtype_name):
    PB = 3
    (hj, hij), (ht, hit) = _tables(dtype_name, PB)
    rng = np.random.default_rng(1)
    r = rng.standard_normal((2, PB, TB, N, F)).astype(np.float32)
    want = jfs.filter_sum_grouped(jnp.asarray(r[0]), jnp.asarray(r[1]), hj,
                                  hij)
    got = tfs.filter_sum_grouped(torch.as_tensor(r[0]), torch.as_tensor(r[1]),
                                 ht, hit)
    for g, w in zip(got, want):
        assert g.shape == (PB, TP, F)
        _close(g, w)
    # the plain reference of the JAX package gives the same
    for g, w in zip(got, jfs.filter_sum_grouped_reference(
            jnp.asarray(r[0]), jnp.asarray(r[1]), hj, hij)):
        _close(g, w)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_t_matches_jax_per_image_tables(dtype_name):
    PB = 3
    (hj, hij), (ht, hit) = _tables(dtype_name, PB)
    g = np.random.default_rng(2).standard_normal((2, PB, TP, F)).astype(
        np.float32)
    want = jfs.filter_sum_grouped_t(jnp.asarray(g[0]), jnp.asarray(g[1]), hj,
                                    hij, jnp.zeros((PB, TB, 2)))
    got = tfs.filter_sum_grouped_t(torch.as_tensor(g[0]),
                                   torch.as_tensor(g[1]), ht, hit, TB)
    for a, w in zip(got, want):
        assert a.shape == (PB, TB, N, F)
        _close(a, w)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_shared_table_matches_jax_vmap(dtype_name):
    """PT = 1 against four images: JAX's vmap over the images."""
    B = 4
    (hj, hij), (ht, hit) = _tables(dtype_name, 1)
    r = np.random.default_rng(3).standard_normal((2, B, 1, TB, N, F)).astype(
        np.float32)
    want = jax.vmap(lambda a, b: jfs.filter_sum_grouped(a, b, hj, hij))(
        jnp.asarray(r[0]), jnp.asarray(r[1]))
    got = tfs.filter_sum_grouped(torch.as_tensor(r[0]).reshape(B, TB, N, F),
                                 torch.as_tensor(r[1]).reshape(B, TB, N, F),
                                 ht, hit)
    for g, w in zip(got, want):
        _close(g, np.asarray(w).reshape(B, TP, F))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_t_shared_table_matches_jax_vmap(dtype_name):
    B = 4
    (hj, hij), (ht, hit) = _tables(dtype_name, 1)
    g = np.random.default_rng(4).standard_normal((2, B, 1, TP, F)).astype(
        np.float32)
    mark = jnp.zeros((1, TB, 2))
    want = jax.vmap(
        lambda a, b: jfs.filter_sum_grouped_t(a, b, hj, hij, mark))(
        jnp.asarray(g[0]), jnp.asarray(g[1]))
    got = tfs.filter_sum_grouped_t(torch.as_tensor(g[0]).reshape(B, TP, F),
                                   torch.as_tensor(g[1]).reshape(B, TP, F),
                                   ht, hit, TB)
    for a, w in zip(got, want):
        _close(a, np.asarray(w).reshape(B, TB, N, F))


def test_grouped_pair_is_a_transpose():
    """<K13 r, g> = <r, K14 g> with a shared table (PT = 1, PB = 3)."""
    (_, _), (ht, hit) = _tables("float32", 1)
    gen = torch.Generator().manual_seed(5)
    r = torch.randn((2, 3, TB, N, F), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 3, TP, F), generator=gen, dtype=torch.float64)
    Kr = tfs.filter_sum_grouped(r[0].float(), r[1].float(), ht, hit)
    Ktg = tfs.filter_sum_grouped_t(g[0].float(), g[1].float(), ht, hit, TB)
    lhs = sum(float((a.double() * b).sum()) for a, b in zip(Kr, g))
    rhs = sum(float((a * b.double()).sum()) for a, b in zip(r, Ktg))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_cpu_path_counts_no_launch():
    (_, _), (ht, hit) = _tables("float32", 1)
    tfs.reset_launch_counts()
    r = torch.zeros((2, TB, N, F))
    tfs.filter_sum_grouped(r, r, ht, hit)
    tfs.filter_sum_grouped_t(torch.zeros((2, TP, F)), torch.zeros((2, TP, F)),
                             ht, hit, TB)
    assert tfs.launch_counts() == {
        "filter_sum_sel": 0, "filter_sum_sel_t": 0,
        "filter_sum_grouped": 0, "filter_sum_grouped_t": 0}
