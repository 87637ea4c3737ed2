"""The port's ``ops/linalg.py`` against the JAX package's on the CPU.

Seeded numpy SPD systems (n = 40, condition 30-100: float32 CG at 1e3
loses orthogonality and its residual trajectory then depends on the
libraries' rounding) go through both. CG's iteration count must equal
JAX's (the early exit at tol^2 ||b||^2, and the cap), its x within 1e-5 of
the solution's max and its final ||r||^2 below the exit threshold (within
rtol 5e-2 of JAX's at the cap); the power method from
JAX's start vector within rtol 1e-5; the Cholesky solve and ridge within
1e-5 of the max (float32 factorizations by different libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops import linalg as jlinalg
from dip_admm_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(2)

TOL = 1e-5


def _spd(n=40, cond=30.0, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.geomspace(1.0, cond, n)
    M = (q * eig) @ q.T
    return (0.5 * (M + M.T)).astype(np.float32), rng.standard_normal(
        n).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("cond,max_iters,tol", [
    (30.0, 200, 1e-6), (100.0, 200, 1e-6), (100.0, 12, 1e-8)],
    ids=["cond_30", "cond_100", "capped"])
def test_cg_matches_jax(cond, max_iters, tol):
    M, b = _spd(cond=cond)
    xj, rsj, kj = jlinalg.cg(lambda v: jnp.asarray(M) @ v, jnp.asarray(b),
                             max_iters=max_iters, tol=tol)
    Mt = torch.as_tensor(M)
    xt, rst, kt = tlinalg.cg(lambda v: Mt @ v, torch.as_tensor(b),
                             max_iters=max_iters, tol=tol)
    assert int(kt) == int(kj)
    _close(xt.numpy(), xj)
    if max_iters == 12:
        assert int(kt) == 12
        np.testing.assert_allclose(float(rst), float(rsj), rtol=0.05)
    else:  # stopped at the tolerance; its residual is rounding-level
        assert int(kt) < max_iters
        assert float(rst) <= tol**2 * float(b @ b)


def test_cg_from_a_start_and_zero_rhs():
    """A warm start x0, and b = 0 (no iteration: ||r||^2 = 0 at the
    floor), as in JAX."""
    M, b = _spd(seed=1)
    x0 = np.full_like(b, 0.5)
    xj, _, kj = jlinalg.cg(lambda v: jnp.asarray(M) @ v, jnp.asarray(b),
                           x0=jnp.asarray(x0), max_iters=200, tol=1e-6)
    Mt = torch.as_tensor(M)
    xt, _, kt = tlinalg.cg(lambda v: Mt @ v, torch.as_tensor(b),
                           x0=torch.as_tensor(x0), max_iters=200, tol=1e-6)
    assert int(kt) == int(kj)
    _close(xt.numpy(), xj)
    z = np.zeros_like(b)
    _, _, kj = jlinalg.cg(lambda v: jnp.asarray(M) @ v, jnp.asarray(z))
    _, _, kt = tlinalg.cg(lambda v: Mt @ v, torch.as_tensor(z))
    assert int(kt) == int(kj) == 0


def test_power_method_matches_jax():
    M, _ = _spd(cond=10.0, seed=2)
    u = np.random.default_rng(5).standard_normal(40).astype(np.float32)
    u /= np.linalg.norm(u)
    M = M + 40.0 * np.outer(u, u)  # the top eigenvalue ~50, the next <= 10
    lam_j = jlinalg.power_method(lambda v: jnp.asarray(M) @ v, (40,),
                                 iters=30, seed=0)
    v0 = torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (40,), jnp.float32)))
    Mt = torch.as_tensor(M)
    lam_t = tlinalg.power_method(lambda v: Mt @ v, (40,), iters=30, v0=v0)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-5)
    # its own draw lands on the same top eigenvalue within the power
    # method's convergence (rtol 1e-2 after 30 steps at a gap of 5x)
    own = tlinalg.power_method(lambda v: Mt @ v, (40,), iters=30,
                               device="cpu")
    np.testing.assert_allclose(float(own), float(lam_j), rtol=1e-2)


def test_solve_spd_and_ridge_match_jax():
    M, b = _spd(cond=1e2, seed=3)
    _close(tlinalg.solve_spd(torch.as_tensor(M), torch.as_tensor(b)).numpy(),
           jlinalg.solve_spd(jnp.asarray(M), jnp.asarray(b)))
    B2 = np.stack([b, 2 * b + 1], axis=1)
    _close(tlinalg.solve_spd(torch.as_tensor(M), torch.as_tensor(B2)).numpy(),
           jlinalg.solve_spd(jnp.asarray(M), jnp.asarray(B2)))
    rng = np.random.default_rng(4)
    A = rng.standard_normal((60, 30)).astype(np.float32)
    y = rng.standard_normal(60).astype(np.float32)
    _close(tlinalg.ridge_solve(torch.as_tensor(A), torch.as_tensor(y),
                               1e-2).numpy(),
           jlinalg.ridge_solve(jnp.asarray(A), jnp.asarray(y), 1e-2))
