"""The port's ``fcv`` node solver against the JAX package's, on the CPU.

A small dense random problem (P=2 nodes, 16x16 images, 300 Gaussian
measurement rows each) is built with numpy and applied by both packages.

- ``build_fourier_precond`` with JAX's Lanczos start passed in: m_hat to
  rtol 1e-5, sigma to rtol 1e-6, step to rtol 1e-4 (25 Lanczos steps in
  float32 and an eigvalsh of the tridiagonal, in another FFT library).
- The port's own certificate, with its default start: 0.95 lambda_true <=
  lambda_est <= 1.001 lambda_true against a dense generalized eigh.
- The divergence monitor with the step scaled x50: the same step halvings,
  the same rolled-back x (rtol 1e-4 of its max) and the same final
  residual (rtol 1e-3: it is recomputed, or taken from a diverged check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from dip_admm_tpu.config import NodeSolverConfig as JNodeCfg
from dip_admm_tpu.core import node_solver as jns
from dip_admm_tpu_torch.config import NodeSolverConfig as TNodeCfg
from dip_admm_tpu_torch.core import node_solver as tns
from dip_admm_tpu_torch.ops import tv

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

P, M, N = 2, 300, 16
n = N * N
RHO = 2.0


def _problem(seed=3):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((P, M, n)) / np.sqrt(M)).astype(np.float32)
    x_star = rng.standard_normal((P, n)).astype(np.float32)
    D = (0.2 + 0.4 * rng.random((P, n))).astype(np.float32)
    b = np.einsum("pmn,pn->pm", A, x_star).astype(np.float32)
    return A, D, b


def _ops_jax(A):
    Aj = jnp.asarray(A)
    return (lambda x: jnp.einsum("pmn,pn->pm", Aj, x),
            lambda r: jnp.einsum("pmn,pm->pn", Aj, r))


def _ops_torch(A):
    At = torch.as_tensor(A)
    return (lambda x: torch.einsum("pmn,pn->pm", At, x),
            lambda r: torch.einsum("pmn,pm->pn", At, r))


def _jax_v0():
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                      jnp.float32))


def test_precond_matches_jax_with_its_start():
    A, D, _ = _problem()
    fj = jns.build_fourier_precond(*_ops_jax(A), jnp.asarray(D), RHO,
                                   JNodeCfg(algorithm="fcv"), N)
    ft = tns.build_fourier_precond(*_ops_torch(A), torch.as_tensor(D), RHO,
                                   TNodeCfg(algorithm="fcv"), N,
                                   v0=torch.as_tensor(_jax_v0()))
    np.testing.assert_allclose(ft.m_hat.numpy(), np.asarray(fj.m_hat),
                               rtol=1e-5)
    np.testing.assert_allclose(ft.sigma.numpy(), np.asarray(fj.sigma),
                               rtol=1e-6)
    np.testing.assert_allclose(ft.step.numpy(), np.asarray(fj.step),
                               rtol=1e-4)


def test_certified_step_brackets_dense_spectrum():
    """With the port's own Lanczos start, the top Ritz value sits within
    5% below the dense generalized eigenvalue of (S, M) and not above it."""
    A, D, _ = _problem()
    Dt = torch.as_tensor(D)
    fwd, adj = _ops_torch(A)
    fp = tns.build_fourier_precond(fwd, adj, Dt, RHO,
                                   TNodeCfg(algorithm="fcv"), N)
    eye = torch.eye(n).reshape(n, N, N)
    ktk = tv.grad_adjoint(*tv.grad(eye)).reshape(n, n)  # symmetric
    lam_est = 0.95 / fp.step.numpy()
    for p in range(P):
        Ap = torch.as_tensor(A[p]).double()
        S = (0.5 * (Ap.T @ Ap + RHO * torch.diag(Dt[p].double()))
             + float(fp.sigma[p]) * ktk.double())
        Mc = torch.fft.irfft2(fp.m_hat[p] * torch.fft.rfft2(eye), s=(N, N))
        Md = Mc.reshape(n, n).double()
        lam_true = scipy.linalg.eigh(
            S.numpy(), (0.5 * (Md + Md.T)).numpy(), eigvals_only=True,
            subset_by_index=[n - 1, n - 1])[0]
        assert lam_est[p] <= lam_true * (1.0 + 1e-3), (lam_est[p], lam_true)
        assert lam_est[p] >= 0.95 * lam_true, (lam_est[p], lam_true)


@pytest.mark.parametrize("check_every", [30, 10])
def test_divergence_monitor_matches_jax(check_every):
    """The certified step scaled x50 diverges. One check at 30 steps sees a
    non-finite residual: the step halves, x rolls back to the start and the
    residual, still inf, is recomputed. Checks every 10 steps see the
    residual grow past 5x its minimum: the step halves twice and x rolls
    back to the first check."""
    A, D, b = _problem()
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal((P, n)).astype(np.float32)
    b_cons = (D * rng.standard_normal((P, n))).astype(np.float32)
    c_quad = np.zeros(P, np.float32)
    L = np.ones(P, np.float32)  # unused by fcv
    fj = jns.build_fourier_precond(*_ops_jax(A), jnp.asarray(D), RHO,
                                   JNodeCfg(algorithm="fcv"), N)
    fj = fj._replace(step=fj.step * 50.0)
    ft = tns.FourierPrecond(*(torch.as_tensor(np.array(v)) for v in fj))
    kw = dict(algorithm="fcv", max_inner=30, check_every=check_every)

    st_j = jns.init_state(P, N, M)._replace(x=jnp.asarray(x0))
    rj = jns.solve_nodes(*_ops_jax(A), jnp.asarray(b), jnp.asarray(D),
                         jnp.asarray(b_cons), jnp.asarray(c_quad), 0.02, RHO,
                         jnp.asarray(L), st_j, jnp.asarray(1e-3),
                         JNodeCfg(**kw), N, fprecond=fj)
    st_t = tns.init_state(P, N, M, "cpu")._replace(x=torch.as_tensor(x0))
    rt = tns.solve_nodes(*_ops_torch(A), torch.as_tensor(b),
                         torch.as_tensor(D), torch.as_tensor(b_cons),
                         torch.as_tensor(c_quad), 0.02, RHO,
                         torch.as_tensor(L), st_t, torch.tensor(1e-3),
                         TNodeCfg(**kw), N, fprecond=ft)

    halvings = 1 if check_every == 30 else 2
    tk_want = np.asarray(fj.step) * 0.5**halvings
    np.testing.assert_array_equal(np.asarray(rj.state.tk), tk_want)
    np.testing.assert_array_equal(rt.state.tk.numpy(), tk_want)
    xj = np.asarray(rj.state.x)
    if check_every == 30:
        np.testing.assert_array_equal(xj, x0)
    np.testing.assert_allclose(rt.state.x.numpy(), xj, rtol=1e-4,
                               atol=1e-4 * np.abs(xj).max())
    gj = np.asarray(rj.g_norm)
    assert np.isfinite(gj).all()
    np.testing.assert_allclose(rt.g_norm.numpy(), gj, rtol=1e-3)
