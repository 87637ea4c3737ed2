"""Inexact node-subproblem solver: batched Condat-Vu primal-dual iteration.

The subproblem at node i and outer iteration k is

    min_x  0.5 ||A_i x - b_i||^2 + lam_tv * TV(x)
           + (rho/2) sum_j ||x - v_ij||^2_{Q_ij}

split as f(x) + h(Kx): f = smooth LS + diagonal quadratic (gradient
A^T(Ax-b) + rho*(D x - b_cons) with D = sum_j Q_ij, b_cons = sum_j Q_ij v_ij),
h = lam_tv * ||.||_{2,1}, K = the forward-difference gradient. Condat-Vu:

    x+ = x - T (grad f(x) + K^T u)
    u+ = Proj_{|.| <= lam_tv} (u + sigma * K (2 x+ - x))

with T = tau (``cv``), T = s M^-1 in a circulant Fourier metric M
(``fcv``, see :func:`build_fourier_precond`) or a per-pixel T from the
Gershgorin row sums of A^T A (``pcv``). ``ppdhg`` is diagonally
preconditioned PDHG with A in the dual, ``fista`` accelerated proximal
gradient with a Chambolle TV prox and gradient restart. All P node
problems run as one batched iteration. Every ``check_every`` steps the stationarity residual
    g = A^T(Ax - b) + rho*(D x - b_cons) + lam_tv * K^T(Kx/|Kx|)
is checked against the target eps_k; the loop stops when every node meets
it, when no node improved by ``plateau_tol`` since the last check, or at
``max_inner``. Loop control runs on the host: one device sync per check.
Nodes that meet the target keep iterating until all finish.

``groups=B`` solves B independent problems of P nodes each, laid out
b-major on the node axis (node b*P + p): the JAX package's ``vmap`` of the
solve over scenarios. Each group makes its own stop decision (its target,
plateau and divergence tests reduce over its own nodes) and a group whose
loop has ended is frozen, state, residuals and inner count, while the
others step on; still one device sync per check.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from dip_admm_tpu_torch.config import NodeSolverConfig
from dip_admm_tpu_torch.ops import tv
from dip_admm_tpu_torch.utils import profiling

ALGORITHMS = ("cv", "fcv", "pcv", "ppdhg", "fista")


class NodeState(NamedTuple):
    """Warm-started inner-solver state (per node, batched), field for
    field the JAX package's."""

    x: torch.Tensor  # [P, n]
    ux: torch.Tensor  # [P, N, N] TV dual, x-component
    uy: torch.Tensor  # [P, N, N] TV dual, y-component
    ua: torch.Tensor  # [P, m] ppdhg: the data-fit dual
    # fcv: x at the last check (rollback point); fista: the previous x
    xp: torch.Tensor  # [P, n]
    # fcv: the adapted step (inf when fresh); fista: the t-sequence
    tk: torch.Tensor  # [P]


class FourierPrecond(NamedTuple):
    """Circulant (Fourier-diagonal) metric M = F^-1 diag(m_hat) F of
    ``fcv``: the parallel-beam normal operator A_i^T A_i is close to
    shift-invariant, so one per-node transfer function captures its
    spectrum."""

    m_hat: torch.Tensor  # [P, N, N//2+1] real positive symbol of M
    step: torch.Tensor  # [P] certified primal step scale s: T = s M^-1
    sigma: torch.Tensor  # [P] dual (TV) step


class NodeSolveResult(NamedTuple):
    state: NodeState
    g_norm: torch.Tensor  # [P] final stationarity residual norms
    objective: torch.Tensor  # [P] node objective values
    # [P] iterations to first acceptance (check_every granularity); nodes
    # that never met the target record the full trip count.
    inner_iters: torch.Tensor
    # iterations the batched solve executed: an int, or with groups > 1 a
    # [B] tensor, each group's own
    trip_count: int | torch.Tensor
    # [P] 0 = accepted at eps_k, 1 = plateau exit before the budget,
    # 2 = ran the full inner budget without meeting the target.
    accept_code: torch.Tensor


def init_state(P: int, N: int, m: int, device, dtype=torch.float32) -> NodeState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return NodeState(
        x=z(P, N * N), ux=z(P, N, N), uy=z(P, N, N), ua=z(P, m),
        xp=z(P, N * N),
        # inf = fresh: fcv takes min(tk, certified step), the full step.
        tk=torch.full((P,), float("inf"), dtype=dtype, device=device),
    )


def _m_apply(m_hat: torch.Tensor, v: torch.Tensor, N: int) -> torch.Tensor:
    """M v = F^-1 diag(m_hat) F v for [P, n] images."""
    V = torch.fft.rfft2(v.reshape(-1, N, N))
    return torch.fft.irfft2(m_hat * V, s=(N, N)).reshape(v.shape[0], -1)


def _m_inv(m_hat: torch.Tensor, r: torch.Tensor, N: int) -> torch.Tensor:
    """M^-1 r = F^-1 (F r / m_hat) for [P, n] images."""
    R = torch.fft.rfft2(r.reshape(-1, N, N))
    return torch.fft.irfft2(R / m_hat, s=(N, N)).reshape(r.shape[0], -1)


def build_fourier_precond(
    fwd: Callable[[torch.Tensor], torch.Tensor],
    adj: Callable[[torch.Tensor], torch.Tensor],
    D_vec: torch.Tensor,  # [P, n] = sum_j Q_ij
    rho: float,
    cfg: NodeSolverConfig,
    N: int,
    n_lanczos: int = 25,
    v0: torch.Tensor | None = None,
) -> FourierPrecond:
    """Per-node circulant symbol and certified steps of ``fcv``.

    m_hat = |F[PSF]| + rho*mean(D) + sigma*l_hat, floored at 1e-6 of its
    max, with PSF = A^T A delta_center (one operator pair per node) and
    l_hat the symbol of K^T K. The step s = 0.95 / lambda_max, where
    lambda_max is the top Ritz value of ``n_lanczos`` Lanczos steps on
    M^-1 (H/2 + sigma K^T K) in the M inner product (H = A^T A +
    rho diag(D)): the Condat-Vu metric condition holds iff s <= 1/lambda.

    ``v0`` [n] is the Lanczos start, shared by every node. JAX draws it
    with ``jax.random.normal(PRNGKey(0))``, which torch cannot reproduce;
    the default is a normal draw from a generator seeded with 0, and a
    caller that must match the JAX package passes JAX's draw."""
    P, n = D_vec.shape
    dtype, dev = D_vec.dtype, D_vec.device
    center = (N // 2) * N + (N // 2)
    e = torch.zeros((P, n), dtype=dtype, device=dev)
    e[:, center] = 1.0
    psf = adj(fwd(e)).reshape(P, N, N)
    # The probe sits half a pixel off the periodic center (even N): the
    # modulus drops the residual linear phase ramp.
    psf = torch.roll(psf, (-(N // 2), -(N // 2)), dims=(1, 2))
    m_hat_A = torch.abs(torch.fft.rfft2(psf))
    d_mean = torch.mean(D_vec, dim=1)

    # Dual step on cv's local scale; without a consensus quadratic
    # (rho*D = 0) fall back to the operator's own spectral scale.
    Ksq = tv.GRAD_OPNORM_SQ
    scale = rho * d_mean
    scale = torch.where(scale > 0, scale, 4.0 * torch.amax(m_hat_A, dim=(1, 2)))
    sigma = (cfg.sigma_scale * scale / (2.0 * Ksq)).to(dtype)

    # The symbol of sigma K^T K (the periodic Laplacian), where CT's
    # spectrum decays and K's peaks.
    kx = torch.arange(N, device=dev, dtype=dtype)[:, None]
    ky = torch.arange(N // 2 + 1, device=dev, dtype=dtype)[None, :]
    l_hat = (4.0 * torch.sin(torch.pi * kx / N) ** 2
             + 4.0 * torch.sin(torch.pi * ky / N) ** 2)
    m_hat = m_hat_A + rho * d_mean[:, None, None] + sigma[:, None, None] * l_hat
    m_hat = torch.maximum(
        m_hat, 1e-6 * torch.amax(m_hat, dim=(1, 2), keepdim=True)
    ).to(dtype)

    def S(x):  # H/2 + sigma K^T K
        gx, gy = tv.grad(x.reshape(P, N, N))
        ktk = tv.grad_adjoint(gx, gy).reshape(P, -1)
        return 0.5 * (adj(fwd(x)) + rho * (D_vec * x)) + sigma[:, None] * ktk

    def m_norm_sq(v):
        return torch.sum(v * _m_apply(m_hat, v, N), dim=1)

    # Lanczos on G = M^-1 S in the M inner product:
    #   alpha_j = v_j^T S v_j, w = G v_j - alpha_j v_j - beta_{j-1} v_{j-1},
    #   beta_j = ||w||_M; a breakdown (beta ~ 0) freezes the recurrence.
    if v0 is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        v0 = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    v = v0.to(device=dev, dtype=dtype).expand(P, n)
    b0 = torch.sqrt(torch.clamp(m_norm_sq(v), min=1e-30))
    v = v / b0[:, None]
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((P,), dtype=dtype, device=dev)
    alphas, betas = [], []
    for _ in range(n_lanczos):
        Sv = S(v)
        alpha = torch.sum(v * Sv, dim=1)
        w = (_m_inv(m_hat, Sv, N) - alpha[:, None] * v
             - beta_prev[:, None] * v_prev)
        beta = torch.sqrt(torch.clamp(m_norm_sq(w), min=0.0))
        live = beta > 1e-12 * torch.clamp(torch.abs(alpha), min=1.0)
        v_next = torch.where(live[:, None],
                             w / torch.clamp(beta, min=1e-30)[:, None], 0.0)
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, dim=1)  # [P, k]
    b = torch.stack(betas, dim=1)[:, :-1]  # beta_j couples v_j and v_{j+1}
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    profiling.count("sync")
    with profiling.span("sync", site="fcv.eigvalsh"):
        lam_max = torch.linalg.eigvalsh(T)[:, -1]
    # Ritz values lower-bound the spectral radius; 0.95 covers what 25
    # steps leave, and the divergence monitor of solve_nodes the rest.
    step = (0.95 / torch.clamp(lam_max, min=1e-30)).to(dtype)
    return FourierPrecond(m_hat=m_hat, step=step, sigma=sigma)


def solve_nodes(
    fwd: Callable[[torch.Tensor], torch.Tensor],
    adj: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,  # [P, m]
    D_vec: torch.Tensor,  # [P, n] = sum_j Q_ij (masked)
    b_cons: torch.Tensor,  # [P, n] = sum_j Q_ij v_ij
    c_quad: torch.Tensor,  # [P] = sum_{j,p} Q_ij v_ij^2 (objective constant)
    lam_tv: float | torch.Tensor,  # a scalar or per node [P]
    rho: float | torch.Tensor,  # a 0-d tensor under adapt_rho, or per node
    L: torch.Tensor,  # [P] Lipschitz bounds ||A^T A|| + rho*max(D)
    state: NodeState,
    eps_k: torch.Tensor,  # scalar or [P] adaptive stationarity target
    cfg: NodeSolverConfig,
    N: int,
    fprecond: FourierPrecond | None = None,  # required for algorithm="fcv"
    any_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
    groups: int = 1,
    group_active: torch.Tensor | None = None,
) -> NodeSolveResult:
    """Batched inexact node solves. ``any_reduce`` ORs the continue flags
    (and the final residual's recompute flag) across the shards of a mesh,
    so every shard runs the same inner trip count and the same collectives;
    it is applied where the host syncs on the flag anyway.

    ``groups`` splits the P nodes into that many independent problems
    (see the module docstring); ``rho`` may then be a per-node [P] tensor.
    ``group_active`` [groups] bool leaves the groups that are False
    untouched from the start (the frozen scenarios of a batched run,
    whose results the caller discards)."""
    with profiling.span("node.solve"):
        if cfg.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown inner algorithm {cfg.algorithm!r}")
        P, n = D_vec.shape
        if P % groups:
            raise ValueError(f"{P} nodes do not split into {groups} groups")
        dtype = state.x.dtype
        dev = state.x.device
        Ksq = tv.GRAD_OPNORM_SQ
        if any_reduce is None:
            any_reduce = lambda v: v  # noqa: E731
        # Per-node lam_tv and rho enter as columns (and lam as [P, 1, 1] for
        # the TV duals); scalars stay Python floats or 0-d tensors.
        per_node = lambda v: (  # noqa: E731
            isinstance(v, torch.Tensor) and v.dim() > 0)
        lam = lam_tv if per_node(lam_tv) else float(lam_tv)
        lam_c = lam[:, None] if per_node(lam) else lam
        lam_im = lam[:, None, None] if per_node(lam) else lam
        rho_c = rho[:, None] if per_node(rho) else rho

        def grad_f(x):
            return adj(fwd(x) - b) + rho_c * (D_vec * x - b_cons)

        def g_residual(x):
            sub = tv.tv_subgradient(x.reshape(P, N, N)).reshape(P, -1)
            return grad_f(x) + lam_c * sub

        def cv_step(metric, sig_im):
            """A Condat-Vu step whose primal step is ``metric(d, st)``."""
            def step(st):
                ktu = tv.grad_adjoint(st.ux, st.uy).reshape(P, -1)
                x_new = st.x - metric(grad_f(st.x) + ktu, st)
                gx, gy = tv.grad((2.0 * x_new - st.x).reshape(P, N, N))
                ux, uy = tv.project_l2_ball(st.ux + sig_im * gx,
                                            st.uy + sig_im * gy, lam_im)
                return st._replace(x=x_new, ux=ux, uy=uy)
            return step

        st = state
        post_check = None
        if cfg.algorithm == "cv":
            # Balanced steps: sigma*||K||^2 = L/2
            # => tau = 0.99/(L/2 + sigma*||K||^2).
            sigma = (cfg.sigma_scale * L / (2.0 * Ksq)).to(dtype)
            tau_c = (0.99 / (L / 2.0 + sigma * Ksq)).to(dtype)[:, None]
            step = cv_step(lambda d, st: tau_c * d, sigma[:, None, None])
        elif cfg.algorithm == "fcv":
            if fprecond is None:
                raise ValueError("algorithm='fcv' requires fprecond "
                                 "(build_fourier_precond)")
            # T = tk * M^-1. The step lives in ``tk`` so the divergence monitor
            # can adapt it and warm starts carry it; min() maps a fresh state
            # (inf) to the full certified step. ``xp`` is the rollback point.
            st = st._replace(tk=torch.minimum(st.tk, fprecond.step), xp=st.x)
            m_hat = fprecond.m_hat
            step = cv_step(lambda d, st: st.tk[:, None] * _m_inv(m_hat, d, N),
                           fprecond.sigma[:, None, None])

            def post_check(st, g_norm, g_prev, g_min):
                # Divergence monitor: a node whose residual is not finite or
                # grew past 5x its running minimum halves its step and rolls x
                # back to the last check; it reports its previous residual.
                # The TV duals are ball projections, bounded, and stay.
                bad = ~torch.isfinite(g_norm) | (g_norm > 5.0 * g_min)
                x = torch.where(bad[:, None], st.xp, st.x)
                st = st._replace(tk=torch.where(bad, st.tk * 0.5, st.tk), x=x,
                                 xp=x)
                return (st, torch.where(bad, g_prev, g_norm),
                        bad.reshape(groups, -1).any(dim=1))
        elif cfg.algorithm == "pcv":
            # Per-pixel steps from the Gershgorin row sums of A^T A + rho D,
            # A^T(A 1) for a nonnegative operator (a Jacobi preconditioner);
            # T_p (L_p/2 + sigma_p ||K||^2) <= 1 holds pixel by pixel.
            L_row = adj(fwd(torch.ones((P, n), dtype=dtype, device=dev)))
            L_row = torch.clamp(L_row + rho_c * D_vec, min=1e-6)
            sigma_p = (cfg.sigma_scale * L_row / (2.0 * Ksq)).to(dtype)
            T = (0.99 / (L_row / 2.0 + sigma_p * Ksq)).to(dtype)
            step = cv_step(lambda d, st: T * d, sigma_p.reshape(P, N, N))
        elif cfg.algorithm == "ppdhg":
            # Diagonally preconditioned PDHG (Pock-Chambolle, alpha = 1):
            # K = [A; grad] in the dual, the consensus quadratic as an exact
            # primal prox; tau_j = 1/sum_i |K_ij|, sigma_i = 1/sum_j |K_ij|
            # from A applied to ones (the projector weights are nonnegative).
            rowsum = fwd(torch.ones((P, n), dtype=dtype, device=dev))
            colsum = adj(torch.ones_like(b))
            sig_a = 1.0 / torch.clamp(rowsum, min=1e-6)
            # TV rows have two unit entries (sigma = 1/2), TV columns <= 4.
            T = (1.0 / (torch.clamp(colsum, min=0.0) + 4.0)).to(dtype)
            rden = 1.0 + T * rho_c * D_vec
            rnum = T * rho_c * b_cons

            def step(st):
                kty = adj(st.ua) + tv.grad_adjoint(st.ux, st.uy).reshape(P, -1)
                x_new = (st.x - T * kty + rnum) / rden
                xb = 2.0 * x_new - st.x
                v = st.ua + sig_a * fwd(xb)
                # the prox of 0.5||.-b||^2's dual
                ua = (v - sig_a * b) / (1.0 + sig_a)
                gx, gy = tv.grad(xb.reshape(P, N, N))
                ux, uy = tv.project_l2_ball(st.ux + 0.5 * gx, st.uy + 0.5 * gy,
                                            lam_im)
                return st._replace(x=x_new, ux=ux, uy=uy, ua=ua)
        else:  # fista
            # Accelerated proximal gradient: a gradient step at the momentum
            # point, then prox_{tau lam TV} by Chambolle's dual ascent
            # warm-started from the node's TV dual field; O'Donoghue-Candes
            # gradient restart per node. Momentum lives within one subproblem
            # (b_cons and D change across outers): the t-sequence restarts at
            # every solve, x and the dual field stay as the warm start.
            st = st._replace(xp=st.x, tk=torch.ones_like(st.tk))
            tau = (0.99 / L).to(dtype)
            tau_c = tau[:, None]
            w_im = (tau * lam).to(dtype)[:, None, None]

            def step(st):
                t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * st.tk * st.tk))
                beta = ((st.tk - 1.0) / t_new)[:, None]
                y = st.x + beta * (st.x - st.xp)
                w = y - tau_c * grad_f(y)
                x_im, (ux, uy) = tv.tv_prox_chambolle(
                    w.reshape(P, N, N), w_im, n_iters=cfg.fista_prox_iters,
                    p_init=(st.ux, st.uy))
                x_new = x_im.reshape(P, -1)
                restart = torch.sum((y - x_new) * (x_new - st.x), dim=1) > 0.0
                t_new = torch.where(restart, torch.ones_like(t_new), t_new)
                return st._replace(x=x_new, ux=ux, uy=uy, xp=st.x, tk=t_new)

        B = groups
        ce = cfg.check_every
        g_prev = torch.full((P,), float("inf"), dtype=dtype, device=dev)
        g_norm = g_prev
        g_min = g_prev
        acc = torch.full((P,), -1, dtype=torch.int32, device=dev)
        # The groups still stepping, kept on the host, where the one sync of
        # each check brings their stop flags. Every group still stepping has
        # run every check so far, so they share the count k; a group's own
        # count (k_grp) stops where it froze.
        if group_active is None:
            run = np.ones(B, dtype=bool)
        else:
            profiling.count("sync")
            with profiling.span("sync", site="node.group_active"):
                run = group_active.cpu().numpy().astype(bool)
        k_grp = np.zeros(B, dtype=np.int64)
        k = 0
        while k < cfg.max_inner and run.any():
            # A group whose loop has ended keeps its state, residuals and
            # acceptance exactly (the select JAX's vmap of the while_loop
            # makes); while every group steps, nothing is selected.
            frozen = not run.all()
            st0, g0, gmin0, acc0 = st, g_prev, g_min, acc
            for _ in range(ce):
                st = step(st)
            g_norm = torch.linalg.norm(g_residual(st.x), dim=1)
            adjusted = False
            if post_check is not None:
                st, g_norm, adjusted = post_check(st, g_norm, g_prev, g_min)
            g_min = torch.minimum(
                g_min,
                torch.where(torch.isfinite(g_norm), g_norm, float("inf")))
            acc = torch.where((acc < 0) & (g_norm <= eps_k), k + ce,
                              acc).to(torch.int32)
            unmet = (g_norm > eps_k).reshape(B, -1).any(dim=1)
            if cfg.plateau_tol > 0:
                improving = torch.where(
                    torch.isinf(g_prev), True,
                    (g_prev - g_norm) > cfg.plateau_tol * torch.abs(g_prev),
                ).reshape(B, -1).any(dim=1)
                # A step adjustment is progress, though the rolled-back
                # residual shows none.
                unmet = unmet & (improving | adjusted)
            if frozen:
                keep = torch.as_tensor(np.repeat(run, P // B), device=dev)
                st = NodeState(*(torch.where(
                    keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
                    for new, old in zip(st, st0)))
                g_norm = torch.where(keep, g_norm, g0)
                g_min = torch.where(keep, g_min, gmin0)
                acc = torch.where(keep, acc, acc0)
            k += ce
            k_grp[run] = k
            profiling.count("inner_steps", ce)
            # the one host sync per check
            profiling.count("sync")
            with profiling.span("sync", site="node.check"):
                run = run & any_reduce(unmet).cpu().numpy()
            g_prev = g_norm
        with profiling.span("node.tail"):
            x = st.x
            # A residual still at inf (the loop never ran, or every check
            # rolled a node back from its first one) is recomputed, as the
            # JAX solver does.
            profiling.count("sync")
            with profiling.span("sync", site="node.isinf"):
                inf_left = bool(any_reduce(torch.isinf(g_norm).any()))
            if inf_left:
                g_norm = torch.where(
                    torch.isinf(g_norm),
                    torch.linalg.norm(g_residual(x), dim=1), g_norm)

            # Each node's group's count: k while no group stopped early.
            k_node = (k if (k_grp == k).all() else torch.as_tensor(
                np.repeat(k_grp, P // B), dtype=torch.int32, device=dev))
            inner_per_node = torch.where(acc >= 0, acc, k_node)
            r = fwd(x) - b
            data_term = 0.5 * torch.sum(r * r, dim=1)
            tv_term = lam * tv.tv_value(x.reshape(P, N, N))
            quad = 0.5 * rho * (
                torch.sum(D_vec * x**2, dim=1)
                - 2.0 * torch.sum(b_cons * x, dim=1) + c_quad
            )
            accept_code = torch.where(
                acc >= 0, 0, 1 + (k_node >= cfg.max_inner)
            ).to(torch.int32)
            trip = k if B == 1 else torch.as_tensor(k_grp)
            return NodeSolveResult(st, g_norm, data_term + tv_term + quad,
                                   inner_per_node, trip, accept_code)
