"""The plain reconstruction: decentralized TV-regularized least squares by
edge-consensus ADMM, written from its equations in float32 torch ops.

Per outer k, for every node i with images x_i [n] and the per-pixel graph
of masked precisions Q_ij:

  node solve : approximately min 0.5||A_i x - b_i||^2 + lam TV(x)
               + (rho/2) sum_j ||x - (z_ij - y_ij)||^2_{Q_ij}
               by Condat-Vu steps (``cv``: scalar steps from the power-method
               norm; ``fcv``: steps in a circulant Fourier metric with a
               Lanczos-certified scale), checked every ``check_every``
               steps against eps_k = eps0 / (k + 1)^(1 + gamma_decay)
  proposal   : a_ij = alpha x_i + (1 - alpha) z_ij + y_ij
  consensus  : z_ij = (a_ij + a_ji) / 2 and y_ij = a_ij - z_ij on the
               union graph's edges (zero elsewhere)

W is the operator's exact column norms, Q_ij = (W_i + W_j) / 2, and each
pixel keeps the edges of its k nearest nodes by Q (ties to the lower
index), with a maximum spanning tree added where that graph falls apart.
Nothing here comes from the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GRAD_OPNORM_SQ = 8.0
EPS = 1e-12


# ---- total variation ----

def grad(x):
    gx = F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))
    gy = F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))
    return gx, gy


def grad_adjoint(gx, gy):
    px, py = gx[..., :-1, :], gy[..., :, :-1]
    out = F.pad(px, (0, 0, 1, 0)) - F.pad(px, (0, 0, 0, 1))
    return out + F.pad(py, (1, 0)) - F.pad(py, (0, 1))


def tv_subgradient(x, eps=1e-12):
    gx, gy = grad(x)
    mag = torch.sqrt(gx**2 + gy**2)
    scale = torch.where(mag > eps, 1.0 / torch.clamp(mag, min=eps), 0.0)
    return grad_adjoint(gx * scale, gy * scale)


def project_ball(gx, gy, radius: float):
    mag = torch.sqrt(gx**2 + gy**2)
    if radius <= 0:
        return torch.zeros_like(gx), torch.zeros_like(gy)
    f = 1.0 / torch.clamp(mag / radius, min=1.0)
    return gx * f, gy * f


# ---- the per-pixel graph ----

def _connected(adj):
    P = adj.shape[-1]
    reach = adj | torch.eye(P, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, P.bit_length())):
        r = reach.float()
        reach = (r @ r) > 0
    return reach[:, 0].all(dim=-1)


def _max_tree(qp):
    n, P, _ = qp.shape
    rows = torch.arange(n, device=qp.device)
    inside = torch.zeros((n, P), dtype=torch.bool, device=qp.device)
    inside[:, 0] = True
    adj = torch.zeros((n, P, P), dtype=torch.bool, device=qp.device)
    for _ in range(P - 1):
        frontier = inside[:, :, None] & ~inside[:, None, :]
        score = torch.where(frontier, qp, float("-inf"))
        flat = torch.argmax(score.reshape(n, P * P), dim=1)
        u, v = flat // P, flat % P
        adj[rows, u, v] = True
        adj[rows, v, u] = True
        inside[rows, v] = True
    return adj


def pixel_graph(W, k: int):
    """(Q [P, P, n] masked, keep [P, P, n], adj [P, P]) of the knn graph."""
    P, n = W.shape
    q = torch.clamp(0.5 * (W[:, None, :] + W[None, :, :]), min=EPS)
    off = ~torch.eye(P, dtype=torch.bool, device=W.device)
    q = q * off[:, :, None]
    qp = (0.5 * (q + q.transpose(0, 1)) * off[:, :, None]).permute(2, 0, 1)
    cand = torch.where(off, qp, float("-inf"))
    idx = torch.sort(cand, dim=-1, descending=True, stable=True).indices
    adj = torch.zeros((n, P, P), dtype=torch.bool, device=W.device)
    adj.scatter_(2, idx[..., :min(k, P - 1)], True)
    adj = adj | adj.transpose(1, 2)
    conn = _connected(adj)
    if not bool(conn.all()):
        adj = torch.where(conn[:, None, None], adj, adj | _max_tree(qp))
    keep = adj.permute(1, 2, 0)
    keep = keep | keep.transpose(0, 1)
    return q * keep, keep, keep.any(dim=-1)


# ---- the node solver ----

def _m_inv(m_hat, r, N):
    R = torch.fft.rfft2(r.reshape(-1, N, N))
    return torch.fft.irfft2(R / m_hat, s=(N, N)).reshape(r.shape)


def _m_apply(m_hat, v, N):
    V = torch.fft.rfft2(v.reshape(-1, N, N))
    return torch.fft.irfft2(m_hat * V, s=(N, N)).reshape(v.shape)


def fourier_metric(fwd, adj, D_vec, rho, sigma_scale, N, v0, n_lanczos=25):
    """fcv's metric: (m_hat [P, N, N//2+1], step [P], sigma [P]). m_hat is
    |F[A^T A e_c]| + rho mean(D) + sigma * (the periodic Laplacian's
    symbol), floored at 1e-6 of its max; the step 0.95 / the top Ritz
    value of Lanczos on M^-1 (H/2 + sigma K^T K) in the M inner product."""
    P, n = D_vec.shape
    dev = D_vec.device
    e = torch.zeros((P, n), device=dev)
    e[:, (N // 2) * N + N // 2] = 1.0
    psf = torch.roll(adj(fwd(e)).reshape(P, N, N), (-(N // 2), -(N // 2)),
                     dims=(1, 2))
    m_A = torch.abs(torch.fft.rfft2(psf))
    d_mean = D_vec.mean(dim=1)
    scale = rho * d_mean
    scale = torch.where(scale > 0, scale, 4.0 * m_A.amax(dim=(1, 2)))
    sigma = sigma_scale * scale / (2.0 * GRAD_OPNORM_SQ)
    kx = torch.arange(N, device=dev, dtype=torch.float32)[:, None]
    ky = torch.arange(N // 2 + 1, device=dev, dtype=torch.float32)[None, :]
    lap = 4.0 * torch.sin(math.pi * kx / N) ** 2 \
        + 4.0 * torch.sin(math.pi * ky / N) ** 2
    m_hat = m_A + rho * d_mean[:, None, None] + sigma[:, None, None] * lap
    m_hat = torch.maximum(m_hat, 1e-6 * m_hat.amax(dim=(1, 2), keepdim=True))

    def S(x):
        gx, gy = grad(x.reshape(P, N, N))
        return 0.5 * (adj(fwd(x)) + rho * D_vec * x) \
            + sigma[:, None] * grad_adjoint(gx, gy).reshape(P, n)

    def mnorm2(v):
        return torch.sum(v * _m_apply(m_hat, v, N), dim=1)

    v = v0.to(dev, torch.float32).expand(P, n)
    v = v / torch.sqrt(torch.clamp(mnorm2(v), min=1e-30))[:, None]
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros(P, device=dev)
    alphas, betas = [], []
    for _ in range(n_lanczos):
        Sv = S(v)
        alpha = torch.sum(v * Sv, dim=1)
        w = _m_inv(m_hat, Sv, N) - alpha[:, None] * v \
            - beta_prev[:, None] * v_prev
        beta = torch.sqrt(torch.clamp(mnorm2(w), min=0.0))
        live = beta > 1e-12 * torch.clamp(torch.abs(alpha), min=1.0)
        v_next = torch.where(live[:, None],
                             w / torch.clamp(beta, min=1e-30)[:, None], 0.0)
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, 1)
    b = torch.stack(betas, 1)[:, :-1]
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    lam = torch.linalg.eigvalsh(T.double())[:, -1].float()
    return m_hat, 0.95 / torch.clamp(lam, min=1e-30), sigma


def power_norm(fwd, adj, v0, iters=30):
    """Power-method estimates of ||A_i^T A_i|| [P] from v0 [P, n]."""
    v = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
    lam = torch.zeros(v.shape[0], device=v.device)
    for _ in range(iters):
        w = adj(fwd(v))
        lam = torch.linalg.norm(w, dim=1)
        v = w / torch.clamp(lam[:, None], min=1e-30)
    return lam


def node_solve(fwd, adj, b, D_vec, b_cons, lam, rho, st, eps_k, node, N,
               metric, rnd=lambda t: t):
    """One outer's node solve of every node (one group): the Condat-Vu
    loop with its checks. ``st`` is (x, ux, uy, xp, tk); returns it.
    ``rnd`` rounds the state after every step (the lower-precision
    control)."""
    P, n = D_vec.shape
    x, ux, uy, xp, tk = st

    def grad_f(v):
        return adj(fwd(v) - b) + rho * (D_vec * v - b_cons)

    if node["algorithm"] == "fcv":
        m_hat, step, sig = metric["m_hat"], metric["step"], metric["sigma"]
        tk = torch.minimum(tk, step)
        xp = x
    else:
        L = metric["L"]
        sig = node["sigma_scale"] * L / (2.0 * GRAD_OPNORM_SQ)
        tau = 0.99 / (L / 2.0 + sig * GRAD_OPNORM_SQ)
    sig_im = sig[:, None, None]
    ce = node["check_every"]
    g_prev = torch.full((P,), float("inf"), device=x.device)
    g_min = g_prev
    k = 0
    while k < node["max_inner"]:
        for _ in range(ce):
            ktu = grad_adjoint(ux, uy).reshape(P, n)
            d = grad_f(x) + ktu
            if node["algorithm"] == "fcv":
                x_new = x - tk[:, None] * _m_inv(m_hat, d, N)
            else:
                x_new = x - tau[:, None] * d
            gx, gy = grad((2.0 * x_new - x).reshape(P, N, N))
            ux, uy = project_ball(ux + sig_im * gx, uy + sig_im * gy, lam)
            x, ux, uy = rnd(x_new), rnd(ux), rnd(uy)
        sub = tv_subgradient(x.reshape(P, N, N)).reshape(P, n)
        g = torch.linalg.norm(grad_f(x) + lam * sub, dim=1)
        adjusted = False
        if node["algorithm"] == "fcv":
            bad = ~torch.isfinite(g) | (g > 5.0 * g_min)
            x = torch.where(bad[:, None], xp, x)
            xp = x
            tk = torch.where(bad, 0.5 * tk, tk)
            g = torch.where(bad, g_prev, g)
            adjusted = bool(bad.any())
        g_min = torch.minimum(g_min, torch.where(torch.isfinite(g), g,
                                                 float("inf")))
        unmet = bool((g > eps_k).any())
        if node["plateau_tol"] > 0:
            improving = torch.where(
                torch.isinf(g_prev), True,
                (g_prev - g) > node["plateau_tol"] * torch.abs(g_prev))
            unmet = unmet and (bool(improving.any()) or adjusted)
        k += ce
        g_prev = g
        if not unmet:
            break
    return x, ux, uy, xp, tk


def reconstruct(proj, b, recipe: dict, lanczos_v0=None, opnorm_v0=None,
                graph_k: int = 2, state_dtype=None):
    """The reconstruction of one sinogram set b [P, m] with ``proj``:
    returns (x [P, n], Z [P, P, n], Y [P, P, n]). ``recipe`` holds lam_tv,
    rho, relax_alpha, max_iters and the node solver's knobs under
    "node". ``state_dtype`` keeps b and the iterates (x, the TV duals, Z
    and Y) rounded to that type (the lower-precision control)."""
    def rnd(t):
        return t if state_dtype is None else t.to(state_dtype).float()

    b = rnd(b)
    P, n, N = proj.P, proj.n, proj.N
    dev = b.device
    node = recipe["node"]
    lam, rho, alpha = recipe["lam_tv"], recipe["rho"], recipe["relax_alpha"]
    Q, _, adjm = pixel_graph(proj.colnorms(), graph_k)
    D_vec = Q.sum(dim=1)
    am = adjm[:, :, None].float()
    if node["algorithm"] == "fcv":
        m_hat, step, sig = fourier_metric(proj.fwd, proj.adj, D_vec, rho,
                                          node["sigma_scale"], N, lanczos_v0)
        metric = {"m_hat": m_hat, "step": step, "sigma": sig}
    else:
        L = power_norm(proj.fwd, proj.adj, opnorm_v0.to(dev)) \
            + rho * D_vec.amax(dim=1)
        metric = {"L": L}
    x = torch.zeros((P, n), device=dev)
    ux = torch.zeros((P, N, N), device=dev)
    uy = torch.zeros_like(ux)
    st = (x, ux, uy, x, torch.full((P,), float("inf"), device=dev))
    Z = torch.zeros((P, P, n), device=dev)
    Y = torch.zeros_like(Z)
    for k in range(recipe["max_iters"]):
        V = Z - Y
        b_cons = torch.sum(Q * V, dim=1)
        eps_k = node["eps0"] / (k + 1.0) ** (1.0 + node["gamma_decay"])
        st = node_solve(proj.fwd, proj.adj, b, D_vec, b_cons, lam, rho, st,
                        eps_k, node, N, metric, rnd)
        x = st[0]
        a = alpha * x[:, None, :] + (1.0 - alpha) * Z + Y
        Zn = 0.5 * (a + a.transpose(0, 1)) * am
        pri = torch.sqrt(torch.sum(((a - Y - Zn) * am) ** 2))
        dual = torch.sqrt(0.5 * rho**2 * torch.sum(((Zn - Z) * am) ** 2))
        Y = rnd((a - Zn) * am)
        Z = rnd(Zn)
        if bool((pri < recipe["eps_pri"]) & (dual < recipe["eps_dual"])):
            break
    return st[0], Z, Y


def psnr(x, ref, data_range):
    """PSNR in dB of each image of x [..., n] against ref [n]."""
    mse = torch.mean((x.double() - ref.double()) ** 2, dim=-1)
    return 20.0 * math.log10(data_range) - 10.0 * torch.log10(mse)
