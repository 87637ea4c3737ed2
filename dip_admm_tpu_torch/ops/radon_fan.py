"""Fan-beam projector by parallel-beam rebinning, and its exact column norms.

A flat-detector fan ray (source angle beta, detector offset d) is exactly
the parallel-beam ray at

    theta = beta + gamma - pi/2,     s = -R_src * sin(gamma),
    gamma = atan(d / (R_src + R_det)),

so a node's fan sinogram is an angular resampling of a parallel sinogram
evaluated on the nonuniform detector grid {s_l}:

  1. parallel-project at T_p = m/2 uniform angles over [0, pi) with
     ``fft_skew`` or ``fft_grouped`` on the rebinned detector grid;
  2. extend to a 2 pi-periodic sinogram with the flip identity
     p(theta + pi, s) = p(theta, -s) (exact for the symmetric grid);
  3. shift each detector column along the angle axis by gamma_l / dbeta,
     a linear-interpolation circular shift applied as real DFT matmuls
     with a per-column phase filter;
  4. mask each node's fan rows.

The parallel-stage geometry is the same for every node, so all nodes share
ONE single-node table set: the node images run through the parallel-stage
kernels as an image batch PB = P against a table batch PT = 1.

Steps 2-4 of every projector call, and their transposes, are one
``proj.rebin`` span and count of ``utils.profiling``; the parallel stage
stays outside it.

Mirrors ``dip_admm_tpu.ops.radon_fan`` (the ``fft_skew`` and ``fft_grouped``
paths and ``colnorms_sq_nodes``). The small rebin geometry is computed on
the CPU in float32 with the JAX package's rounding (float64 transcendentals
rounded once, true divisions), then moved to the device: a floor that
flipped at an integer boundary would move a whole table row.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dip_admm_tpu_torch.config import GeometryConfig
from dip_admm_tpu_torch.ops import radon, radon_fft
from dip_admm_tpu_torch.ops.radon_fft import _cos_sin, _fma
from dip_admm_tpu_torch.utils import profiling


def _parallel_cfg(cfg: GeometryConfig) -> GeometryConfig:
    return dataclasses.replace(cfg, fan_beam=False)


def _rebin_geometry(cfg: GeometryConfig, m: int):
    """(theta [T_p], s_l [D], shift [D]) in float32 on the CPU: the
    parallel angles, the rebinned detector positions and each detector
    column's angular shift in beta-index units."""
    f32 = torch.float32
    D = cfg.n_det
    dets = torch.as_tensor(
        radon.detector_centers(D, cfg.det_width_factor * 2.0), dtype=f32)
    q = dets / torch.tensor(cfg.src_radius + cfg.det_radius, dtype=f32)
    gamma = torch.atan(q.to(torch.float64)).to(f32)  # [D]
    s_l = torch.tensor(-cfg.src_radius, dtype=f32) * _cos_sin(gamma)[1]
    T_p = m // 2
    theta = (torch.arange(T_p, dtype=f32) + 0.5) * torch.tensor(
        math.pi / T_p, dtype=f32)
    shift = (gamma - torch.tensor(math.pi / 2.0, dtype=f32)) / torch.tensor(
        2.0 * math.pi / m, dtype=f32)
    return theta, s_l, shift


def _rebin_filter(shift: torch.Tensor, m: int):
    """Per-column phase filter [D, F] (re, im) of the angular shift:
    e^{i w k} ((1 - fr) + fr e^{i w}), shift = k + fr, w = 2 pi f / m."""
    f32 = torch.float32
    k = torch.floor(shift)
    fr = shift - k
    f = torch.arange(m // 2 + 1, dtype=f32)
    ang = (2.0 * math.pi / m) * f
    bre, bim = _cos_sin(ang[None, :] * k[:, None])
    ca, sa = _cos_sin(ang)
    tre = (1.0 - fr)[:, None] + fr[:, None] * ca[None, :]
    tim = fr[:, None] * sa[None, :]
    return bre * tre - bim * tim, bre * tim + bim * tre


def _fan_tables(cfg: GeometryConfig, beta: torch.Tensor, valid, precompute):
    """Tables shared by both fan paths around the parallel stage that
    ``precompute(cfg_par, theta [1, T_p], valid [1, T_p], dets)`` builds."""
    assert cfg.fan_beam
    P, m = beta.shape
    if m % 2 != 0:
        raise ValueError("fan rebinning needs an even angle count per node")
    dev = beta.device
    theta, s_l, shift = _rebin_geometry(cfg, m)
    par = precompute(_parallel_cfg(cfg), theta[None].to(dev),
                     torch.ones((1, m // 2), dtype=torch.bool, device=dev),
                     s_l.to(dev))
    Rre, Rim = _rebin_filter(shift, m)
    Bre, Bim, Dre, Dim = radon_fft._dft_mats(m, m, dev)
    if valid is None:
        valid = torch.ones((P, m), dtype=torch.bool, device=dev)
    return {
        "shared": {
            "par": par,
            "rebin_re": Rre.to(dev), "rebin_im": Rim.to(dev),  # [D, F]
            "Bre": Bre, "Bim": Bim,  # [m, F] forward DFT of the angle axis
            "Dre": Dre, "Dim": Dim,  # [F, m] irfft coefficients
        },
        "fan_valid": valid.to(torch.float32),  # [P, m]
    }


def precompute_fan_skew(cfg: GeometryConfig, beta: torch.Tensor, valid=None,
                        table_dtype=torch.float32, nb: int = 128) -> dict:
    """Tables for :func:`project_nodes_fan_skew`: one shared ``fft_skew``
    table set on the rebinned detector grid, the rebin filter, the
    angle-axis DFT matrices and the per-node row masks. ``beta``/``valid``
    [P, m] are the uniform per-node grids of ``radon.node_angles``."""
    def par(cfg_par, theta, v, dets):
        return radon_fft.precompute_shear(cfg_par, theta, v, table_dtype,
                                          nb=nb, dets=dets)

    return _fan_tables(cfg, beta, valid, par)


def precompute_fan_grouped(cfg: GeometryConfig, beta: torch.Tensor,
                           valid=None, table_dtype=torch.float32) -> dict:
    """Tables for :func:`project_nodes_fan_grouped`: as
    :func:`precompute_fan_skew` with one shared ``fft_grouped`` table set."""
    def par(cfg_par, theta, v, dets):
        return radon_fft.precompute_grouped(cfg_par, theta, v, table_dtype,
                                            dets=dets)

    return _fan_tables(cfg, beta, valid, par)


def _rebin_apply(p2, t):
    """[P, m, D] periodic parallel sinograms -> [P, m, D] fan sinograms:
    the per-column circular shift by the rebin filter, as DFT matmuls."""
    ph_re = torch.einsum("pmd,mf->pfd", p2, t["Bre"])
    ph_im = torch.einsum("pmd,mf->pfd", p2, t["Bim"])
    Rre = t["rebin_re"].T[None]  # [1, F, D]
    Rim = t["rebin_im"].T[None]
    o_re = ph_re * Rre - ph_im * Rim
    o_im = ph_re * Rim + ph_im * Rre
    return (torch.einsum("pfd,fm->pmd", o_re, t["Dre"])
            + torch.einsum("pfd,fm->pmd", o_im, t["Dim"]))


def _rebin_apply_t(bar, t):
    """Exact transpose of :func:`_rebin_apply`."""
    z_re = torch.einsum("pmd,fm->pfd", bar, t["Dre"])
    z_im = torch.einsum("pmd,fm->pfd", bar, t["Dim"])
    Rre = t["rebin_re"].T[None]
    Rim = t["rebin_im"].T[None]
    ph_re = z_re * Rre + z_im * Rim
    ph_im = -z_re * Rim + z_im * Rre
    return (torch.einsum("pfd,mf->pmd", ph_re, t["Bre"])
            + torch.einsum("pfd,mf->pmd", ph_im, t["Bim"]))


def precompute_fan(cfg: GeometryConfig, beta: torch.Tensor, valid=None,
                   table_dtype=torch.float32) -> dict:
    """Tables of one node's mode-``fft`` fan projection (``beta``,
    ``valid`` [m]): the parallel stage's phase tables on the rebinned
    detector grid (``radon_fft.precompute_phases`` at the T_p = m/2
    parallel angles, every angle valid), the rebin filter ``rebin_re``/
    ``rebin_im`` [D, m/2 + 1] in ``table_dtype`` and, with ``valid``, the
    row mask ``fan_valid`` [m]."""
    assert cfg.fan_beam
    m = beta.shape[0]
    if m % 2 != 0:
        raise ValueError("fan rebinning needs an even angle count per node")
    dev = beta.device
    theta, s_l, shift = _rebin_geometry(cfg, m)
    tables = radon_fft.precompute_phases(_parallel_cfg(cfg), theta.to(dev),
                                         None, table_dtype, s_l.to(dev))
    Rre, Rim = _rebin_filter(shift, m)
    tables["rebin_re"] = Rre.to(device=dev, dtype=table_dtype)
    tables["rebin_im"] = Rim.to(device=dev, dtype=table_dtype)
    if valid is not None:
        tables["fan_valid"] = valid.to(torch.float32)
    return tables


def precompute_fan_nodes(cfg: GeometryConfig, beta: torch.Tensor,
                         valid: torch.Tensor,
                         table_dtype=torch.float32) -> dict:
    """Tables of :func:`project_nodes_fan` (``beta``, ``valid`` [P, m]).
    Only the row mask differs between nodes, so one node's
    :func:`precompute_fan` tables are kept once, as a table batch of one
    under ``"shared"`` (PT = 1, kept whole on every rank of a mesh), beside
    the per-node ``fan_valid`` [P, m]. The JAX package vmaps the whole set
    over the nodes; ``data/serialization.py`` converts between the two."""
    one = precompute_fan(cfg, beta[0], None, table_dtype)
    return {"shared": {k: v[None] for k, v in one.items()},
            "fan_valid": valid.to(torch.float32)}


def _rebin_fft(p2: torch.Tensor, Rre: torch.Tensor, Rim: torch.Tensor):
    """The angular rebin of mode ``fft``: [K, PT, m, D] periodic parallel
    sinograms -> rFFT along the angle axis, times the filter [PT, D, F]
    (float32), irFFT back (the imaginary parts of DC and Nyquist dropped,
    see ``radon_fft._edge_mask``)."""
    m = p2.shape[-2]
    ph = torch.fft.rfft(p2, dim=-2)  # [K, PT, F, D]
    R = torch.complex(Rre.to(torch.float32),
                      Rim.to(torch.float32)).transpose(-1, -2)
    out = ph * R
    mask = radon_fft._edge_mask(out.shape[-2], p2.device)[:, None]
    out = torch.complex(out.real, out.imag * mask)
    return torch.fft.irfft(out, n=m, dim=-2)


def _rebin_fft_t(bar: torch.Tensor, Rre: torch.Tensor, Rim: torch.Tensor):
    """Exact transpose of :func:`_rebin_fft` (see
    ``radon_fft._branch_apply_t`` for the two FFT transposes)."""
    m = bar.shape[-2]
    F = m // 2 + 1
    interior = radon_fft._edge_mask(F, bar.device)[:, None]
    Z = torch.fft.rfft(bar, dim=-2) * ((1.0 + interior) / m)
    Z = torch.complex(Z.real, Z.imag * interior)
    R = torch.complex(Rre.to(torch.float32),
                      Rim.to(torch.float32)).transpose(-1, -2)
    ph = Z * R.conj()
    X = torch.complex(ph.real * (2.0 - interior), ph.imag * interior)
    return torch.fft.irfft(X, n=m, dim=-2) * (m / 2.0)


def project_nodes_fan(cfg: GeometryConfig, imgs: torch.Tensor,
                      tables: dict) -> torch.Tensor:
    """Mode ``fft``'s batched fan projection [PB, N, N] -> [PB, m, D] on
    :func:`precompute_fan_nodes` tables: the parallel stage
    (``radon_fft``'s split-table branches), the flip periodization, the
    rebin by FFTs along the angle axis and the row mask. No kernel, as the
    JAX package's XLA path."""
    t = tables["shared"]
    PT = t["rebin_re"].shape[0]
    p = radon_fft.project_nodes_phases(_parallel_cfg(cfg), imgs, t)
    profiling.count("proj.rebin")
    with profiling.span("proj.rebin"):
        p2 = radon_fft._kview(torch.cat([p, p.flip(2)], dim=1), PT)
        out = _rebin_fft(p2, t["rebin_re"], t["rebin_im"])
        out = out.reshape(imgs.shape[0], *out.shape[2:])
        return _mask_rows(out, tables["fan_valid"])


def backproject_nodes_fan(cfg: GeometryConfig, sinos: torch.Tensor,
                          tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_fan`, composed by hand."""
    t = tables["shared"]
    PT = t["rebin_re"].shape[0]
    T_p = tables["fan_valid"].shape[1] // 2
    profiling.count("proj.rebin")
    with profiling.span("proj.rebin"):
        ob = radon_fft._kview(_mask_rows(sinos, tables["fan_valid"]), PT)
        p2_bar = _rebin_fft_t(ob, t["rebin_re"], t["rebin_im"])
        p2_bar = p2_bar.reshape(sinos.shape[0], *p2_bar.shape[2:])
        p_bar = p2_bar[:, :T_p] + p2_bar[:, T_p:].flip(2)
    return radon_fft.backproject_nodes_phases(_parallel_cfg(cfg), p_bar, t)


def _single(tables: dict, valid) -> dict:
    """One node's :func:`precompute_fan` tables in
    :func:`precompute_fan_nodes`'s layout, with its row mask (all rows
    without ``valid``)."""
    t = dict(tables)
    fv = t.pop("fan_valid", None)
    if fv is None:
        m = 2 * t["p_r"].shape[0]
        fv = (torch.ones(m, device=t["p_r"].device) if valid is None
              else valid.to(torch.float32))
    return {"shared": {k: v[None] for k, v in t.items()},
            "fan_valid": fv[None]}


def project(cfg: GeometryConfig, img: torch.Tensor, beta: torch.Tensor,
            valid=None, tables: dict | None = None) -> torch.Tensor:
    """One node's fan projection [N, N] x [m] -> [m, D] (the JAX
    package's signature)."""
    if tables is None:
        tables = precompute_fan(cfg, beta, valid)
    return project_nodes_fan(cfg, img[None], _single(tables, valid))[0]


def backproject(cfg: GeometryConfig, sino: torch.Tensor, beta: torch.Tensor,
                valid=None, tables: dict | None = None) -> torch.Tensor:
    """Exact adjoint of :func:`project` [m, D] -> [N, N]."""
    if tables is None:
        tables = precompute_fan(cfg, beta, valid)
    return backproject_nodes_fan(cfg, sino[None], _single(tables, valid))[0]


def _mask_rows(s: torch.Tensor, fan_valid: torch.Tensor) -> torch.Tensor:
    """[PB, m, D] sinograms times the fan row mask [P, m] of node p % P
    (PB = B * P images, b-major)."""
    P, m = fan_valid.shape
    return (s.reshape(-1, P, m, s.shape[-1])
            * fan_valid[None, :, :, None]).reshape(s.shape)


def _project(project_par, cfg, imgs, tables):
    t = tables
    T_p = t["fan_valid"].shape[1] // 2
    p = project_par(_parallel_cfg(cfg), imgs, t["shared"]["par"], T_p)
    profiling.count("proj.rebin")
    with profiling.span("proj.rebin"):
        p2 = torch.cat([p, p.flip(2)], dim=1)  # [PB, m, D], 2 pi-periodic
        out = _rebin_apply(p2, t["shared"])
        return _mask_rows(out, t["fan_valid"]).to(imgs.dtype)


def _backproject(backproject_par, cfg, sinos, tables):
    t = tables
    T_p = t["fan_valid"].shape[1] // 2
    profiling.count("proj.rebin")
    with profiling.span("proj.rebin"):
        ob = _mask_rows(sinos.to(torch.float32), t["fan_valid"])
        p2_bar = _rebin_apply_t(ob, t["shared"])
        p_bar = p2_bar[:, :T_p] + p2_bar[:, T_p:].flip(2)
    return backproject_par(_parallel_cfg(cfg), p_bar.to(sinos.dtype),
                           t["shared"]["par"]).to(sinos.dtype)


def project_nodes_fan_skew(cfg: GeometryConfig, imgs: torch.Tensor,
                           tables: dict) -> torch.Tensor:
    """Batched fan forward projection [P, N, N] -> [P, m, D]: the shared
    ``fft_skew`` parallel stage (K1, K3) on all node images at once, the
    flip periodization, the rebin matmuls and the row mask."""
    return _project(radon_fft.project_nodes_skew, cfg, imgs, tables)


def backproject_nodes_fan_skew(cfg: GeometryConfig, sinos: torch.Tensor,
                               tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_fan_skew`, composed by hand."""
    return _backproject(radon_fft.backproject_nodes_skew, cfg, sinos, tables)


def project_nodes_fan_skew_rowshard(cfg: GeometryConfig, imgs: torch.Tensor,
                                    tables: dict,
                                    shard: radon_fft.RowShard) -> torch.Tensor:
    """:func:`project_nodes_fan_skew` with the shared parallel stage split
    over the pixel axis (``radon_fft.project_nodes_skew_rowshard`` on the
    ``shared.par`` tables, which carry this shard's row blocks); the rebin
    tail stays replicated. The nodes fold into the kernels' image batch
    (PB = P against PT = 1) as on the unsharded fan path."""
    def par(cfg_par, x, t, n_rows):
        return radon_fft.project_nodes_skew_rowshard(cfg_par, x, t, shard,
                                                     n_rows)

    return _project(par, cfg, imgs, tables)


def backproject_nodes_fan_skew_rowshard(cfg: GeometryConfig,
                                        sinos: torch.Tensor, tables: dict,
                                        shard: radon_fft.RowShard
                                        ) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_fan_skew_rowshard`."""
    def par(cfg_par, s, t):
        return radon_fft.backproject_nodes_skew_rowshard(cfg_par, s, t, shard)

    return _backproject(par, cfg, sinos, tables)


def project_nodes_fan_grouped(cfg: GeometryConfig, imgs: torch.Tensor,
                              tables: dict) -> torch.Tensor:
    """Batched fan forward projection [P, N, N] -> [P, m, D] on the shared
    ``fft_grouped`` parallel stage (K13) and the rebin tail."""
    def par(cfg_par, x, t, n_rows):
        return radon_fft.project_nodes_grouped(cfg_par, x, t)

    return _project(par, cfg, imgs, tables)


def backproject_nodes_fan_grouped(cfg: GeometryConfig, sinos: torch.Tensor,
                                  tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_fan_grouped` (K14)."""
    return _backproject(radon_fft.backproject_nodes_grouped, cfg, sinos,
                        tables)


def colnorms_sq_nodes(cfg: GeometryConfig, beta: torch.Tensor,
                      valid=None) -> torch.Tensor:
    """Exact W[i, p] = ||A_i[:, p]||^2 of the rebinned fan operator, batched
    over nodes (beta/valid [P, m] -> [P, N, N]).

    A = M_i Sh P2 A_par: the parallel stage (exact per-pixel weights
    w_t[l, a, i] of the composite 2-tap kernel), the flip periodization
    P2, the per-column circular shift Sh (integer k_l plus a fractional
    2-tap fr_l) and the node's row mask M_i. The fractional tap couples only
    adjacent angles, so per column l

        Sh^T M Sh = diag(q_tt) + offdiag_1(q_t1),
        q_tt(t) = (1-fr)^2 M(t-k) + fr^2 M(t-k-1),  q_t1(t) = fr(1-fr) M(t-k),

    and the norm needs one [D, N, N] weight block per parallel angle and
    the correlations of adjacent ones, shared by all nodes."""
    assert cfg.fan_beam
    P, m = beta.shape
    dev = beta.device
    f32 = torch.float32
    V = (torch.ones((P, m), dtype=f32, device=dev) if valid is None
         else valid.to(f32))
    T_p = m // 2
    N = cfg.N
    theta, s_l, shift = (x.to(dev) for x in _rebin_geometry(cfg, m))
    k = torch.floor(shift).long()  # [D]
    fr = shift - torch.floor(shift)
    t_idx = torch.arange(m, device=dev)[:, None]
    Vk = V[:, torch.remainder(t_idx - k[None, :], m)]  # [P, m, D]
    Vk1 = V[:, torch.remainder(t_idx - k[None, :] - 1, m)]
    q_tt = (1.0 - fr) ** 2 * Vk + fr**2 * Vk1
    q_t1 = (fr * (1.0 - fr)) * Vk
    # Fold the periodized second half (y(t + T_p, l) = y(t, D-1-l)) back
    # onto t in [0, T_p): diagonal, interior-pair and seam-pair weights.
    e1 = q_tt[:, :T_p] + q_tt[:, T_p:].flip(2)  # [P, T_p, D]
    e2 = q_t1[:, :T_p - 1] + q_t1[:, T_p:m - 1].flip(2)
    e3 = q_t1[:, T_p - 1] + q_t1[:, m - 1].flip(1)  # [P, D]

    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = radon_fft._coeffs(
        _parallel_cfg(cfg), theta, dets=s_l)
    idx = torch.arange(N, dtype=f32, device=dev)
    use_r = use_r.tolist()

    def wblock(t: int) -> torch.Tensor:
        """Exact per-pixel weights of parallel angle t: [D, N, N] on the
        image grid (branch C computes on the transposed image)."""
        sel = use_r[t]
        p, B, C, scale = ((Pr[t], Br[t], Cr[t], sr[t]) if sel
                          else (Pc[t], Bc[t], Cc[t], sc[t]))
        v0 = torch.floor(p)
        fp = p - v0
        sig = _fma(B, idx, C)  # [N]

        def tap(v, wv):
            pos = v[:, None] + sig[None, :]  # [D, N]
            h = torch.clamp(1.0 - torch.abs(pos[:, :, None] - idx), min=0.0)
            return wv[:, None, None] * h

        w = scale * (tap(v0, 1.0 - fp) + tap(v0 + 1.0, fp))
        return w if sel else w.transpose(1, 2)

    def ein(e, w2):
        return torch.einsum("pl,lai->pai", e, w2)

    w0 = wblock(0)
    W = ein(e1[:, 0], w0 * w0)
    w_prev = w0
    for t in range(1, T_p):
        w = wblock(t)
        W = W + ein(e1[:, t], w * w)
        W = W + 2.0 * ein(e2[:, t - 1], w_prev * w)
        w_prev = w
    # Seam pairs (T_p-1 <-> T_p and m-1 <-> 0 on the periodized circle).
    return W + 2.0 * ein(e3, w_prev * w0.flip(0))



def colnorms_sq(cfg: GeometryConfig, beta: torch.Tensor,
                valid=None) -> torch.Tensor:
    """Single-node :func:`colnorms_sq_nodes` (``beta`` [m] -> [N, N])."""
    v = None if valid is None else valid[None]
    return colnorms_sq_nodes(cfg, beta[None], v)[0]
