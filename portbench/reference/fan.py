"""The plain flat-detector fan-beam projector, as explicit sparse matrices.

The source turns on a circle of radius ``src_radius`` about the centre of
the image ([-1, 1]^2, N x N pixels) and a flat detector of D cells spanning
``2 * det_width_factor`` faces it at ``det_radius``. The fan ray from the
source at angle beta to the detector cell at offset d is the parallel ray
at

    theta = beta + gamma - pi/2,   s = -src_radius sin(gamma),
    gamma = atan(d / (src_radius + det_radius)).

A node with m source angles beta_u = (u + 1/2) 2 pi / m (m even) therefore
reads, for each detector l:

  - the parallel operator of ``projector.py`` at the T_p = m/2 angles
    theta_t = (t + 1/2) pi / T_p, detector l read at s_l: rows p[t, l];
  - its 2 pi-periodic extension p2, row t + T_p being row t with the
    detector reversed (p(theta + pi, s) = p(theta, -s), exact since the
    grid is symmetric, s_{D-1-l} = -s_l);
  - the linear interpolation of p2 along the angle at u + shift_l,
    shift_l = (gamma_l - pi/2) / (2 pi / m) = k_l + fr_l (k_l its floor):

        y[u, l] = (1 - fr_l) p2[u + k_l, l] + fr_l p2[u + k_l + 1, l],

    angle indices mod m;
  - the node's row mask (rows past its count are zero).

Each fan row is built as that two-term combination of stored parallel
rows, one sparse product summed in float64, and kept in float32 with its
transpose as compressed sparse rows. The geometry is worked out in
float64 from the float32 detector centres. ``tap_dtype`` rounds the
parallel taps and the two interpolation weights, ``operand_dtype`` the
product's operand rows, as in ``projector.py`` (the lower-precision
controls).

Each node's beta grid is that of its own count, as the configuration
states it (``node_angles``). Where the total does not split evenly over
the nodes, the counts differ by one, so one of them is odd and the
reference refuses the split: a fan configuration splits its angles evenly
into even counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.projector import (
    Projector, _entries, _round, detector_grid, node_angles,
)


def rebin_geometry(D: int, det_width_factor: float, src_radius: float,
                   det_radius: float, m: int, device):
    """(s [D], k [D], fr [D]): the rebinned detector positions and each
    column's angular shift k + fr in units of 2 pi / m, in float64."""
    d = detector_grid(D, det_width_factor, device).float().double()
    gamma = torch.atan(d / (src_radius + det_radius))
    s = -src_radius * torch.sin(gamma)
    shift = (gamma - math.pi / 2.0) / (2.0 * math.pi / m)
    k = torch.floor(shift)
    return s, k.long(), shift - k


def _fan_entries(N, D, s, k, fr, m, tap_dtype, device):
    """(rows, cols, values) of the fan matrix of one node with m source
    angles, rows u * D + l: R @ A_par, R [m * D, T_p * D] holding each fan
    row's two weights (1 - fr_l, fr_l) at its periodized parallel rows,
    in float64."""
    if m % 2:
        raise ValueError("fan rebinning needs an even angle count per node")
    T = m // 2
    theta = (np.arange(T) + 0.5) * np.pi / T
    pr, pc, pv = _entries(N, s, theta, np.ones(T, dtype=bool), tap_dtype,
                          device)
    par = torch.sparse_coo_tensor(torch.stack([pr, pc]), pv.double(),
                                  (T * D, N * N))
    del pr, pc, pv
    u = torch.arange(m, device=device)[:, None]
    ls = torch.arange(D, device=device)
    w = (_round(1.0 - fr, tap_dtype), _round(fr, tap_dtype))
    src, wts = [], []
    for j in (0, 1):
        t2 = torch.remainder(u + k + j, m)  # [m, D]
        src.append(torch.remainder(t2, T) * D
                   + torch.where(t2 < T, ls, D - 1 - ls))
        wts.append(w[j].expand(m, D))
    fan_row = (u * D + ls).reshape(-1).repeat(2)
    R = torch.sparse_coo_tensor(
        torch.stack([fan_row, torch.cat(src).reshape(-1)]),
        torch.cat(wts).reshape(-1), (m * D, T * D))
    A = torch.sparse.mm(R.coalesce(), par.coalesce()).coalesce()
    r, c = A.indices()
    v = A.values().float()
    keep = v != 0
    return r[keep], c[keep], v[keep]


class FanProjector(Projector):
    """Every node's fan-beam forward and adjoint, with exact column norms,
    behind :class:`Projector`'s interface (``fwd``, ``adj``, ``colnorms``,
    ``row_valid``, ``m``, ``N``, ``P``, ``n``). Nodes with the same source
    angles share one matrix."""

    def __init__(self, N: int, P: int, angles_total, det_pixels,
                 det_width_factor: float, src_radius: float,
                 det_radius: float, device="cpu", tap_dtype=None,
                 operand_dtype=None):
        D = det_pixels if det_pixels is not None else N

        def entries(_, valid):
            m = int(valid.sum())
            s, k, fr = rebin_geometry(D, det_width_factor, src_radius,
                                      det_radius, m, device)
            return _fan_entries(N, D, s, k, fr, m, tap_dtype, device)

        self._build(N, P, D, *node_angles(N, P, angles_total, 2.0 * np.pi),
                    device, operand_dtype, entries)
