"""The plain parallel-beam projector, as an explicit sparse matrix.

The operator the benchmark's configurations state: an N x N image on
[-1, 1]^2, angles split over the nodes, a detector of D cells spanning
``2 * det_width_factor``. For an angle with |sin| >= |cos| (else the same
on the transposed image) every image row a is moved along itself to the
real position r = i - sigma_a of its pixel i, sigma_a = B a + C, and
spread over the integer grid by a 2-tap linear interpolation; detector l
reads the summed profile at the real position p_l through a second 2-tap
interpolation, times the branch scale h / |sin|. So pixel (a, i) and
detector l are joined by

    s * sum_q tent(q - p_l) * tent(q - (i - sigma_a)),
    tent(z) = max(0, 1 - |z|)

over the integers q. The geometry is worked out in float64 from the
float32 angles, and each node's matrix [T * D, N * N] (angle-major rows,
invalid angles zero) is built once per distinct angle set, with its
transpose, as compressed sparse rows. ``tap_dtype`` rounds every
interpolation tap to a narrower type before the product, and
``operand_dtype`` each image or measurement row the product reads, scaled
to the type's range by its largest magnitude (the lower-precision
controls).
"""

from __future__ import annotations

import numpy as np
import torch


def node_angles(N: int, P: int, angles_total: int | None = None,
                span: float = np.pi):
    """Per-node angles [P, m_max] float64 and valid [P, m_max] bool: the
    total max(180, 3N) split evenly with the remainder to the first
    nodes, node k taking the cell centres of [0, span) cut into its
    count (span 2 pi for a fan's source angles)."""
    total = angles_total if angles_total is not None else max(180, 3 * N)
    counts = [total // P + (1 if i < total % P else 0) for i in range(P)]
    m = max(counts)
    angles = np.zeros((P, m))
    valid = np.zeros((P, m), dtype=bool)
    for k, c in enumerate(counts):
        angles[k, :c] = (np.arange(c) + 0.5) * span / c
        valid[k, :c] = True
    return angles, valid


def detector_grid(D: int, det_width_factor: float, device) -> torch.Tensor:
    """The centres [D] float64 of D equal cells spanning
    2 * det_width_factor."""
    det_w = 2.0 * det_width_factor
    return (torch.arange(D, dtype=torch.float64, device=device) + 0.5) \
        * (det_w / D) - det_w / 2.0


def _tent(z):
    return torch.clamp(1.0 - torch.abs(z), min=0.0)


# Angles of one node whose entries are built at once.
_CHUNK = 16


def _round(w, tap_dtype):
    return w if tap_dtype is None else w.to(tap_dtype).to(w.dtype)


def _entries(N, dets, angles, valid, tap_dtype, device):
    """(rows, cols, values) of one node's matrix, nonzeros only, with
    detector l read at the position dets[l] (float64)."""
    f64 = torch.float64
    h = 2.0 / N
    D = dets.numel()
    c0 = -1.0 + 0.5 * h
    th = torch.as_tensor(np.asarray(angles, np.float32), device=device).to(f64)
    cos, sin = torch.cos(th), torch.sin(th)
    use_r = torch.abs(sin.float()) >= torch.abs(cos.float())
    s_ = torch.where(use_r, sin, cos)
    c_ = torch.where(use_r, cos, sin)
    s_ = torch.where(torch.abs(s_) < 1e-9, torch.full_like(s_, 1e-9), s_)
    Pdet = dets[None, :] / (h * s_[:, None])  # [T, D]
    B = -(c_ / s_)
    C = (1.0 - c0 * (c_ / s_)) / h - 0.5
    scale = h / torch.abs(s_)
    a_idx = torch.arange(N, dtype=f64, device=device)
    j = torch.arange(4, device=device)
    rows, cols, vals = [], [], []
    keep = torch.nonzero(torch.as_tensor(valid, device=device)).flatten()
    for t0 in range(0, keep.numel(), _CHUNK):
        ts = keep[t0:t0 + _CHUNK]
        p = Pdet[ts][:, :, None, None]  # [Tc, D, 1, 1]
        sig = (B[ts][:, None] * a_idx + C[ts][:, None])[:, None, :, None]
        i = torch.floor(p + sig).long() - 1 + j  # [Tc, D, N, 4]
        r = i.to(f64) - sig
        q0 = torch.floor(p)
        fp = p - q0
        d0, d1 = _round(1.0 - fp, tap_dtype), _round(fp, tap_dtype)
        K = d0 * _round(_tent(q0 - r), tap_dtype) \
            + d1 * _round(_tent(q0 + 1.0 - r), tap_dtype)
        K = (K * scale[ts][:, None, None, None]).to(torch.float32)
        ok = (i >= 0) & (i < N) & (K != 0)
        a = a_idx.long()[None, None, :, None].expand_as(i)
        ur = use_r[ts][:, None, None, None]
        col = torch.where(ur, a * N + i, i * N + a)
        row = (ts[:, None, None, None] * D
               + torch.arange(D, device=device)[None, :, None, None]
               ).expand_as(i)
        rows.append(row[ok])
        cols.append(col[ok])
        vals.append(K[ok])
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def _csr(rows, cols, vals, shape):
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    csr = coo.coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(csr.crow_indices().int(),
                                   csr.col_indices().int(), csr.values(),
                                   shape)


class Projector:
    """Every node's forward and adjoint on [P, n] images / [P, m]
    measurements (or [..., P, n] stacks of them), with exact column norms.
    Nodes with the same angle set share one matrix."""

    def __init__(self, N: int, P: int, angles_total=None, det_pixels=None,
                 det_width_factor: float = 1.0, device="cpu",
                 tap_dtype=None, operand_dtype=None):
        D = det_pixels if det_pixels is not None else N
        dets = detector_grid(D, det_width_factor, device)
        self._build(N, P, D, *node_angles(N, P, angles_total), device,
                    operand_dtype, lambda angles, valid: _entries(
                        N, dets, angles, valid, tap_dtype, device))

    def _build(self, N, P, D, angles, valid, device, operand_dtype, entries):
        """The shapes, the row mask, and one matrix for each distinct angle
        set, from ``entries(angles, valid)`` of its first node: (rows,
        cols, values)."""
        self.N, self.P, self.D, self.n = N, P, D, N * N
        self.operand_dtype = operand_dtype
        self.m = angles.shape[1] * D
        self.row_valid = torch.as_tensor(
            np.repeat(valid, D, axis=1), dtype=torch.float32, device=device)
        groups: dict = {}
        for i in range(P):
            key = (angles[i].tobytes(), valid[i].tobytes())
            groups.setdefault(key, []).append(i)
        self.groups = []
        for nodes in groups.values():
            r, c, v = entries(angles[nodes[0]], valid[nodes[0]])
            A = _csr(r, c, v, (self.m, self.n))
            AT = _csr(c, r, v, (self.n, self.m))
            del r, c
            W = torch.zeros(self.n, dtype=torch.float64, device=device)
            W.index_add_(0, _row_ids(AT), AT.values().double() ** 2)
            self.groups.append((nodes, A, AT, W.float()))

    def _apply(self, x, which, width_out):
        lead = x.shape[:-2]
        x = _round_rows(x.reshape(-1, self.P, x.shape[-1]),
                        self.operand_dtype)
        out = x.new_empty((x.shape[0], self.P, width_out))
        for nodes, A, AT, _ in self.groups:
            M = A if which == "fwd" else AT
            cols = x[:, nodes].reshape(-1, x.shape[-1]).T.contiguous()
            y = torch.sparse.mm(M, cols).T
            out[:, nodes] = y.reshape(x.shape[0], len(nodes), width_out)
        return out.reshape(*lead, self.P, width_out)

    def fwd(self, x):
        return self._apply(x, "fwd", self.m)

    def adj(self, y):
        return self._apply(y, "adj", self.n)

    def colnorms(self) -> torch.Tensor:
        """W [P, n] = ||A_i[:, p]||^2."""
        W = torch.empty((self.P, self.n), device=self.row_valid.device)
        for nodes, _, _, w in self.groups:
            W[nodes] = w
        return W


def _round_rows(x, dtype):
    """x rounded to ``dtype`` row by row, each row scaled so that its
    largest magnitude is the type's largest finite value."""
    if dtype is None:
        return x
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                    torch.ones_like(amax))
    return (x / s).to(dtype).to(x.dtype) * s


def _row_ids(csr) -> torch.Tensor:
    """The row of each stored entry of a CSR matrix."""
    crow = csr.crow_indices().long()
    counts = crow[1:] - crow[:-1]
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=crow.device), counts)
