"""Acquisition geometry and the Joseph projector, with its dense matrix.

Image on [-1,1]^2, pixel centres c(i) = -1 + (i + 0.5) h with h = 2/N; a
parallel-beam ray (theta, d) is the line {x : x . (cos t, sin t) = d}.
Each node spans the full [0, pi) (fan beam: [0, 2 pi)) at its own angular
resolution, padded to m_max angles with a validity mask.

The Joseph projector integrates each ray along its dominant axis: at each
crossed row (or column) a 2-tap linear interpolation samples the image,
weighted by the crossing length h / |u|. Its adjoint is written out, not
derived: the taps of every ray are sorted by destination pixel once per
problem (:func:`transpose_taps`), and a pixel sums its taps in that fixed
order, so the adjoint and the column norms are the forward's weights
exactly and repeat bit for bit. :func:`dense_matrix` evaluates the same
2-tap weights directly as hat functions, an angle chunk at a time.

Ray geometry rounds cos/sin once (float64, then float32), as the port's
other projectors do; the rest runs in float32 in the JAX package's order.
"""

from __future__ import annotations

import numpy as np
import torch

from dip_admm_tpu_torch.config import GeometryConfig
from dip_admm_tpu_torch.ops.radon_fft import _cos_sin


def node_angles(cfg: GeometryConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-node angle arrays padded to m_max.

    Returns (angles [P, m_max] float64, valid [P, m_max] bool,
    m_per_node [P]); node k gets the cell centres of a uniform partition of
    [0, pi) (fan beam: [0, 2 pi)) into its own count m_k.
    """
    counts = cfg.angles_per_node()
    m_max = max(counts)
    P = cfg.num_nodes
    span = 2.0 * np.pi if cfg.fan_beam else np.pi
    angles = np.zeros((P, m_max), dtype=np.float64)
    valid = np.zeros((P, m_max), dtype=bool)
    for kk, m_k in enumerate(counts):
        angles[kk, :m_k] = (np.arange(m_k) + 0.5) * span / m_k
        valid[kk, :m_k] = True
    return angles, valid, np.asarray(counts)


def detector_centers(n_det: int, det_width: float) -> np.ndarray:
    return -det_width / 2.0 + (np.arange(n_det) + 0.5) * (det_width / n_det)


# ---------------------------------------------------------------------------
# Rays
# ---------------------------------------------------------------------------


def parallel_rays(angles: torch.Tensor, dets: torch.Tensor):
    """Parallel-beam rays x(t) = p + t u, p = d (cos, sin), u = (-sin, cos).
    angles [..., A], dets [D] -> p0, p1, u0, u1 each [..., A, D]."""
    cos, sin = (v[..., None] for v in _cos_sin(angles))
    p0 = dets * cos
    p1 = dets * sin
    return p0, p1, (-sin).expand_as(p0), cos.expand_as(p0)


def fan_rays(angles: torch.Tensor, dets: torch.Tensor, src_radius: float,
             det_radius: float):
    """Flat-detector fan-beam rays: the source at -src_radius along the
    angle's axis (cos, sin), the detector line at +det_radius across it;
    ``dets`` are positions along that line. Each ray starts at the source,
    with the unit direction towards its detector cell."""
    cos, sin = (v[..., None] for v in _cos_sin(angles))
    s0 = -src_radius * cos
    s1 = -src_radius * sin
    q0 = det_radius * cos - dets * sin
    q1 = det_radius * sin + dets * cos
    v0 = q0 - s0
    v1 = q1 - s1
    norm = torch.sqrt(v0**2 + v1**2)
    u0 = v0 / norm
    u1 = v1 / norm
    return s0.expand_as(u0), s1.expand_as(u0), u0, u1


def make_rays(cfg: GeometryConfig, angles: torch.Tensor):
    """Rays of an angle set [..., A] -> each [..., A, D], on its device."""
    dets = torch.as_tensor(
        detector_centers(cfg.n_det, cfg.det_width_factor * 2.0),
        dtype=torch.float32, device=angles.device)
    angles = angles.to(torch.float32)
    if cfg.fan_beam:
        return fan_rays(angles, dets, cfg.src_radius, cfg.det_radius)
    return parallel_rays(angles, dets)


# ---------------------------------------------------------------------------
# Joseph projection
# ---------------------------------------------------------------------------


def _axis0_taps(p0, p1, u0, u1, N: int):
    """The 2-tap samples of rays parametrized along axis 0 (valid where
    |u0| >= |u1|). Ray arrays [R] -> (b0, b1 [R, N] column indices, clamped
    into the image, w0, w1 [R, N] their weights, zero out of range, and
    the length weight scale [R] = h / |u0|). At the plane x0 = c(a) the ray
    crosses x1 = p1 + (c(a) - p0) u1 / u0."""
    h = 2.0 / N
    ca = -1.0 + (torch.arange(N, dtype=p0.dtype, device=p0.device) + 0.5) * h
    safe_u0 = torch.where(torch.abs(u0) < 1e-12, 1e-12, u0)
    slope = u1 / safe_u0
    x1 = p1[..., None] + (ca - p0[..., None]) * slope[..., None]
    fb = torch.clamp((x1 + 1.0) / h - 0.5, -2.0, N + 1.0)
    b0f = torch.floor(fb)
    w = fb - b0f
    b0 = b0f.to(torch.int64)
    b1 = b0 + 1
    w0 = torch.where((b0 >= 0) & (b0 < N), 1.0 - w, 0.0)
    w1 = torch.where((b1 >= 0) & (b1 < N), w, 0.0)
    return (torch.clamp(b0, 0, N - 1), torch.clamp(b1, 0, N - 1), w0, w1,
            h / torch.abs(safe_u0))


def joseph_taps(p0, p1, u0, u1, N: int, valid=None):
    """Every ray's taps on the flattened image: rays [R] -> (idx [R, 2N]
    pixel indices, w [R, 2N] weights, the length weight folded in; zero
    for taps out of the image and for invalid rays). A ray integrates
    along axis 0 where |u0| >= |u1| and along axis 1 otherwise, crossing by
    crossing."""
    rb0, rb1, rw0, rw1, rs = _axis0_taps(p0, p1, u0, u1, N)
    cb0, cb1, cw0, cw1, cs = _axis0_taps(p1, p0, u1, u0, N)
    a = torch.arange(N, device=p0.device)
    use_r = (torch.abs(u0) >= torch.abs(u1))[..., None]
    # axis-0 branch: pixel (a, b); axis-1 branch: pixel (b, a)
    i0 = torch.where(use_r, a * N + rb0, cb0 * N + a)
    i1 = torch.where(use_r, a * N + rb1, cb1 * N + a)
    w0 = torch.where(use_r, rs[..., None] * rw0, cs[..., None] * cw0)
    w1 = torch.where(use_r, rs[..., None] * rw1, cs[..., None] * cw1)
    idx = torch.stack([i0, i1], dim=-1).flatten(-2)
    w = torch.stack([w0, w1], dim=-1).flatten(-2)
    if valid is not None:
        w = torch.where(valid[..., None], w, 0.0)
    return idx, w


def joseph_project(img, p0, p1, u0, u1, valid=None, squared: bool = False):
    """Joseph line integrals of img [N, N] over rays of any common shape.

    Each ray integrates along its dominant direction component, so every
    crossed row or column contributes one 2-tap sample (:func:`joseph_taps`).
    ``squared=True`` applies the elementwise-squared weights (each pixel
    appears at most once per ray, so their transpose applied to ones is the
    column norms).
    """
    shape = p0.shape
    if valid is not None:
        valid = valid.expand(shape).reshape(-1)
    idx, w = joseph_taps(*(r.reshape(-1) for r in (p0, p1, u0, u1)),
                         img.shape[-1], valid)
    if squared:
        w = w * w
    return torch.sum(w * img.reshape(-1)[idx], dim=-1).reshape(shape)


def transpose_taps(idx, w, n: int):
    """The adjoint's tap layout: idx, w [R, T] -> (src [n, K] ray indices,
    tw [n, K] weights), K the most taps any pixel receives. Pixel p's taps
    sit in ray order (a stable sort by destination); unused slots point at
    ray R, which the adjoint reads as zero."""
    R, T = idx.shape
    keep = (w != 0).flatten()
    dest = idx.flatten()[keep]
    src = torch.div(torch.arange(R * T, device=idx.device), T,
                    rounding_mode="floor")[keep]
    ww = w.flatten()[keep]
    dest, order = torch.sort(dest, stable=True)
    src, ww = src[order], ww[order]
    counts = torch.bincount(dest, minlength=n)
    K = max(int(counts.max()), 1) if dest.numel() else 1
    pos = torch.arange(dest.numel(), device=idx.device) - (
        torch.cumsum(counts, 0) - counts)[dest]
    S = torch.full((n, K), R, dtype=torch.int64, device=idx.device)
    Wt = torch.zeros((n, K), dtype=w.dtype, device=w.device)
    S[dest, pos] = src
    Wt[dest, pos] = ww
    return S, Wt


def _pad_cols(t: torch.Tensor, K: int, fill) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, K - t.shape[-1]), value=fill)


def joseph_tables(cfg: GeometryConfig, angles: torch.Tensor,
                  valid: torch.Tensor) -> dict:
    """Per-node tap tables of the Joseph pair, angles/valid [P, m]:
    ``idx``, ``w`` [P, m * D, 2N] (the forward's taps) and ``src``, ``tw``
    [P, n, K] (the adjoint's, :func:`transpose_taps`, padded to the
    largest K of any node). Every leaf has the node count leading, so a
    node slice of the tables is a node block's projector."""
    N, n = cfg.N, cfg.n
    fwd, adj = [], []
    for i in range(angles.shape[0]):
        rays = [r.reshape(-1) for r in make_rays(cfg, angles[i])]
        v = valid[i][:, None].expand(-1, cfg.n_det).reshape(-1)
        idx, w = joseph_taps(*rays, N, v)
        fwd.append((idx, w))
        adj.append(transpose_taps(idx, w, n))
    K = max(s.shape[1] for s, _ in adj)
    R = fwd[0][0].shape[0]
    return {
        "idx": torch.stack([i for i, _ in fwd]),
        "w": torch.stack([w for _, w in fwd]),
        "src": torch.stack([_pad_cols(s, K, R) for s, _ in adj]),
        "tw": torch.stack([_pad_cols(t, K, 0.0) for _, t in adj]),
    }


def _apply_taps(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor):
    """out[p, r] = sum_j w[p, r, j] x[p, idx[p, r, j]] in j order, for x
    [PB, ...] of PB = B * P images against the P nodes' taps, image p
    taking node p % P's (b-major)."""
    P, R, T = idx.shape
    B = x.shape[0] // P
    g = torch.gather(x.reshape(B, P, -1), 2,
                     idx.reshape(1, P, R * T).expand(B, P, R * T))
    return torch.sum(g.reshape(B, P, R, T) * w, dim=-1).reshape(B * P, R)


def project_nodes(cfg: GeometryConfig, imgs: torch.Tensor,
                  tables: dict) -> torch.Tensor:
    """Forward-project every node's image: [P, N, N] -> [P, m_max, D]; a
    batch of B * P images (b-major) against the same P nodes' tables gives
    [B * P, m_max, D]."""
    PB = imgs.shape[0]
    out = _apply_taps(imgs.reshape(PB, -1), tables["idx"], tables["w"])
    return out.reshape(PB, -1, cfg.n_det)


def backproject_nodes(cfg: GeometryConfig, sinos: torch.Tensor,
                      tables: dict) -> torch.Tensor:
    """Adjoint per node: [P, m_max, D] -> [P, N, N] (or B * P of each)."""
    PB = sinos.shape[0]
    ext = torch.nn.functional.pad(sinos.reshape(PB, -1), (0, 1))  # ray R = 0
    out = _apply_taps(ext, tables["src"], tables["tw"])
    return out.reshape(PB, cfg.N, cfg.N)


def colnorms_sq_nodes(tables: dict) -> torch.Tensor:
    """W[i, p] = ||A_i[:, p]||^2 from the adjoint's taps: [P, n]."""
    return torch.sum(tables["tw"] ** 2, dim=-1)


def _one_node(cfg, angles, valid):
    valid = (torch.ones(angles.shape, dtype=torch.bool, device=angles.device)
             if valid is None else valid)
    return joseph_tables(cfg, angles[None], valid[None])


def project(cfg: GeometryConfig, img: torch.Tensor, angles: torch.Tensor,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Forward projection: img [N, N] x angles [A] -> sinogram [A, D]."""
    p0, p1, u0, u1 = make_rays(cfg, angles)
    v = None if valid is None else valid[..., None]
    return joseph_project(img, p0, p1, u0, u1, valid=v)


def backproject(cfg: GeometryConfig, sino: torch.Tensor, angles: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """The exact adjoint of :func:`project`: sino [A, D] -> [N, N]."""
    t = _one_node(cfg, angles, valid)
    return backproject_nodes(cfg, sino[None], t)[0]


def colnorms_sq(cfg: GeometryConfig, angles: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Column norms W[p] = ||A[:, p]||^2 of one node's operator as an
    [N, N] image: the squared-weights transpose applied to ones."""
    t = _one_node(cfg, angles, valid)
    return colnorms_sq_nodes(t)[0].reshape(cfg.N, cfg.N)


# ---------------------------------------------------------------------------
# Dense matrix
# ---------------------------------------------------------------------------


def _dense_block(cfg: GeometryConfig, ang_blk, val_blk) -> torch.Tensor:
    """The 2-tap Joseph weights of one angle chunk as hat functions:
    [tc] -> [tc * D, n]."""
    N, D = cfg.N, cfg.n_det
    dtype, dev = ang_blk.dtype, ang_blk.device
    h = 2.0 / N
    c = -1.0 + (torch.arange(N, dtype=dtype, device=dev) + 0.5) * h
    i_idx = torch.arange(N, dtype=dtype, device=dev)
    p0, p1, u0, u1 = make_rays(cfg, ang_blk)  # each [tc, D]

    def branch(p0, p1, u0, u1, transpose):
        safe = torch.where(torch.abs(u0) < 1e-12, 1e-12, u0)
        slope = u1 / safe
        x1 = p1[:, :, None] + (c - p0[:, :, None]) * slope[:, :, None]
        fb = (x1 + 1.0) / h - 0.5  # [tc, D, a]
        w = torch.clamp(1.0 - torch.abs(fb[..., None] - i_idx), min=0.0)
        w = (h / torch.abs(safe))[:, :, None, None] * w  # [tc, D, a, i]
        return w.transpose(2, 3) if transpose else w

    use_r = (torch.abs(u0) >= torch.abs(u1))[:, :, None, None]
    w = torch.where(use_r, branch(p0, p1, u0, u1, False),
                    branch(p1, p0, u1, u0, True))
    w = w * val_blk[:, None, None, None]
    return w.reshape(-1, N * N)


def dense_matrix(cfg: GeometryConfig, angles: torch.Tensor,
                 valid: torch.Tensor | None = None, chunk: int = 32,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The dense operator A [A * D, N * N] (float32) of one node.

    Row r = angle * D + detector, column p = the row-major pixel index.
    The weights are evaluated directly, ``chunk`` angles at a time, the
    angle set padded with invalid angles to whole chunks. ``out`` [A * D,
    n] receives A in place (a node's slice of a stack)."""
    T, D = angles.shape[0], cfg.n_det
    f32, dev = torch.float32, angles.device
    T_pad = -(-T // chunk) * chunk
    ang = torch.zeros(T_pad, dtype=f32, device=dev)
    ang[:T] = angles.to(f32)
    val = torch.zeros(T_pad, dtype=f32, device=dev)
    val[:T] = 1.0 if valid is None else valid.to(f32)
    if out is None:
        out = torch.empty((T * D, cfg.n), dtype=f32, device=dev)
    for s in range(0, T, chunk):
        blk = _dense_block(cfg, ang[s:s + chunk], val[s:s + chunk])
        rows = min(chunk, T - s) * D
        out[s * D:s * D + rows] = blk[:rows]
    return out


def _batch_bmm(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A_p v_{b, p} for A [P, r, c] and v [B * P, c] (b-major): one
    [P, r, c] x [P, c, B] product -> [B * P, r]."""
    P = A.shape[0]
    B = v.shape[0] // P
    if B == 1:  # the unbatched product, [P, c, 1] in its own layout
        return torch.bmm(A, v.reshape(P, -1, 1)).reshape(P, -1)
    out = torch.bmm(A, v.reshape(B, P, -1).permute(1, 2, 0))  # [P, r, B]
    return out.permute(2, 0, 1).reshape(B * P, -1)


def project_nodes_dense(cfg: GeometryConfig, imgs: torch.Tensor,
                        tables: dict) -> torch.Tensor:
    """A_i x_i for every node: [P, N, N] -> [P, m_max, D] (float32); a
    batch of B * P images (b-major) -> [B * P, m_max, D] in one product."""
    PB = imgs.shape[0]
    out = _batch_bmm(tables["A"], imgs.reshape(PB, -1))
    return out.reshape(PB, -1, cfg.n_det)


def backproject_nodes_dense(cfg: GeometryConfig, sinos: torch.Tensor,
                            tables: dict) -> torch.Tensor:
    """A_i^T r_i for every node: [P, m_max, D] -> [P, N, N] (float32), or
    B * P of each."""
    PB = sinos.shape[0]
    out = _batch_bmm(tables["A"].transpose(1, 2), sinos.reshape(PB, -1))
    return out.reshape(PB, cfg.N, cfg.N)
