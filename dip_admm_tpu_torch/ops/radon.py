"""Acquisition geometry helpers: the per-node angle split and detector grid.

Image on [-1,1]^2, pixel centres c(i) = -1 + (i + 0.5) h with h = 2/N; a
parallel-beam ray (theta, d) is the line {x : x . (cos t, sin t) = d}.
Each node spans the full [0, pi) at its own angular resolution. The Joseph
gather projector of the JAX package is not ported yet.
"""

from __future__ import annotations

import numpy as np

from dip_admm_tpu_torch.config import GeometryConfig


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
