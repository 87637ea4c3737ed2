"""Piecewise-constant test phantoms (host-side numpy, bit-identical to the
JAX package's generators).

``const_im``/``rand_im`` compose, on an N x N zero canvas, a 200-valued
rectangle to the bottom-right border, a radius-N/2 circle of 80 that
overwrites it, a radius-N/8 circle of 300 and two radius-N/16 circles of
400 (both max-combined). A circle centre ``(u, v)`` lands at row=v, col=u.
"""

from __future__ import annotations

import numpy as np


def _circle_mask(N: int, row: float, col: float, radius: float) -> np.ndarray:
    r = np.arange(N)[:, None]
    c = np.arange(N)[None, :]
    return (c - col) ** 2 + (r - row) ** 2 <= radius**2


def const_im(N: int) -> np.ndarray:
    """Deterministic phantom."""
    r_big, r_med, r_small = N // 2, N // 8, N // 16
    img = np.zeros((N, N), dtype=np.float64)
    img[N // 6 :, N // 5 :] = 200.0
    big = _circle_mask(N, row=N // 3, col=N // 3, radius=r_big)
    img = np.where(big, 80.0, img)
    med = _circle_mask(N, row=3 * N // 5, col=3 * N // 5, radius=r_med)
    img = np.maximum(img, np.where(med, 300.0, 0.0))
    s1 = _circle_mask(N, row=N - N // 6, col=N // 10, radius=r_small)
    img = np.maximum(img, np.where(s1, 400.0, 0.0))
    s2 = _circle_mask(N, row=N // 10, col=N - N // 6, radius=r_small)
    img = np.maximum(img, np.where(s2, 400.0, 0.0))
    return img


def rand_im(N: int, seed: int | None = None) -> np.ndarray:
    """Randomized phantom: the shapes of ``const_im`` at seeded positions."""
    rng = np.random.default_rng(seed)
    r_big, r_med, r_small = N // 2, N // 8, N // 16
    img = np.zeros((N, N), dtype=np.float64)

    ofs = rng.integers(N // 8, N // 4 + N // 8, size=2)
    img[ofs[0] :, ofs[1] :] = 200.0

    c1 = rng.integers(N // 4, N // 2, size=2)  # (col, row)
    big = _circle_mask(N, row=c1[1], col=c1[0], radius=r_big)
    img = np.where(big, 80.0, img)

    c2 = rng.integers(N // 2, 3 * N // 4, size=2)
    med = _circle_mask(N, row=c2[1], col=c2[0], radius=r_med)
    img = np.maximum(img, np.where(med, 300.0, 0.0))

    c3 = rng.integers(0, N // 4, size=2) + np.array([0, N - N // 4])
    s1 = _circle_mask(N, row=c3[1], col=c3[0], radius=r_small)
    img = np.maximum(img, np.where(s1, 400.0, 0.0))

    c4 = rng.integers(0, N // 4, size=2) + np.array([N - N // 4, 0])
    s2 = _circle_mask(N, row=c4[1], col=c4[0], radius=r_small)
    img = np.maximum(img, np.where(s2, 400.0, 0.0))
    return img


# Modified Shepp-Logan ellipses: (value, a, b, x0, y0, phi_degrees).
_SHEPP_LOGAN = [
    (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
    (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
    (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
    (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
    (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
    (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
    (0.1, 0.046, 0.046, 0.0, -0.1, 0.0),
    (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
    (0.1, 0.023, 0.023, 0.0, -0.606, 0.0),
    (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
]


def shepp_logan(N: int, scale: float = 1.0) -> np.ndarray:
    """Modified Shepp-Logan phantom on [-1, 1]^2 (row = y top-down)."""
    y = np.linspace(1, -1, N, endpoint=False) - 1.0 / N
    x = np.linspace(-1, 1, N, endpoint=False) + 1.0 / N
    X, Y = np.meshgrid(x, y)
    img = np.zeros((N, N), dtype=np.float64)
    for val, a, b, x0, y0, phi in _SHEPP_LOGAN:
        t = np.deg2rad(phi)
        ct, st = np.cos(t), np.sin(t)
        Xr = (X - x0) * ct + (Y - y0) * st
        Yr = -(X - x0) * st + (Y - y0) * ct
        img += val * ((Xr / a) ** 2 + (Yr / b) ** 2 <= 1.0)
    return img * scale


def make_phantom(kind: str, N: int, seed: int | None = None) -> np.ndarray:
    if kind == "const":
        return const_im(N)
    if kind == "rand":
        return rand_im(N, seed=seed)
    if kind == "shepp":
        # Scaled to the other phantoms' intensity range, so lam_tv and rho
        # keep comparable operating points.
        return shepp_logan(N, scale=400.0)
    raise ValueError(f"unknown phantom kind {kind!r}")
