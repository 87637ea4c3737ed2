"""Inputs made from ``--seed``: the phantom, the measurement noise of each
reconstruction, and the power-method and Lanczos starts.

Every draw has a stream of its own, a 64-bit seed worked out from the
run's seed and the draw's tags by ``numpy.random.SeedSequence``, and is
made on the device by a ``torch.Generator`` there: the same seed gives
the same inputs in any process, and any whole number is a seed.
"""

from __future__ import annotations

import numpy as np
import torch

# Tags of the draws.
NOISE, OPNORM_V0, LANCZOS_V0 = 1, 2, 3

# The modified Shepp-Logan ellipses: (value, a, b, x0, y0, phi_degrees).
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


def shepp_logan(N: int, scale: float) -> np.ndarray:
    """The modified Shepp-Logan phantom on [-1, 1]^2 (row = y top-down),
    times ``scale``: [N, N] float64."""
    y = np.linspace(1, -1, N, endpoint=False) - 1.0 / N
    x = np.linspace(-1, 1, N, endpoint=False) + 1.0 / N
    X, Y = np.meshgrid(x, y)
    img = np.zeros((N, N))
    for val, a, b, x0, y0, phi in _SHEPP_LOGAN:
        t = np.deg2rad(phi)
        ct, st = np.cos(t), np.sin(t)
        Xr = (X - x0) * ct + (Y - y0) * st
        Yr = -(X - x0) * st + (Y - y0) * ct
        img += val * ((Xr / a) ** 2 + (Yr / b) ** 2 <= 1.0)
    return img * scale


def phantom(spec: dict, N: int) -> np.ndarray:
    if spec["kind"] != "shepp_logan":
        raise ValueError(f"unknown phantom {spec['kind']!r}")
    return shepp_logan(N, spec["scale"])


def stream(seed: int, *tags: int) -> int:
    """The 64-bit seed of the draw ``tags`` of run ``seed``."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def normal(shape, seed: int, *tags: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(stream(seed, *tags))
    return torch.randn(shape, generator=gen, device=device)


def noise(seed: int, recon: int, lane: int, shape, device) -> torch.Tensor:
    """The standard-normal measurement noise [P, m] of lane ``lane`` of
    reconstruction ``recon``."""
    return normal(shape, seed, NOISE, recon, lane, device=device)
