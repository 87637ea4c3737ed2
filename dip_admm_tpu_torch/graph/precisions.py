"""Pairwise precisions Q_ij from the column-norm weights W_i.

  W[i, p]    = ||A_i[:, p]||_2^2          (floored at EPS)
  harmonic   : Q[i,j,p] = W_i W_j / (W_i + W_j)
  arithmetic : Q[i,j,p] = (W_i + W_j) / 2
with Q floored at EPS and the diagonal Q[i,i,:] = 0.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def pairwise_q(W: torch.Tensor, q_mode: str = "arithmetic") -> torch.Tensor:
    """Q [P, P, n] from W [P, n]; diagonal zeroed."""
    Wi = W[:, None, :]
    Wj = W[None, :, :]
    if q_mode == "harmonic":
        q = (Wi * Wj) / (Wi + Wj)
    elif q_mode == "arithmetic":
        q = 0.5 * (Wi + Wj)
    else:
        raise ValueError("q_mode must be 'harmonic' or 'arithmetic'")
    q = torch.clamp(q, min=EPS)
    P = W.shape[0]
    off_diag = ~torch.eye(P, dtype=torch.bool, device=W.device)
    return q * off_diag[:, :, None]
