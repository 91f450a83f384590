"""Error bounds of Theorem 2 / Corollary 3, as executable checks.

Torch twin of ``repro.core.bounds``:

    || X^_B^(l+1) - X_B^(l+1) ||_F
        <= eps^(l) (1 + O(Lip(h))) Lip(sigma) ||C|| ||X|| ||W||     (Thm 2)

    || grad^_X_B - grad_X_B ||_F
        <= eps^(l) (1 + O(Lip(h))) sigma'_max ||C|| ||grad_X^(l+1)|| ||W||
                                                                    (Cor 3)

Plain tensor functions on any device.
"""
from __future__ import annotations

import math

import torch


def fro(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm, accumulated in f32."""
    return torch.sqrt(torch.sum(torch.square(x.float())))


def vq_relative_error(x: torch.Tensor, x_recon: torch.Tensor) -> torch.Tensor:
    """eps = ||X - R X~||_F / ||X||_F."""
    return fro(x - x_recon) / torch.clamp(fro(x), min=1e-12)


def feature_error_bound(eps, c_fro, x_fro, w_fro, lip_sigma: float = 1.0,
                        lip_h: float = 0.0):
    """Theorem 2 right-hand side.  lip_h = 0 for fixed convolutions."""
    return eps * (1.0 + lip_h) * lip_sigma * c_fro * x_fro * w_fro


def gradient_error_bound(eps, c_fro, g_fro, w_fro,
                         sigma_prime_max: float = 1.0, lip_h: float = 0.0):
    """Corollary 3 right-hand side."""
    return eps * (1.0 + lip_h) * sigma_prime_max * c_fro * g_fro * w_fro


def lipschitz_leaky_relu(negative_slope: float = 0.2) -> float:
    return max(1.0, negative_slope)


def gat_h_lipschitz(w: torch.Tensor, a: torch.Tensor,
                    negative_slope: float = 0.2,
                    score_clip: float = 5.0) -> torch.Tensor:
    """Upper bound on Lip(h) for the (Lipschitz-regularized) GAT score

        h(x_i, x_j) = exp(clip(LeakyReLU([x_i W || x_j W] . a), +-c))

    (paper App. E): clipping the pre-exp score to [-c, c] bounds the exp's
    local Lipschitz constant by e^c, and the inner map's by ||W|| ||a||
    (2-norms of the flattened tensors)."""
    return math.exp(score_clip) * lipschitz_leaky_relu(negative_slope) \
        * torch.linalg.norm(w.float()) * torch.linalg.norm(a.float())
