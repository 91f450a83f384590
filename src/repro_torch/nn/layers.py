"""Shared NN primitives for the LM stack (twin of ``repro.nn.layers``).

The initialisers take an explicit ``torch.Generator`` in place of a JAX
key and draw on the generator's device (a CUDA generator draws on the
card, which is what makes a full-width model quick to build); they draw
from the same distributions as the reference but cannot replay JAX's
PRNG, so parity tests carry the reference's weights across with
``repro_torch.convert``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _normal(gen: Optional[torch.Generator], shape,
            device: Optional[torch.device]) -> torch.Tensor:
    draw_on = gen.device if gen is not None else (device or "cpu")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=draw_on)
    return x if device is None else x.to(device)


def dense_init(gen: Optional[torch.Generator], f_in: int, f_out: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, 1/f_in) weights [f_in, f_out], drawn in f32, stored in
    ``dtype``."""
    return (_normal(gen, (f_in, f_out), device) / math.sqrt(f_in)).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, 0.02^2) embedding table [vocab, d]."""
    return (0.02 * _normal(gen, (vocab, d), device)).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim in f32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 500000.0) -> torch.Tensor:
    """Rotary embedding (rotate-half form).  x: [..., S, H, dh],
    positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs              # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x w1) * (x w3)) w2."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2
