"""Feed-forward layers of the LM stack: the SwiGLU MLP (twin of the MLP
half of ``repro.nn.ffn``; the routed Mixture-of-Experts comes with the LM
families slice)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.nn.layers import dense_init, swiglu


class MLPParams(NamedTuple):
    w1: torch.Tensor   # [d, ff]
    w3: torch.Tensor   # [d, ff]   (gate)
    w2: torch.Tensor   # [ff, d]


def init_mlp(gen: Optional[torch.Generator], d: int, ff: int,
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None) -> MLPParams:
    return MLPParams(dense_init(gen, d, ff, dtype, device),
                     dense_init(gen, d, ff, dtype, device),
                     dense_init(gen, ff, d, dtype, device))


def apply_mlp(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p.w1, p.w3, p.w2)
