"""The arithmetic of the reference's matrix products.

``Precision()`` is float32 throughout.  ``Precision(tf32=True)`` rounds
both operands of every product (and of its two backward products) to
TF32 -- a 10-bit mantissa, round to nearest even -- and accumulates in
float32, as a tensor core's TF32 mode does.  It runs the same on a CPU
and on a card, so the control of the correctness check is one
computation everywhere.
"""
from __future__ import annotations

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return round_tf32(a) @ round_tf32(w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(w).t(), round_tf32(a).t() @ g


class Precision:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a [..., k] @ w [k, n], differentiable in both."""
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        out = _TF32Product.apply(a2, w) if self.tf32 else a2 @ w
        return out.reshape(*lead, w.shape[1])

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched a [B, m, k] @ b [B, k, n], no gradient."""
        if self.tf32:
            return torch.bmm(round_tf32(a), round_tf32(b))
        return torch.bmm(a, b)
