"""Dispatch between the CUDA kernels and their plain versions.

Decided by the operand's device alone: a CPU tensor goes to ``ref.py``, a
CUDA tensor goes to the hand-written kernel, whose wrapper validates it and
launches or raises.  There is no environment knob and no fallback: a CUDA
tensor that the kernel refuses is an error, never a silent plain-PyTorch
run.  ``spmm_ell`` is differentiable in ``x``: its backward is the
transposed kernel ``spmm_ell_t`` (dispatched the same way).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.context_ell import context_ell_cuda
from repro_torch.kernels.spmm_ell import spmm_ell_cuda, spmm_ell_t_cuda
from repro_torch.kernels.vq_assign import vq_assign_cuda
from repro_torch.kernels.vq_update import vq_assign_update_cuda


def vq_assign(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """[nb, n, f] rows vs [nb, k, f] codewords -> [nb, n] int32."""
    if x.is_cuda:
        return vq_assign_cuda(x, codewords)
    return ref.vq_assign(x, codewords)


def vq_assign_update(x: torch.Tensor, codewords: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Fused assign + cluster stats: [nb, b, f] rows vs [nb, k, f]
    codewords -> (assignment [nb, b] int32, qerr [nb, b], counts [nb, k],
    sums [nb, k, f])."""
    if x.is_cuda:
        return vq_assign_update_cuda(x, codewords)
    return ref.vq_assign_update(x, codewords)


def spmm_ell_t(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
               g: torch.Tensor, n_src: int) -> torch.Tensor:
    """Transposed ELLPACK SpMM: [b, D] ids/values, g [b, f] -> [n_src, f]."""
    if g.is_cuda:
        return spmm_ell_t_cuda(nbr_idx, nbr_val, g, n_src)
    return ref.spmm_ell_t(nbr_idx, nbr_val, g, n_src)


class _SpmmEll(torch.autograd.Function):
    """``spmm_ell`` with its backward in ``x`` (the edge ids and values
    are constants of the graph and get no gradient)."""

    @staticmethod
    def forward(ctx, nbr_idx, nbr_val, x):
        ctx.save_for_backward(nbr_idx, nbr_val)
        ctx.n_src = x.shape[0]
        if x.is_cuda:
            return spmm_ell_cuda(nbr_idx, nbr_val, x)
        return ref.spmm_ell(nbr_idx, nbr_val, x)

    @staticmethod
    def backward(ctx, g):
        nbr_idx, nbr_val = ctx.saved_tensors
        return None, None, spmm_ell_t(nbr_idx, nbr_val, g.contiguous(),
                                      ctx.n_src)


def spmm_ell(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMM: [b, D] ids/values into an [n_src, f] source -> [b, f],
    differentiable in ``x``.  Edge values that require grad are refused:
    on every path they are degree constants of the graph."""
    if nbr_val.requires_grad and torch.is_grad_enabled():
        raise ValueError("spmm_ell: nbr_val requires grad; the kernel's "
                         "backward covers x only (edge values are constants)")
    return _SpmmEll.apply(nbr_idx, nbr_val, x)


def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor, codewords: torch.Tensor,
                w_t: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-branch codeword context -> [b, nb * f_blk], or ``@ w_t``
    fused into the same kernel -> [b, f_out]."""
    if out_vals.is_cuda:
        return context_ell_cuda(out_ids, out_vals, assignment, codewords, w_t)
    return ref.context_ell(out_ids, out_vals, assignment, codewords, w_t)
