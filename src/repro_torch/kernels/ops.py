"""Dispatch between the CUDA kernels and their plain versions.

Decided by the operand's device alone: a CPU tensor goes to ``ref.py``, a
CUDA tensor goes to the hand-written kernel, whose wrapper validates it and
launches or raises.  There is no environment knob and no fallback: a CUDA
tensor that the kernel refuses is an error, never a silent plain-PyTorch
run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.context_ell import context_ell_cuda
from repro_torch.kernels.spmm_ell import spmm_ell_cuda
from repro_torch.kernels.vq_assign import vq_assign_cuda


def vq_assign(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """[nb, n, f] rows vs [nb, k, f] codewords -> [nb, n] int32."""
    if x.is_cuda:
        return vq_assign_cuda(x, codewords)
    return ref.vq_assign(x, codewords)


def spmm_ell(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMM: [b, D] ids/values into an [n_src, f] source -> [b, f]."""
    if x.is_cuda:
        return spmm_ell_cuda(nbr_idx, nbr_val, x)
    return ref.spmm_ell(nbr_idx, nbr_val, x)


def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor,
                codewords: torch.Tensor) -> torch.Tensor:
    """Multi-branch codeword context -> [b, nb * f_blk]."""
    if out_vals.is_cuda:
        return context_ell_cuda(out_ids, out_vals, assignment, codewords)
    return ref.context_ell(out_ids, out_vals, assignment, codewords)
