"""Checked wrapper of the fused VQ-context CUDA kernel
(``csrc/context_ell.cu``).

Counterpart of ``repro.kernels.context_ell.context_ell_pallas`` in its
forward form: f32 codewords, an int32 ``[nb, n]`` assignment table read in
place, no ``w_t`` epilogue.  ``launches`` counts the kernel launches of
this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def context_ell_cuda(out_ids: torch.Tensor, out_vals: torch.Tensor,
                     assignment: torch.Tensor,
                     codewords: torch.Tensor) -> torch.Tensor:
    """out_ids [b, D] int32, out_vals [b, D] f32, assignment [nb, n] int32,
    codewords [nb, k, f_blk] f32, all contiguous CUDA tensors ->
    [b, nb * f_blk] f32 (branch-concatenated codeword context)."""
    global launches
    _build.check_operands("context_ell", {"out_ids": torch.int32,
                                          "out_vals": torch.float32,
                                          "assignment": torch.int32,
                                          "codewords": torch.float32},
                          out_ids=out_ids, out_vals=out_vals,
                          assignment=assignment, codewords=codewords)
    if out_ids.dim() != 2 or out_vals.shape != out_ids.shape \
            or assignment.dim() != 2 or codewords.dim() != 3 \
            or assignment.shape[0] != codewords.shape[0]:
        raise ValueError(
            f"context_ell: want ids/vals [b, D], assignment [nb, n], "
            f"codewords [nb, k, f_blk]; got {tuple(out_ids.shape)}, "
            f"{tuple(out_vals.shape)}, {tuple(assignment.shape)}, "
            f"{tuple(codewords.shape)}")
    b, deg = out_ids.shape
    nb, n = assignment.shape
    _, k, f_blk = codewords.shape
    if deg == 0 or b == 0:
        # no neighbor slots: the context term is zero (no launch)
        return torch.zeros((b, nb * f_blk), dtype=torch.float32,
                           device=out_vals.device)
    if n == 0 or k == 0 or f_blk == 0:
        raise ValueError("context_ell: empty assignment or codeword table")
    out = torch.empty((b, nb * f_blk), dtype=torch.float32,
                      device=out_vals.device)
    err = _build.library().repro_context_ell_f32(
        out_ids.data_ptr(), out_vals.data_ptr(), assignment.data_ptr(),
        codewords.data_ptr(), out.data_ptr(), b, deg, n, nb, k, f_blk,
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "context_ell")
    launches += 1
    return out
