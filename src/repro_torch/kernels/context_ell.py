"""Checked wrapper of the fused VQ-context CUDA kernel
(``csrc/context_ell.cu``).

Counterpart of ``repro.kernels.context_ell.context_ell_pallas`` with f32
codewords and an int32 ``[nb, n]`` assignment table read in place, in both
its forms: the plain accumulate (``_context_ell_kernel``) and the fused
``@ w_t`` epilogue of the Eq. 7 backward (``_context_ell_wt_kernel``).
``launches`` counts the launches of either kernel in this process,
``launches_wt`` those of the ``w_t`` form alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
launches_wt = 0

WT_ROWS = 8                   # output rows per block of the w_t kernel
SMEM_LIMIT = 232448           # dynamic shared memory one H100 block may use


def context_ell_cuda(out_ids: torch.Tensor, out_vals: torch.Tensor,
                     assignment: torch.Tensor, codewords: torch.Tensor,
                     w_t: torch.Tensor | None = None) -> torch.Tensor:
    """out_ids [b, D] int32, out_vals [b, D] f32, assignment [nb, n] int32,
    codewords [nb, k, f_blk] f32, all contiguous CUDA tensors ->
    [b, nb * f_blk] f32 (branch-concatenated codeword context), or, with
    ``w_t`` [nb * f_blk, f_out] contiguous f32, that context ``@ w_t``:
    [b, f_out]."""
    global launches, launches_wt
    operands = dict(out_ids=out_ids, out_vals=out_vals,
                    assignment=assignment, codewords=codewords)
    if w_t is not None:
        operands["w_t"] = w_t
    _build.check_operands("context_ell", {"out_ids": torch.int32,
                                          "out_vals": torch.float32,
                                          "assignment": torch.int32,
                                          "codewords": torch.float32,
                                          "w_t": torch.float32},
                          **operands)
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
    if w_t is not None and (w_t.dim() != 2 or w_t.shape[0] != nb * f_blk):
        raise ValueError(f"context_ell: w_t must be [nb * f_blk = "
                         f"{nb * f_blk}, f_out], got {tuple(w_t.shape)}")
    if w_t is not None and WT_ROWS * nb * f_blk * 4 > SMEM_LIMIT:
        raise ValueError(f"context_ell: {nb * f_blk} context columns do not "
                         f"fit the w_t kernel's shared memory "
                         f"({SMEM_LIMIT} B for {WT_ROWS} rows)")
    f_out = nb * f_blk if w_t is None else w_t.shape[1]
    if deg == 0 or b == 0:
        # no neighbor slots: the context term is zero (no launch)
        return torch.zeros((b, f_out), dtype=torch.float32,
                           device=out_vals.device)
    if n == 0 or k == 0 or f_blk == 0:
        raise ValueError("context_ell: empty assignment or codeword table")
    out = torch.empty((b, f_out), dtype=torch.float32,
                      device=out_vals.device)
    if f_out == 0:
        return out
    stream = torch.cuda.current_stream(out.device).cuda_stream
    lib = _build.library()
    if w_t is None:
        err = lib.repro_context_ell_f32(
            out_ids.data_ptr(), out_vals.data_ptr(), assignment.data_ptr(),
            codewords.data_ptr(), out.data_ptr(), b, deg, n, nb, k, f_blk,
            stream)
    else:
        err = lib.repro_context_ell_wt_f32(
            out_ids.data_ptr(), out_vals.data_ptr(), assignment.data_ptr(),
            codewords.data_ptr(), w_t.data_ptr(), out.data_ptr(), b, deg, n,
            nb, k, f_blk, f_out, stream)
    _build.check(err, "context_ell")
    launches += 1
    if w_t is not None:
        launches_wt += 1
    return out
