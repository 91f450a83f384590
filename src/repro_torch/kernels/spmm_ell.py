"""Checked wrappers of the ELLPACK SpMM CUDA kernels (``csrc/spmm_ell.cu``).

``spmm_ell_cuda`` is the counterpart of
``repro.kernels.spmm_ell.spmm_ell_pallas`` (f32 form); ``spmm_ell_t_cuda``
is its transpose, the backward in ``x`` that the reference gets from JAX
autodiff.  ``launches`` and ``launches_t`` count each kernel's launches in
this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
launches_t = 0


def spmm_ell_cuda(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """nbr_idx [b, D] int32, nbr_val [b, D] f32, x [n_src, f] f32, all
    contiguous CUDA tensors -> [b, f] f32 with
    out[i] = sum_d val[i, d] * x[idx[i, d]]."""
    global launches
    _build.check_operands("spmm_ell", {"nbr_idx": torch.int32,
                                       "nbr_val": torch.float32,
                                       "x": torch.float32},
                          nbr_idx=nbr_idx, nbr_val=nbr_val, x=x)
    if nbr_idx.dim() != 2 or nbr_val.shape != nbr_idx.shape or x.dim() != 2:
        raise ValueError(f"spmm_ell: want idx/val [b, D] and x [n_src, f], "
                         f"got {tuple(nbr_idx.shape)}, "
                         f"{tuple(nbr_val.shape)}, {tuple(x.shape)}")
    b, deg = nbr_idx.shape
    n_src, f = x.shape
    if deg > 0 and n_src == 0:
        raise ValueError("spmm_ell: neighbor slots into an empty source")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return out
    err = _build.library().repro_spmm_ell_f32(
        nbr_idx.data_ptr(), nbr_val.data_ptr(), x.data_ptr(), out.data_ptr(),
        b, deg, n_src, f, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "spmm_ell")
    launches += 1
    return out


def spmm_ell_t_cuda(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                    g: torch.Tensor, n_src: int) -> torch.Tensor:
    """nbr_idx [b, D] int32, nbr_val [b, D] f32, g [b, f] f32, all
    contiguous CUDA tensors -> [n_src, f] f32 with
    out[idx[i, d]] += val[i, d] * g[i] (slots with val == 0 add nothing)."""
    global launches_t
    _build.check_operands("spmm_ell_t", {"nbr_idx": torch.int32,
                                         "nbr_val": torch.float32,
                                         "g": torch.float32},
                          nbr_idx=nbr_idx, nbr_val=nbr_val, g=g)
    if nbr_idx.dim() != 2 or nbr_val.shape != nbr_idx.shape or g.dim() != 2 \
            or g.shape[0] != nbr_idx.shape[0]:
        raise ValueError(f"spmm_ell_t: want idx/val [b, D] and g [b, f], "
                         f"got {tuple(nbr_idx.shape)}, "
                         f"{tuple(nbr_val.shape)}, {tuple(g.shape)}")
    b, deg = nbr_idx.shape
    f = g.shape[1]
    if deg > 0 and n_src < 1:
        raise ValueError("spmm_ell_t: neighbor slots into an empty source")
    out = torch.zeros((n_src, f), dtype=torch.float32, device=g.device)
    if b == 0 or f == 0 or deg == 0:
        return out
    err = _build.library().repro_spmm_ell_t_f32(
        nbr_idx.data_ptr(), nbr_val.data_ptr(), g.data_ptr(), out.data_ptr(),
        b, deg, n_src, f, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "spmm_ell_t")
    launches_t += 1
    return out
