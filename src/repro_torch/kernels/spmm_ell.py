"""Checked wrappers of the ELLPACK SpMM CUDA kernels (``csrc/spmm_ell.cu``).

``spmm_ell_cuda`` is the counterpart of
``repro.kernels.spmm_ell.spmm_ell_pallas``: its f32 form and, with an int8
or fp8 source and ``x_scale``, its ``_spmm_ell_q_kernel`` form;
``spmm_ell_t_cuda`` is its transpose, the backward in ``x`` that the
reference gets from JAX autodiff.  ``launches`` counts every forward
launch in this process, ``launches_q`` the quantized ones, ``launches_t``
the transposed kernel's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
launches_q = 0
launches_t = 0

_Q = {torch.int8: "repro_spmm_ell_q_i8",
      torch.float8_e4m3fn: "repro_spmm_ell_q_f8"}


def spmm_ell_cuda(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                  x: torch.Tensor, x_scale: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """nbr_idx [b, D] int32, nbr_val [b, D] f32, x [n_src, f] f32 -- or
    int8 / float8_e4m3fn with ``x_scale`` [1, f] f32 -- all contiguous
    CUDA tensors -> [b, f] f32 with
    out[i] = sum_d val[i, d] * x[idx[i, d]] (then * x_scale), the slots
    added in order; a slot whose value is 0 is not gathered, which is
    bit-equal to the plain version's sum for a finite x."""
    global launches, launches_q
    quantized = x.dtype in _Q
    if not quantized and x.dtype != torch.float32:
        raise TypeError(f"spmm_ell: x has dtype {x.dtype}, the kernel takes "
                        f"float32, int8 or float8_e4m3fn")
    if quantized != (x_scale is not None):
        raise ValueError("spmm_ell: an int8 / fp8 source takes x_scale "
                         "[1, f], an f32 one none")
    operands = dict(nbr_idx=nbr_idx, nbr_val=nbr_val, x=x)
    if quantized:
        operands["x_scale"] = x_scale
    _build.check_operands("spmm_ell", {"nbr_idx": torch.int32,
                                       "nbr_val": torch.float32,
                                       "x": x.dtype,
                                       "x_scale": torch.float32},
                          **operands)
    if nbr_idx.dim() != 2 or nbr_val.shape != nbr_idx.shape or x.dim() != 2:
        raise ValueError(f"spmm_ell: want idx/val [b, D] and x [n_src, f], "
                         f"got {tuple(nbr_idx.shape)}, "
                         f"{tuple(nbr_val.shape)}, {tuple(x.shape)}")
    b, deg = nbr_idx.shape
    n_src, f = x.shape
    if quantized and x_scale.numel() != f:
        raise ValueError(f"spmm_ell: x_scale must be [1, {f}], got "
                         f"{tuple(x_scale.shape)}")
    if deg > 0 and n_src == 0:
        raise ValueError("spmm_ell: neighbor slots into an empty source")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if quantized:
        err = getattr(lib, _Q[x.dtype])(
            nbr_idx.data_ptr(), nbr_val.data_ptr(), x.data_ptr(),
            x_scale.data_ptr(), out.data_ptr(), b, deg, n_src, f, stream)
    else:
        err = lib.repro_spmm_ell_f32(
            nbr_idx.data_ptr(), nbr_val.data_ptr(), x.data_ptr(),
            out.data_ptr(), b, deg, n_src, f, stream)
    _build.check(err, "spmm_ell")
    launches += 1
    launches_q += quantized
    return out


def spmm_ell_t_cuda(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                    g: torch.Tensor, n_src: int) -> torch.Tensor:
    """nbr_idx [b, D] int32, nbr_val [b, D] f32, g [b, f] f32, all
    contiguous CUDA tensors -> [n_src, f] f32 with
    out[idx[i, d]] += val[i, d] * g[i] (slots with val == 0 add nothing).

    The output is zeroed here and the kernel adds into it with atomics, a
    warp per row of g: 16-byte reductions where f is a multiple of 4,
    scalar ones otherwise; a g whose storage offset leaves its rows
    unaligned is read a column at a time (the kernel checks alignment at
    run time).  The sums land in no fixed order."""
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
    if n_src >= 2 ** 31:
        raise ValueError(f"spmm_ell_t: n_src={n_src} rows exceed the "
                         f"kernel's int32 row ids")
    out = torch.zeros((n_src, f), dtype=torch.float32, device=g.device)
    if b == 0 or f == 0 or deg == 0:
        return out
    err = _build.library().repro_spmm_ell_t_f32(
        nbr_idx.data_ptr(), nbr_val.data_ptr(), g.data_ptr(), out.data_ptr(),
        b, deg, n_src, f, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "spmm_ell_t")
    launches_t += 1
    return out
