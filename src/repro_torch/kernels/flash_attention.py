"""Checked wrapper of the block flash-attention CUDA kernels
(``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``
as ``kernels/ops.py:flash_attention`` reaches it, at every shape that
function is given: ragged sequence tails and any head width up to 256 are
handled inside the kernels (the reference sends shapes with ``sq % 128 !=
0`` to its oracle instead), and the causal mask takes the ``skv - sq``
offset of ``ref.flash_attention``.

Two kernels, and one rule that picks between them (:func:`route`): bf16
operands with a head width of 64 or 128, every pointer 16-byte aligned, go
to the tensor-core kernel (wgmma); everything else -- f32, other widths,
unaligned views -- to the FMA kernel.  ``launches`` counts every launch of
this process, ``launches_tc`` and ``launches_fma`` those of each route.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0
launches_tc = 0
launches_fma = 0

MAX_D = 256                   # widest head the FMA kernel's registers hold
MAX_BH = 65535                # batch x heads rides the FMA grid's y
TC_D = (64, 128)              # head widths of the tensor-core kernel
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
_TC_ENTRY = "repro_flash_attention_tc_bf16"


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """'tc' (tensor cores) for bf16 q / k / v of head width 64 or 128
    whose data all start 16-byte aligned, else 'fma'."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "tc" if q.dtype == torch.bfloat16 and q.shape[-1] in TC_D \
        and aligned else "fma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q [b, h, sq, d], k / v [b, h, skv, d] of one dtype (f32 or bf16),
    contiguous CUDA tensors -> [b, h, sq, d] in q's dtype, on the kernel
    :func:`route` picks."""
    global launches, launches_tc, launches_fma
    entry = _ENTRY.get(q.dtype)
    if entry is None:
        raise TypeError(f"flash_attention: q of dtype {q.dtype}; the kernel "
                        f"takes {sorted(map(str, _ENTRY))}")
    _build.check_operands("flash_attention",
                          {"q": q.dtype, "k": q.dtype, "v": q.dtype},
                          q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: want q [b, h, sq, d] and k / v "
                         f"[b, h, skv, d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if not (1 <= d <= MAX_D and 1 <= b * h <= MAX_BH and sq >= 1
            and skv >= 1):
        raise ValueError(f"flash_attention: d={d} (1..{MAX_D}), b*h="
                         f"{b * h} (1..{MAX_BH}), sq={sq} or skv={skv} "
                         f"(>= 1) outside what the kernel takes")
    tc = route(q, k, v) == "tc"
    out = torch.empty_like(q)
    err = getattr(_build.library(), _TC_ENTRY if tc else entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
        skv, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    launches_tc += tc
    launches_fma += not tc
    return out
