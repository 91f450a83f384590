"""Checked wrapper of the multi-branch VQ-assign CUDA kernel
(``csrc/vq_assign.cu``, on ``vq_update``'s tensor-core scan in
``csrc/vq_update.cuh``).

Counterpart of ``repro.kernels.vq_assign.vq_assign_pallas`` as
``core/codebook.py`` uses it: vmapped over the product-VQ branches, which
here is one launch for all branches, with the reference's optional
``want_min`` output.  Both outputs are the plain version's bit for bit:
the scan rescores exactly every codeword that its bound
(``vq_update.candidate_bound`` and ``vq_update.norm_cap``) cannot rule
out.
A branch wider than 32, or a codebook too large for the narrow build's
shared memory, takes the scan's wide build (``vq_update.uses_wide``), at
any f up to ``vq_update.WIDE_MAX_F`` and any k, with the scratch
``vq_update.wide_scratch`` allocates (``vq_update.wide_queued_rows`` reads
its queue counter).
``launches`` counts the kernel launches of this process, ``launches_wide``
those of the wide build, ``launches_wide_by_shape`` the same by operand
shape, ``(nb, n, k, f)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, vq_update
from repro_torch.kernels.vq_update import check_width

launches = 0
launches_wide = 0
launches_wide_by_shape: dict[tuple, int] = {}


def kstep(f: int) -> int:
    """The depth of the scan's k-steps at width f (``Cfg::KSTEP``: 4 at
    f 4, else 8); the products' work is 3 * 2 * kstep * ceil(f / kstep)
    flops a distance."""
    return 4 if f == 4 else 8


def smem_bytes(k: int, f: int) -> int:
    """Shared memory a narrow-build block needs for one branch
    (``smem_base`` in ``vq_update.cuh``): the codewords and their |c|^2,
    k (f + 1) floats, and at f 4 the codewords' hi / lo pairs.  The rows it
    stages beside them are optional."""
    split = -(-k // 8) * 8 * 4 * 8 if f == 4 else 0
    return split + 4 * k * (f + 1)


def uses_wide(k: int, f: int) -> bool:
    """Whether the scan at (k, f) takes the wide build
    (``vq_update.uses_wide`` with this kernel's :func:`smem_bytes`)."""
    return vq_update.uses_wide(k, f, smem_bytes)


def vq_assign_cuda(x: torch.Tensor, codewords: torch.Tensor,
                   want_min: bool = False):
    """x [nb, n, f] f32 (any row/branch strides, unit element stride),
    codewords [nb, k, f] contiguous f32 -> [nb, n] int32 nearest codeword
    (lowest index on ties); with ``want_min`` also each row's squared
    distance to it, [nb, n] f32 (``ref.vq_assign``'s).

    The strided ``x`` lets the caller pass the branch view of an [n, nb*f]
    activation table without a transposing copy."""
    global launches, launches_wide
    _build.check_operands("vq_assign", {"x": (torch.float32, "strided"),
                                        "codewords": torch.float32},
                          x=x, codewords=codewords)
    if x.dim() != 3 or codewords.dim() != 3 \
            or x.shape[0] != codewords.shape[0] \
            or x.shape[2] != codewords.shape[2]:
        raise ValueError(f"vq_assign: want x [nb, n, f] and codewords "
                         f"[nb, k, f]; got {tuple(x.shape)}, "
                         f"{tuple(codewords.shape)}")
    nb, n, f = x.shape
    k = codewords.shape[1]
    if x.stride(2) != 1 and f > 1:
        raise ValueError("vq_assign: x rows must have unit element stride")
    check_width("vq_assign", k, f)
    wide = uses_wide(k, f)
    out = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((nb, n), dtype=torch.float32, device=x.device) \
        if want_min else None
    if nb > 0 and n > 0:
        lib = _build.library()
        # the wide build's scratch, filled by its prologue
        entry, scratch = (
            lib.repro_vq_assign_wide_f32,
            (vq_update.wide_scratch(nb, k, f, x.device).data_ptr(),)) \
            if wide else (lib.repro_vq_assign_f32, ())
        err = entry(
            x.data_ptr(), x.stride(0), x.stride(1), codewords.data_ptr(),
            *scratch, out.data_ptr(), mind.data_ptr() if want_min else None,
            nb, n, k, f, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "vq_assign")
        launches += 1
        launches_wide += wide
        if wide:
            key = (nb, n, k, f)
            launches_wide_by_shape[key] = \
                launches_wide_by_shape.get(key, 0) + 1
    return (out, mind) if want_min else out


def wide_probe_cuda(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """The wide scan's approximate distances themselves: x [nb, n, f] and
    codewords [nb, k, f] contiguous f32 CUDA tensors -> d~ [nb, n, k_pad]
    (``vq_update.wide_kpad``; the columns past k are +inf or NaN), each
    |c|^2 plus the 3 ceil(f / 8) TF32 products, for probing the tensor
    cores' accumulation error.  Not counted, and no path calls it."""
    _build.check_operands("vq_wide_probe", {"x": torch.float32,
                                            "codewords": torch.float32},
                          x=x, codewords=codewords)
    nb, n, f = x.shape
    k = codewords.shape[1]
    check_width("vq_wide_probe", k, f)
    d = torch.empty((nb, n, vq_update.wide_kpad(k)), dtype=torch.float32,
                    device=x.device)
    scratch = vq_update.wide_scratch(nb, k, f, x.device)
    err = _build.library().repro_vq_wide_probe_f32(
        x.data_ptr(), codewords.data_ptr(), scratch.data_ptr(), d.data_ptr(),
        nb, n, k, f, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vq_wide_probe")
    return d


def wide_plan_card(f: int, wgs: int) -> tuple:
    """The plan the card's launch takes at width f with ``wgs`` warpgroups
    (``repro_vq_wide_plan``): (ares, kc, stages, smem), to hold
    ``vq_update.wide_plan`` against it."""
    import ctypes
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().repro_vq_wide_plan(f, wgs, out),
                 "vq_wide_plan")
    return bool(out[0]), out[1], out[2], out[3]
