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
``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

MAX_F = 32                    # widest branch the kernel holds in registers
SMEM_LIMIT = 232448           # dynamic shared memory one H100 block may use


def kstep(f: int) -> int:
    """The depth of the scan's k-steps at width f (``Cfg::KSTEP``: 4 at
    f 4, else 8); the products' work is 3 * 2 * kstep * ceil(f / kstep)
    flops a distance."""
    return 4 if f == 4 else 8


def smem_bytes(k: int, f: int) -> int:
    """Shared memory a block needs for one branch (``smem_base`` in
    ``vq_update.cuh``): the codewords and their |c|^2, k (f + 1) floats,
    and at f 4 the codewords' hi / lo pairs.  The rows it stages beside
    them are optional."""
    split = -(-k // 8) * 8 * 4 * 8 if f == 4 else 0
    return split + 4 * k * (f + 1)


def vq_assign_cuda(x: torch.Tensor, codewords: torch.Tensor,
                   want_min: bool = False):
    """x [nb, n, f] f32 (any row/branch strides, unit element stride),
    codewords [nb, k, f] contiguous f32 -> [nb, n] int32 nearest codeword
    (lowest index on ties); with ``want_min`` also each row's squared
    distance to it, [nb, n] f32 (``ref.vq_assign``'s).

    The strided ``x`` lets the caller pass the branch view of an [n, nb*f]
    activation table without a transposing copy."""
    global launches
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
    if not 1 <= f <= MAX_F:
        raise ValueError(f"vq_assign: branch width f={f} outside the "
                         f"kernel's 1..{MAX_F}")
    if k < 1 or smem_bytes(k, f) > SMEM_LIMIT:
        raise ValueError(f"vq_assign: k={k} codewords of width {f} do not "
                         f"fit one block's shared memory ({SMEM_LIMIT} B)")
    out = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((nb, n), dtype=torch.float32, device=x.device) \
        if want_min else None
    if nb > 0 and n > 0:
        err = _build.library().repro_vq_assign_f32(
            x.data_ptr(), x.stride(0), x.stride(1), codewords.data_ptr(),
            out.data_ptr(), mind.data_ptr() if want_min else None, nb, n, k,
            f, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "vq_assign")
        launches += 1
    return (out, mind) if want_min else out
