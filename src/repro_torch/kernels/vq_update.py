"""Checked wrapper of the fused VQ assign + cluster-statistics CUDA kernel
(``csrc/vq_update.cu``).

Counterpart of ``repro.kernels.vq_update.vq_assign_update_pallas`` with
int32 emit, as ``core/codebook.py:update`` uses it: vmapped over the
product-VQ branches, which here is one launch for all branches.
``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

MAX_F = 32                    # widest branch the kernel holds in registers
SMEM_LIMIT = 232448           # dynamic shared memory one H100 block may use


def vq_assign_update_cuda(x: torch.Tensor, codewords: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """x [nb, n, f] and codewords [nb, k, f], contiguous f32 CUDA tensors
    -> (assignment [nb, n] int32, qerr [nb, n], counts [nb, k],
    sums [nb, k, f]).  The statistics are added with atomics into buffers
    zeroed here: counts are exact, sums depend on the order of the adds."""
    return _run("repro_vq_update_f32", x, codewords, count=True)


def vq_assign_update_generic_cuda(x: torch.Tensor, codewords: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """The same function through the kernel's generic-width instantiation,
    whatever f is: for timing it against the fixed-width builds.  No path
    of the package calls it, and ``launches`` does not count it."""
    return _run("repro_vq_update_generic_f32", x, codewords, count=False)


def _run(entry: str, x: torch.Tensor, codewords: torch.Tensor, count: bool):
    global launches
    _build.check_operands("vq_update", {"x": torch.float32,
                                        "codewords": torch.float32},
                          x=x, codewords=codewords)
    if x.dim() != 3 or codewords.dim() != 3 \
            or x.shape[0] != codewords.shape[0] \
            or x.shape[2] != codewords.shape[2]:
        raise ValueError(f"vq_update: want x [nb, n, f] and codewords "
                         f"[nb, k, f]; got {tuple(x.shape)}, "
                         f"{tuple(codewords.shape)}")
    nb, n, f = x.shape
    k = codewords.shape[1]
    if not 1 <= f <= MAX_F:
        raise ValueError(f"vq_update: branch width f={f} outside the "
                         f"kernel's 1..{MAX_F}")
    if k < 1 or (k * (f + 1) * 4) > SMEM_LIMIT:
        raise ValueError(f"vq_update: k={k} codewords of width {f} do not "
                         f"fit one block's shared memory ({SMEM_LIMIT} B)")
    dev = x.device
    idx = torch.empty((nb, n), dtype=torch.int32, device=dev)
    qerr = torch.empty((nb, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((nb, k), dtype=torch.float32, device=dev)
    sums = torch.zeros((nb, k, f), dtype=torch.float32, device=dev)
    if nb == 0 or n == 0:
        return idx, qerr, counts, sums
    err = getattr(_build.library(), entry)(
        x.data_ptr(), codewords.data_ptr(), idx.data_ptr(), qerr.data_ptr(),
        counts.data_ptr(), sums.data_ptr(), nb, n, k, f,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vq_update")
    launches += count
    return idx, qerr, counts, sums
