"""Checked wrapper of the fused VQ assign + cluster-statistics CUDA kernel
(``csrc/vq_update.cuh``, entries in ``vq_update.cu`` and ``vq_update_u8.cu``).

Counterpart of ``repro.kernels.vq_update.vq_assign_update_pallas`` as
``core/codebook.py:update`` uses it: vmapped over the product-VQ branches,
which here is one launch for all branches.  The assignment is emitted as
int32, or narrow: uint8 (k <= 256) written by the kernel itself, and
uint4 (k <= 16), which the kernel writes through the same uint8 output --
the port's uint4 is a uint8 tensor of values < 16, so the wrapper's
narrowing is that k check.  ``launches`` counts the counted launches of
this process, ``launches_u8`` those with a narrow emit.

The kernel scans the distances on the tensor cores (TF32 split hi + lo),
rescores the winning group of codewords exactly (u, an exact distance),
and then every codeword whose approximate distance is at most
``u + candidate_bound(|x|, min(c_max, norm_cap(|x|, u)))``, so the
assignment and qerr are the plain version's bit for bit;
:func:`candidate_bound` and :func:`norm_cap` are the kernel's bounds, kept
here for the CPU emulation that tests them (``tests/test_torch_vq_scan.py``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.quantization import dtype_name
from repro_torch.kernels import _build

launches = 0
launches_u8 = 0

# narrow emit dtypes and the largest k each can index (int32: any k);
# signed int4 would wrap ids 8..15, so it is absent, as in the reference
EMIT_K_LIMITS = {"uint8": 256, "uint4": 16}


def check_emit(emit_dtype, k: int) -> str:
    """The emit dtype's name, after the reference's checks: an emit dtype
    that is not int32, uint8 or uint4, or a k it cannot index, raises."""
    emit = dtype_name(emit_dtype)
    limit = EMIT_K_LIMITS.get(emit)
    if emit != "int32" and limit is None:
        raise ValueError(
            f"emit_dtype={emit!r} is not a supported assignment storage "
            f"dtype; want int32 or one of {sorted(EMIT_K_LIMITS)}")
    if limit is not None and k > limit:
        raise ValueError(
            f"emit_dtype={emit!r} supports k <= {limit}, got k={k}; use "
            f"emit_dtype=int32 (always valid)"
            + (" or uint8 (k <= 256)" if emit == "uint4" else ""))
    return emit

MAX_F = 32                    # widest branch the kernel holds in registers
# dynamic shared memory one H100 block may use: the kernel stages a
# branch's [k, f] codewords and their [k] squared norms, k (f + 1) * 4
# bytes (k <= 2,641 at f 21), and its warps' rows where they fit beside
SMEM_LIMIT = 232448
# the scan's bound: allowance per tensor-core accumulation, relative to the
# magnitudes it adds, and the floor for products a tensor core may flush
TC_EPS = 2.0 ** -20
TINY = 2.0 ** -118
# the margins of norm_cap's fp32 evaluation in the kernel
NORM_UP = 1.0 + 2.0 ** -14
DISC_SLACK = 2.0 ** -16


def candidate_bound(x_norm, c_max, f: int):
    """E(x) of ``csrc/vq_update.cuh``: an upper bound on |d~ - d| for every
    codeword of a branch, d the plain version's fp32 distance, d~ the
    tensor cores' (at most 3 * ceil(f / 8) mma accumulations; ``vq_assign``'s
    f 4 scan takes two), for rows of norm ``x_norm`` against codewords of
    norm at most ``c_max``."""
    n_mma = 3 * -(-f // 8)
    return (n_mma + 6) * TC_EPS * (c_max * c_max + 4 * x_norm * c_max) \
        + TINY * (1 + x_norm + c_max)


def norm_cap(x_norm: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r of ``csrc/vq_update.cuh``: no codeword of norm above it has a plain
    fp32 distance of at most ``u`` to a row of norm ``x_norm``, with the
    kernel's margins."""
    b = x_norm * NORM_UP
    bb = b * b
    return (b + torch.sqrt(torch.clamp(bb + u, min=0.0)
                           + DISC_SLACK * (bb + u.abs()))) * NORM_UP


def vq_assign_update_cuda(x: torch.Tensor, codewords: torch.Tensor,
                          emit_dtype=torch.int32
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """x [nb, n, f] and codewords [nb, k, f], contiguous f32 CUDA tensors
    -> (assignment [nb, n] int32 -- uint8 for ``emit_dtype`` uint8 or
    ``"uint4"`` --, qerr [nb, n], counts [nb, k], sums [nb, k, f]).  The
    assignment and qerr are the plain version's bit for bit.  The
    statistics are added with atomics into buffers zeroed here: counts are
    exact, sums depend on the order of the adds."""
    narrow = check_emit(emit_dtype, codewords.shape[1]) != "int32"
    return _run("repro_vq_update_u8_f32" if narrow else "repro_vq_update_f32",
                x, codewords, count=True)


def vq_assign_update_generic_cuda(x: torch.Tensor, codewords: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """The same function through the kernel's generic-width instantiation,
    whatever f is: for timing it against the fixed-width builds.  No path
    of the package calls it, and ``launches`` does not count it."""
    return _run("repro_vq_update_generic_f32", x, codewords, count=False)


def _run(entry: str, x: torch.Tensor, codewords: torch.Tensor, count: bool):
    global launches, launches_u8
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
    narrow = entry == "repro_vq_update_u8_f32"
    idx = torch.empty((nb, n), dtype=torch.uint8 if narrow else torch.int32,
                      device=dev)
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
    launches_u8 += count and narrow
    return idx, qerr, counts, sums
