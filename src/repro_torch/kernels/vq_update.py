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

Two builds of the scan.  The narrow one holds a row in registers and the
branch's whole codebook in shared memory (f <= 32, k (f + 1) * 4 bytes);
the wide one (:func:`uses_wide`: f > 32, or a codebook too large for that)
streams tiles of codewords past tiles of 64 rows and takes any f up to
``WIDE_MAX_F`` and any k.  Its bound E adds the plain version's rounding at
that width (``candidate_bound(wide=True)``).  ``launches_wide`` counts the
counted launches that took the wide build, ``launches_wide_by_shape`` the
same launches by operand shape, ``(nb, n, k, f, emit)``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.quantization import dtype_name
from repro_torch.kernels import _build

launches = 0
launches_u8 = 0
launches_wide = 0
launches_wide_by_shape: dict[tuple, int] = {}

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

MAX_F = 32                    # widest branch the narrow build holds
# dynamic shared memory one H100 block may use: the narrow build stages a
# branch's [k, f] codewords and their [k] squared norms, k (f + 1) * 4
# bytes (k <= 2,641 at f 21), and its warps' rows where they fit beside
SMEM_LIMIT = 232448
# the wide build (csrc/vq_update.cuh: kWideMaxF, kWideBM, WideMisc): rows
# a tile, and a block's bookkeeping beside its row and codeword tiles
WIDE_MAX_F = 440
WIDE_BM = 64
WIDE_MISC_BYTES = 4392
# the scan's bound: allowance per tensor-core accumulation, relative to the
# magnitudes it adds, and the floor for products a tensor core may flush
TC_EPS = 2.0 ** -20
TINY = 2.0 ** -118
# the margins of norm_cap's fp32 evaluation in the kernel
NORM_UP = 1.0 + 2.0 ** -14
DISC_SLACK = 2.0 ** -16


# the wide build's margins of norm_cap (kWideUp): the plain version's
# rounding rho = (2f + 3) 2^-24 reaches 2^-14.2 at WIDE_MAX_F
WIDE_UP = 1.0 + 2.0 ** -12


def candidate_bound(x_norm, c_max, f: int, wide: bool = False):
    """E(x) of ``csrc/vq_update.cuh``: an upper bound on |d~ - d| for every
    codeword of a branch, d the plain version's fp32 distance, d~ the
    tensor cores' (3 * ceil(f / 8) mma accumulations in both builds;
    ``vq_assign``'s f 4 scan takes two), for rows of norm ``x_norm`` against
    codewords of norm at most ``c_max``.  The narrow build's allowance of 6
    covers the split and the plain version's own rounding up to f 32; the
    wide build adds ceil((2f + 3) / 16) for that rounding at any f."""
    n_mma = 3 * -(-f // 8)
    coef = n_mma + 6 + (-(-(2 * f + 3) // 16) if wide else 0)
    return coef * TC_EPS * (c_max * c_max + 4 * x_norm * c_max) \
        + TINY * (1 + x_norm + c_max)


def norm_cap(x_norm: torch.Tensor, u: torch.Tensor,
             wide: bool = False) -> torch.Tensor:
    """r of ``csrc/vq_update.cuh``: no codeword of norm above it has a plain
    fp32 distance of at most ``u`` to a row of norm ``x_norm``, with the
    kernel's margins (the wide build's wider ones with ``wide``)."""
    up, slack = (WIDE_UP, WIDE_UP - 1.0) if wide else (NORM_UP, DISC_SLACK)
    b = x_norm * up
    bb = b * b
    return (b + torch.sqrt(torch.clamp(bb + u, min=0.0)
                           + slack * (bb + u.abs()))) * up


def wide_smem_bytes(f: int, bn: int) -> int:
    """Shared memory of a wide-build block (``wide_smem``): 64 staged rows
    and two tiles of ``bn`` codewords at a stride of f rounded up to 8,
    plus 4 floats, their tiles' |c|^2 and the bookkeeping."""
    stride = -(-f // 8) * 8 + 4
    return (WIDE_BM + 2 * bn) * stride * 4 + 2 * bn * 4 + WIDE_MISC_BYTES


def smem_bytes(k: int, f: int) -> int:
    """Shared memory the narrow build stages for one branch: its [k, f]
    codewords and their [k] squared norms."""
    return 4 * k * (f + 1)


def uses_wide(k: int, f: int, smem=smem_bytes) -> bool:
    """Whether the scan at (k, f) takes the wide build: a branch wider than
    the narrow build's registers, or a codebook beyond its shared memory,
    ``smem(k, f)`` bytes for the kernel at hand (``vq_assign`` stages
    more at f 4)."""
    return f > MAX_F or smem(k, f) > SMEM_LIMIT


def check_width(kernel: str, k: int, f: int) -> None:
    """Raise for a shape that neither build takes."""
    if not 1 <= f <= WIDE_MAX_F or k < 1:
        raise ValueError(f"{kernel}: branch width f={f} (k={k}) outside the "
                         f"kernel's 1..{WIDE_MAX_F} (k >= 1)")


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
    wide = uses_wide(codewords.shape[1], codewords.shape[-1])
    return _run(f"repro_vq_update{'_wide' if wide else ''}"
                f"{'_u8' if narrow else ''}_f32", x, codewords, count=True)


def vq_assign_update_generic_cuda(x: torch.Tensor, codewords: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """The same function through the narrow build's generic-width
    instantiation, whatever f <= 32 is: for timing it against the
    fixed-width builds.  No path of the package calls it, and ``launches``
    does not count it."""
    return _run("repro_vq_update_generic_f32", x, codewords, count=False)


def _run(entry: str, x: torch.Tensor, codewords: torch.Tensor, count: bool):
    global launches, launches_u8, launches_wide
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
    wide = "_wide" in entry
    if wide:
        check_width("vq_update", k, f)
    elif not 1 <= f <= MAX_F or k < 1 or uses_wide(k, f):
        raise ValueError(f"vq_update: the narrow build takes f <= {MAX_F} "
                         f"and a codebook in one block's shared memory "
                         f"({SMEM_LIMIT} B); got k={k}, f={f}")
    dev = x.device
    narrow = "_u8" in entry
    idx = torch.empty((nb, n), dtype=torch.uint8 if narrow else torch.int32,
                      device=dev)
    qerr = torch.empty((nb, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((nb, k), dtype=torch.float32, device=dev)
    sums = torch.zeros((nb, k, f), dtype=torch.float32, device=dev)
    if nb == 0 or n == 0:
        return idx, qerr, counts, sums
    # the wide build's scratch: the codewords' |c|^2, filled by the launch
    cn2 = torch.empty((nb, k), dtype=torch.float32, device=dev) if wide \
        else None
    scratch = (cn2.data_ptr(),) if wide else ()
    err = getattr(_build.library(), entry)(
        x.data_ptr(), codewords.data_ptr(), *scratch, idx.data_ptr(),
        qerr.data_ptr(), counts.data_ptr(), sums.data_ptr(), nb, n, k, f,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vq_update")
    launches += count
    launches_u8 += count and narrow
    launches_wide += count and wide
    if count and wide:
        key = (nb, n, k, f, "uint8" if narrow else "int32")
        launches_wide_by_shape[key] = launches_wide_by_shape.get(key, 0) + 1
    return idx, qerr, counts, sums
