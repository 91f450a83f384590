"""Operations and bytes of the kernels and of the whole step, from the
cell's shapes, and the least time one H100 could take for them.

Bytes count each input read once and each output written once; where the
work depends on the data (a sparse gather), they count what these inputs
need: the distinct rows and codewords a call touches, not every row it
could.  Products run at ``PRODUCT_FLOPS``, 495/3 TFLOP/s: TF32 on the
tensor cores split three ways (3xTF32), the fastest fp32-accurate route
the program uses, so a faithful kernel cannot beat it.  A kernel's least
time is the larger of its products at that rate and its bytes at the HBM
rate; a group's least time is the sum over its launches.  A backbone's model
FLOPs are counted beside its reference, ``reference/<backbone>.py``'s
``layer_flops``.
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PRODUCT_FLOPS = 495e12 / 3       # 3xTF32 on the tensor cores
FP32_FLOPS = 67e12               # fp32 outside the tensor cores


class Work(NamedTuple):
    flops: float
    bytes: float

    def least_s(self, flops_per_s: float = PRODUCT_FLOPS) -> float:
        return max(self.flops / flops_per_s, self.bytes / HBM_BYTES_PER_S)


def vq_update(nb: int, b: int, f: int, k: int) -> Work:
    """Nearest codeword and cluster statistics of b rows in nb branches:
    reads rows and codewords, writes ids, errors, counts and sums."""
    return Work(2.0 * nb * b * f * k,
                4.0 * (nb * b * f + nb * k * f + 2 * nb * b + nb * k * (f + 1)))


def vq_assign(nb: int, n: int, f: int, k: int) -> Work:
    """Nearest codeword of n rows in nb branches: reads rows and
    codewords, writes the ids."""
    return Work(2.0 * nb * n * f * k, 4.0 * (nb * n * f + nb * k * f + nb * n))


def spmm_ell(b: int, deg: int, f: int, rows: int, live: int) -> Work:
    """Exact in-batch messages: [b, deg] ids and values, the ``rows``
    distinct source rows of width f, the [b, f] output; ``live`` real
    slots multiply-add."""
    return Work(2.0 * live * f, 8.0 * b * deg + 4.0 * rows * f + 4.0 * b * f)


def spmm_ell_t(b: int, deg: int, f: int, n_src: int, live: int) -> Work:
    """Its backward: the [b, f] output gradient read, the [n_src, f]
    source gradient written."""
    return Work(2.0 * live * f,
                8.0 * b * deg + 4.0 * b * f + 4.0 * n_src * f)


def context_ell(b: int, deg: int, nb: int, fb: int, nodes: int, pairs: int,
                live: int) -> Work:
    """Codeword messages: [b, deg] ids and values, the ``nodes`` distinct
    neighbours' nb table entries, the ``pairs`` distinct (branch,
    codeword) rows of width fb, the [b, nb * fb] output."""
    return Work(2.0 * live * nb * fb,
                8.0 * b * deg + 4.0 * nb * nodes + 4.0 * fb * pairs
                + 4.0 * b * nb * fb)


def context_ell_wt(b: int, deg: int, nb: int, gb: int, f_out: int,
                   nodes: int, pairs: int, live: int) -> Work:
    """Eq. 7's injected gradient: the codeword sum as above over the
    reverse edges, then @ W^T into [b, f_out]."""
    return Work(2.0 * live * nb * gb + 2.0 * b * nb * gb * f_out,
                8.0 * b * deg + 4.0 * nb * nodes + 4.0 * gb * pairs
                + 4.0 * nb * gb * f_out + 4.0 * b * f_out)
