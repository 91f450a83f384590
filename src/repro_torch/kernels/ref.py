"""Plain PyTorch versions of the serving path's kernels.

Twins of ``repro.kernels.ref`` (``vq_assign``, ``spmm_ell``,
``context_ell``): the numerical ground truth each CUDA kernel is held
against, and the CPU execution path of ``ops.py``.  On a CUDA card nothing
on the main path calls them; ``chip_smoke.py`` runs them there only to
compare with the kernels.

Each sums in the kernel's order -- over the D neighbor slots, or over the
f feature dims, one separately rounded multiply and add at a time, as the
Pallas kernels' loops do -- so a CUDA kernel that keeps that order (and
rounds each step, ``__fmul_rn``/``__fadd_rn``) agrees with its plain
version bit for bit.
"""
from __future__ import annotations

import torch

# rows per [nb, rows, k] distance block of vq_assign: bounds the plain
# version's scratch to 256 MiB per temporary at any n (the kernel needs none)
_ASSIGN_BLOCK_ELEMS = 1 << 26


def vq_assign(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """Nearest codeword by squared L2, every branch at once.

    x: [nb, b, f] (any strides), codewords: [nb, k, f] -> [nb, b] int32.
    The distance is ``|c|^2 - 2 x.c`` (``|x|^2`` is constant per row); ties
    keep the lowest index, as ``jnp.argmin`` does."""
    nb, b, f = x.shape
    k = codewords.shape[1]
    c32 = codewords.float()
    cn2 = torch.zeros((nb, 1, k), dtype=torch.float32, device=x.device)
    for j in range(f):
        cn2 = cn2 + (c32[:, :, j] * c32[:, :, j])[:, None, :]
    out = torch.empty((nb, b), dtype=torch.int32, device=x.device)
    rows = max(1, _ASSIGN_BLOCK_ELEMS // max(1, nb * k))
    for s in range(0, b, rows):
        xs = x[:, s:s + rows].float()                          # [nb, r, f]
        dot = torch.zeros((nb, xs.shape[1], k), dtype=torch.float32,
                          device=x.device)
        for j in range(f):
            dot = dot + xs[:, :, j, None] * c32[:, None, :, j]
        dist = cn2 - 2.0 * dot
        out[:, s:s + rows] = torch.argmin(dist, dim=2).to(torch.int32)
    return out


def spmm_ell(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Padded-neighbor (ELLPACK) sparse @ dense.

    nbr_idx: [b, D] int (padding entries point at a valid row, val 0)
    nbr_val: [b, D] float;  x: [n_src, f]
    returns  [b, f] with out[i] = sum_d val[i,d] * x[idx[i,d]]
    """
    b, deg = nbr_idx.shape
    idx = nbr_idx.long()
    val = nbr_val.float()
    x32 = x.float()
    acc = torch.zeros((b, x.shape[1]), dtype=torch.float32, device=x.device)
    for d in range(deg):
        acc = acc + val[:, d, None] * x32[idx[:, d]]
    return acc


def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor,
                codewords: torch.Tensor) -> torch.Tensor:
    """Multi-branch VQ-context SpMM (the Eq. 6 out-of-batch term).

    out_ids/out_vals: [b, D] (padding entries carry val == 0)
    assignment: [nb, n] int codeword id of every node per branch
    codewords:  [nb, k, f_blk]
    out[i] = sum_d val[i, d] * concat_beta cw[beta, assignment[beta, ids[i, d]]]
    """
    nb, _, f_blk = codewords.shape
    b, deg = out_ids.shape
    ids = out_ids.long()
    vals = out_vals.float()
    a = assignment.long()
    cw = codewords.float()
    beta = torch.arange(nb, device=codewords.device)[None, :]
    acc = torch.zeros((b, nb, f_blk), dtype=torch.float32,
                      device=out_vals.device)
    for d in range(deg):
        rows = cw[beta, a[:, ids[:, d]].t()]                  # [b, nb, fb]
        acc = acc + vals[:, d, None, None] * rows
    return acc.reshape(b, nb * f_blk)
