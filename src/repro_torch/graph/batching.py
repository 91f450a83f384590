"""Mini-batch packing: Graph -> padded (ELLPACK) neighbor tables on device.

Torch twin of the serving-path half of ``repro.graph.batching``:
:func:`_pack_rows` (numpy, vectorized CSR slicing), the whole-graph
:class:`FullGraphOperands` / :class:`EpochPlan` device tables, the static
wrap-padded batch slicers, and :func:`plan_batch`, which derives one
batch's :class:`~repro_torch.core.conv.MinibatchPack` on device (row gather
plus node->slot scatter) with no host-side packing per batch.

The HBM SpMM stripe index is not ported: the serving path's intra-batch
source is ``[b, f]`` and never needs it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.conv import MinibatchPack
from repro_torch.graph.structure import CSR, Graph
from repro_torch.runtime import resolve_device


def _pack_rows(csr: CSR, ids: np.ndarray, deg_cap: int,
               inv: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Padded (ELLPACK) neighbor rows for ``ids`` -- one fancy-gather over
    ``csr.indices``, no per-row Python loop.  ``inv`` (node -> in-batch
    position, -1 elsewhere) is optional; without it no positions are
    computed."""
    ids = np.asarray(ids, np.int64)
    b = len(ids)
    starts = csr.indptr[ids]                                  # [b]
    degs = np.minimum(csr.indptr[ids + 1] - starts, deg_cap)  # [b]
    offs = np.arange(deg_cap, dtype=np.int64)[None, :]        # [1, D]
    valid = offs < degs[:, None]                              # [b, D]
    if csr.m == 0:
        nbr = np.zeros((b, deg_cap), np.int32)
    else:
        nbr = csr.indices[np.where(valid, starts[:, None] + offs, 0)
                          ].astype(np.int32)
        nbr[~valid] = 0
    mask = valid.astype(np.float32)
    pos = None if inv is None else \
        np.where(valid, inv[nbr], np.int32(-1)).astype(np.int32)
    return nbr, mask, pos


class FullGraphOperands(NamedTuple):
    """Whole-graph ELL operands for exact message passing."""
    nbr_ids: torch.Tensor    # [n, D] int32
    nbr_mask: torch.Tensor   # [n, D] f32
    degrees: torch.Tensor    # [n]    f32


def full_operands(g: Graph, deg_cap: int | None = None, *,
                  device: str | torch.device = "cuda") -> FullGraphOperands:
    dev = resolve_device(device)
    deg_cap = deg_cap or g.max_degree()
    nbr, mask, _ = _pack_rows(g.in_csr, np.arange(g.n), deg_cap)
    return FullGraphOperands(
        nbr_ids=torch.from_numpy(nbr).to(dev),
        nbr_mask=torch.from_numpy(mask).to(dev),
        degrees=torch.from_numpy(g.degrees()).to(dev))


def epoch_slices(perm: np.ndarray,
                 batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Split a node permutation into S static-shape batches: [S, b] ids +
    [S, b] slot mask.  The tail batch is wrap-padded with nodes from the
    start of the permutation; padding slots carry slot-mask 0.
    ``batch_size`` is clamped to the pool size, so every batch holds
    distinct nodes."""
    perm = np.asarray(perm)
    n = len(perm)
    batch_size = min(batch_size, n)
    if n == 0:
        return (np.zeros((0, 0), np.int64), np.zeros((0, 0), np.float32))
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    ids = np.concatenate([perm, perm[:pad]]) if pad else perm
    slot_mask = np.ones(n_batches * batch_size, np.float32)
    slot_mask[n:] = 0.0
    return (ids.reshape(n_batches, batch_size),
            slot_mask.reshape(n_batches, batch_size))


def inference_slices(n: int,
                     batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Static-shape inference batches: :func:`epoch_slices` over the
    identity permutation."""
    return epoch_slices(np.arange(n), batch_size)


class EpochPlan(NamedTuple):
    """Pack-once, device-resident neighbor tables of every node; one
    batch's pack is derived on device by :func:`plan_batch`."""
    nbr_ids: torch.Tensor    # [n, D]   in-neighbor global ids (0 on padding)
    nbr_mask: torch.Tensor   # [n, D]   1.0 on real in-edges
    rev_ids: torch.Tensor    # [n, Dr]  out-edge target global ids
    rev_mask: torch.Tensor   # [n, Dr]

    @property
    def n(self) -> int:
        return self.nbr_ids.shape[0]


def build_epoch_plan(g: Graph, deg_cap: int | None = None, *,
                     full_ops: Optional[FullGraphOperands] = None,
                     device: str | torch.device = "cuda") -> EpochPlan:
    """One-time whole-graph pack -> device tables.  Passing the
    ``full_operands`` of the same graph aliases their in-edge tables (when
    the deg_cap matches) instead of storing them twice; the plan then
    lives on their device."""
    deg_cap = deg_cap or g.max_degree()
    ids = np.arange(g.n)
    if full_ops is not None and tuple(full_ops.nbr_ids.shape) == \
            (g.n, deg_cap):
        dev = full_ops.nbr_ids.device
        nbr_d, nmask_d = full_ops.nbr_ids, full_ops.nbr_mask
    else:
        dev = resolve_device(device)
        nbr, nmask, _ = _pack_rows(g.in_csr, ids, deg_cap)
        nbr_d = torch.from_numpy(nbr).to(dev)
        nmask_d = torch.from_numpy(nmask).to(dev)
    rev, rmask, _ = _pack_rows(g.out_csr, ids, deg_cap)
    return EpochPlan(nbr_ids=nbr_d, nbr_mask=nmask_d,
                     rev_ids=torch.from_numpy(rev).to(dev),
                     rev_mask=torch.from_numpy(rmask).to(dev))


def plan_batch(plan: EpochPlan, batch_ids: torch.Tensor,
               slot_mask: Optional[torch.Tensor] = None) -> MinibatchPack:
    """One batch's MinibatchPack on device: node->slot scatter + row gather.

    Duplicate ids (serve-request padding repeats id 0) keep their LAST slot:
    the scatter is an ``amax`` reduction over increasing slot numbers, which
    is deterministic on CUDA (a plain ``index_put_`` with duplicates is not)
    and matches the reference's sequential CPU scatter.  Any slot of a
    duplicated id holds the same feature row, so outputs are unaffected."""
    b = batch_ids.shape[0]
    dev = plan.nbr_ids.device
    batch_ids = batch_ids.to(device=dev, dtype=torch.int32)
    ids64 = batch_ids.long()
    slot = torch.full((plan.n,), -1, dtype=torch.int32, device=dev)
    slot.scatter_reduce_(0, ids64,
                         torch.arange(b, dtype=torch.int32, device=dev),
                         reduce="amax")
    nbr = plan.nbr_ids[ids64]
    nmask = plan.nbr_mask[ids64]
    rev = plan.rev_ids[ids64]
    rmask = plan.rev_mask[ids64]
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    npos = torch.where(nmask != 0, slot[nbr.long()], minus1)
    rpos = torch.where(rmask != 0, slot[rev.long()], minus1)
    return MinibatchPack(
        batch_ids=batch_ids, nbr_ids=nbr, nbr_mask=nmask, nbr_pos=npos,
        rev_ids=rev, rev_mask=rmask, rev_pos=rpos, slot_mask=slot_mask)
