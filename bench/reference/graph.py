"""Neighbour tables and mini-batches, rebuilt from the raw edge list.

The graph is the deduplicated edge set.  A node's in-neighbours are the
sources of its in-edges in ascending id, its out-neighbours the targets
of its out-edges in ascending id; each list keeps its first ``deg_cap``
entries and is padded with id 0 and mask 0.  ``degrees`` is every node's
whole in-degree (before the cap): the GCN normalisation reads it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Tables(NamedTuple):
    in_ids: torch.Tensor     # [n, D] int64
    in_mask: torch.Tensor    # [n, D] f32
    out_ids: torch.Tensor    # [n, D] int64
    out_mask: torch.Tensor   # [n, D] f32
    degrees: torch.Tensor    # [n] f32 in-degree


class Batch(NamedTuple):
    ids: torch.Tensor        # [b] int64
    nbr: torch.Tensor        # [b, D] in-neighbour ids
    nmask: torch.Tensor      # [b, D]
    npos: torch.Tensor       # [b, D] in-batch position or -1
    rev: torch.Tensor        # [b, D] out-neighbour ids
    rmask: torch.Tensor
    rpos: torch.Tensor


def _ell(major: np.ndarray, minor: np.ndarray, n: int, cap: int):
    """Rows of ``minor`` grouped by ``major`` (both sorted, major first),
    the first ``cap`` of each row kept."""
    m = len(major)
    start = np.searchsorted(major, np.arange(n))
    rank = np.arange(m) - start[major]
    keep = rank < cap
    ids = np.zeros((n, cap), np.int64)
    mask = np.zeros((n, cap), np.float32)
    ids[major[keep], rank[keep]] = minor[keep]
    mask[major[keep], rank[keep]] = 1.0
    return ids, mask


def tables(src: np.ndarray, dst: np.ndarray, n: int, deg_cap: int,
           device) -> Tables:
    eid = np.unique(src.astype(np.int64) * n + dst.astype(np.int64))
    s, d = eid // n, eid % n                  # sorted by (s, d)
    out_ids, out_mask = _ell(s, d, n, deg_cap)
    order = np.lexsort((s, d))                # sorted by (d, s)
    in_ids, in_mask = _ell(d[order], s[order], n, deg_cap)
    deg = np.bincount(d, minlength=n).astype(np.float32)

    def put(a):
        return torch.from_numpy(a).to(device)
    return Tables(put(in_ids), put(in_mask), put(out_ids), put(out_mask),
                  put(deg))


def batch(t: Tables, ids: torch.Tensor) -> Batch:
    """One mini-batch of node ids; a repeated id keeps its last slot."""
    ids = ids.long()
    n, b = t.degrees.shape[0], ids.shape[0]
    slot = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    slot.scatter_reduce_(0, ids, torch.arange(b, device=ids.device),
                         reduce="amax")
    nbr, nmask = t.in_ids[ids], t.in_mask[ids]
    rev, rmask = t.out_ids[ids], t.out_mask[ids]
    npos = torch.where(nmask > 0, slot[nbr], -1)
    rpos = torch.where(rmask > 0, slot[rev], -1)
    return Batch(ids, nbr, nmask, npos, rev, rmask, rpos)


def last_slots(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the slots that hold their id's last occurrence."""
    ids = ids.long()
    b = ids.shape[0]
    pos = torch.arange(b, device=ids.device)
    slot = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    slot.scatter_reduce_(0, ids, pos, reduce="amax")
    return slot[ids] == pos
