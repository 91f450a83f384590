"""The graph half of the reference's sharding helpers, on torch.distributed.

Torch twin of the GNN part of ``repro.distributed.sharding``
(``graph_dp_mesh`` and the row-sharded graph state, DESIGN.md sections 9
and 14).  A mesh here is a process group: each rank is one process with
one device, and the reference's ``axis_name="data"`` becomes the
:class:`GraphMesh` that every sharded function takes explicitly.

Ownership is contiguous-block, as in the reference: on an ``ndev``-rank
mesh every node table is padded to :func:`shard_padded_rows` rows (one
sacrificial row for the inference scatter's diverted writes, then a
multiple of ``ndev``) and rank ``s`` holds rows ``[s * n_local, (s + 1) *
n_local)``.  The [k, f] codebooks with their counts, sums and revival
state, the [nb, n] assignment tables and the [n] degree vector stay
replicated.

The reference places arrays with ``PartitionSpec``s and lets ``shard_map``
cut them; here each rank cuts its own part, so the three specs become
split helpers: :func:`epoch_batch_shard` (training: the rank's b/ndev
columns of every [S, b] batch), :func:`scan_shard` (inference: the rank's
S/ndev whole batches) and :func:`serve_rows` (a serving micro-batch's
b/ndev rows).  The LM half of the reference's
module (strategies, parameter and cache shardings) is not ported here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime import resolve_device


@dataclass
class GraphMesh:
    """One rank's view of a 1-axis data mesh: its process group, its rank
    and the group's size, the device it computes on and the group's
    backend.  ``share_device`` marks a gloo group whose ranks share one
    card.  With ``time_collectives`` every collective of
    ``distributed.collectives`` is timed on the host clock (synchronised
    with the device before and after) into ``collective_s`` and counted
    in ``collective_calls``."""
    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str
    share_device: bool = False
    time_collectives: bool = False
    collective_s: float = 0.0
    collective_calls: int = 0


def check_ranks(world_size: int, backend: str,
                device: str | torch.device, share_device: bool) -> None:
    """Refuse a mesh the machine cannot hold, before any process starts: a
    CUDA request without a card, NCCL off the card, a shared card on
    anything but gloo, or more ranks than cards without one."""
    dev = resolve_device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unsupported backend {backend!r}; want 'gloo' or "
                         f"'nccl'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' runs on CUDA devices only")
    if share_device and (backend != "gloo" or dev.type != "cuda"):
        raise ValueError("share_device=True puts several ranks on one card "
                         "and needs backend='gloo' on device='cuda'")
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and not share_device and count < world_size:
        raise ValueError(
            f"requested a {world_size}-rank data mesh on {backend} but only "
            f"{count} card(s) exist -- each mesh rank owns a 1/{world_size} "
            f"contiguous row block of the sharded graph state (node tables "
            f"padded to a multiple of {world_size} rows, shard_padded_rows) "
            f"and needs a card of its own; to run several ranks on one "
            f"card ask for it explicitly: a gloo group with "
            f"share_device=True")


def graph_dp_mesh(n_devices: Optional[int] = None, *,
                  device: str | torch.device | None = None,
                  share_device: bool = False) -> GraphMesh:
    """The :class:`GraphMesh` of this process in the initialised default
    process group (``torchrun``'s, or :func:`repro_torch.distributed.
    ranks.run_ranks`'s): the mesh size is the group's world size, and
    ``n_devices``, when given, must equal it.

    The device defaults to the rank's card (``LOCAL_RANK``, or the rank)
    on either backend, as the port's entry points default to the card; a
    CPU mesh is asked for with ``device="cpu"`` (gloo).  A CUDA mesh asks
    for a card per rank and raises when fewer exist; ranks share one card
    only on an explicit ``share_device=True`` gloo group, which puts every
    rank on card 0."""
    if not dist.is_initialized():
        raise RuntimeError("graph_dp_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, torchrun "
                           "or repro_torch.distributed.ranks.run_ranks)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank data mesh in a group "
                         f"of {world} ranks")
    backend = str(dist.get_backend())
    if device is None:
        device = "cuda"
    check_ranks(world, backend, device, share_device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if share_device:
            dev = torch.device("cuda", dev.index or 0)
        else:
            dev = torch.device("cuda",
                               int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    return GraphMesh(group=dist.group.WORLD, rank=rank, world_size=world,
                     device=dev, backend=backend, share_device=share_device)


# ---------------------------------------------------------------------------
# the batch-axis, scan-axis and serving splits (the reference's specs)
# ---------------------------------------------------------------------------

def _split(n: int, mesh: GraphMesh, what: str) -> slice:
    if n % mesh.world_size != 0:
        raise ValueError(f"{what} {n} not divisible by the data mesh size "
                         f"{mesh.world_size}")
    m = n // mesh.world_size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def epoch_batch_shard(a, mesh: GraphMesh):
    """This rank's b/ndev columns of a stacked [S, b] epoch array (perm or
    slot mask): the reference's ``epoch_batch_spec``, scan axis whole and
    batch axis split."""
    return a[:, _split(a.shape[1], mesh, "batch size")]


def scan_shard(a, mesh: GraphMesh):
    """This rank's S/ndev whole batches of a stacked [S, b] array: the
    reference's ``scan_shard_spec`` (pad S first, ``_pad_scan_axis``)."""
    return a[_split(a.shape[0], mesh, "scan length")]


def serve_rows(b: int, mesh: GraphMesh) -> slice:
    """This rank's b/ndev rows of a serving micro-batch of ``b`` slots:
    the reference's ``serve_batch_spec``."""
    return _split(b, mesh, "serve micro-batch")


# ---------------------------------------------------------------------------
# row-sharded graph state (DESIGN.md section 14)
# ---------------------------------------------------------------------------

def shard_padded_rows(n: int, ndev: int) -> int:
    """Padded global row count of an ``n``-row node table over ``ndev``
    ranks: one sacrificial row (global id ``n``) for the inference
    scatter's wrap-pad and masked-slot writes, then rounded up so every
    rank owns an equal contiguous block (pad rows land on the last
    rank)."""
    if ndev <= 0:
        raise ValueError(f"ndev must be positive, got {ndev}")
    return -(-(n + 1) // ndev) * ndev


def node_to_shard(gid, n_local: int):
    """Owning rank of global node id(s): rank ``s`` owns rows ``[s *
    n_local, (s + 1) * n_local)``."""
    return gid // n_local


def global_to_local(gid, shard, n_local: int):
    """Local row of global id(s) on ``shard`` (meaningful only where
    ``node_to_shard(gid, n_local) == shard``)."""
    return gid - shard * n_local


def local_to_global(lid, shard, n_local: int):
    """Global node id of local row(s) ``lid`` on ``shard``."""
    return lid + shard * n_local


def pad_rows(x, n_pad: int, fill=0):
    """A node table's leading axis padded to ``n_pad`` rows with ``fill``
    (numpy or torch input; returns the same kind)."""
    n = x.shape[0]
    if n > n_pad:
        raise ValueError(f"table has {n} rows > padded target {n_pad}")
    if n == n_pad:
        return x
    shape = (n_pad - n,) + tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)])
    return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)])


def shard_rows(x, mesh: GraphMesh, n_pad: Optional[int] = None,
               fill=0) -> torch.Tensor:
    """This rank's contiguous row block of a node table, padded first to
    ``n_pad`` rows (by default :func:`shard_padded_rows` of its rows,
    unless they already divide), as a tensor of its own on the rank's
    device: the full table is neither kept nor referenced."""
    ndev = mesh.world_size
    if n_pad is None:
        n_pad = shard_padded_rows(x.shape[0] - 1, ndev) \
            if x.shape[0] % ndev else x.shape[0]
    if n_pad % ndev:
        raise ValueError(f"padded rows {n_pad} not divisible by the data "
                         f"mesh size {ndev}")
    n_local = n_pad // ndev
    lo, hi = mesh.rank * n_local, (mesh.rank + 1) * n_local
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    block = x[lo:min(hi, x.shape[0])]
    block = pad_rows(block, n_local, fill) if block.shape[0] < n_local \
        else block
    return block.to(mesh.device).clone()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def per_device_bytes(tree) -> int:
    """Bytes this rank holds of a tree (lists, tuples, dicts) of tensors:
    a replicated table counts fully, a row-sharded one its block.  The
    blocks of every rank are of one size, so each rank reports the same
    figure -- the reference's peak over devices -- with no collective."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))
