"""Data parallelism and row-sharded graph state for the VQ epoch executor
(DESIGN.md sections 9 and 14), one rank per process.

Torch twin of ``repro.distributed.data_parallel``.  Where the reference
wraps ``models.gnn._vq_epoch_body`` in ``shard_map`` over a 1-axis
"data" mesh, every rank here calls the same body itself with its
:class:`~repro_torch.distributed.sharding.GraphMesh`, on its own cut of
the inputs:

  * :func:`vq_train_epoch_dp` splits the BATCH axis of the stacked [S, b]
    epoch arrays: each rank trains on b/ndev columns of every batch, as a
    VQ mini-batch of its own (cross-rank in-batch neighbours ride the
    codeword context, the paper's out-of-batch approximation), and the
    step glues the ranks into one model: param grads SUM-all-reduced
    (``collectives.psum_tree``; the reference sums, so no
    ``DistributedDataParallel``, which averages), the codebook moments,
    counts and sums all-reduced inside ``codebook.update(mesh=)``, and
    the refreshed assignments all-gathered into the replicated tables.
    At one rank it computes what ``models.gnn.vq_train_epoch`` does.
  * :class:`ShardedGraphState` holds this rank's contiguous row block of
    every node table; :func:`vq_train_epoch_sharded` is the data-parallel
    epoch against it (every batch row gathered cross-shard),
    :func:`vq_infer_epoch_sharded` splits the SCAN axis (each rank sweeps
    S/ndev whole batches, so the result equals the unsharded executor's)
    and :func:`vq_serve_batch_sharded` serves replicated request ids
    exactly.

Every function here is collective: each rank of the mesh calls it with
the same arguments (the full [S, b] arrays; each rank takes its own
part) in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import all_gather_rows
from repro_torch.distributed.sharding import (GraphMesh, epoch_batch_shard,
                                              graph_dp_mesh, scan_shard,
                                              shard_padded_rows, shard_rows)
from repro_torch.graph.batching import EpochPlan
from repro_torch.models.gnn import (GNNConfig, _vq_epoch_body,
                                    _vq_infer_layer_sharded,
                                    _vq_serve_body_sharded)
from repro_torch.train.optimizer import Optimizer

__all__ = ["graph_dp_mesh", "vq_train_epoch_dp", "ShardedGraphState",
           "vq_train_epoch_sharded", "vq_infer_epoch_sharded",
           "vq_serve_batch_sharded"]


def _on(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(t).to(dev)


def vq_train_epoch_dp(mesh: GraphMesh, params, vq_states, opt_state,
                      plan: EpochPlan, perm, slot_mask, x, labels,
                      train_mask, degrees, cfg: GNNConfig, opt: Optimizer):
    """Data-parallel ``vq_train_epoch``: this rank's part of one epoch.

    Same arguments and returns as the single-device executor plus the
    leading ``mesh``; ``perm`` / ``slot_mask`` are the whole [S, b]
    arrays (the same on every rank) and the batch axis must divide by the
    mesh size.  The graph tables are replicated on every rank."""
    nd = mesh.world_size
    if perm.shape[1] % nd != 0:
        raise ValueError(
            f"batch size {perm.shape[1]} not divisible by the data mesh "
            f"size {nd}")
    dev = mesh.device
    return _vq_epoch_body(
        params, vq_states, opt_state, plan,
        _on(epoch_batch_shard(perm, mesh), dev),
        _on(epoch_batch_shard(slot_mask, mesh), dev), x, labels,
        train_mask, degrees, cfg=cfg, opt=opt, mesh=mesh)


# ---------------------------------------------------------------------------
# row-sharded graph state (DESIGN.md section 14)
# ---------------------------------------------------------------------------

class ShardedGraphState:
    """This rank's block of every node-indexed table of a graph.

    Built once a graph, from the full tables (host or device): each
    [n, ...] table is padded to ``shard_padded_rows(n, ndev)`` rows (one
    sacrificial row for the inference scatter's diverted writes, then
    equal contiguous blocks) and only this rank's block is kept, on its
    device.  ``degrees`` stays REPLICATED: the per-batch edge values index
    it by arbitrary neighbour ids and it costs 4 bytes a node -- the
    reasoning of the replicated [k, f] codebooks and [nb, n] assignment
    tables."""

    def __init__(self, mesh: GraphMesh, plan: EpochPlan, x, degrees,
                 labels=None, train_mask=None):
        self.mesh = mesh
        self.ndev = mesh.world_size
        self.n = int(plan.n)
        self.n_pad = shard_padded_rows(self.n, self.ndev)
        self.n_local = self.n_pad // self.ndev

        def put(t):
            return None if t is None else shard_rows(t, mesh, self.n_pad)
        self.plan = EpochPlan(*(put(t) for t in plan))
        self.x = put(x)
        self.degrees = _on(degrees, mesh.device)
        self.labels = put(labels)
        self.train_mask = put(train_mask)

    def per_device_bytes(self) -> int:
        """Bytes of the held graph state on this rank (the capacity
        metric: ~1/ndev of the replicated footprint plus the replicated
        [n] degree vector); equal on every rank."""
        return shd.per_device_bytes([self.plan, self.x, self.degrees,
                                     self.labels, self.train_mask])

    def unshard(self, table: torch.Tensor) -> np.ndarray:
        """Host copy of a row-sharded [n_local, ...] output with the pad
        rows stripped: an all-gather, so every rank calls it."""
        return all_gather_rows(table, self.mesh)[: self.n].cpu().numpy()


def _pad_scan_axis(perm, slot_mask, ndev: int):
    """The stacked [S, b] inference arrays with the scan axis padded to a
    multiple of ``ndev`` by all-masked batches (ids 0, mask 0), so every
    rank sweeps the same number of batches and the per-step collectives
    stay in lockstep; the padding batches write only the sacrificial
    row."""
    perm, slot_mask = torch.as_tensor(perm), torch.as_tensor(slot_mask)
    s = perm.shape[0]
    s_pad = -(-s // ndev) * ndev
    if s_pad == s:
        return perm, slot_mask
    zp = torch.zeros((s_pad - s,) + tuple(perm.shape[1:]), dtype=perm.dtype,
                     device=perm.device)
    zm = torch.zeros((s_pad - s,) + tuple(slot_mask.shape[1:]),
                     dtype=slot_mask.dtype, device=slot_mask.device)
    return torch.cat([perm, zp]), torch.cat([slot_mask, zm])


def vq_train_epoch_sharded(state: ShardedGraphState, params, vq_states,
                           opt_state, perm, slot_mask, cfg: GNNConfig,
                           opt: Optimizer, *, compress: bool = False):
    """``vq_train_epoch_dp`` against row-sharded graph state: the batch
    axis still splits over the ranks, but the plan / feature / label /
    mask tables are the ranks' row blocks and every batch row is gathered
    cross-shard.  The gathers reassemble the same batches, so the result
    is the replicated data-parallel executor's at the same mesh size;
    per-rank graph-state bytes drop ~1/ndev.  Same returns as
    ``vq_train_epoch``."""
    nd = state.ndev
    if perm.shape[1] % nd != 0:
        raise ValueError(
            f"batch size {perm.shape[1]} not divisible by the data mesh "
            f"size {nd} -- the sharded-state executor splits each batch "
            f"over the mesh; pick b as a multiple of {nd} (the trainer "
            f"clamps batch_size to the {state.n}-node pool first)")
    if state.labels is None or state.train_mask is None:
        raise ValueError(
            "ShardedGraphState built without labels/train_mask cannot "
            "train -- pass them at construction")
    mesh, dev = state.mesh, state.mesh.device
    return _vq_epoch_body(
        params, vq_states, opt_state, state.plan,
        _on(epoch_batch_shard(perm, mesh), dev),
        _on(epoch_batch_shard(slot_mask, mesh), dev), state.x, state.labels,
        state.train_mask, state.degrees, cfg=cfg, opt=opt, mesh=mesh,
        sharded_state=True, compress=compress)


def vq_infer_epoch_sharded(state: ShardedGraphState, params, vq_states,
                           perm, slot_mask, cfg: GNNConfig, *,
                           inductive: bool = False, compress: bool = False):
    """``vq_infer_epoch`` against row-sharded graph state: per layer, this
    rank sweeps its S/ndev whole batches (the scan axis padded to a
    multiple of ndev first), with the activation tables row-sharded
    throughout -- equal to the unsharded executor's result.  Returns
    (acts, states): ``acts`` this rank's [n_local, f_out] block
    (``state.unshard(acts)`` for the [n, f_out] host view), ``states``
    the (refreshed) replicated layer states."""
    perm, slot_mask = _pad_scan_axis(perm, slot_mask, state.ndev)
    mesh, dev = state.mesh, state.mesh.device
    perm = _on(scan_shard(perm, mesh), dev)
    slot_mask = _on(scan_shard(slot_mask, mesh), dev)
    acts = state.x
    states = list(vq_states)
    for l in range(cfg.n_layers):
        acts, states[l] = _vq_infer_layer_sharded(
            params[l], states[l], state.plan, perm, slot_mask, acts,
            state.degrees, cfg=cfg, layer=l, mesh=mesh, n_global=state.n,
            inductive=inductive, compress=compress)
    return acts, states


def vq_serve_batch_sharded(state: ShardedGraphState, params, vq_states,
                           bids, cfg: GNNConfig, *,
                           compress: bool = False) -> torch.Tensor:
    """``vq_serve_batch`` against row-sharded graph state: request ids
    replicated (the same on every rank), plan and feature rows gathered
    cross-shard, the forward exact -- the serving endpoint's capacity
    mode (``serve_gnn --mesh N --shard-graph``)."""
    return _vq_serve_body_sharded(params, vq_states, state.plan,
                                  _on(bids, state.mesh.device), state.x,
                                  state.degrees, cfg, mesh=state.mesh,
                                  compress=compress)

