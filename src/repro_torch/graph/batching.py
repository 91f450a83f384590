"""Mini-batch packing: Graph -> padded (ELLPACK) neighbor tables on device.

Torch twin of ``repro.graph.batching`` on one device: :func:`_pack_rows`
(numpy, vectorized CSR slicing), the host-built stripe index of the
staged SpMM kernel (:func:`make_stripe_index`), the host packer of one
batch (:func:`make_pack`, behind the host-stepped batch loops and
:func:`minibatch_stream`), the whole-graph and sampled-subgraph
:class:`FullGraphOperands`, the inductive training view
(:func:`inductive_view`), the :class:`EpochPlan` device tables, the
static wrap-padded batch slicers, :func:`plan_batch`, which derives one
batch's :class:`~repro_torch.core.conv.MinibatchPack` on device (row
gather plus node->slot scatter, equal to :func:`make_pack` on the same
ids) with no host-side packing per batch, its row-sharded form
(:func:`plan_batch_sharded`, positions by :func:`_inbatch_positions`), and
the sampling baselines' stacked epoch (:class:`SamplerEpochPlan`,
:func:`pack_sampler_epoch`, :func:`pad_bucket`).
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.conv import MinibatchPack
from repro_torch.graph.structure import CSR, Graph, build_graph, csr_from_coo
from repro_torch.kernels.spmm_ell_hbm import (DEFAULT_BB, DEFAULT_STRIPE,
                                              StripeIndex, clamp_tiles)
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


def make_stripe_index(nbr_idx: np.ndarray, n_src: int, *,
                      mask: np.ndarray | None = None,
                      bb: int = DEFAULT_BB, stripe: int = DEFAULT_STRIPE,
                      max_stripes: int | None = None,
                      device: str | torch.device = "cuda") -> StripeIndex:
    """Host-built tile -> stripes index of the staged SpMM kernel, for a
    call over ``nbr_idx`` [b, D] into an ``n_src``-row source.

    ``mask`` marks the real (non-padding) slots; padding touches no
    stripe.  The tiles are clamped as the kernel's (``clamp_tiles``).  The
    ids width is min(n_stripes, bb * deg), fixed by the shapes, or
    ``max_stripes``; a tile touching more stripes than that raises rather
    than dropping some.  ``bb`` / ``stripe`` default to the reference's
    128 / 512."""
    nbr_idx = np.asarray(nbr_idx)
    b, deg = nbr_idx.shape
    bb, stripe = clamp_tiles(b, n_src, bb, stripe)
    bp = (b + bb - 1) // bb * bb
    nt = bp // bb
    n_stripes = (n_src + stripe - 1) // stripe
    sid = np.zeros((bp, deg), np.int64)
    valid = np.zeros((bp, deg), bool)
    sid[:b] = np.clip(nbr_idx, 0, None) // stripe
    valid[:b] = np.ones((b, deg), bool) if mask is None \
        else np.asarray(mask) != 0
    sid, valid = sid.reshape(nt, bb * deg), valid.reshape(nt, bb * deg)
    per_tile = [np.unique(sid[t][valid[t]]) for t in range(nt)]
    ms = max_stripes if max_stripes is not None \
        else max(1, min(n_stripes, bb * deg))
    worst = max((len(u) for u in per_tile), default=0)
    if worst > ms:
        raise ValueError(
            f"a row tile touches {worst} stripes > max_stripes={ms}; "
            f"raise the cap or the stripe size")
    ids = np.zeros((nt, ms), np.int32)
    counts = np.zeros((nt,), np.int32)
    for t, u in enumerate(per_tile):
        ids[t, :len(u)] = u
        counts[t] = len(u)
    dev = resolve_device(device)
    return StripeIndex(torch.from_numpy(ids).to(dev),
                       torch.from_numpy(counts).to(dev),
                       bb=bb, stripe=stripe, n_src=n_src)


def make_pack(g: Graph, batch_ids: np.ndarray, deg_cap: int | None = None,
              *, stripe_index: bool = False, stripe_bb: int = DEFAULT_BB,
              stripe: int = DEFAULT_STRIPE,
              slot_mask: np.ndarray | None = None,
              device: str | torch.device = "cuda") -> MinibatchPack:
    """Pack one mini-batch on the host (``_pack_rows`` of both edge
    directions, positions through a node -> slot map) and copy it to
    ``device``.  With ``stripe_index=True`` the pack also carries the
    staged SpMM kernel's index for the intra-batch term (source rows =
    batch positions, live only where the neighbour is in the batch).
    ``slot_mask`` (optional, [b]) is 0 on the wrap-padded slots of a tail
    batch (:func:`epoch_slices`).  On the same distinct ids the fields
    equal :func:`plan_batch`'s."""
    dev = resolve_device(device)
    batch_ids = np.asarray(batch_ids)
    deg_cap = deg_cap or g.max_degree()
    inv = np.full(g.n, -1, np.int32)
    inv[batch_ids] = np.arange(len(batch_ids), dtype=np.int32)
    nbr, nmask, npos = _pack_rows(g.in_csr, batch_ids, deg_cap, inv)
    rev, rmask, rpos = _pack_rows(g.out_csr, batch_ids, deg_cap, inv)
    sidx = None
    if stripe_index:
        sidx = make_stripe_index(np.maximum(npos, 0), len(batch_ids),
                                 mask=(npos >= 0) & (nmask != 0),
                                 bb=stripe_bb, stripe=stripe, device=dev)

    def put(a):
        return torch.from_numpy(a).to(dev)
    return MinibatchPack(
        batch_ids=put(batch_ids.astype(np.int32)), nbr_ids=put(nbr),
        nbr_mask=put(nmask), nbr_pos=put(npos), rev_ids=put(rev),
        rev_mask=put(rmask), rev_pos=put(rpos), stripe_index=sidx,
        slot_mask=None if slot_mask is None
        else put(np.asarray(slot_mask, np.float32)))


class FullGraphOperands(NamedTuple):
    """Whole-(sub)graph ELL operands for exact message passing: the
    full-graph oracle and evaluation, and the sampling baselines on their
    sampled subgraphs.  ``stripe_index`` (optional) is the staged SpMM
    kernel's index for the [n, f] source; without it the kernel builds one
    on the device."""
    nbr_ids: torch.Tensor    # [n, D] int32
    nbr_mask: torch.Tensor   # [n, D] f32
    degrees: torch.Tensor    # [n]    f32
    stripe_index: Optional[StripeIndex] = None


def full_operands(g: Graph, deg_cap: int | None = None, *,
                  stripe_index: bool = False, stripe_bb: int = DEFAULT_BB,
                  stripe: int = DEFAULT_STRIPE,
                  device: str | torch.device = "cuda") -> FullGraphOperands:
    """Whole-graph operands; with ``stripe_index`` also the host-built
    index at the tiles ``stripe_bb`` / ``stripe`` (see
    :func:`make_stripe_index`)."""
    dev = resolve_device(device)
    deg_cap = deg_cap or g.max_degree()
    nbr, mask, _ = _pack_rows(g.in_csr, np.arange(g.n), deg_cap)
    sidx = make_stripe_index(nbr, g.n, mask=mask, bb=stripe_bb,
                             stripe=stripe, device=dev) \
        if stripe_index else None
    return FullGraphOperands(
        nbr_ids=torch.from_numpy(nbr).to(dev),
        nbr_mask=torch.from_numpy(mask).to(dev),
        degrees=torch.from_numpy(g.degrees()).to(dev), stripe_index=sidx)


def subgraph_operands(src: np.ndarray, dst: np.ndarray, n_sub: int,
                      deg_cap: int, *, device: str | torch.device = "cuda"
                      ) -> FullGraphOperands:
    """The ELL operands of an ``n_sub``-node subgraph given by its local
    edges ``src -> dst``."""
    dev = resolve_device(device)
    csr = csr_from_coo(src.astype(np.int64), dst.astype(np.int64), n_sub)
    nbr, mask, _ = _pack_rows(csr, np.arange(n_sub), deg_cap)
    return FullGraphOperands(
        nbr_ids=torch.from_numpy(nbr).to(dev),
        nbr_mask=torch.from_numpy(mask).to(dev),
        degrees=torch.from_numpy(csr.degrees()).to(dev))


def inductive_view(g: Graph) -> Graph:
    """Training view for the inductive setting (PPI): val/test nodes and
    all their edges are invisible during training (paper Sec. 6).  The
    reference walks the visible nodes one by one; this keeps the in-edges
    whose both ends are visible in one mask over the CSR, in the same
    order (node by node, CSR order within a node)."""
    visible = np.zeros(g.n, bool)
    visible[g.train_idx] = True
    csr = g.in_csr
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(csr.indptr))
    keep = visible[dst] & visible[csr.indices]
    return build_graph(csr.indices[keep], dst[keep], g.n, g.features,
                       g.labels, (g.train_idx, g.val_idx, g.test_idx),
                       multilabel=g.multilabel, name=g.name + "-inductive")


PAD_BUCKET_CAP = 1 << 22


def pad_bucket(n: int, cap: int = PAD_BUCKET_CAP) -> int:
    """A sampled subgraph's size rounded up to a power-of-two bucket (at
    least 256) and clamped to ``cap``.  A subgraph above the cap raises:
    clamping ``n`` itself would drop real nodes."""
    if n > cap:
        raise ValueError(
            f"sampled subgraph has {n} nodes, above the pad-bucket cap "
            f"{cap}: shrink the sampler batch size / walk length / fanout "
            f"or raise the cap")
    b = 256
    while b < n:
        b *= 2
    return min(b, cap)


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


def minibatch_stream(g: Graph, batch_size: int, rng: np.random.Generator,
                     idx_pool: np.ndarray | None = None,
                     deg_cap: int | None = None, *,
                     device: str | torch.device = "cuda"
                     ) -> Iterator[MinibatchPack]:
    """Random-node mini-batches covering the pool once per epoch, packed
    on the host (:func:`make_pack`): one ``rng.permutation`` of the pool
    split by :func:`epoch_slices`, the tail batch wrap-padded with
    loss-masked slots, so every node of the pool is traversed every
    epoch."""
    pool = idx_pool if idx_pool is not None else np.arange(g.n)
    ids, slot_mask = epoch_slices(rng.permutation(pool), batch_size)
    for s in range(ids.shape[0]):
        yield make_pack(g, ids[s], deg_cap, slot_mask=slot_mask[s],
                        device=device)


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
    npos = torch.where(nmask != 0, slot[nbr.long()], -1)
    rpos = torch.where(rmask != 0, slot[rev.long()], -1)
    return MinibatchPack(
        batch_ids=batch_ids, nbr_ids=nbr, nbr_mask=nmask, nbr_pos=npos,
        rev_ids=rev, rev_mask=rmask, rev_pos=rpos, slot_mask=slot_mask)


def _inbatch_positions(batch_ids: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """node id -> in-batch position (-1 when absent or masked) by a stable
    argsort and a searchsorted over the b batch ids, in place of
    :func:`plan_batch`'s [n] node->slot scatter: the row-sharded paths
    use it because an O(n) transient would undo the per-rank memory the
    row sharding saves.  For distinct batch ids the result equals the
    scatter's; for a duplicated id (the serving path) it picks the first
    slot where :func:`plan_batch` keeps the last -- both slots hold the
    same node's row, so the values gathered downstream are equal."""
    b = batch_ids.shape[0]
    batch_ids = batch_ids.long()
    order = torch.argsort(batch_ids, stable=True)
    sb = batch_ids[order]
    ids = ids.long()
    j = torch.clamp(torch.searchsorted(sb, ids), 0, b - 1)
    hit = (sb[j] == ids) & (mask != 0)
    return torch.where(hit, order[j], -1).to(torch.int32)


def plan_batch_sharded(plan: EpochPlan, batch_ids: torch.Tensor, mesh,
                       slot_mask: Optional[torch.Tensor] = None
                       ) -> MinibatchPack:
    """:func:`plan_batch` against a ROW-SHARDED EpochPlan: each table is
    this rank's contiguous [n_local, D] block of the padded global table
    and the rows come cross-shard through
    :func:`repro_torch.distributed.collectives.gather_from_shards` on
    ``mesh``.  The id tables and the mask tables are concatenated to
    [n_local, D + Dr] first, so a batch costs two cross-shard gathers
    (one int, one float), not four.  Positions come from
    :func:`_inbatch_positions` (no O(n) transient).  Equal to
    ``plan_batch`` on the unsharded plan for the same distinct ids."""
    from repro_torch.distributed.collectives import gather_from_shards

    d = plan.nbr_ids.shape[1]
    batch_ids = batch_ids.to(device=plan.nbr_ids.device, dtype=torch.int32)
    ids_tab = torch.cat([plan.nbr_ids, plan.rev_ids], dim=1)
    mask_tab = torch.cat([plan.nbr_mask, plan.rev_mask], dim=1)
    ids_rows = gather_from_shards(ids_tab, batch_ids, mesh)
    mask_rows = gather_from_shards(mask_tab, batch_ids, mesh)
    # contiguous halves: the kernels take contiguous operands
    nbr, rev = ids_rows[:, :d].contiguous(), ids_rows[:, d:].contiguous()
    nmask = mask_rows[:, :d].contiguous()
    rmask = mask_rows[:, d:].contiguous()
    npos = _inbatch_positions(batch_ids, nbr, nmask)
    rpos = _inbatch_positions(batch_ids, rev, rmask)
    return MinibatchPack(
        batch_ids=batch_ids, nbr_ids=nbr, nbr_mask=nmask, nbr_pos=npos,
        rev_ids=rev, rev_mask=rmask, rev_pos=rpos, slot_mask=slot_mask)


# ---------------------------------------------------------------------------
# sampler epoch plans
# ---------------------------------------------------------------------------

class SamplerEpochPlan(NamedTuple):
    """An epoch of pre-sampled induced subgraphs, stacked to one static
    shape [S, P, ...] on the device, for ``models.gnn.sampler_train_epoch``.

    ``nbr_ids`` are local subgraph positions; padding rows have empty
    neighbour lists, degree 0, node id 0 and loss weight 0, so they feed
    nothing into real rows and nothing into the masked loss."""
    node_ids: torch.Tensor   # [S, P]    global node ids (0 on padding), int32
    nbr_ids: torch.Tensor    # [S, P, D] in-neighbour local positions, int32
    nbr_mask: torch.Tensor   # [S, P, D] 1.0 on real in-edges
    degrees: torch.Tensor    # [S, P]    in-degree within the subgraph
    loss_mask: torch.Tensor  # [S, P]    seed weight (0 on padding/non-seed)

    @property
    def s(self) -> int:
        return self.node_ids.shape[0]

    @property
    def p(self) -> int:
        return self.node_ids.shape[1]


def pack_sampler_epoch(batches: list[tuple], deg_cap: int,
                       n_pad: Optional[int] = None, *,
                       device: str | torch.device = "cuda"
                       ) -> SamplerEpochPlan:
    """Stack one epoch of sampler 5-tuples ``(src, dst, nodes, seed_pos,
    seed_weight)`` (``graph.sampling``) into a :class:`SamplerEpochPlan`:
    every subgraph padded to ``n_pad`` rows, or to the power-of-two bucket
    of the epoch's largest (:func:`pad_bucket`), and its neighbour lists to
    ``deg_cap``."""
    if not batches:
        raise ValueError("pack_sampler_epoch needs at least one batch")
    dev = resolve_device(device)
    sizes = [len(nodes) for _, _, nodes, _, _ in batches]
    p = n_pad if n_pad is not None else pad_bucket(max(sizes))
    if max(sizes) > p:
        raise ValueError(f"subgraph of {max(sizes)} nodes exceeds "
                         f"n_pad={p}")
    s = len(batches)
    node_ids = np.zeros((s, p), np.int32)
    nbr = np.zeros((s, p, deg_cap), np.int32)
    mask = np.zeros((s, p, deg_cap), np.float32)
    degs = np.zeros((s, p), np.float32)
    loss = np.zeros((s, p), np.float32)
    for i, (src, dst, nodes, seed_pos, seed_w) in enumerate(batches):
        csr = csr_from_coo(np.asarray(src, np.int64),
                           np.asarray(dst, np.int64), p)
        nbr[i], mask[i], _ = _pack_rows(csr, np.arange(p), deg_cap)
        degs[i] = csr.degrees()
        node_ids[i, :len(nodes)] = nodes
        loss[i, np.asarray(seed_pos)] = np.asarray(seed_w, np.float32)
    return SamplerEpochPlan(
        *(torch.from_numpy(a).to(dev)
          for a in (node_ids, nbr, mask, degs, loss)))
