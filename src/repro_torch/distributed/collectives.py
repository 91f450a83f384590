"""Collectives of the data-parallel and row-sharded GNN paths.

Torch twin of ``repro.distributed.collectives``: :func:`psum_tree` (the
exact SUM all-reduce of gradients and statistics), the int8 all-reduce
with error feedback (:func:`quantize_int8`, :func:`dequantize_int8`,
:func:`compressed_psum`, :func:`compressed_grad_allreduce`), and the
cross-shard row movement of the row-sharded graph state
(:func:`all_gather_rows`, :func:`gather_from_shards`,
:func:`shard_scatter_rows`).  Every function takes the
:class:`~repro_torch.distributed.sharding.GraphMesh` of the calling rank
and must be called by every rank of it in the same order, as a
``shard_map`` body runs on every device.

Only operations that both ``nccl`` and ``gloo`` carry are used: SUM and
MAX all-reduces, all-gathers of equal-sized contiguous tensors and
broadcasts, in float32, int32, int64 and uint8.  Every collective is
called on the tensors where they lie, on either backend: the installed
gloo carries all of them on CUDA tensors (``tools/gloo_cuda_probe.py``
on torch 2.11.0+cu128, every operation and dtype above on an H100; and
faster than staging them through host memory by hand), so nothing is
staged; a gloo build that refused one would raise.  With
``mesh.time_collectives`` each collective is timed on the host clock,
synchronised with the device before and after.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import GraphMesh

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


@contextmanager
def _timed(mesh: GraphMesh, t: torch.Tensor):
    if not mesh.time_collectives:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    mesh.collective_s += time.perf_counter() - t0
    mesh.collective_calls += 1


def all_reduce(t: torch.Tensor, mesh: GraphMesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor holding the all-reduce (SUM or MAX) of ``t`` over the
    mesh; ``t`` is left as it was."""
    with _timed(mesh, t):
        buf = t.detach().contiguous().clone()
        dist.all_reduce(buf, op=op, group=mesh.group)
        return buf


def broadcast(t: torch.Tensor, mesh: GraphMesh, src: int = 0
              ) -> torch.Tensor:
    """A new tensor holding rank ``src``'s ``t`` on every rank (every rank
    passes a tensor of the same shape and dtype)."""
    with _timed(mesh, t):
        buf = t.detach().contiguous().clone()
        dist.broadcast(buf, src=src, group=mesh.group)
        return buf


def all_gather(t: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """[ndev, *t.shape]: every rank's ``t`` in rank order."""
    with _timed(mesh, t):
        src = t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.stack(parts)


# ---------------------------------------------------------------------------
# tree all-reduce, exact and int8-compressed
# ---------------------------------------------------------------------------

def _flatten(tree) -> tuple[list[torch.Tensor], Any]:
    """Leaves of a tree of tensors (dicts, lists, tuples, NamedTuples) and
    the function that rebuilds it from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda it: next(it)
    if isinstance(tree, dict):
        parts = {k: _flatten(v) for k, v in tree.items()}
        leaves = [l for ls, _ in parts.values() for l in ls]
        return leaves, lambda it: {k: f(it) for k, (_, f) in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        leaves = [l for ls, _ in parts for l in ls]
        if hasattr(tree, "_fields"):
            return leaves, lambda it: type(tree)(*(f(it) for _, f in parts))
        return leaves, lambda it: type(tree)(f(it) for _, f in parts)
    raise TypeError(f"unsupported tree node {type(tree)}")


def _unflatten(rebuild, leaves: list[torch.Tensor]):
    return rebuild(iter(leaves))


def psum_tree(tree, mesh: GraphMesh):
    """Leaf-wise uncompressed SUM over the mesh -- the exact all-reduce of
    the data-parallel step: param grads and codebook statistics stay
    bit-consistent across ranks, so codebooks and assignment tables never
    diverge.  The leaves of one dtype travel as one flat buffer (one
    collective); every rank gets the same sums."""
    leaves, rebuild = _flatten(tree)
    out: list[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = all_reduce(flat, mesh)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    return _unflatten(rebuild, out)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8: (q, scale) with scale = max|x| / 127 (+1e-12) and
    q = round-half-even(x / scale) clipped to [-127, 127]."""
    x32 = x.float()
    scale = x32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, mesh: GraphMesh,
                    residual: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce over the mesh with error feedback: returns (sum,
    new_residual).  Each rank quantizes ``x + residual`` against its own
    scale and keeps what the quantization lost; the int8 payloads are
    summed in int32 and dequantized with the largest scale (conservative,
    as in the reference)."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual
    q, scale = quantize_int8(x32)
    new_residual = x32 - dequantize_int8(q, scale)
    qsum = all_reduce(q.to(torch.int32), mesh)
    smax = all_reduce(scale, mesh, dist.ReduceOp.MAX)
    return qsum.float() * smax, new_residual


def compressed_grad_allreduce(grads, mesh: GraphMesh, residuals=None):
    """Tree-wise :func:`compressed_psum` (one scale per tensor): returns
    (sums, new residuals), both in the tree's structure."""
    leaves, rebuild = _flatten(grads)
    res = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
           for g in leaves] if residuals is None \
        else _flatten(residuals)[0]
    outs, news = [], []
    for g, r in zip(leaves, res):
        o, nr = compressed_psum(g, mesh, r)
        outs.append(o)
        news.append(nr)
    return _unflatten(rebuild, outs), _unflatten(rebuild, news)


# ---------------------------------------------------------------------------
# cross-shard row gather / scatter for the row-sharded graph state
# (DESIGN.md section 14): rank s owns global rows [s*n_local, (s+1)*n_local)
# of a table whose rank-local operand is its [n_local, ...] block
# ---------------------------------------------------------------------------

def all_gather_rows(x: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """All-gather flattening the rank axis into the leading row axis, in
    rank order -- the contiguous-block ownership, so gathering every
    rank's [n_local, ...] block yields the padded global table."""
    g = all_gather(x, mesh)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def gather_from_shards(table: torch.Tensor, ids: torch.Tensor,
                       mesh: GraphMesh, *, compress: bool = False
                       ) -> torch.Tensor:
    """Cross-shard ``table[ids]`` for a row-sharded table.

    Every rank passes its [n_local, ...] block and a request vector of
    *global* row ids (the same length on every rank; each id indexes the
    padded global table); the requests are all-gathered, each rank
    answers the ones it owns (zero elsewhere), one SUM all-reduce
    superposes the answers (each row has exactly one owner, so the sum is
    exact) and each rank slices its own requests back out.  Integer and
    bool payloads are summed in int32 and cast back, fp8 payloads as
    their uint8 bytes summed in int32 -- both bit-exact.
    ``compress=True`` moves float payloads as int8 against ONE
    MAX-shared scale: each row has one owner, so the result is exact up
    to one quantization half-step (max|table| / 254)."""
    n_local = table.shape[0]
    b = ids.shape[0]
    all_ids = all_gather_rows(ids.to(torch.int32), mesh).long()
    loc = all_ids - mesh.rank * n_local
    own = (loc >= 0) & (loc < n_local)
    rows = table[torch.clamp(loc, 0, n_local - 1)]
    mask = own.reshape((-1,) + (1,) * (rows.ndim - 1))
    if table.dtype in _FP8:
        bits = torch.where(mask, rows.view(torch.uint8).to(torch.int32), 0)
        full = all_reduce(bits, mesh).to(torch.uint8).view(table.dtype)
    elif not table.dtype.is_floating_point:
        contrib = torch.where(mask, rows.to(torch.int32), 0)
        full = all_reduce(contrib, mesh).to(table.dtype)
    elif compress:
        contrib = torch.where(mask, rows.float(), 0.0)
        scale = all_reduce(contrib.abs().max(), mesh,
                           dist.ReduceOp.MAX) / 127.0 + 1e-12
        q = torch.round(contrib / scale).to(torch.int8)
        qsum = all_reduce(q.to(torch.int32), mesh)
        full = (qsum.float() * scale).to(table.dtype)
    else:
        contrib = torch.where(mask, rows, torch.zeros_like(rows))
        full = all_reduce(contrib, mesh)
    return full[mesh.rank * b:(mesh.rank + 1) * b]


def shard_scatter_rows_(buf: torch.Tensor, ids: torch.Tensor,
                        rows: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """In-place cross-shard ``table[ids] = rows`` into ``buf``, this
    rank's [n_local + 1, ...] block with one parked row last: every
    rank's (global id, row) pairs are all-gathered, each rank writes the
    rows it owns and parks foreign writes on the last row.  ``ids`` must
    be distinct over the whole gather wherever they target real rows
    (writes diverted to the sacrificial global row may repeat: it is
    never read back).  Returns ``buf``."""
    n_local = buf.shape[0] - 1
    all_ids = all_gather_rows(ids.to(torch.int32), mesh).long()
    all_rows = all_gather_rows(rows, mesh)
    loc = all_ids - mesh.rank * n_local
    own = (loc >= 0) & (loc < n_local)
    dst = torch.where(own, loc, n_local)
    buf.index_copy_(0, dst, all_rows.to(buf.dtype))
    return buf


def shard_scatter_rows(table: torch.Tensor, ids: torch.Tensor,
                       rows: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """Cross-shard ``table.at[ids].set(rows)`` for a row-sharded table (the
    reference's form): a new [n_local, ...] block, ``table`` untouched;
    see :func:`shard_scatter_rows_`."""
    park = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                       device=table.device)
    return shard_scatter_rows_(torch.cat([table, park]), ids, rows,
                               mesh)[:-1]
