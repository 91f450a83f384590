"""Activation layout constraints (twin of
``repro.distributed.act_constraints``), on DTensor.

Contracting a batch-sharded activation with an FSDP-sharded weight gives
two competing uses of the data axes; the reference pins the activation's
layout at block boundaries (``with_sharding_constraint``) so that GSPMD
gathers the weight and keeps the batch sharded.  Here the pin is a
``redistribute`` of a DTensor activation to batch-over-the-data-axes,
every other dim whole (the Megatron layout; the TP reductions handle d).

The policy is process-global and set by the launcher / dry-run before the
step runs; when unset (unit tests, one device) every call returns its
input, and a plain tensor is always returned as it is, so the model code
stays device-agnostic and computes bit for bit what it computes without
a mesh.

DTensor resolves each op on its own, without GSPMD's propagation through
the whole program, and refuses some views GSPMD reshards silently.  The
other helpers here make the layouts explicit where the model needs them
(each a no-op on plain tensors): ``split_ready`` (a sharded dim made
splittable into heads), ``by_heads`` (attention on each rank's (batch,
kv head) part), ``gather_params`` (a layer's FSDP gather),
``keep_layout`` (a gradient in its forward value's layout, the transpose
of a sharding constraint), ``match_layout`` (a gradient in its
parameter's layout) and ``relayout_batch`` (a microbatch in its batch's
layout).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import axis_names

_POLICY: Optional[tuple] = None   # (mesh, batch_axes)
_GATHER: Optional[tuple] = None   # the axes a layer's params are gathered on


def set_policy(mesh: Any, batch_axes) -> None:
    global _POLICY
    _POLICY = (mesh, (batch_axes,) if isinstance(batch_axes, str)
               else tuple(batch_axes))


def clear_policy() -> None:
    global _POLICY
    _POLICY = None


def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """Pin a [batch, seq, d_model] DTensor activation: batch over the
    policy's batch axes, seq / d whole.  Where the axes do not all divide
    the batch (a microbatch), over the major ones whose sizes still
    divide it, the rest whole: the reference leaves such a batch to
    GSPMD's propagation, which DTensor does not have.  A plain tensor, no
    policy or a rank below 2: ``x`` unchanged."""
    if _POLICY is None or not is_dtensor(x) or x.ndim < 2:
        return x
    from torch.distributed.tensor import Replicate, Shard
    _, batch_axes = _POLICY
    mesh = x.device_mesh
    sizes = dict(zip(axis_names(mesh), mesh.shape))
    keep, kept = set(), 1
    for a in batch_axes:
        if sizes[a] > 1 and x.shape[0] % (kept * sizes[a]) == 0:
            keep.add(a)
            kept *= sizes[a]
    placements = [Shard(0) if a in keep else Replicate()
                  for a in axis_names(mesh)]
    if list(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return keep_layout(x)


class _KeepLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was laid out."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is whole on every rank
        ctx.layout = (x.device_mesh, tuple(
            Replicate() if pl.is_partial() else pl for pl in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        if is_dtensor(g) and tuple(g.placements) != placements:
            g = g.redistribute(mesh, placements)
        return g


def keep_layout(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` whose gradient takes ``x``'s own layout -- as the
    transpose of a sharding constraint constrains the cotangent in JAX.
    Without it a reduction's backward (a mean's expand of a replicated
    scalar) hands back a replicated gradient, and every op behind it runs
    on the whole batch on every rank.  Plain tensors pass as they are."""
    return _KeepLayout.apply(x) if is_dtensor(x) else x


def split_ready(x: torch.Tensor, dim: int, n_outer: int) -> torch.Tensor:
    """``x`` laid out so that dim ``dim`` can be split into (``n_outer``,
    rest) by a view: DTensor refuses to split a dim whose shards do not
    divide ``n_outer`` ("Cannot unflatten unevenly sharded tensor"), where
    GSPMD reshards silently.  Of the mesh dims that shard ``dim``, the
    major ones whose sizes still divide ``n_outer`` are kept and the rest
    made whole (a gather over them).  A plain tensor, or one whose shards
    already divide, is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.ndim
    mesh = x.device_mesh
    placements = list(x.placements)
    kept = 1
    changed = False
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            if n_outer % (kept * mesh.size(i)) == 0:
                kept *= mesh.size(i)
            else:
                placements[i] = Replicate()
                changed = True
    return x.redistribute(mesh, placements) if changed else x



def by_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             *rest, **kw):
    """``fn(q, k, v, *rest, **kw)`` -- an attention whose output row (b,
    query, head) reads only batch row b and kv head ``head // G`` -- on
    each rank's part: for DTensor q [B, Sq, Hq, dh] and k / v [B, Skv,
    Hkv, dh], the mesh dims that shard q's batch keep sharding it, those
    that shard its heads keep sharding q's and k / v's heads while their
    sizes divide Hkv (contiguous kv heads carry their query groups with
    them), and the rest see whole tensors; each ``rest`` tensor [B, ...]
    takes the batch layout.  ``fn`` then runs on plain local tensors
    (``local_map``: autograd carries the gradients back in these
    layouts), so the layout of scores, masks and views inside it is the
    one of a single device, where GSPMD would reshard them op by op.
    Plain tensors call ``fn`` as it is."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    hkv = k.shape[2]
    heads, batch = [], []
    kept = 1
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            heads.append(Shard(0))
            batch.append(Shard(0))
        elif isinstance(pl, Shard) and pl.dim == 2 \
                and hkv % (kept * mesh.size(i)) == 0:
            kept *= mesh.size(i)
            heads.append(Shard(2))
            batch.append(Replicate())
        else:
            heads.append(Replicate())
            batch.append(Replicate())
    rest_pl = tuple(batch if isinstance(t, torch.Tensor) else None
                    for t in rest)
    return local_map(lambda *a: fn(*a, **kw), out_placements=heads,
                     in_placements=(heads, heads, heads) + rest_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, *rest)


def match_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` (a gradient) laid out as ``like`` (its parameter):
    a partial sum is reduced, a replicated one cut; plain tensors and
    matching layouts pass as they are."""
    if not is_dtensor(t) or tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def gather_params(tree: Any, x: torch.Tensor) -> Any:
    """A layer's parameters as its activation ``x`` [B, ...] uses them:
    every DTensor leaf made whole over the policy's gather axes (the data
    axes under tp_fsdp / moe_ep_dp, every axis under fsdp; without a
    policy the mesh dims that shard ``x``'s batch) -- FSDP's all-gather
    before the layer, whose backward reduce-scatters the gradient -- its
    other shards kept (tensor and expert parallelism).  Without it
    DTensor may resolve an FSDP-sharded weight against a batch-sharded
    activation by gathering the activation -- every rank then computes
    the whole batch -- the resolution the reference's constraints keep
    GSPMD from.  Plain
    ``x``: the tree as it is."""
    if not is_dtensor(x):
        return tree
    from torch.distributed.tensor import Replicate, Shard
    if _GATHER is not None:
        names = axis_names(x.device_mesh)
        batch = {i for i, a in enumerate(names) if a in _GATHER}
    else:
        batch = {i for i, pl in enumerate(x.placements)
                 if isinstance(pl, Shard) and pl.dim == 0}

    def gather(t):
        if isinstance(t, dict):
            return {k: gather(v) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(gather(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(gather(v) for v in t)
        if not is_dtensor(t):
            return t
        pl = [Replicate() if i in batch else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) \
            else t.redistribute(t.device_mesh, pl)
    return gather(tree)


class policy:
    """``set_policy(mesh, batch_axes)`` for the ``with`` block (None: no
    policy) and, with ``gather_axes``, the axes :func:`gather_params`
    gathers a layer's parameters on; the previous settings restored
    after it."""

    def __init__(self, mesh: Any, batch_axes,
                 gather_axes: Optional[tuple] = None) -> None:
        self.new = None if mesh is None else (mesh, batch_axes)
        self.gather = None if gather_axes is None else tuple(gather_axes)

    def __enter__(self):
        global _GATHER
        self.old = (_POLICY, _GATHER)
        if self.new is None:
            clear_policy()
        else:
            set_policy(*self.new)
        _GATHER = self.gather
        return self

    def __exit__(self, *exc) -> None:
        global _POLICY, _GATHER
        _POLICY, _GATHER = self.old


def relayout_batch(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A batch ``t`` [b, ...] that every rank holds whole, as a DTensor
    laid out as ``like`` on ``like``'s mesh, each rank keeping its rows
    (no communication); of the mesh dims that shard ``like``'s batch, the
    major ones whose sizes still divide b are kept, the rest whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = like.device_mesh
    placements, kept = [], 1
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard) and pl.dim == 0 and mesh.size(i) > 1 \
                and t.shape[0] % (kept * mesh.size(i)) == 0:
            kept *= mesh.size(i)
            placements.append(Shard(0))
        else:
            placements.append(Replicate())
    return distribute_tensor(t.contiguous(), mesh, placements,
                             src_data_rank=None)



def by_batch(fn, n_batch: int, *args):
    """``fn(*args)`` -- whose output rows [B, ...] read only the same rows
    of its first ``n_batch`` arguments (a recurrence scanned per sequence)
    -- on each rank's part: DTensor batch arguments keep the mesh dims
    that shard the first one's batch, and are whole elsewhere; every
    other DTensor argument (parameters) is made whole; ``fn`` runs on
    plain local tensors (``local_map``) and its output takes the batch
    layout.  Plain tensors call ``fn`` as it is."""
    x = args[0]
    if not is_dtensor(x):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    batch = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
             else Replicate() for pl in x.placements]
    whole = [Replicate()] * mesh.ndim
    in_pl = tuple((batch if i < n_batch else whole)
                  if isinstance(a, torch.Tensor) else None
                  for i, a in enumerate(args))
    return local_map(fn, out_placements=batch, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)
