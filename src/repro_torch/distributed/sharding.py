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
b/ndev rows).

The LM half (the reference's ``:35-287``, after the graph helpers) is the
reference's rules verbatim on DTensor: ``strategy_for``,
``_spec_for_leaf``, ``param_shardings``, ``token_sharding``,
``_seq_axes_for``, ``cache_shardings`` and ``replicated``.  A spec is
the port's own :class:`PartitionSpec` (a tuple with an entry a tensor
dim: None, an axis name or a tuple of axis names), a leaf is named by the
reference's ``jax.tree_util`` path string (``['blocks']['attn'].wq``:
dict keys ``['k']``, NamedTuple fields ``.f``), so the same strings meet
the same rules; :func:`to_placements` turns a spec into DTensor
placements on a ``DeviceMesh``, and :func:`distribute` places a tree.
The rules read only the mesh's axis names and sizes, so an abstract mesh
(``axis_names`` and ``shape[name]``) serves as well as a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import hostenv
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axes_size, axis_names, axis_sizes, dp_axes
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
                               int(hostenv.env_knob("LOCAL_RANK", rank)))
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


# ===========================================================================
# the LM half: per-architecture strategies (DESIGN.md section 5)
# ===========================================================================
#
# Strategies (chosen by ``strategy_for(cfg)`` from head / ff divisibility):
#   tp_fsdp    -- Megatron tensor parallelism on the ``model`` axis (q heads
#                 / d_ff / vocab / experts) + FSDP of params and optimizer
#                 states over the data axes ("pod", "data"): column-parallel
#                 wq / wk / wv / w1 / w3, row-parallel wo / w2;
#   moe_ep_dp  -- experts over ``model``, everything else over the data
#                 axes (attention runs pure DP);
#   fsdp       -- no TP (head counts indivisible by the model axis): params
#                 over the flattened mesh on their largest divisible dim;
#   replicate  -- tiny models (whisper-tiny): pure DP.
# Every rule checks divisibility against the mesh: a dim that does not
# divide stays unsharded.

# stacked-layer containers: leading dims are layer axes, never sharded
_STACKED1 = ("blocks", "pairs", "enc_blocks", "cross_blocks")
_STACKED2 = ("mamba",)


class PartitionSpec(tuple):
    """A tensor's layout over a mesh, one entry a dim: None (whole), an
    axis name, or a tuple of axis names (major to minor); trailing dims
    without an entry are whole.  The port's own twin of
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: PartitionSpec, mesh: Any) -> list:
    """DTensor placements of ``spec``, one a mesh dim: ``Shard(d)`` on
    every mesh dim that an entry of tensor dim ``d`` names, ``Replicate()``
    on the others.  A tuple of axes on one dim shards it major to minor in
    the tuple's order, as JAX lays it out; DTensor nests shards of one dim
    in mesh-dim order, so the tuple must follow the mesh's axis order.  A
    mesh dim of size 1 gets ``Replicate()`` (the same layout: DTensor's
    view rules treat a shard over one rank as a sharded dim)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {_axes(entry)} of dim {d} "
                             f"are out of the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] == 1:
                continue
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return out


def shard_shape(shape: tuple[int, ...], spec: PartitionSpec,
                mesh: Any) -> tuple[int, ...]:
    """A rank's local shape of a ``shape`` tensor laid out by ``spec``
    (every sharded dim divides: the rules shard no other)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {shape} does not divide over "
                                 f"{a} ({sizes[a]})")
            out[d] //= sizes[a]
    return tuple(out)


def strategy_for(cfg: ArchConfig, mesh: Any) -> str:
    tp = axis_sizes(mesh)["model"]
    if cfg.param_count() < 200e6:
        return "replicate"
    if cfg.family == "moe" and cfg.n_experts % tp == 0:
        # experts-on-model + DP attention: one all-reduce a layer where
        # Megatron-TP on a d_model 2048 attention takes four
        return "moe_ep_dp"
    if cfg.n_heads % tp == 0 and (cfg.d_ff == 0 or cfg.d_ff % tp == 0):
        return "tp_fsdp"
    return "fsdp"


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _spec_for_leaf(pathstr: str, shape: tuple[int, ...], strategy: str,
                   mesh: Any, cfg: ArchConfig) -> PartitionSpec:
    dp = dp_axes(mesh)
    dp_n = axes_size(mesh, dp)
    tp_n = axis_sizes(mesh)["model"]
    all_ax = dp + ("model",)
    all_n = dp_n * tp_n

    # number of leading stacked dims to skip
    skip = 0
    if any(f"['{k}']" in pathstr for k in _STACKED1):
        skip = 1
    if any(f"['{k}']" in pathstr for k in _STACKED2):
        skip = 2
    dims = list(shape[skip:])
    lead = [None] * skip

    def out(spec_tail):
        return P(*lead, *spec_tail)

    if len(dims) == 0:
        return out([])

    if strategy == "replicate":
        return out([None] * len(dims))

    # vocab-parallel embedding / head in every sharded strategy; the
    # d_model axis stays whole (d over dp would conflict with batch-over-
    # dp activations)
    if "['embed']" in pathstr and len(dims) == 2:
        spec = [None, None]
        if _divides(dims[0], tp_n):
            spec[0] = "model"
        elif _divides(dims[0], dp_n):
            spec[0] = dp          # odd vocabs: shard vocab over dp instead
        return out(spec)
    if "['head']" in pathstr and len(dims) == 2:
        spec = [None, None]
        if _divides(dims[1], tp_n):
            spec[1] = "model"
        elif _divides(dims[1], dp_n):
            spec[1] = dp
        return out(spec)

    if strategy == "moe_ep_dp":
        # experts over ``model`` (EP); everything else over dp, replicated
        # over ``model`` (attention runs pure DP)
        spec = [None] * len(dims)
        if (".w1" in pathstr or ".w3" in pathstr or ".w2" in pathstr) \
                and len(dims) == 3:
            if _divides(dims[0], tp_n):
                spec[0] = "model"
            rest = 1 if ".w2" not in pathstr else 2
            if _divides(dims[rest], dp_n):
                spec[rest] = dp
            return out(spec)
        if ".router" in pathstr and len(dims) == 2:
            if _divides(dims[1], tp_n):
                spec[1] = "model"
            return out(spec)
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if _divides(dims[i], dp_n):
                spec[i] = dp
                break
        return out(spec)

    if strategy == "fsdp":
        # shard the largest dim divisible by the whole mesh; else by dp
        spec = [None] * len(dims)
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if _divides(dims[i], all_n):
                spec[i] = all_ax
                return out(spec)
        for i in order:
            if _divides(dims[i], dp_n):
                spec[i] = dp
                return out(spec)
        return out(spec)

    # ----- tp_fsdp: named Megatron rules + generic fallback -----
    def col(d_in_idx: int, d_out_idx: int):
        """column-parallel: out dim over model, in dim over dp."""
        spec = [None] * len(dims)
        if _divides(dims[d_out_idx], tp_n):
            spec[d_out_idx] = "model"
        if _divides(dims[d_in_idx], dp_n):
            spec[d_in_idx] = dp
        return out(spec)

    def row(d_in_idx: int, d_out_idx: int):
        """row-parallel: in dim over model, out dim over dp."""
        spec = [None] * len(dims)
        if _divides(dims[d_in_idx], tp_n):
            spec[d_in_idx] = "model"
        if _divides(dims[d_out_idx], dp_n):
            spec[d_out_idx] = dp
        return out(spec)

    if ".wq" in pathstr or ".wv" in pathstr or ".wk" in pathstr:
        if "cross" in pathstr or len(dims) == 2:
            return col(0, 1)
    if ".wo" in pathstr and len(dims) == 2:
        return row(0, 1)
    if ".w1" in pathstr or ".w3" in pathstr:
        if len(dims) == 2:
            return col(0, 1)
        if len(dims) == 3:     # MoE experts [E, d, eff]: EP over model
            spec = [None, None, None]
            if _divides(dims[0], tp_n):
                spec[0] = "model"
            if _divides(dims[1], dp_n):
                spec[1] = dp
            return out(spec)
    if ".w2" in pathstr:
        if len(dims) == 2:
            return row(0, 1)
        if len(dims) == 3:     # [E, eff, d]
            spec = [None, None, None]
            if _divides(dims[0], tp_n):
                spec[0] = "model"
            if _divides(dims[2], dp_n):
                spec[2] = dp
            return out(spec)
    if ".router" in pathstr and len(dims) == 2:
        return col(0, 1)
    if "['embed']" in pathstr:
        spec = [None, None]
        if _divides(dims[0], tp_n):
            spec[0] = "model"        # vocab-parallel embedding
        if _divides(dims[1], dp_n):
            spec[1] = dp
        return out(spec)
    if "['head']" in pathstr:
        return col(0, 1)

    # generic fallback (mamba in_proj / out_proj, xlstm projections, ...):
    # last dim over model, largest other dim over dp
    spec = [None] * len(dims)
    if len(dims) >= 2:
        if _divides(dims[-1], tp_n):
            spec[-1] = "model"
        rest = sorted(range(len(dims) - 1), key=lambda i: -dims[i])
        for i in rest:
            if _divides(dims[i], dp_n):
                spec[i] = dp
                break
    return out(spec)


def leaf_paths(tree: Any, sep: str = "") -> list[tuple[str, Any]]:
    """(path string, leaf) of every leaf in ``jax.tree_util``'s order:
    dict keys sorted, ``['k']``; NamedTuple fields ``.f``; list / tuple
    items ``[i]``; None an empty subtree; the components joined by
    ``sep`` ("": the reference's path strings; the checkpoint's keys join
    them by "/").  A leaf is a tensor (a fake one too) or a
    :class:`NamedSharding`."""
    out: list = []

    def walk(t, parts: tuple) -> None:
        if t is None:
            return
        if isinstance(t, (torch.Tensor, NamedSharding)):
            out.append((sep.join(parts), t))
        elif hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), parts + (f".{f}",))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], parts + (f"[{k!r}]",))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, parts + (f"[{i}]",))
        else:
            raise TypeError(f"leaf_paths: unsupported node {type(t)}")
    walk(tree, ())
    return out


def map_with_path(fn, tree: Any, *rest: Any, prefix: str = "") -> Any:
    """``tree``'s structure with each leaf ``fn(path string, leaf, *the
    same leaf of each of rest)``."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, NamedSharding)):
        return fn(prefix, tree, *rest)
    if hasattr(tree, "_fields"):
        return type(tree)(*(
            map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                          prefix=f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 prefix=f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        prefix=f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    raise TypeError(f"map_with_path: unsupported node {type(tree)}")


def param_shardings(params: Any, cfg: ArchConfig, mesh: Any,
                    strategy: str | None = None) -> Any:
    """A :class:`NamedSharding` for every leaf of ``params`` (or of an Adam
    moment tree of the same structure)."""
    strategy = strategy or strategy_for(cfg, mesh)
    return map_with_path(lambda path, leaf: NamedSharding(
        mesh, _spec_for_leaf(path, tuple(leaf.shape), strategy, mesh, cfg)),
        params)


# ---------------------------------------------------------------------------
# activations / batch / cache shardings
# ---------------------------------------------------------------------------

def token_sharding(batch: int, mesh: Any, cfg: ArchConfig,
                   strategy: str = "tp_fsdp") -> NamedSharding:
    """Batch goes over the data axes; when the strategy does not use the
    ``model`` axis for tensor parallelism (replicate / fsdp), the batch
    spreads over it too (the model axis would otherwise idle)."""
    dp = dp_axes(mesh)
    if strategy in ("replicate", "fsdp"):
        allax = dp + ("model",)
        if _divides(batch, axes_size(mesh, allax)):
            return NamedSharding(mesh, P(allax, None))
    b_spec = dp if _divides(batch, axes_size(mesh, dp)) else None
    return NamedSharding(mesh, P(b_spec, None))


def _seq_axes_for(seq: int, batch: int, mesh: Any):
    """For decode caches: shard sequence over as much mesh as the batch
    leaves unused (long_500k batch 1 -> sequence over the whole mesh)."""
    dp = dp_axes(mesh)
    tp_n = axis_sizes(mesh)["model"]
    if _divides(batch, axes_size(mesh, dp)):
        return dp, ("model",) if _divides(seq, tp_n) else None
    # batch unshardable: put everything on the sequence
    allax = dp + ("model",)
    if _divides(seq, axes_size(mesh, allax)):
        return None, allax
    return None, ("model",) if _divides(seq, tp_n) else None


def cache_shardings(cache: Any, cfg: ArchConfig, mesh: Any, batch: int,
                    seq_len: int) -> Any:
    """Shardings for the serve-step cache tree (``lm.init_serve_cache``'s
    structure; its shapes are enough)."""
    b_ax, s_ax = _seq_axes_for(seq_len, batch, mesh)

    def spec(pathstr: str, leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        pspec: list = [None] * len(shape)
        # the batch dim: the first dim of size ``batch`` after the layer dim
        for i, d in enumerate(shape):
            if i == 0:
                continue           # stacked layer dim
            if d == batch and b_ax is not None:
                pspec[i] = b_ax
                break
        if (pathstr.endswith(".k") or pathstr.endswith(".v")
                or "win_" in pathstr or "cross_" in pathstr
                or "sum_" in pathstr):
            # KV-like tensors: shard their sequence / window / codebook dim
            for i, d in enumerate(shape):
                if i == 0 or pspec[i] is not None:
                    continue
                if d in (seq_len, cfg.vq_k, cfg.n_patches, cfg.enc_seq) \
                        and s_ax is not None and _divides(
                            d, axes_size(mesh, s_ax)):
                    pspec[i] = s_ax
                    break
        return NamedSharding(mesh, P(*pspec))

    return map_with_path(spec, cache)


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------

def distribute(tree: Any, shardings: Any, *,
               src_data_rank: Optional[int] = 0) -> Any:
    """Every leaf of ``tree`` as a DTensor laid out by its
    :class:`NamedSharding` in ``shardings`` (same structure, or one
    sharding for every leaf); a DTensor leaf is redistributed.  A plain
    leaf is cut from rank ``src_data_rank``'s tensor (``distribute_tensor``:
    every rank passes one of the same shape and dtype), or, with None,
    from each rank's own -- no communication, for tensors every rank holds
    whole and equal."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(_, t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        d = distribute_tensor(t, sh.mesh, sh.placements,
                              src_data_rank=src_data_rank)
        if src_data_rank is not None:
            return d
        # the shard is a view of the whole tensor: a copy of its own lets
        # the caller free the whole
        return DTensor.from_local(d.to_local().clone(), sh.mesh,
                                  sh.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())
    if isinstance(shardings, NamedSharding):
        return map_with_path(lambda p, t: place(p, t, shardings), tree)
    return map_with_path(place, tree, shardings)


def gather_full(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its full tensor on every rank
    (other leaves as they are)."""
    from torch.distributed.tensor import DTensor
    return map_with_path(lambda _, t: t.full_tensor()
                         if isinstance(t, DTensor) else t, tree)
