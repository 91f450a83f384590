"""Entry-point registry for the dispatch and shared-memory passes.

Builds ONE tiny setup (a 40-node SBM graph, a 2-layer GCN, an epoch plan)
per device and branch width, and registers every hot entry point of the
port against it: the single-device, data-parallel and row-sharded epoch
executors, the sampler baseline's epoch, the layer-locked inference sweep
and the serving step (the latter two across all five precision tiers).
Each :class:`Entry` bundles

  * ``make(device)``, which builds the entry's arguments on a device once
    (cached), and ``call``, the entry itself: :meth:`Entry.run` is the
    eager counterpart of the reference's ``trace`` thunk, so a recorder
    around it sees every dispatch the entry makes;
  * its contracts: the exact dispatch count per batch step
    (``DISPATCH_COUNTS``; ``steps`` batch steps a call), and the quantized
    storage dtypes of its state that must reach the kernels.

The data-parallel and row-sharded entries run in a one-rank process group
(:func:`one_rank_group`: gloo on the CPU, NCCL on the card), which their
``call`` receives as its first argument.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

# Tiny-but-ragged: S = ceil(40/16) = 3 batches with a wrap-padded tail, so
# every run exercises the slot-mask path.
_N, _B = 40, 16
_F, _CLASSES = 16, 4
_S = -(-_N // _B)

# Dispatch counts per batch step (one scan body in the reference), pinned
# per entry.  The registry pins them exactly: a new dispatch in the hot path
# must update this table in the same change, which is the review surface
# the checker exists to create.  Branch-count (nb) invariance is checked by
# running two branch widths -- the counts here must hold for BOTH.
DISPATCH_COUNTS = {
    # per layer: ONE fused context dispatch (regardless of nb) + ONE
    # intra-batch SpMM; the non-inductive inference path runs no
    # assignment-refresh kernel.  Serve = the same two per layer x 2.
    "vq_infer_layer": 2,
    "vq_serve_batch": 4,
}

# storage dtype names of a quantized state (a packed table is "uint4")
STORAGE = ("int8", "float8_e4m3fn", "uint8", "uint4")


@dataclasses.dataclass
class Entry:
    """One registered entry point plus its static contracts."""
    name: str
    make: Callable[[torch.device], tuple]   # device -> arguments
    call: Callable[..., Any]                # the entry on those arguments
    steps: int = 1                          # batch steps one call runs
    dispatch_count: Optional[int] = None    # pinned dispatches a step
    quantized_dtypes: tuple = ()            # storage dtypes of its state
    group: bool = False                     # runs in a one-rank group
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    def args(self, device) -> tuple:
        """The entry's arguments on ``device``, built once."""
        key = str(torch.device(device))
        if key not in self._args:
            self._args[key] = self.make(torch.device(device))
        return self._args[key]

    def run(self, device="cpu"):
        """Call the entry on ``device`` (inside a one-rank group if it
        needs one)."""
        args = self.args(device)
        if not self.group:
            return self.call(*args)
        with one_rank_group(device) as mesh:
            return self.call(mesh, *args)


_group_meshes: list = []


@contextlib.contextmanager
def one_rank_group(device="cpu"):
    """A one-rank process group on ``device`` (gloo on the CPU, NCCL on the
    card, over a ``FileStore`` in a temporary directory), yielding its
    ``GraphMesh``; reentrant, and destroyed on the way out of the
    outermost.  Refuses to stand beside another initialised group."""
    import torch.distributed as dist
    from repro_torch.distributed.ranks import default_backend, process_group
    if _group_meshes:
        yield _group_meshes[-1]
        return
    if dist.is_initialized():
        raise RuntimeError("one_rank_group: a process group is already "
                           "initialised in this process")
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp, process_group(
            default_backend(dev), 1, 0, os.path.join(tmp, "store"),
            device=dev) as mesh:
        _group_meshes.append(mesh)
        try:
            yield mesh
        finally:
            _group_meshes.pop()


@functools.lru_cache(maxsize=None)
def _graph():
    from repro_torch.graph.datasets import _node_classification
    return _node_classification("analysis-tiny", _N, _F, _CLASSES, 3.0, 0.6,
                                0.5, 0.5, 8, 0)


def _config(f_prod: int):
    from repro_torch.core.codebook import CodebookConfig
    from repro_torch.models.gnn import GNNConfig
    g = _graph()
    return GNNConfig(backbone="gcn", f_in=g.f, hidden=8, n_out=g.num_classes,
                     n_layers=2, codebook=CodebookConfig(k=8, f_prod=f_prod))


@functools.lru_cache(maxsize=None)
def tiny_setup(f_prod: int = 4, device: str = "cpu") -> dict:
    """The shared tiny problem instance on ``device``, built once per
    branch width (weights and codebooks drawn on the CPU from explicit
    generators, so every device holds the same state)."""
    from repro_torch.graph.batching import (build_epoch_plan, epoch_slices,
                                            full_operands)
    from repro_torch.models.gnn import init_gnn, init_vq_states
    from repro_torch.train.optimizer import rmsprop
    dev = torch.device(device)
    g = _graph()
    cfg = _config(f_prod)
    tm = np.zeros(g.n, np.float32)
    tm[g.train_idx] = 1.0
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    vq = init_vq_states(cfg, g.n, torch.Generator().manual_seed(1),
                        device=dev)
    opt = rmsprop(3e-3)
    bids, smask = epoch_slices(np.arange(g.n), _B)
    fops = full_operands(g, device=dev)
    return dict(
        g=g, cfg=cfg, opt=opt, params=params, vq=vq, ost=opt.init(params),
        plan=build_epoch_plan(g, full_ops=fops, device=dev),
        degrees=fops.degrees,
        x=torch.from_numpy(g.features).to(dev),
        labels=torch.from_numpy(g.labels).to(dev),
        tm=torch.from_numpy(tm).to(dev),
        perm=torch.from_numpy(bids.astype(np.int32)).to(dev),
        smask=torch.from_numpy(smask).to(dev))


def _setup(f_prod: int, dev: torch.device) -> dict:
    return tiny_setup(f_prod, str(dev))


def quantized_leaf_dtypes(states) -> tuple:
    """Storage dtype names of the sub-f32 leaves of layer VQ states: the
    codeword snapshots' and the assignment tables' (``"uint4"`` for a
    packed one)."""
    from repro_torch.distributed.quantization import PackedAssignment
    found = set()
    for st in states:
        a = st.assignment
        found.add("uint4" if isinstance(a, PackedAssignment)
                  else str(a.dtype).removeprefix("torch."))
        if st.qcw is not None:
            for q in st.qcw:
                found.add(str(q.q.dtype).removeprefix("torch."))
    return tuple(sorted(found & set(STORAGE)))


def _tier_states(s: dict, tier: str):
    from repro_torch.models.gnn import quantize_vq_states
    if tier == "fp32":
        return s["vq"]
    return quantize_vq_states(s["vq"], s["cfg"], precision=tier)


def _suffix(f_prod: int) -> str:
    return f"@f_prod={f_prod}" if f_prod != 4 else ""


def _infer_entry(tier: str, f_prod: int = 4) -> Entry:
    from repro_torch.models.gnn import vq_infer_layer

    def make(dev):
        s = _setup(f_prod, dev)
        acts = torch.zeros((s["g"].n, s["cfg"].f_in), dtype=torch.float32,
                           device=dev)
        return (s["params"][0], _tier_states(s, tier)[0], s["plan"],
                s["perm"], s["smask"], acts, s["degrees"])

    cfg = _config(f_prod)
    probe = _tier_states(_setup(f_prod, torch.device("cpu")), tier)
    return Entry(
        name=f"vq_infer_layer[{tier}]{_suffix(f_prod)}", make=make,
        call=lambda *a: vq_infer_layer(*a, cfg=cfg, layer=0,
                                       inductive=False),
        steps=_S, dispatch_count=DISPATCH_COUNTS["vq_infer_layer"],
        quantized_dtypes=quantized_leaf_dtypes(probe[:1]))


def _serve_entry(tier: str, f_prod: int = 4) -> Entry:
    from repro_torch.models.gnn import vq_serve_batch

    def make(dev):
        s = _setup(f_prod, dev)
        bids = torch.zeros((_B,), dtype=torch.int32, device=dev)
        return (s["params"], _tier_states(s, tier), s["plan"], bids, s["x"],
                s["degrees"])

    cfg = _config(f_prod)
    probe = _tier_states(_setup(f_prod, torch.device("cpu")), tier)
    return Entry(
        name=f"vq_serve_batch[{tier}]{_suffix(f_prod)}", make=make,
        call=lambda *a: vq_serve_batch(*a, cfg=cfg),
        dispatch_count=DISPATCH_COUNTS["vq_serve_batch"],
        quantized_dtypes=quantized_leaf_dtypes(probe))


def _epoch_args(dev) -> tuple:
    s = _setup(4, dev)
    return (s["params"], s["vq"], s["ost"], s["plan"], s["perm"],
            s["smask"], s["x"], s["labels"], s["tm"], s["degrees"])


def _train_entries() -> list[Entry]:
    from repro_torch.distributed.data_parallel import (
        ShardedGraphState, vq_train_epoch_dp, vq_train_epoch_sharded)
    from repro_torch.graph.batching import SamplerEpochPlan
    from repro_torch.models.gnn import sampler_train_epoch, vq_train_epoch
    cfg = _config(4)
    opt = _setup(4, torch.device("cpu"))["opt"]

    def sampler_args(dev):
        s = _setup(4, dev)
        # sampler baseline: S batches of P=16 padded subgraph rows, deg cap 8
        sp = SamplerEpochPlan(
            node_ids=torch.zeros((_S, _B), dtype=torch.int32, device=dev),
            nbr_ids=torch.zeros((_S, _B, 8), dtype=torch.int32, device=dev),
            nbr_mask=torch.zeros((_S, _B, 8), dtype=torch.float32,
                                 device=dev),
            degrees=torch.zeros((_S, _B), dtype=torch.float32, device=dev),
            loss_mask=torch.zeros((_S, _B), dtype=torch.float32, device=dev))
        return (s["params"], s["ost"], sp, s["x"], s["labels"])

    def sharded(mesh, params, vq, ost, plan, perm, smask, x, labels, tm,
                degrees):
        state = ShardedGraphState(mesh, plan, x, degrees, labels, tm)
        return vq_train_epoch_sharded(state, params, vq, ost, perm, smask,
                                      cfg, opt)

    return [
        Entry(name="vq_train_epoch", make=_epoch_args,
              call=lambda *a: vq_train_epoch(*a, cfg, opt), steps=_S),
        Entry(name="sampler_train_epoch", make=sampler_args,
              call=lambda *a: sampler_train_epoch(*a, cfg, opt), steps=_S),
        # the data-parallel and row-sharded executors split the batch axis
        # over the mesh; at one rank the shard is the whole table, as the
        # reference registers them at ndev 1
        Entry(name="vq_train_epoch_dp", make=_epoch_args,
              call=lambda mesh, *a: vq_train_epoch_dp(mesh, *a, cfg, opt),
              steps=_S, group=True),
        Entry(name="vq_train_epoch_sharded", make=_epoch_args, call=sharded,
              steps=_S, group=True),
    ]


@functools.lru_cache(maxsize=None)
def entries() -> tuple:
    """All registered entries (tuple: cached, iteration-stable)."""
    from repro_torch.kernels import ops as kops
    out = _train_entries()
    for tier in kops.PRECISIONS:
        out.append(_infer_entry(tier))
        out.append(_serve_entry(tier))
    # branch-count invariance probes: same dispatch-count contract must
    # hold at a different product-VQ width (f_prod=2 -> more branches)
    out.append(_infer_entry("fp32", f_prod=2))
    out.append(_serve_entry("int8+a4", f_prod=2))
    return tuple(out)


def pinned() -> tuple:
    """The entries with a pinned dispatch count."""
    return tuple(e for e in entries() if e.dispatch_count is not None)
