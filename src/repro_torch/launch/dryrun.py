"""Fake-rank dry-run: trace every (arch x shape) cell on the production
meshes, one rank's part of it, and count what that rank executes (twin of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \
        --shape train_4k [--multi-pod] [--layers 2] [--vq] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell on 256 / 512 virtual XLA CPU
devices.  Here the process joins a fake process group of 256 / 512 ranks
as rank 0 (``torch.distributed``'s "fake" backend: collectives return at
once, their results' values meaningless) and runs the cell's step once
under a ``FakeTensorMode``, so nothing is allocated and no value is
computed; the inputs are DTensors placed by the sharding rules
(``distributed/sharding.py``) from ``launch/input_specs.py``.  The ranks
are CPU ranks, as the reference's devices are CPU devices, so the kernels'
plain versions are what is traced, as the reference lowers its oracles
there; nothing touches a card.

Per cell it writes ``<out>/<cell>.json`` with the reference's keys:
  * ``cost``: ``flops`` (the matmul-class ops this rank executes, by
    ``torch.utils.flop_counter``'s formulas on their local shapes),
    ``bytes accessed`` (each executed op's tensor operands and results,
    views excluded) and ``transcendentals`` (elements out of exp, log,
    tanh, sigmoid, sin, cos, sqrt, rsqrt, pow, erf, softmax, logsumexp,
    silu and gelu);
  * ``collectives``: ``bytes`` and ``counts`` by kind under the
    reference's names (each collective's result bytes, as the reference
    counts its HLO ops' output shapes), and ``by_axis``, the same split
    by the mesh axis whose group carried it.  Every executed collective
    counts, so there is no entry / loop split and no trip correction
    (``trip_hints`` are recorded for the record only).  On a CPU group
    DTensor issues an all-to-all as an all-gather and a chunk;
  * ``memory``: ``argument_bytes`` (the local shards of every input),
    ``output_bytes`` (the local shards of the results), ``peak_bytes``
    (``torch.distributed._tools.MemTracker`` over the step, arguments
    included), ``temp_bytes`` (peak less arguments) and
    ``generated_code_bytes`` (0: nothing is compiled);
  * ``trace_s`` in place of ``lower_s`` / ``compile_s``.
The reference's HLO parsing (``collective_bytes``, ``_shape_bytes``) has
no counterpart: there is no HLO.  ``--layers`` cuts the depth (the cell
name gains ``__l<N>``).  Every op is traced through DTensor's Python
dispatch, so a cell's time grows with its op count: xlstm's sLSTM steps
one token at a time (prefill_32k at 2 layers: ~12 min).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import sharding as shd
from repro_torch.launch.input_specs import arch_for_cell, cell_specs
from repro_torch.launch.mesh import PRODUCTION, axis_names
from repro_torch.launch.train import on_mesh
from repro_torch.models import lm
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import adam

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "sin", "cos", "sqrt", "rsqrt", "pow", "erf",
                   "_softmax", "_log_softmax", "logsumexp", "silu", "gelu"}

# fit-constrained gradient accumulation of the train cells (the
# reference's table)
ACCUM = {"llama3-405b": 16, "qwen3-32b": 8, "qwen3-moe-30b-a3b": 8,
         "granite-3-8b": 8, "zamba2-2.7b": 8, "llama3.2-3b": 8,
         "xlstm-350m": 8, "phi3.5-moe-42b-a6.6b": 8}


def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (an initialised group of another size or backend is destroyed
    first)."""
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                str(dist.get_backend()) == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x: Any) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class RankCounter(TorchDispatchMode):
    """Counts what one rank executes: an op on DTensors is handed back to
    DTensor (``NotImplemented``), which runs it as local ops and
    collectives that come back here, so every count is of local shapes.
    ``groups`` maps a process group's name to its mesh axis.  DTensor
    infers an op's output shapes by running it once on fake tensors of
    the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``); while the counter is entered
    that method is wrapped, and the ops it runs are not counted."""

    def __init__(self, groups: dict[str, str]):
        super().__init__()
        self.in_meta = 0
        self._saved = None
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.groups = groups
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.coll_bytes: dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll_counts: dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.by_axis: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.in_meta:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = _KIND.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors(out))
                group = [a for a in list(args) + list(kwargs.values())
                         if isinstance(a, str)][-1]
                axis = self.groups.get(group, group)
                self.coll_bytes[kind] += b
                self.coll_counts[kind] += 1
                per = self.by_axis.setdefault(axis, {})
                per[kind] = per.get(kind, 0) + b
            return out
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors(list(args)) + _tensors(out))
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is not None:
            def meta(prop, *a, **kw):
                self.in_meta += 1
                try:
                    return orig(prop, *a, **kw)
                finally:
                    self.in_meta -= 1
            self._saved = (ShardingPropagator, name, orig)
            setattr(ShardingPropagator, name, meta)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._saved is not None:
            setattr(*self._saved)
            self._saved = None
        return super().__exit__(*exc)


def trip_hints(cfg: ArchConfig, sh: dict, arch: str) -> dict:
    """The reference's static trip counts of the cell's scans, recorded
    beside the counts (which need no correction: every executed op is
    counted)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        layer_trips = cfg.n_layers
    elif fam == "audio":
        layer_trips = cfg.n_layers + cfg.enc_layers
    elif fam == "ssm":
        layer_trips = cfg.n_layers // 2
    else:
        layer_trips = cfg.n_layers
    accum = ACCUM.get(arch, 4) if sh["kind"] == "train" else 1
    inner = 1
    if sh["kind"] in ("train", "prefill"):
        if cfg.vq_attn:
            inner = max(1, sh["seq_len"] // cfg.vq_window)
        else:
            inner = max(1, sh["seq_len"] // 1024)
    return {"layer_trips": layer_trips, "accum": accum,
            "inner_attn_trips": inner}


def _local_bytes(tree: Any) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for _, t in shd.leaf_paths(tree))


def spec_bytes(tree: Any, shardings: Any) -> int:
    """Bytes of one rank's shards of ``tree``, from the specs alone."""
    sh = dict(shd.leaf_paths(shardings)) \
        if not isinstance(shardings, shd.NamedSharding) else None
    total = 0
    for path, t in shd.leaf_paths(tree):
        s = shardings if sh is None else sh[path]
        n = 1
        for d in shd.shard_shape(tuple(t.shape), s.spec, s.mesh):
            n *= d
        total += n * t.element_size()
    return total


def _cell_inputs(cfg: ArchConfig, kind: str, b: int, s: int, mesh,
                 strategy: str, mode) -> tuple[list, list]:
    """(the step's arguments, their shardings) for the cell."""
    specs = cell_specs(cfg, kind, b, s, mode)
    tok_sh = shd.token_sharding(b, mesh, cfg, strategy)
    if kind == "train":
        st = specs["state"]
        psh = shd.param_shardings(st.params, cfg, mesh, strategy)
        state_sh = type(st)(
            params=psh,
            opt=type(st.opt)(step=shd.replicated(mesh),
                             mu=shd.param_shardings(st.opt.mu, cfg, mesh,
                                                    strategy),
                             nu=shd.param_shardings(st.opt.nu, cfg, mesh,
                                                    strategy)),
            step=shd.replicated(mesh))
        args, shs = [st, specs["tokens"]], [state_sh, tok_sh]
    elif kind == "prefill":
        args = [specs["params"], specs["tokens"]]
        shs = [shd.param_shardings(specs["params"], cfg, mesh, strategy),
               tok_sh]
    else:
        args = [specs["params"], specs["token"], specs["cache"]]
        shs = [shd.param_shardings(specs["params"], cfg, mesh, strategy),
               tok_sh, shd.cache_shardings(specs["cache"], cfg, mesh, b, s)]
    if "aux_embeds" in specs:
        args.append(specs["aux_embeds"])
        shs.append(tok_sh)
    return args, shs


def trace_step(cfg: ArchConfig, kind: str, batch: int, seq: int,
               dims: tuple[int, ...], names: tuple[str, ...], *,
               accum: int = 1, strategy: Optional[str] = None) -> dict:
    """Run one step of a cell -- ``kind`` "train" (``make_train_step``
    with bf16 Adam moments and bf16 accumulation over ``accum``
    microbatches), "prefill" or "decode" at [batch, seq] -- as rank 0 of
    a fake group over a ``dims`` mesh of axes ``names``, under a
    ``FakeTensorMode``; returns the strategy and the counts (module
    docstring).  ``strategy`` overrides ``strategy_for``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh
    world = 1
    for n in dims:
        world *= n
    fake_group(world)
    mesh = init_device_mesh("cpu", tuple(dims), mesh_dim_names=tuple(names))
    strategy = strategy or shd.strategy_for(cfg, mesh)
    mode = FakeTensorMode()
    groups = {mesh.get_group(a).group_name: a for a in axis_names(mesh)}
    counter = RankCounter(groups)
    with mode, on_mesh(mesh, cfg, strategy, batch):
        args, shs = _cell_inputs(cfg, kind, batch, seq, mesh, strategy,
                                 mode)
        want_args = sum(spec_bytes(a, s) for a, s in zip(args, shs))
        placed = [shd.distribute(a, s) for a, s in zip(args, shs)]
        arg_bytes = sum(_local_bytes(a) for a in placed)
        if kind == "train":
            opt = adam(moment_dtype=torch.bfloat16)
            step = make_train_step(cfg, opt, accum=accum,
                                   accum_dtype=torch.bfloat16)

            def fn():
                return step(*placed)
        elif kind == "prefill":
            def fn():
                with torch.no_grad():
                    return lm.prefill(placed[0], placed[1], cfg,
                                      *placed[2:])
        else:
            def fn():
                with torch.no_grad():
                    return lm.serve_step(*placed, cfg)
        tracker = MemTracker()
        tracker.track_external(*[t.to_local() for a in placed
                                 for _, t in shd.leaf_paths(a)])
        t0 = time.time()
        with tracker, counter:
            out = fn()
        trace_s = time.time() - t0
        peak = sum(v.get("Total", 0) for v in
                   tracker.get_tracker_snapshot("peak").values())
        out_bytes = _local_bytes(out)
    return {
        "strategy": strategy, "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": arg_bytes,
                   "spec_argument_bytes": want_args,
                   "output_bytes": out_bytes,
                   "temp_bytes": max(0, peak - arg_bytes),
                   "peak_bytes": peak,
                   "generated_code_bytes": 0},
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes_accessed),
                 "transcendentals": float(counter.transcendentals)},
        "collectives": {"bytes": counter.coll_bytes,
                        "counts": counter.coll_counts,
                        "by_axis": counter.by_axis}}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, force_vq: bool = False,
             layers: Optional[int] = None) -> dict:
    """Trace one cell on a fake group of 256 (512) ranks; returns (and,
    with ``out_dir``, writes) its JSON record."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (
        "__vq" if force_vq else "") + (f"__l{layers}" if layers else "")
    t_start = time.time()
    base_cfg = ARCHS[arch]
    if force_vq:
        base_cfg = base_cfg.with_vq()
    if layers:
        base_cfg = dataclasses.replace(base_cfg, n_layers=layers)
    cfg = arch_for_cell(base_cfg, shape_name)
    sh = SHAPES[shape_name]
    dims, names = PRODUCTION[multi_pod]
    got = trace_step(cfg, sh["kind"], sh["global_batch"], sh["seq_len"],
                     dims, names, accum=ACCUM.get(arch, 4)
                     if sh["kind"] == "train" else 1)
    result = {
        "cell": cell_id, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "strategy": got.pop("strategy"),
        "kind": sh["kind"], "seq_len": sh["seq_len"],
        "global_batch": sh["global_batch"],
        "vq_attn": cfg.vq_attn, "n_layers": cfg.n_layers,
        "param_count": cfg.param_count(),
        "trip_hints": trip_hints(cfg, sh, arch), **got,
        "wall_s": round(time.time() - t_start, 1)}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--vq", action="store_true",
                    help="force VQ-Attention for the cell (perf variants)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                cell = f"{arch}__{shape_name}__{mesh_name}"
                path = os.path.join(args.out, cell + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {cell}")
                    continue
                try:
                    r = run_cell(arch, shape_name, mp, args.out,
                                 force_vq=args.vq, layers=args.layers)
                    print(f"[ok]   {r['cell']}  "
                          f"flops={r['cost']['flops']:.3e} "
                          f"peak={r['memory']['peak_bytes']/2**30:.2f}GiB "
                          f"trace={r['trace_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 -- a cell's failure
                    failures.append((cell, repr(e)))
                    print(f"[FAIL] {cell}: {e}")
                    traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for c, e in failures:
            print(" ", c, e)
        return 1
    print("\nall cells traced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
