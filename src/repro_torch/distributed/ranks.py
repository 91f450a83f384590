"""Ranks as processes: the port's own spawner of a data mesh.

:func:`run_ranks` starts ``world_size`` processes (``torch.
multiprocessing``, spawn), joins them into one process group over a
``FileStore`` in a temporary directory, hands each rank its
:class:`~repro_torch.distributed.sharding.GraphMesh` and returns what
every rank's function returned, in rank order.  Every group has a
timeout on its collectives, and the parent waits at most the same
timeout for the ranks' results, so a deadlocked collective fails instead
of hanging; a rank that raises fails the call with its traceback, and
the other ranks are terminated.

The mesh is checked before any process starts
(:func:`~repro_torch.distributed.sharding.check_ranks`: more NCCL ranks
than cards raise, a card is shared only on an explicit ``share_device``
gloo group), and on a CUDA mesh the kernel library is built in the parent
first, so the ranks load it instead of each building it.

:func:`process_group` is the context that a rank (or a single process,
as a one-rank mesh) runs in.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (GraphMesh, check_ranks,
                                              graph_dp_mesh)

DEFAULT_TIMEOUT_S = 300.0


@contextmanager
def process_group(backend: str, world_size: int, rank: int, store_path: str,
                  *, device: str | torch.device = "cuda",
                  share_device: bool = False,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """Initialise this process's group over a ``FileStore`` at
    ``store_path`` (every rank passes the same path), yield its
    :class:`GraphMesh`, and destroy the group on the way out."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        yield graph_dp_mesh(world_size, device=device,
                            share_device=share_device)
    finally:
        dist.destroy_process_group()


@contextmanager
def sync_functional_collectives(device_type: str = "cuda"):
    """Within the context, route the functional collectives that DTensor
    issues (``torch.ops._c10d_functional``: all-gather, reduce-scatter,
    all-reduce, all-to-all, broadcast, and ``wait_tensor``) on
    ``device_type`` tensors through the synchronous ``torch.distributed``
    calls; torch's own implementations are back on the way out.  gloo
    carries every one of those calls on CUDA tensors, but its
    asynchronous functional collectives crash the process when waited on
    (``tools/gloo_cuda_probe.py``, torch 2.11), and a card shared by
    several ranks can only be a gloo group (NCCL wants a card a rank).
    Each collective then completes before it returns, so ``wait_tensor``
    returns its input.  Not reentrant."""
    import torch.distributed.distributed_c10d as c10d
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def group(name):
        return c10d._resolve_process_group(name)

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=group(group_name))
        return out

    def reduce_scatter(inp, reduce_op, group_size, group_name):
        out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
        op = reduce_op.lower()
        dist.reduce_scatter_tensor(out, inp.contiguous(),
                                   op=ops["sum" if op == "avg" else op],
                                   group=group(group_name))
        return out.div_(group_size) if op == "avg" else out

    def all_reduce_(inp, reduce_op, group_name):
        # gloo has no AVG: a sum, then divided by the group's size
        op, g = reduce_op.lower(), group(group_name)
        dist.all_reduce(inp, op=ops["sum" if op == "avg" else op], group=g)
        return inp.div_(g.size()) if op == "avg" else inp

    def all_reduce(inp, reduce_op, group_name):
        return all_reduce_(inp.clone(), reduce_op, group_name)

    def all_to_all(inp, out_splits, in_splits, group_name):
        rows = sum(out_splits) if out_splits else inp.shape[0]
        out = inp.new_empty((rows, *inp.shape[1:]))
        dist.all_to_all_single(out, inp.contiguous(),
                               list(out_splits) or None,
                               list(in_splits) or None,
                               group=group(group_name))
        return out

    def broadcast_(inp, src, group_name):
        g = group(group_name)
        dist.broadcast(inp, src=dist.get_global_rank(g, src), group=g)
        return inp

    def broadcast(inp, src, group_name):
        return broadcast_(inp.clone(), src, group_name)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (
            ("all_gather_into_tensor", all_gather),
            ("all_gather_into_tensor_coalesced",
             lambda xs, n, g: [all_gather(x, n, g) for x in xs]),
            ("reduce_scatter_tensor", reduce_scatter),
            ("reduce_scatter_tensor_coalesced",
             lambda xs, op, n, g: [reduce_scatter(x, op, n, g) for x in xs]),
            ("all_reduce", all_reduce), ("all_reduce_", all_reduce_),
            ("all_reduce_coalesced",
             lambda xs, op, g: [all_reduce(x, op, g) for x in xs]),
            ("all_to_all_single", all_to_all),
            ("broadcast", broadcast), ("broadcast_", broadcast_),
            ("wait_tensor", lambda t: t)):
        lib.impl(name, fn, key)
    try:
        yield
    finally:
        lib._destroy()             # torch's kernels take over again


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               share_device: bool, store_path: str, timeout_s: float,
               threads: int, fn: Callable, args: tuple, results) -> None:
    torch.set_num_threads(threads)
    try:
        with process_group(backend, world_size, rank, store_path,
                           device=device, share_device=share_device,
                           timeout_s=timeout_s) as mesh:
            out = fn(mesh, *args)
        results.put((rank, True, out))
    except Exception:                 # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def default_backend(device: str | torch.device,
                    share_device: bool = False) -> str:
    """The group's backend for ``device``: NCCL on the card, gloo on the
    CPU and for ranks that share one card (NCCL wants a card a rank)."""
    return "nccl" if torch.device(device).type == "cuda" \
        and not share_device else "gloo"


def run_ranks(fn: Callable[..., Any], world_size: int,
              backend: str | None = None,
              device: str | torch.device = "cuda", *args,
              share_device: bool = False,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              threads: int = 1) -> list[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes joined in one
    ``backend`` group (default :func:`default_backend`), each rank on
    ``device`` -- the card unless the caller asks for ``"cpu"``: its own
    card on NCCL, the one card with ``share_device`` -- and return their
    results in rank order.  ``fn`` and ``args`` are pickled (``fn`` by
    its import path); results come back pickled, so return numpy arrays
    or plain Python.
    Each rank runs ``threads`` intra-op threads.  Raises when a rank
    raises, exits without a result or misses ``timeout_s``."""
    if backend is None:
        backend = default_backend(device, share_device)
    check_ranks(world_size, backend, device, share_device)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(rank, world_size, backend, str(device), share_device,
                  os.path.join(tmp, "store"), timeout_s, threads, fn, args,
                  results)) for rank in range(world_size)]
        try:
            for p in procs:
                p.start()
            got: dict[int, Any] = {}
            deadline = time.monotonic() + timeout_s
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"gave no result within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"rank {r} exited with code {p.exitcode} "
                                f"and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            return [got[r] for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=10)
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=10)
            results.close()
