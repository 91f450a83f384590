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
