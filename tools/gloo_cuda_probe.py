#!/usr/bin/env python3
"""Which collectives the installed gloo carries on CUDA tensors.

    python3 tools/gloo_cuda_probe.py

Two ranks on card 0 joined in a gloo group (``share_device=True``, as
``chip_smoke.py``'s mesh phase runs them) call ``torch.distributed``'s
SUM and MAX all-reduce, broadcast and all-gather directly on CUDA tensors
of every dtype that ``repro_torch.distributed.collectives`` moves
(float32, int32, int64, uint8; a 0-d float32 for the all-reduced
denominators), and check the values that come back.  Each result is
``ok``, ``wrong`` (the call returned other values) or ``refused: <the
error's first line>``; a refused call on gloo raises before it
communicates, and the ranks meet at a CPU barrier after every call.
Then, where both forms are carried, it times a float32 SUM all-reduce
and an all-gather of 1 M and 6 M elements (4 and 24 MB a rank; the
revival gather of a full-width step moves ~6 M a rank a layer) on the
CUDA tensor itself and staged (copied to the host, reduced or gathered
there, copied back), the median of 5 after one warm-up, each synchronised
on the host clock.  Prints the card's name and power limit and one
``{"gloo_cuda_probe": ...}`` line; exits 1 without a card or if the
ranks disagree.  ``repro_torch.distributed.collectives`` calls every
operation on the CUDA tensor itself, by this probe's result.

Then the collectives that DTensor issues for the LM mesh (``launch/
train.py``'s sharded step): ``all_gather_into_tensor``,
``reduce_scatter_tensor`` (SUM), ``all_to_all_single`` and ``scatter``
on float32 / bfloat16 CUDA tensors, and DTensor's own redistributions on
a 2-rank 1-D mesh of the card (Shard -> Replicate, Partial -> Shard,
Partial -> Replicate, Shard(0) -> Shard(1), ``distribute_tensor`` from
rank 0), each ``ok``, ``wrong`` or ``refused: ...`` as above.  Each
rank writes its results before and after every call, so a call that
kills a rank (a crash in the backend) stays in the line as ``crashed``,
the spawner's message under ``crashed``; the exit code is then 1.  On
torch 2.11 the redistributions crash (gloo's asynchronous functional
collectives on CUDA tensors); ``--sync-funcol`` first routes them through
the synchronous calls (``distributed.ranks.sync_functional_collectives``,
the context that the LM mesh's ranks sharing a card run in).

    python3 tools/gloo_cuda_probe.py [--sync-funcol]
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DTYPES = ("float32", "int32", "int64", "uint8")
OPS = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather")
DTENSOR_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "scatter")
DTENSOR_DTYPES = ("float32", "bfloat16")


def _call(op: str, dtype: str, shape: tuple, mesh) -> str:
    import torch
    import torch.distributed as dist
    dt = getattr(torch, dtype)
    t = torch.full(shape, mesh.rank + 1, dtype=dt, device=mesh.device)
    try:
        if op == "all_reduce_sum":
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
            want = [torch.full(shape, 3, dtype=dt)]
            got = [t]
        elif op == "all_reduce_max":
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
            want = [torch.full(shape, 2, dtype=dt)]
            got = [t]
        elif op == "broadcast":
            dist.broadcast(t, src=0, group=mesh.group)
            want = [torch.full(shape, 1, dtype=dt)]
            got = [t]
        else:
            got = [torch.empty_like(t) for _ in range(mesh.world_size)]
            dist.all_gather(got, t, group=mesh.group)
            want = [torch.full(shape, r + 1, dtype=dt)
                    for r in range(mesh.world_size)]
        torch.cuda.synchronize(mesh.device)
        ok = all(g.is_cuda and torch.equal(g.cpu(), w)
                 for g, w in zip(got, want))
        return "ok" if ok else "wrong"
    except Exception as e:             # the probe's result, not a failure
        return "refused: " + (str(e).strip().splitlines() or [""])[0][:200]
    finally:
        dist.barrier(group=mesh.group)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dtensor_call(op: str, dtype: str, mesh) -> str:
    """One of the tensor collectives DTensor's redistributions use, on a
    [2 * world, 8] CUDA tensor of ``dtype``."""
    import torch
    import torch.distributed as dist
    dt = getattr(torch, dtype)
    w, r = mesh.world_size, mesh.rank
    dev = mesh.device
    try:
        if op == "all_gather_into_tensor":
            src = torch.full((2, 8), r + 1, dtype=dt, device=dev)
            got = torch.empty((2 * w, 8), dtype=dt, device=dev)
            dist.all_gather_into_tensor(got, src, group=mesh.group)
            want = torch.cat([torch.full((2, 8), i + 1, dtype=dt)
                              for i in range(w)])
        elif op == "reduce_scatter_tensor":
            src = torch.arange(2 * w * 8, device=dev).reshape(
                2 * w, 8).to(dt) + r
            got = torch.empty((2, 8), dtype=dt, device=dev)
            dist.reduce_scatter_tensor(got, src, group=mesh.group)
            full = sum(torch.arange(2 * w * 8).reshape(2 * w, 8).to(dt) + i
                       for i in range(w))
            want = full[2 * r:2 * r + 2]
        elif op == "all_to_all_single":
            src = torch.full((2 * w, 8), r + 1, dtype=dt, device=dev) \
                * (torch.arange(2 * w, device=dev)[:, None] // 2 + 1).to(dt)
            got = torch.empty_like(src)
            dist.all_to_all_single(got, src, group=mesh.group)
            want = torch.cat([torch.full((2, 8), (i + 1) * (r + 1),
                                         dtype=dt) for i in range(w)])
        else:
            got = torch.empty((2, 8), dtype=dt, device=dev)
            parts = [torch.full((2, 8), i + 1, dtype=dt, device=dev)
                     for i in range(w)] if r == 0 else None
            dist.scatter(got, parts, src=0, group=mesh.group)
            want = torch.full((2, 8), r + 1, dtype=dt)
        _sync(dev)
        return "ok" if got.device == dev and torch.equal(got.cpu(), want) \
            else "wrong"
    except Exception as e:             # the probe's result, not a failure
        return "refused: " + (str(e).strip().splitlines() or [""])[0][:200]
    finally:
        dist.barrier(group=mesh.group)


def _redistributions(mesh) -> dict:
    """DTensor's redistributions on a 1-D mesh of the ranks (the card
    shared), each checked against the whole tensor."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    w, r = mesh.world_size, mesh.rank
    dm = init_device_mesh(mesh.device.type, (w,), mesh_dim_names=("data",))
    full = torch.arange(4 * w * 6, dtype=torch.float32).reshape(4 * w, 6)
    cases = {
        "distribute_tensor from rank 0": lambda: distribute_tensor(
            full.to(mesh.device), dm, [Shard(0)]),
        "shard -> replicate": lambda: distribute_tensor(
            full.to(mesh.device), dm, [Shard(0)],
            src_data_rank=None).redistribute(dm, [Replicate()]),
        "shard(0) -> shard(1)": lambda: distribute_tensor(
            full.to(mesh.device), dm, [Shard(0)],
            src_data_rank=None).redistribute(dm, [Shard(1)]),
        "partial -> shard": lambda: DTensor.from_local(
            full.to(mesh.device) / w, dm, [Partial()]).redistribute(
            dm, [Shard(0)]),
        "partial -> replicate": lambda: DTensor.from_local(
            full.to(mesh.device) / w, dm, [Partial()]).redistribute(
            dm, [Replicate()]),
    }
    res = {}
    for name, make in cases.items():
        try:
            got = make().full_tensor()
            _sync(mesh.device)
            res[name] = "ok" if got.device == mesh.device and \
                torch.allclose(got.cpu(), full) else "wrong"
        except Exception as e:         # the probe's result, not a failure
            res[name] = "refused: " + (str(e).strip().splitlines()
                                       or [""])[0][:200]
        finally:
            dist.barrier(group=mesh.group)
    return res


def _time(op: str, numel: int, staged: bool, mesh) -> float:
    import time
    import torch
    import torch.distributed as dist
    t = torch.full((numel,), float(mesh.rank + 1), device=mesh.device)
    times = []
    for _ in range(6):
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        src = t.cpu() if staged else t
        if op == "all_reduce_sum":
            dist.all_reduce(src, group=mesh.group)
            out = src
        else:
            parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
            dist.all_gather(parts, src, group=mesh.group)
            out = torch.stack(parts)
        if staged:
            out = out.to(mesh.device)
        torch.cuda.synchronize(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[2]


def _rank(rank: int, store: str, out_dir: str, sync: bool) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import ranks
    faulthandler.enable()
    torch.set_num_threads(1)
    res = {}
    path = os.path.join(out_dir, f"{rank}.json")

    def record(key: str, fn, *args) -> None:
        # written before and after each call: a call that kills the process
        # stays in the file as "crashed"
        res[key] = "crashed"
        with open(path, "w") as f:
            json.dump(res, f)
        res[key] = fn(*args)
        with open(path, "w") as f:
            json.dump(res, f)

    # DTensor's collectives routed through the synchronous calls only
    # when ``sync`` asks for it
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    mesh = ranks.graph_dp_mesh(2, device="cuda", share_device=True)
    try:
        with ranks.sync_functional_collectives("cuda") if sync \
                else contextlib.nullcontext():
            for op in OPS:
                for dtype in DTYPES:
                    record(f"{op}/{dtype}", _call, op, dtype, (1000,), mesh)
            record("all_reduce_sum/float32 0-d", _call, "all_reduce_sum",
                   "float32", (), mesh)
            for op in DTENSOR_OPS:
                for dtype in DTENSOR_DTYPES:
                    record(f"{op}/{dtype}", _dtensor_call, op, dtype, mesh)
            record("dtensor redistributions", _redistributions, mesh)
            for op in ("all_reduce_sum", "all_gather"):
                if res[f"{op}/float32"] != "ok":
                    continue
                for numel in (1 << 20, 6 << 20):
                    for staged in (False, True):
                        record(f"ms {op} {numel} "
                               f"{'staged' if staged else 'cuda'}", _time, op,
                               numel, staged, mesh)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import argparse

    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sync-funcol", action="store_true",
                    help="route DTensor's functional collectives through "
                         "the synchronous calls first, as the port's ranks "
                         "that share a card do")
    sync = ap.parse_args().sync_funcol
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    crashed = None
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        try:
            mp.spawn(_rank, args=(os.path.join(tmp, "store"), tmp, sync),
                     nprocs=2, join=True)
        except mp.ProcessExitedException as e:
            crashed = str(e)
        res = [json.load(open(os.path.join(tmp, f"{r}.json")))
               if os.path.exists(os.path.join(tmp, f"{r}.json")) else {}
               for r in range(2)]
    calls = [{k: v for k, v in r.items() if not k.startswith("ms ")}
             for r in res]
    agree = calls[0] == calls[1]
    print(json.dumps({"gloo_cuda_probe": {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": card, "rank0": res[0], "rank1": res[1],
        "ranks_agree": agree, "crashed": crashed,
        "sync_funcol": sync}}), flush=True)
    return 0 if agree and crashed is None else 1


if __name__ == "__main__":
    sys.exit(main())
