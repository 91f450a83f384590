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
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DTYPES = ("float32", "int32", "int64", "uint8")
OPS = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather")


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


def _rank(rank: int, store: str, out_dir: str) -> None:
    import torch
    from repro_torch.distributed.ranks import process_group
    torch.set_num_threads(1)
    res = {}
    with process_group("gloo", 2, rank, store, device="cuda",
                       share_device=True, timeout_s=60) as mesh:
        for op in OPS:
            for dtype in DTYPES:
                res[f"{op}/{dtype}"] = _call(op, dtype, (1000,), mesh)
        res["all_reduce_sum/float32 0-d"] = _call("all_reduce_sum",
                                                  "float32", (), mesh)
        for op in ("all_reduce_sum", "all_gather"):
            if res[f"{op}/float32"] != "ok":
                continue
            for numel in (1 << 20, 6 << 20):
                for staged in (False, True):
                    res[f"ms {op} {numel} {'staged' if staged else 'cuda'}"] \
                        = _time(op, numel, staged, mesh)
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), tmp), nprocs=2,
                 join=True)
        res = [json.load(open(os.path.join(tmp, f"{r}.json")))
               for r in range(2)]
    calls = [{k: v for k, v in r.items() if not k.startswith("ms ")}
             for r in res]
    agree = calls[0] == calls[1]
    print(json.dumps({"gloo_cuda_probe": {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": card, "rank0": res[0], "rank1": res[1],
        "ranks_agree": agree}}), flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
