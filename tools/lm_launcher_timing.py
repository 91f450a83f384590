"""Time the LM training launcher (``repro_torch.launch.train``) on one
card, for one or more trees of the port in one call: each tree's launcher
runs in a subprocess of its own, with that tree's ``src/`` first on the
path, in the order given.

    python3 tools/lm_launcher_timing.py --src src --src parent/src \\
        [--src src --src parent/src] -- --arch llama3.2-3b --steps 12

Everything after ``--`` goes to the launcher as it is.  A step's time is
the wall time between two consecutive batches the launcher draws from the
token stream, the card synchronised at each (the whole iteration: the
batch's placement, the step, the every-10th-step loss print); the last
step ends when the launcher returns.  Each run prints one JSON line
``{"lm_launcher_timing": {"src", "step_ms", "p50_ms" (over the steps after
the first two), "max_memory_allocated", "wall_s"}}``; the card's name and
power limit come first.  Exits 1 without a card or if a run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WARMUP = 2          # steps left out of the p50


def _one(src: str, argv: list[str]) -> int:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    from repro_torch.launch import train
    marks: list[float] = []
    draw = train.batch_shard
    cuda = torch.cuda.is_available()

    def timed_draw(*a, **k):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return draw(*a, **k)

    train.batch_shard = timed_draw
    t0 = time.perf_counter()
    train.main(argv)
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(json.dumps({"lm_launcher_timing": {
        "src": src, "argv": argv, "step_ms": ms,
        "p50_ms": float(np.percentile(ms[WARMUP:], 50)) if len(ms) > WARMUP
        else None,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated())
        if cuda else None,
        "wall_s": time.perf_counter() - t0}}), flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if "--one" in args:
        i = args.index("--one")
        return _one(args[i + 1], args[args.index("--") + 1:])
    import torch
    if not torch.cuda.is_available():
        print("lm_launcher_timing: no CUDA card", file=sys.stderr)
        return 1
    cut = args.index("--") if "--" in args else len(args)
    srcs = [args[i + 1] for i in range(cut) if args[i] == "--src"]
    launcher = args[cut + 1:]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    rc = 0
    for src in srcs:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", src, "--", *launcher],
                           env=dict(os.environ, PYTHONPATH=""))
        rc = rc or r.returncode
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
