"""Readings for the correctness limits of a cell, over many seeds in one
process: for each seed the program's set-up (and for inference a short
window), then the driver's ``calibrate``: the program, the control and
the planted faults, each against the float32 reference.  One JSON line a
seed on standard output.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 [--seconds 2]
        [--faults N]     (the planted faults on the first N seeds only)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=1 << 30)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness, shapes
    spec = harness.Spec(ROOT)
    cell = spec.workload(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(traffic["driver"])
    dev = torch.device("cuda")
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, cfg, traffic, seed, dev,
                              shapes.layers(cfg))
        state = driver.setup(ctx)
        driver.window(ctx, state, args.seconds)
        out = driver.calibrate(ctx, state, faults=i < args.faults)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
        del state
        harness.free({})
    return 0


if __name__ == "__main__":
    sys.exit(main())
