"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``bench/configs/<config>.json``: the configuration as it is run;
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters, among
  them ``driver``, the module under ``bench/drivers/`` that sets the cell
  up, runs its window, traces it and checks its outputs;
* ``bench/metrics/<metric>.py``: a per-layer metric's reader
  ``read(reading) -> float | None`` (None where it finds nothing to read;
  its unit, layer and cells are ``BENCHMARK.json``'s); a metric split by
  the end-to-end metric it moves (``step_mfu.train``, ``step_mfu.infer``)
  may share one reader, ``bench/metrics/<name before the first dot>.py``;
* ``bench/limits/<workload>.json``: the limit of each number the cell's
  correctness check compares.

A run: set-up (the driver's), then the measured window of ``--seconds``
(end-to-end metrics), with ``--trace 1`` also a profiled window (per-layer
metrics), then the correctness check against the plain reference.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from bench import shapes as shp
from bench import trace as tracing

# top-level module names the timed process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A run that cannot start: unknown names, missing files."""


class Spec:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise BenchError(f"no BENCHMARK.json in {self.root}")
        self.data = json.loads(path.read_text())

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.data[kind]:
            if e["name"] == name:
                return e
        known = ", ".join(e["name"] for e in self.data[kind])
        raise BenchError(f"unknown {kind[:-1]} {name!r}; BENCHMARK.json "
                         f"has: {known}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return self._json(self._entry("configs", name)["file"])

    def _json(self, rel: str) -> dict:
        path = self.root / rel
        if not path.exists():
            raise BenchError(f"missing file {rel}")
        return json.loads(path.read_text())

    def traffic(self, name: str) -> dict:
        return self._json(f"bench/traffic/{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json(f"bench/limits/{workload}.json")

    def module(self, rel: str):
        path = self.root / rel
        if not path.exists():
            raise BenchError(f"missing file {rel}")
        name = "bench_" + rel.replace("/", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self.module(f"bench/drivers/{name}.py")

    def reader(self, metric: str):
        """A per-layer metric's reader: ``bench/metrics/<metric>.py``, or
        the one its split shares, ``<metric before the first dot>.py``."""
        rel = f"bench/metrics/{metric}.py"
        if not (self.root / rel).exists():
            rel = f"bench/metrics/{metric.split('.')[0]}.py"
        return self.module(rel)

    def _applies(self, metric: dict, workload: str) -> bool:
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if self._applies(m, workload)]

    def per_layer(self, workload: str) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if self._applies(m, workload) and m["moves"] in e2e]


class Context(NamedTuple):
    """What a driver gets: the cell, its configuration and traffic, the
    run's seed and device, and the configuration's layer shapes."""
    workload: str
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    shapes: list


class Window(NamedTuple):
    """A driver's measured window."""
    metrics: dict          # end-to-end metric -> value
    attempted: int         # steps or passes run
    failed: int            # of them, those whose output is not finite
    seconds: float         # the window's length
    iterations: int        # calls of the program's entry
    call_s: list           # host seconds of each call, before its sync
    steps_per_call: int


class Reading(NamedTuple):
    """What a per-layer metric reads."""
    trace: tracing.Trace
    window: Window
    work: dict             # the driver's least times and model FLOPs


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(state: dict, *keys: str) -> None:
    """Drop the program's objects from a driver's state and return their
    device memory, before the reference runs."""
    for key in keys:
        state.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t0: float,
             chips: int = 1) -> tuple[dict, dict]:
    """One run of a cell: (result line, compared numbers)."""
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(traffic["driver"])
    limits = spec.limits(workload)
    e2e = spec.end_to_end(workload)
    layer_metrics = [(m, spec.reader(m["name"]))
                     for m in spec.per_layer(workload)] if traced else []
    ctx = Context(workload, cfg, traffic, seed, device, shp.layers(cfg))

    state = driver.setup(ctx)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    win = driver.window(ctx, state, seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    values = {"setup_s": setup_s, "peak_device_gb": peak / 1e9,
              **win.metrics}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": chips, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed}
    if traced:
        tr = tracing.profile(lambda i: driver.trace_iteration(ctx, state, i),
                             traffic["trace_iterations"], device)
        reading = Reading(tr, win, driver.work(ctx, state))
        metrics = {}
        for m, mod in layer_metrics:
            v = mod.read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise BenchError(f"{workload}: the driver measured no "
                             f"{', '.join(missing)}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    result.update(metrics=metrics, device=dev)
    if traced:
        result["breakdown"] = tr.breakdown()

    readings = driver.check(ctx, state)
    del state
    gc.collect()
    if set(readings) != set(limits):
        raise BenchError(f"{workload}: the check compares "
                         f"{sorted(readings)}, bench/limits holds "
                         f"{sorted(limits)}")
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    result["correct"] = win.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result, checks


def _args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], root: Path, t0: float,
         device: Optional[str] = None) -> int:
    args = _args(argv)
    try:
        spec = Spec(root)
        chips = spec.workload(args.workload)["chips"]
    except BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"bench: {args.workload} needs {chips} CUDA device(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = "cuda"
    sys.path.insert(0, str(Path(root) / "src"))
    try:
        result, checks = run_cell(spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device(device), t0, chips)
    except BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
