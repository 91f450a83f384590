"""The traced window: ``torch.profiler`` over a fixed number of
iterations, reduced to what the per-layer metrics read.

* ``kernels``: device time and launches by kernel name;
* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills), so overlapping operations count once;
* ``gaps``: the device's idle intervals, each named by the innermost host
  operation running at its midpoint (a CUDA runtime call only where no
  other operation covers it).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, NamedTuple

import torch


class Trace(NamedTuple):
    iterations: int
    window_s: float
    busy_s: float
    kernels: dict          # name -> (launches, device seconds)
    gaps: dict             # host operation -> idle device seconds

    def device_s(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any needle."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(n in name for n in needles))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, s] for name, (_, s) in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_ops_at(cpu: list, times: list[float]) -> list[str]:
    """The innermost host operation covering each of the ascending
    ``times`` (µs), by one sweep over the host events."""
    evs = sorted(cpu, key=lambda e: e.time_range.start)
    active, out, j = [], [], 0
    for t in times:
        while j < len(evs) and evs[j].time_range.start <= t:
            active.append(evs[j])
            j += 1
        active = [e for e in active if e.time_range.end >= t]
        named = [e for e in active if not e.name.startswith("cuda")] \
            or active
        out.append(min(named, key=lambda e: e.time_range.elapsed_us()).name
                   if named else "(no host operation)")
    return out


def profile(run: Callable[[int], None], iterations: int,
            device: torch.device) -> Trace:
    """Profile ``run(i)`` for i in range(iterations), ending in a device
    synchronisation.  On a CPU (the harness's own tests) the top-level
    host operations stand in for the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(iterations):
            run(i)
        if cuda:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events
           if (e.device_type == DeviceType.CUDA if cuda
               else e.cpu_parent is None)
           and e.time_range.end > e.time_range.start]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += e.time_range.elapsed_us() * 1e-6
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    idle = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    gaps: dict = defaultdict(float)
    for (a, b), name in zip(idle, _host_ops_at(cpu, [(a + b) / 2
                                                     for a, b in idle])):
        gaps[name] += (b - a) * 1e-6
    return Trace(iterations, window,
                 sum(b - a for a, b in busy) * 1e-6,
                 {k: tuple(v) for k, v in kernels.items()}, dict(gaps))
