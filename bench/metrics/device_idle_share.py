"""Share of the traced window in which no operation ran on the device
(the profiler's kernels, copies and fills, overlaps counted once)."""


def read(r):
    t = r.trace
    return (1.0 - t.busy_s / t.window_s) * 100
