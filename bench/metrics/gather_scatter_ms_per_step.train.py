"""Device milliseconds a training step spends in index, gather and
scatter kernels (by the profiler's kernel names): the backbones' row
gathers and ``index_add_`` backward passes."""

NEEDLES = ("index", "gather", "scatter")


def read(r):
    t = r.trace
    s = sum(sec for name, (_, sec) in t.kernels.items()
            if any(n in name.lower() for n in NEEDLES))
    return s / (t.iterations * r.work["steps_per_iteration"]) * 1e3
