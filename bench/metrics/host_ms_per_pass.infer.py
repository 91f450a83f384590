"""Host milliseconds a whole-graph pass spends in ``vq_infer_epoch``: the
host clock around each call, before the pass's sync, over the untraced
window."""


def read(r):
    w = r.window
    return sum(w.call_s) / w.iterations * 1e3
