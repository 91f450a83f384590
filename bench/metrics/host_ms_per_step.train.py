"""Host milliseconds a training step spends in ``vq_train_epoch``: the
host clock around each call, before the epoch's sync, over the steps of
the untraced window."""


def read(r):
    w = r.window
    return sum(w.call_s) / (w.iterations * w.steps_per_call) * 1e3
