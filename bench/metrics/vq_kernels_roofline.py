"""The VQ kernels' share of their roofline: the least time of their
traced launches (``bench/roofline.py``: the distance products at
3xTF32, inputs read and outputs written once) over the device time of
the kernels the driver names (``vq_kernels``: the update kernels in
training, the assignment kernels in inference)."""


def read(r):
    dev = r.trace.device_s(*r.work["vq_kernels"])
    return r.work["vq_least_s"] / dev * 100 if dev > 0 else None
