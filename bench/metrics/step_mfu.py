"""The whole step's (or whole-graph pass's) share of the chip's peak:
its model FLOPs (``bench/roofline.py`` and each backbone's
``layer_flops``: GEMMs, aggregation, the injection, the VQ distance
products; the backward once) over 165 TFLOP/s (3xTF32) times the
untraced window's time an iteration."""

from bench.roofline import PRODUCT_FLOPS


def read(r):
    w = r.window
    per_iter = w.seconds / w.iterations
    return r.work["model_flops_per_iteration"] / (PRODUCT_FLOPS * per_iter) \
        * 100
