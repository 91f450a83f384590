"""Named counters and the dispatch recorder.

A :class:`TraceCounter` is a plain dict of named counters with snapshot /
delta helpers, as in the reference.  The reference also keeps
``INFER_TRACE_COUNT``, bumped once per jit trace of the inference
executors; eager PyTorch compiles nothing, so that counter has no
counterpart here (REPRO107 is reserved, ROADMAP's divergences).

In its place is the dispatch recorder: inside :func:`recording` every
dispatcher of ``kernels/ops.py`` notes the kernel the card would launch
for its operands -- the same decision ``ops.py`` takes on the card, the
tuner's cached winners included (nothing is measured for a CPU tensor) --
with the operands' shapes and dtypes, whatever their device.  The
recorder also marks the span during which a dispatcher runs
(:attr:`DispatchRecorder.in_span`), so that a conversion can be told
inside a kernel's call from outside it (REPRO103).  Outside a recording
the dispatchers behave exactly as they do without this module.

:func:`launch_counts` reads the kernel wrappers' own launch counters into
the recorder's ``(kernel, form)`` keys, so that the card's launches can be
held against the recorder's prediction.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, NamedTuple


class TraceCounter(dict):
    """Named monotonic counters with snapshot/delta helpers."""

    def bump(self, key) -> None:
        """Increment ``key``."""
        self[key] = self.get(key, 0) + 1

    def snapshot(self) -> dict:
        return dict(self)

    def delta(self, before: dict) -> dict:
        """Per-key increments since ``before`` (a :meth:`snapshot`)."""
        keys = set(self) | set(before)
        return {k: self.get(k, 0) - before.get(k, 0) for k in keys}


class Dispatch(NamedTuple):
    """One kernel launch the card would make: the kernel (its wrapper's
    name), its form (see :func:`launch_counts`), and each operand's shape
    and storage dtype name (``"uint4"`` for a packed table)."""
    kernel: str
    form: str
    shapes: tuple
    dtypes: tuple


class DispatchRecorder(TraceCounter):
    """Launch counts by ``(kernel, form)``, the :class:`Dispatch` records
    in order, and the dispatcher span depth."""

    def __init__(self):
        super().__init__()
        self.records: list[Dispatch] = []
        self.depth = 0

    @property
    def in_span(self) -> bool:
        """True while a dispatcher of ``kernels/ops.py`` runs."""
        return self.depth > 0


_recorders: list[DispatchRecorder] = []


@contextlib.contextmanager
def recording() -> Iterator[DispatchRecorder]:
    """Record every dispatch made inside the block."""
    rec = DispatchRecorder()
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def active() -> bool:
    """Whether a recording is on (the dispatchers then predict the card's
    kernel for CPU tensors too)."""
    return bool(_recorders)


def _operand(t) -> tuple[tuple, str]:
    packed = getattr(t, "packed", None)
    if packed is not None:                  # a PackedAssignment
        return tuple(t.shape), "uint4"
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def note(kernel: str, form: str, *operands) -> None:
    """Record one launch of ``kernel`` in ``form`` on ``operands`` (None
    entries skipped) with every active recorder."""
    if not _recorders:
        return
    ops = [_operand(t) for t in operands if t is not None]
    d = Dispatch(kernel, form, tuple(s for s, _ in ops),
                 tuple(dt for _, dt in ops))
    for rec in _recorders:
        rec.records.append(d)
        rec.bump((kernel, form))


def dispatcher(fn):
    """Mark ``fn`` (a public dispatcher of ``kernels/ops.py``) as a kernel
    span for every active recorder."""
    @functools.wraps(fn)
    def span(*args, **kwargs):
        if not _recorders:
            return fn(*args, **kwargs)
        held = list(_recorders)
        for rec in held:
            rec.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            for rec in held:
                rec.depth -= 1
    return span


def launch_counts() -> dict[tuple[str, str], int]:
    """The kernel wrappers' launch counters in the recorder's keys
    (zero counts left out).  The forms: ``spmm_ell`` / ``spmm_ell_hbm``
    'f32' or 'q' (int8 / fp8 source), ``spmm_ell_t`` 'f32', ``context_ell``
    its library entry (``repro_context_ell[_wt]_<cw>_<table>``),
    ``vq_assign`` 'narrow' or 'wide', ``vq_update`` 'narrow' or 'wide' and
    its emit ('int32' or 'uint8'), ``vq_attention`` 'decode',
    ``flash_attention`` its route ('tc' or 'fma')."""
    from repro_torch.kernels import (context_ell, flash_attention, spmm_ell,
                                     spmm_ell_hbm, vq_assign, vq_attention,
                                     vq_update)
    wide_u8 = sum(v for key, v in vq_update.launches_wide_by_shape.items()
                  if key[-1] == "uint8")
    wide_i32 = vq_update.launches_wide - wide_u8
    got = {
        ("spmm_ell", "f32"): spmm_ell.launches - spmm_ell.launches_q,
        ("spmm_ell", "q"): spmm_ell.launches_q,
        ("spmm_ell_hbm", "f32"): spmm_ell_hbm.launches
        - spmm_ell_hbm.launches_q,
        ("spmm_ell_hbm", "q"): spmm_ell_hbm.launches_q,
        ("spmm_ell_t", "f32"): spmm_ell.launches_t,
        ("vq_assign", "narrow"): vq_assign.launches - vq_assign.launches_wide,
        ("vq_assign", "wide"): vq_assign.launches_wide,
        ("vq_update", "narrow int32"): vq_update.launches
        - vq_update.launches_u8 - wide_i32,
        ("vq_update", "narrow uint8"): vq_update.launches_u8 - wide_u8,
        ("vq_update", "wide int32"): wide_i32,
        ("vq_update", "wide uint8"): wide_u8,
        ("vq_attention", "decode"): vq_attention.launches,
        ("flash_attention", "tc"): flash_attention.launches_tc,
        ("flash_attention", "fma"): flash_attention.launches_fma,
        **{("context_ell", e): n
           for e, n in context_ell.launches_by_entry.items()}}
    return {k: v for k, v in got.items() if v}
