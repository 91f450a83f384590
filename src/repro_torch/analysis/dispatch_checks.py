"""Pass 1: dispatch-level contract checks (REPRO10x) over the registry.

The counterpart of the reference's ``jaxpr_checks.py``.  Every registered
entry point runs on the tiny setup under the dispatch recorder
(``trace_count.recording``), which notes the kernel each dispatcher of
``kernels/ops.py`` would launch on the card:

  REPRO101  exact dispatch count per batch step -- in particular ONE fused
            context dispatch per layer regardless of the product-VQ
            branch count (the registry runs a second branch width).  On
            the card also: the kernels' own launch counters move exactly
            as the recorder predicted.
  REPRO102  (the ``sync`` pass, on the card only) no device-to-host
            synchronization inside a hot entry: warmed once, the entry
            runs again under ``torch.cuda.set_sync_debug_mode("error")``
            -- the eager form of "a host callback fences the device every
            step".
  REPRO103  quantized dtype flow: every storage dtype of the entry's
            quantized state (int8 / float8_e4m3fn codewords, uint8 /
            packed tables) reaches a recorded dispatch in that dtype, and
            no op outside a dispatcher's span turns a storage-dtype tensor
            into a float one (a ``TorchDispatchMode`` watches every aten
            op: ``_to_copy``, ``copy_`` and type-promoting arithmetic) --
            i.e. no host-level dequantization before the kernel.  On the
            CPU the plain versions dequantize inside the span, which the
            check excludes.
  REPRO106  gradient-injection residuals: the tensors the forward of
            ``core.message_passing.inject_context_grad`` saves for its
            backward (seen by ``torch.autograd.graph.saved_tensors_hooks``)
            stay O(b*Dr + k*f) -- none, and not their sum, as large as the
            dense [b, Dr, f_grad] reconstruction the lazy Eq. 7 form
            exists to avoid.

REPRO104 (donation), REPRO105 (scan carry) and REPRO107 (trace counter)
have no eager counterpart and stay reserved (ROADMAP's divergences).
"""
from __future__ import annotations

import contextlib
import os
import sysconfig
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import Finding, registry, trace_count

_STORAGE = (torch.int8, torch.float8_e4m3fn, torch.uint8)
_PKG = os.sep + "repro_torch" + os.sep


_LIBS = tuple(sysconfig.get_paths()[k] for k in ("stdlib", "purelib",
                                                   "platlib"))


def _site(frames) -> str:
    """The deepest frame in the port outside this package, as
    ``path:line`` under ``repro_torch/``; else the deepest frame outside
    this package and the installed libraries (a caller's own code)."""
    frames = list(frames)
    for fr in reversed(frames):
        rel = fr.filename.split(_PKG, 1)
        if len(rel) == 2 and not rel[1].startswith("analysis" + os.sep):
            return f"{rel[1]}:{fr.lineno}"
    for fr in reversed(frames):
        name = fr.filename
        if _PKG not in name and not name.startswith(_LIBS) \
                and not name.startswith("<"):
            return f"{os.path.basename(name)}:{fr.lineno}"
    return "<unknown>"


class HostUpcasts(TorchDispatchMode):
    """Every aten op outside a dispatcher's span that takes a
    storage-dtype tensor and returns a float one, with where it ran."""

    def __init__(self, recorder: trace_count.DispatchRecorder):
        super().__init__()
        self.recorder = recorder
        self.seen: list[tuple[str, str, str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.recorder.in_span:
            src = {t.dtype for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor) and t.dtype in _STORAGE}
            dst = {t.dtype for t in pytree.tree_leaves(out)
                   if isinstance(t, torch.Tensor)
                   and t.dtype.is_floating_point and t.dtype not in _STORAGE}
            if src and dst:
                self.seen.append((str(func), _names(src), _names(dst),
                                  _site(traceback.extract_stack())))
        return out


def _names(dtypes) -> str:
    return ", ".join(sorted(str(d).removeprefix("torch.") for d in dtypes))


class Run:
    """What one recorded run of an entry saw."""

    def __init__(self, records, upcasts, launched=None, error=None):
        self.records = records     # [trace_count.Dispatch]
        self.upcasts = upcasts     # HostUpcasts.seen
        self.launched = launched   # the card's counter deltas, or None
        self.error = error         # the exception text, or None


def _record(entry, device) -> Run:
    dev = torch.device(device)
    card = dev.type == "cuda"
    before = trace_count.launch_counts() if card else None
    with trace_count.recording() as rec, HostUpcasts(rec) as watch:
        try:
            entry.run(dev)
        except Exception as exc:      # a broken entry is itself a finding
            return Run(rec.records, watch.seen,
                       error=f"{type(exc).__name__}: {exc}")
    launched = None
    if card:
        torch.cuda.synchronize(dev)
        after = trace_count.launch_counts()
        launched = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
    return Run(rec.records, watch.seen, launched)


_runs: dict[tuple[str, str], Run] = {}


def recorded(entry, device="cpu") -> Run:
    """The entry's recorded run on ``device`` (once per entry and device;
    the shared-memory pass reads the same records)."""
    key = (entry.name, str(torch.device(device)))
    if key not in _runs:
        _runs[key] = _record(entry, device)
    return _runs[key]


def dispatch_counts(records) -> dict:
    out: dict = {}
    for d in records:
        out[(d.kernel, d.form)] = out.get((d.kernel, d.form), 0) + 1
    return out


def check_entry(entry, device="cpu", run: Run | None = None
                ) -> list[Finding]:
    """REPRO101 / REPRO103 for one entry (``run``: an earlier recorded
    run of it, else a fresh one)."""
    run = _record(entry, device) if run is None else run
    loc = f"<entry:{entry.name}>"
    if run.error is not None:
        return [Finding("REPRO101", loc, 0,
                        f"entry failed to run: {run.error}")]
    findings: list[Finding] = []

    # REPRO101 -- exact dispatch count per batch step
    n = len(run.records)
    counts = dispatch_counts(run.records)
    if entry.dispatch_count is not None and \
            n != entry.dispatch_count * entry.steps:
        findings.append(Finding(
            "REPRO101", loc, 0,
            f"expected exactly {entry.dispatch_count} dispatches a batch "
            f"step ({entry.steps} steps), recorded {n}: "
            f"{sorted(counts.items())}"))
    if run.launched is not None and run.launched != counts:
        findings.append(Finding(
            "REPRO101", loc, 0,
            f"the card launched {sorted(run.launched.items())}, the "
            f"recorder predicted {sorted(counts.items())}"))

    # REPRO103 -- quantized dtype flow
    for dt in entry.quantized_dtypes:
        if run.records and not any(dt in d.dtypes for d in run.records):
            findings.append(Finding(
                "REPRO103", loc, 0,
                f"quantized operand dtype {dt} never reaches a kernel "
                f"dispatch (dequantized upstream?)"))
    if entry.quantized_dtypes:
        for func, src, dst, site in run.upcasts:
            findings.append(Finding(
                "REPRO103", loc, 0,
                f"host-level dequantization {src} -> {dst} ({func} at "
                f"{site}) outside a kernel dispatch: quantized operands "
                f"must stay in storage dtype until the in-kernel epilogue"))
    return findings


def saved_bytes(fn) -> list[int]:
    """Bytes of each tensor ``fn`` (a forward pass) saves for backward, as
    ``torch.autograd.graph.saved_tensors_hooks`` sees them."""
    sizes: list[int] = []

    def pack(t):
        sizes.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sizes


def saved_tensor_findings(fn, dense_bytes: int,
                          where: str) -> list[Finding]:
    """Flag the tensors ``fn`` saves for backward that reach
    ``dense_bytes`` (singly or summed)."""
    sizes = saved_bytes(fn)
    findings = []
    if any(sz >= dense_bytes for sz in sizes):
        findings.append(Finding(
            "REPRO106", where, 0,
            f"a tensor saved for backward is as large as the dense [b, Dr, "
            f"f_grad] reconstruction ({max(sizes)} >= {dense_bytes} "
            f"bytes): the lazy Eq. 7 form must save only the "
            f"O(b*Dr + k*f) operands"))
    if sum(sizes) >= dense_bytes:
        findings.append(Finding(
            "REPRO106", where, 0,
            f"total saved tensors ({sum(sizes)} bytes) reach the dense "
            f"reconstruction size ({dense_bytes} bytes)"))
    return findings


def injection_forward(device="cpu"):
    """The forward of the lazy Eq. 7 injection at the reference's shapes
    (b 16, Dr 8, nb 4, k 8, f_blk 4, f 8, n 40) as a thunk, and the bytes
    of the dense [b, Dr, f_grad] reconstruction."""
    from repro_torch.core.message_passing import inject_context_grad
    dev = torch.device(device)
    b, dr, nb, k, f_blk, f, n = 16, 8, 4, 8, 4, 8, 40
    f_grad = nb * f_blk
    gen = torch.Generator().manual_seed(0)
    x_b = torch.zeros((b, f), dtype=torch.float32, device=dev,
                      requires_grad=True)
    rv = torch.ones((b, dr), dtype=torch.float32, device=dev)
    ri = torch.randint(0, n, (b, dr), generator=gen,
                       dtype=torch.int32).to(dev)
    gcw = torch.ones((nb, k, f_blk), dtype=torch.float32, device=dev)
    asg = torch.zeros((nb, n), dtype=torch.int32, device=dev)
    w = torch.ones((f_grad, f), dtype=torch.float32, device=dev)
    return (lambda: inject_context_grad(x_b, rv, ri, gcw, asg, w),
            b * dr * f_grad * 4)


def residual_findings(device="cpu") -> list[Finding]:
    """REPRO106: what the forward of the lazy Eq. 7 injection saves."""
    fn, dense = injection_forward(device)
    return saved_tensor_findings(fn, dense, "<saved:inject_context_grad>")


def sync_findings(entry, device="cuda") -> list[Finding]:
    """REPRO102 for one entry: warmed once, then run under
    ``torch.cuda.set_sync_debug_mode("error")``; a synchronizing call is
    a finding, named by where it ran.  The card only."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("REPRO102 (the sync pass) runs on the card only: "
                         "torch.cuda.set_sync_debug_mode watches CUDA "
                         "synchronizations")
    loc = f"<entry:{entry.name}>"
    with contextlib.ExitStack() as stack:
        if entry.group:
            stack.enter_context(registry.one_rank_group(dev))
        if (entry.name, str(dev)) not in _runs:
            entry.run(dev)                  # the warm run
        torch.cuda.synchronize(dev)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            entry.run(dev)
        except RuntimeError as exc:
            if "synchroniz" not in str(exc):
                return [Finding("REPRO101", loc, 0,
                                f"entry failed to run: {exc}")]
            site = _site(traceback.extract_tb(exc.__traceback__))
            return [Finding(
                "REPRO102", loc, 0,
                f"device-to-host synchronization at {site} inside the hot "
                f"entry (fences the device every step): {exc}")]
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            torch.cuda.synchronize(dev)
    return []


def run(root: str | None = None, device="cpu") -> list[Finding]:
    """REPRO101 / 103 / 106 over the registry on ``device``."""
    del root  # the dispatch contracts are registry-driven, not path-driven
    dev = str(torch.device(device))
    findings: list[Finding] = []
    with registry.one_rank_group(dev):      # one group for every entry
        for entry in registry.entries():
            findings.extend(check_entry(entry, dev, recorded(entry, dev)))
    findings.extend(residual_findings(dev))
    return findings


def run_sync(root: str | None = None, device="cuda") -> list[Finding]:
    """REPRO102 over the registry (the card only)."""
    del root
    findings: list[Finding] = []
    with registry.one_rank_group(device):
        for entry in registry.entries():
            findings.extend(sync_findings(entry, device))
    return findings
