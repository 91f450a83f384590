"""Pass 2: shared-memory static analysis (REPRO20x).

The counterpart of the reference's ``pallas_vmem.py``.  A TPU kernel's
footprint is its BlockSpecs in VMEM; a CUDA kernel's is the shared memory
one block asks for, which every wrapper sizes itself.  For each dispatch
the registry's entries record (``dispatch_checks.recorded``) the block's
shared memory is computed from that sizing:

  * ``vq_update`` / ``vq_assign``: the narrow build's ``smem_bytes``, the
    wide build's ``wide_plan(f, wgs)[3]`` at each row tile it may take;
  * ``spmm_ell_hbm``: ``smem_bytes`` at the tiles ``clamp_tiles`` gives;
  * ``context_ell``: the staged and ``w_t`` forms' sizing in
    ``csrc/context_ell.cu`` (``staged_bytes``, ``launch_wt``), on the
    constants read from that source;
  * ``spmm_ell`` / ``spmm_ell_t``: ``csrc/spmm_ell.cu`` declares no shared
    memory.

  REPRO201  a dispatch's shared memory exceeds ``SMEM_LIMIT`` (a block's
            opt-in limit on the H100, 232,448 B, ``kernels/_build.py``),
            or a wide width has no plan.  On the card also: the device's
            opt-in limit equals ``SMEM_LIMIT``, and the wide plan the
            card's launch takes equals ``vq_update.wide_plan`` at the
            registry's widths.
  REPRO203  dispatch crossovers of ``kernels/ops.py``, probed at 0.9x and
            1.2x their budgets: ``spmm_ell_variant`` takes the resident
            kernel below the SpMM's L2 budget and the staged one above it,
            whose default tiles the kernel takes; ``context_ell`` makes
            one fused dispatch below a configured context budget and one
            ``spmm_ell`` a branch above it -- and at the default, unbounded
            budget the fused one at both probes (the port's documented
            divergence: the card measured the fused kernel ahead at every
            table size).

The probes re-derive their shapes from the LIVE budgets, so a deployment
that sets ``REPRO_*_L2_BUDGET_MB`` is checked against its own
configuration.  REPRO202 (ragged BlockSpecs) has no counterpart: the CUDA
kernels guard their own tails (ROADMAP's divergences).
"""
from __future__ import annotations

import functools
import math
import re
from pathlib import Path

import torch

from repro_torch.analysis import Finding, registry, trace_count
from repro_torch.analysis.dispatch_checks import recorded
from repro_torch.kernels import _build
from repro_torch.kernels import context_ell as _ctx
from repro_torch.kernels import spmm_ell_hbm as _hbm
from repro_torch.kernels import vq_assign as _vqa
from repro_torch.kernels import vq_update as _vqu

SMEM_LIMIT = _build.SMEM_LIMIT
_CSRC = Path(_ctx.__file__).resolve().parent / "csrc"
_ITEMSIZE = {"float32": 4, "int8": 1, "float8_e4m3fn": 1}


@functools.lru_cache(maxsize=None)
def cu_constants(source: str) -> dict[str, int]:
    """The ``constexpr int kName = N;`` constants of ``csrc/<source>``."""
    text = (_CSRC / source).read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr\s+int\s+(k\w+)\s*=\s*(\d+)\s*;", text)}


@functools.lru_cache(maxsize=None)
def declares_shared(source: str) -> bool:
    """Whether ``csrc/<source>`` declares any shared memory."""
    return "__shared__" in (_CSRC / source).read_text()


def _warp_rows(c: dict, nb: int, f_blk: int) -> int:
    rw = (c["kPL"] * 32) // (nb * f_blk)
    if rw * nb > c["kAS"]:
        rw = c["kAS"] // nb
    return max(rw, 1)


def context_smem(b: int, nb: int, k: int, f_blk: int, cw_itemsize: int,
                 wt: bool, limit: int = SMEM_LIMIT) -> int:
    """Dynamic shared memory of one ``context_ell`` block, as
    ``csrc/context_ell.cu``'s ``launch`` / ``launch_wt`` size it (0 for the
    direct kernel)."""
    c = cu_constants("context_ell.cu")
    rw = _warp_rows(c, nb, f_blk)
    fits = nb <= c["kAS"] and nb * f_blk <= c["kPL"] * 32
    if not wt:
        staged = (-(-(nb * k * f_blk * cw_itemsize) // 16) * 16
                  + c["kStWarps"] * rw * c["kDS"] * (nb + 1) * 4)
        return staged if (b >= c["kStagedRows"] and fits
                          and staged <= limit) else 0
    ncol_s = -(-(nb * f_blk) // 4) * 4
    wide = (32 * ncol_s + c["kWtK"] * c["kWtOut"]) * 4
    if b < c["kStagedRows"] or wide > limit:
        return _ctx.WT_ROWS * ncol_s * 4
    if cw_itemsize == 1:
        stage = (c["kMaxThreads"] // 32) * rw * c["kDS"] * (nb + 1) * 4
        if fits and wide + stage <= limit:
            return wide + stage
    return wide


def _wide_smem(f: int) -> int | None:
    """The most shared memory a wide launch at width f may take (its row
    tiles of 64 and 128 rows), or None without a plan."""
    plans = [_vqu.wide_plan(f, wgs) for wgs in (1, 2)]
    plans = [p for p in plans if p is not None]
    return max(p[3] for p in plans) if plans else None


def dispatch_smem(d: trace_count.Dispatch) -> int | None:
    """Shared memory one block of the recorded dispatch ``d`` asks for
    (None: a wide width without a plan, or a kernel not sized here)."""
    if d.kernel in ("spmm_ell", "spmm_ell_t"):
        return 0 if not declares_shared("spmm_ell.cu") else None
    if d.kernel == "spmm_ell_hbm":
        (b, deg), _, (n_src, _f) = d.shapes[:3]
        bb, stripe = _hbm.clamp_tiles(b, n_src, _hbm.DEFAULT_BB,
                                      _hbm.DEFAULT_STRIPE)
        return _hbm.smem_bytes(bb, stripe, deg, n_src, indexed=True)
    if d.kernel == "context_ell":
        (b, _), _, _, (nb, k, f_blk) = d.shapes[:4]
        return context_smem(b, nb, k, f_blk, _ITEMSIZE[d.dtypes[3]],
                            "_wt" in d.form)
    if d.kernel in ("vq_update", "vq_assign"):
        (_, _, f), (_, k, _) = d.shapes[:2]
        if d.form.startswith("wide"):
            return _wide_smem(f)
        return (_vqu if d.kernel == "vq_update" else _vqa).smem_bytes(k, f)
    return None


def check_dispatches(records, where: str,
                     limit: int = SMEM_LIMIT) -> list[Finding]:
    """REPRO201 over the recorded dispatches of one entry."""
    findings = []
    for d in records:
        sm = dispatch_smem(d)
        if sm is None and d.kernel in ("vq_update", "vq_assign"):
            findings.append(Finding(
                "REPRO201", where, 0,
                f"'{d.kernel}' ({d.form}) at shapes {d.shapes} has no "
                f"shared-memory plan within {limit} bytes"))
        elif sm is not None and sm > limit:
            findings.append(Finding(
                "REPRO201", where, 0,
                f"'{d.kernel}' ({d.form}) at shapes {d.shapes} asks for "
                f"{sm} bytes of shared memory a block, over the {limit}-byte "
                f"limit"))
    return findings


def _context_probe(n: int, nb: int = 4) -> list[trace_count.Dispatch]:
    """The dispatches ``ops.context_ell`` records for an [nb, n] int32 table
    (a broadcast view: no table is allocated) on CPU tensors."""
    from repro_torch.kernels import ops as kops
    b, deg, k, fb = 32, 8, 8, 4
    ids = torch.zeros((b, deg), dtype=torch.int32)
    vals = torch.ones((b, deg), dtype=torch.float32)
    table = torch.zeros((nb, 1), dtype=torch.int32).expand(nb, n)
    cw = torch.zeros((nb, k, fb), dtype=torch.float32)
    with trace_count.recording() as rec:
        kops.context_ell(ids, vals, table, cw)
    return rec.records


def crossover_findings() -> list[Finding]:
    """REPRO203: the ``ops.py`` crossovers against the kernels."""
    from repro_torch.kernels import ops as kops
    findings: list[Finding] = []
    where = "<crossover:spmm_ell>"
    budget = kops._l2_budget_mb(kops._dispatch_overrides,
                                "REPRO_SPMM_L2_BUDGET_MB",
                                kops._DEFAULT_L2_BUDGET_MB) * 2 ** 20
    f, b, deg = 16, 32, 8
    n_below = int(budget * 0.9) // (f * 4)
    n_above = int(budget * 1.2) // (f * 4)
    below = kops.spmm_ell_variant(n_below, f, measure=False)
    above = kops.spmm_ell_variant(n_above, f, measure=False)
    if below != "resident":
        findings.append(Finding(
            "REPRO203", where, 0,
            f"below the SpMM crossover ([{n_below}, {f}] f32) the dispatch "
            f"stages the source ('{below}'), though it fits the L2 budget"))
    if above != "hbm":
        findings.append(Finding(
            "REPRO203", where, 0,
            f"above the SpMM crossover ([{n_above}, {f}] f32) the dispatch "
            f"keeps the resident kernel ('{above}') for a source past the "
            f"L2 budget"))
    else:
        bb, stripe = _hbm.clamp_tiles(b, n_above, _hbm.DEFAULT_BB,
                                      _hbm.DEFAULT_STRIPE)
        err = _hbm.tiles_error(bb, stripe, deg, n_above, False)
        if err is not None:
            findings.append(Finding(
                "REPRO203", where, 0,
                f"above the SpMM crossover the staged kernel refuses its "
                f"default tiles: {err}"))

    where = "<crossover:context_ell>"
    nb = 4
    cbudget = kops._l2_budget_mb(kops._context_overrides,
                                 "REPRO_CONTEXT_L2_BUDGET_MB",
                                 kops._DEFAULT_CONTEXT_L2_BUDGET_MB)
    # at the unbounded default the probes take the SpMM budget's sizes
    probe = budget if math.isinf(cbudget) else cbudget * 2 ** 20
    n_below = int(probe * 0.9) // (nb * 4)
    n_above = int(probe * 1.2) // (nb * 4)
    fused = [("context_ell", "repro_context_ell_f32_i32")]
    loop = [("spmm_ell", "f32")] * nb
    want_above = fused if math.isinf(cbudget) else loop
    for n, want, side in ((n_below, fused, "below"),
                          (n_above, want_above, "above")):
        got = [(d.kernel, d.form) for d in _context_probe(n, nb)]
        if got != want:
            findings.append(Finding(
                "REPRO203", where, 0,
                f"{side} the context crossover ([{nb}, {n}] int32, budget "
                f"{cbudget} MiB) expected {want}, recorded {got}"))
    return findings


def card_findings(device="cuda", widths=()) -> list[Finding]:
    """REPRO201 on the card: the device's opt-in shared memory a block is
    ``SMEM_LIMIT``, and ``vq_update.wide_plan`` is the card's plan at
    ``widths``."""
    dev = torch.device(device)
    findings: list[Finding] = []
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    if optin is None:
        optin = _ctx.smem_optin()
    if int(optin) != SMEM_LIMIT:
        findings.append(Finding(
            "REPRO201", "<device>", 0,
            f"the card's opt-in shared memory a block is {optin} bytes, the "
            f"wrappers size their blocks for {SMEM_LIMIT}"))
    for f in sorted(set(widths)):
        for wgs in (1, 2):
            host = _vqu.wide_plan(f, wgs)
            try:
                card = _vqa.wide_plan_card(f, wgs)
            except RuntimeError:
                card = None
            if card != host:
                findings.append(Finding(
                    "REPRO201", "<device>", 0,
                    f"the wide plan at f={f}, wgs={wgs}: the card's launch "
                    f"takes {card}, vq_update.wide_plan says {host}"))
    return findings


def run(root: str | None = None, device="cpu") -> list[Finding]:
    """REPRO201 / 203 over the registry's recorded dispatches on
    ``device`` (and the card's own limits there)."""
    del root
    dev = str(torch.device(device))
    findings: list[Finding] = []
    widths = set()
    for entry in registry.entries():
        run_ = recorded(entry, dev)
        findings.extend(check_dispatches(run_.records,
                                         f"<entry:{entry.name}>"))
        widths |= {d.shapes[0][-1] for d in run_.records
                   if d.kernel in ("vq_update", "vq_assign")}
    findings.extend(crossover_findings())
    if torch.device(dev).type == "cuda":
        findings.extend(card_findings(dev, widths))
    return findings
