"""Dispatch between the CUDA kernels and their plain versions.

Decided by the operand's device first: a CPU tensor goes to ``ref.py``
whatever the settings below say, a CUDA tensor goes to a hand-written
kernel, whose wrapper validates it and launches or raises.  There is no
fallback: a CUDA tensor that the kernel refuses is an error, never a
silent plain-PyTorch run.  ``spmm_ell`` is differentiable in ``x``: its
backward is the transposed kernel ``spmm_ell_t`` (dispatched the same
way).  The LM side's ``vq_attention_decode`` and ``flash_attention``
follow the same rule: the reference also sends ``flash_attention`` shapes
with ``sq % 128 != 0`` to its oracle, but here every CUDA tensor goes to
the kernel, which handles ragged tails itself.

On the card two calls have two kernels each, picked by the reference's
precedence -- a forced variant, then a configured budget, then the tuner
(``kernels/autotune.py``, opt-in), then the default budget:

  * ``spmm_ell``: the resident kernel, or the staged-stripe one for a
    source above the budget (``spmm_ell_variant``; ``REPRO_SPMM_VARIANT``,
    ``configure_spmm_dispatch`` / ``REPRO_SPMM_L2_BUDGET_MB``);
  * ``context_ell``: the fused kernel, or the per-branch loop -- the
    branch ids gathered, one ``spmm_ell`` a branch on its [k, f_blk]
    codewords, the ``@ w_t`` product a ``torch.matmul`` after the
    concatenation (``context_ell_variant``; ``REPRO_CONTEXT_VARIANT``,
    ``configure_context_dispatch`` / ``REPRO_CONTEXT_L2_BUDGET_MB``).

The budgets size what the kernels read through the H100's L2, where the
reference sizes a TPU core's VMEM, so their variables carry the L2 in
their names; the reference's ``REPRO_SPMM_VMEM_BUDGET_MB`` and
``REPRO_CONTEXT_VMEM_BUDGET_MB`` raise a ValueError that names them.  The
SpMM's default is the L2's 50 MiB; the context's is unbounded ('auto' is
the fused kernel at every table size, as the card measured it ahead of the
loop at every table timed; a configured budget still sends larger tables
to the loop).  With
``REPRO_AUTOTUNE=1`` the tuner also sets the staged kernel's tiles (unless
a ``StripeIndex`` pins them) and the wide VQ scan's row tile.  Every
``REPRO_*`` read goes through ``repro_torch.hostenv``.

Inside ``analysis.trace_count.recording()`` every public dispatcher here
also notes the kernel the card would launch for its operands, on either
device: for a CPU tensor it takes the card's decision above, the tuner's
cached winners included, and measures nothing.  Outside a recording a CPU
tensor goes to ``ref.py`` without consulting any variant.

The precision tiers are data-driven here as in the reference: quantized
codewords arrive as a ``QTensor``, narrow tables as uint8 tensors or a
``PackedAssignment``, and each reaches its kernel form in its storage
type.  The tier setting (``configure_kernel_precision`` /
``REPRO_KERNEL_PRECISION``) only tells the functions that build VQ states
which storage to make (``core/conv.py``, ``models/gnn.py``,
``launch/serve_gnn.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import hostenv
from repro_torch.analysis import trace_count
from repro_torch.distributed.quantization import PackedAssignment, QTensor
from repro_torch.kernels import autotune, ref
from repro_torch.kernels import vq_assign as _vq_assign
from repro_torch.kernels import vq_update as _vq_update
from repro_torch.kernels.context_ell import (context_ell_cuda,
                                             entry_name as context_entry)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 route as _flash_route)
from repro_torch.kernels.spmm_ell import spmm_ell_cuda, spmm_ell_t_cuda
from repro_torch.kernels.spmm_ell_hbm import StripeIndex, spmm_ell_hbm_cuda
from repro_torch.kernels.vq_assign import vq_assign_cuda
from repro_torch.kernels.vq_attention import vq_attention_decode_cuda
from repro_torch.kernels.vq_update import check_emit, vq_assign_update_cuda

# ---------------------------------------------------------------------------
# operand precision tiers
# ---------------------------------------------------------------------------

# 'fp32' (dense), 'int8' (int8 codewords + uint8 tables, k <= 256), 'fp8'
# (float8_e4m3fn codewords, the same uint8 tables), and the '+a4' tiers that
# also nibble-pack the tables for k <= 16 (two ids a byte, 8x vs int32).
PRECISIONS = ("fp32", "int8", "fp8", "int8+a4", "fp8+a4")
_precision_override: list[str] = []


def _check_precision(p: str, source: str) -> str:
    if p not in PRECISIONS:
        raise ValueError(
            f"{source}={p!r}: unknown kernel precision tier; valid tiers "
            f"are {', '.join(PRECISIONS)}")
    return p


def configure_kernel_precision(precision: Optional[str] = None, *,
                               reset: bool = False) -> None:
    """Programmatic override of ``REPRO_KERNEL_PRECISION`` (it wins over
    the environment); ``reset`` drops it first.  An unknown tier raises,
    listing the valid ones."""
    if reset:
        _precision_override.clear()
    if precision is not None:
        _check_precision(precision, "kernel precision")
        _precision_override[:] = [precision]


def kernel_precision() -> str:
    """The active tier: the override, else ``REPRO_KERNEL_PRECISION``, else
    'fp32'."""
    if _precision_override:
        return _precision_override[0]
    return _check_precision(
        hostenv.env_knob("REPRO_KERNEL_PRECISION", "fp32"),
        "REPRO_KERNEL_PRECISION")


def precision_codeword_dtype(precision: Optional[str] = None
                             ) -> Optional[torch.dtype]:
    """Codeword storage dtype of a tier: None (dense f32), int8 or fp8."""
    p = _check_precision(precision if precision is not None
                         else kernel_precision(), "kernel precision")
    if p == "fp32":
        return None
    return torch.float8_e4m3fn if p.startswith("fp8") else torch.int8


def precision_packs_assignment(precision: Optional[str] = None) -> bool:
    """True for the '+a4' tiers that nibble-pack assignment tables."""
    p = _check_precision(precision if precision is not None
                         else kernel_precision(), "kernel precision")
    return p.endswith("+a4")


# ---------------------------------------------------------------------------
# dispatch budgets (the card's L2 in place of the reference's VMEM)
# ---------------------------------------------------------------------------

# The H100's L2 (NVIDIA's data sheet): a source that fits stays there
# between the resident kernel's gathers; a larger one is staged in stripes.
_DEFAULT_L2_BUDGET_MB = 50.0


def _l2_budget_mb(overrides: dict, env_name: str, default: float) -> float:
    """A dispatch budget: the programmatic override, else ``env_name``,
    else ``default``; a positive float (MiB) or a ValueError."""
    raw = overrides.get("l2_budget_mb", hostenv.env_knob(env_name, default))
    try:
        budget = float(raw)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        raise ValueError(f"{env_name}={raw!r}: want a positive float "
                         f"(MiB)") from None
    if budget <= 0.0:
        raise ValueError(f"{env_name}={raw!r}: want a positive float (MiB)")
    return budget


def _budget_forced(overrides: dict, env_name: str, vmem_name: str) -> bool:
    """True when the budget was configured (the tuner then stands down).
    The reference's VMEM-named variable raises here, naming ours: it
    sizes a TPU core's VMEM, not the card's L2."""
    if hostenv.env_knob_set(vmem_name):
        raise ValueError(
            f"{vmem_name} is the reference's TPU VMEM budget; the port's "
            f"dispatch budget is the card's L2: set {env_name} (MiB)")
    return "l2_budget_mb" in overrides or hostenv.env_knob_set(env_name)


# ---------------------------------------------------------------------------
# spmm_ell variant dispatch: the resident kernel or the staged-stripe one
# ---------------------------------------------------------------------------

SPMM_VARIANTS = ("auto", "resident", "hbm")

# Programmatic overrides; they take precedence over the environment.
_dispatch_overrides: dict[str, object] = {}


def configure_spmm_dispatch(variant: Optional[str] = None,
                            l2_budget_mb: Optional[float] = None, *,
                            reset: bool = False) -> None:
    """Override the ``spmm_ell`` dispatch: ``variant`` in {'auto',
    'resident', 'hbm'} ('auto' clears a forced variant), ``l2_budget_mb``
    the source size above which 'auto' stages the source in stripes.
    None leaves a setting as it is; ``reset=True`` first drops every
    programmatic override (back to the environment and the defaults).

    The budget is the reference's ``vmem_budget_mb`` /
    ``REPRO_SPMM_VMEM_BUDGET_MB``, measured against the card's L2 instead
    of a TPU core's VMEM; its variable is ``REPRO_SPMM_L2_BUDGET_MB``."""
    if reset:
        _dispatch_overrides.clear()
    if variant is not None:
        if variant not in SPMM_VARIANTS:
            raise ValueError(f"unknown spmm variant: {variant!r}")
        _dispatch_overrides["variant"] = variant
    if l2_budget_mb is not None:
        _dispatch_overrides["l2_budget_mb"] = float(l2_budget_mb)


def spmm_ell_variant(n_src: int, f: int, itemsize: int = 4,
                     dtype: Optional[torch.dtype] = None, *,
                     measure: bool = True) -> str:
    """'resident' or 'hbm' for an [n_src, f] source of ``itemsize``-byte
    elements (of storage ``dtype``, which keys the tuner).  Precedence: a
    forced variant (``configure_spmm_dispatch``, else
    ``REPRO_SPMM_VARIANT``), then a configured budget, then the tuner
    (``REPRO_AUTOTUNE=1``; with ``measure=False`` its cached winners
    only), then the default budget, 50 MiB."""
    forced = _dispatch_overrides.get(
        "variant", hostenv.env_knob("REPRO_SPMM_VARIANT", "auto"))
    if forced not in SPMM_VARIANTS:
        raise ValueError(
            f"REPRO_SPMM_VARIANT={forced!r}: want auto, resident or hbm")
    if forced != "auto":
        return str(forced)
    if not _budget_forced(_dispatch_overrides, "REPRO_SPMM_L2_BUDGET_MB",
                          "REPRO_SPMM_VMEM_BUDGET_MB"):
        tuned = autotune.tuned_spmm(n_src, f, itemsize, dtype,
                                    measure=measure)
        if tuned is not None:
            return str(tuned["variant"])
    budget = _l2_budget_mb(_dispatch_overrides, "REPRO_SPMM_L2_BUDGET_MB",
                           _DEFAULT_L2_BUDGET_MB)
    return "hbm" if n_src * f * itemsize > budget * 2 ** 20 else "resident"


def _spmm_variant(x: torch.Tensor, measure: bool = True) -> str:
    n_src, f = x.shape
    return spmm_ell_variant(n_src, f, x.element_size(), x.dtype,
                            measure=measure)


def _note_spmm(variant, nbr_idx, nbr_val, x, x_scale) -> None:
    """Record the SpMM kernel ``variant`` names (the resident one launches
    nothing for an empty output)."""
    if trace_count.active() and (
            variant == "hbm" or (nbr_idx.shape[0] > 0 and x.shape[1] > 0)):
        trace_count.note("spmm_ell_hbm" if variant == "hbm" else "spmm_ell",
                         "f32" if x_scale is None else "q", nbr_idx, nbr_val,
                         x, x_scale)


def _note_spmm_cpu(nbr_idx, nbr_val, x, x_scale) -> None:
    if trace_count.active():
        _note_spmm(_spmm_variant(x, measure=False), nbr_idx, nbr_val, x,
                   x_scale)


def _spmm_cuda(nbr_idx, nbr_val, x, stripe_index, x_scale):
    """The card's SpMM kernel for this source, by ``spmm_ell_variant``;
    the staged kernel at the tuner's tiles unless ``stripe_index`` pins
    its own."""
    n_src, f = x.shape
    variant = _spmm_variant(x)
    _note_spmm(variant, nbr_idx, nbr_val, x, x_scale)
    if variant == "hbm":
        tiles = {}
        if stripe_index is None:
            tuned = autotune.tuned_spmm(n_src, f, x.element_size(), x.dtype)
            if tuned is not None:
                tiles = dict(bb=int(tuned["bb"]),
                             stripe=int(tuned["stripe"]))
        return spmm_ell_hbm_cuda(nbr_idx, nbr_val, x, stripe_index, x_scale,
                                 **tiles)
    return spmm_ell_cuda(nbr_idx, nbr_val, x, x_scale)


# ---------------------------------------------------------------------------
# context_ell variant dispatch: the fused kernel or the per-branch loop
# ---------------------------------------------------------------------------

CONTEXT_VARIANTS = ("auto", "fused", "loop")
# Unbounded: both variants gather the same b * D * nb table entries
# wherever the table lives, and the loop adds a launch a branch and an
# [nb, b, D] id tensor to that; on the H100 the fused kernel beat the loop
# at every [32, n] int32 table measured, 21.7 to 512 MB (chip_smoke.py's
# dispatch phase, PERF.md).  A configured budget keeps the reference's
# rule: a table above it takes the loop.
_DEFAULT_CONTEXT_L2_BUDGET_MB = float("inf")

_context_overrides: dict[str, object] = {}


def configure_context_dispatch(variant: Optional[str] = None,
                               l2_budget_mb: Optional[float] = None, *,
                               reset: bool = False) -> None:
    """Override the ``context_ell`` dispatch: ``variant`` in {'auto',
    'fused', 'loop'} ('auto' clears a forced variant), ``l2_budget_mb``
    the table size above which 'auto' takes the per-branch loop.  None
    leaves a setting as it is; ``reset=True`` first drops every
    programmatic override.  The budget is the reference's
    ``vmem_budget_mb`` / ``REPRO_CONTEXT_VMEM_BUDGET_MB`` against the
    card's L2; its variable is ``REPRO_CONTEXT_L2_BUDGET_MB``."""
    if reset:
        _context_overrides.clear()
    if variant is not None:
        if variant not in CONTEXT_VARIANTS:
            raise ValueError(f"unknown context variant: {variant!r}")
        _context_overrides["variant"] = variant
    if l2_budget_mb is not None:
        _context_overrides["l2_budget_mb"] = float(l2_budget_mb)


def context_ell_variant(n_nodes: int, n_branches: int,
                        itemsize: float = 4, dtype=None, *,
                        measure: bool = True) -> str:
    """'fused' or 'loop' for an [n_branches, n_nodes] assignment table of
    ``itemsize`` bytes an entry -- fractional: 0.5 for a
    ``PackedAssignment`` -- whose storage ``dtype`` (``"uint4"`` when
    packed) keys the tuner.  Precedence: a forced variant
    (``configure_context_dispatch``, else ``REPRO_CONTEXT_VARIANT``), then
    a configured budget, then the tuner (``REPRO_AUTOTUNE=1``; with
    ``measure=False`` its cached winners only), then the default budget."""
    forced = _context_overrides.get(
        "variant", hostenv.env_knob("REPRO_CONTEXT_VARIANT", "auto"))
    if forced not in CONTEXT_VARIANTS:
        raise ValueError(
            f"REPRO_CONTEXT_VARIANT={forced!r}: want auto, fused or loop")
    if forced != "auto":
        return str(forced)
    if not _budget_forced(_context_overrides, "REPRO_CONTEXT_L2_BUDGET_MB",
                          "REPRO_CONTEXT_VMEM_BUDGET_MB"):
        tuned = autotune.tuned_context(n_nodes, n_branches, itemsize, dtype,
                                       measure=measure)
        if tuned is not None:
            return str(tuned["variant"])
    budget = _l2_budget_mb(_context_overrides, "REPRO_CONTEXT_L2_BUDGET_MB",
                           _DEFAULT_CONTEXT_L2_BUDGET_MB)
    return "loop" if n_nodes * n_branches * itemsize > budget * 2 ** 20 \
        else "fused"


def _context_ell_loop(out_ids, out_vals, assignment, codewords, w_t,
                      cw_scale=None):
    """The per-branch variant: a packed table unpacked, the branch ids
    ``assignment[:, out_ids]`` gathered, one resident ``spmm_ell`` kernel
    a branch on that branch's [k, f_blk] codewords (a quantized branch
    with its ``cw_scale[i]`` as the source's scale: the dequantize
    commutes with the accumulate, as in the fused kernel's epilogue), the
    branches concatenated, then ``@ w_t`` as a ``torch.matmul``.  A
    branch's source is a few-KB codeword table, so the SpMM dispatch is
    not consulted; the tuner races this function itself.  On CPU tensors
    every step is the plain version's."""
    if isinstance(assignment, PackedAssignment):
        assignment = assignment.unpack()
    branch_ids = assignment[:, out_ids.long()].to(torch.int32)  # [nb, b, D]
    spmm = spmm_ell_cuda if out_vals.is_cuda else ref.spmm_ell
    out = torch.cat([
        spmm(branch_ids[i], out_vals, codewords[i],
             None if cw_scale is None else cw_scale[i])
        for i in range(codewords.shape[0])], dim=-1)
    if w_t is not None:
        out = torch.matmul(out, w_t.float())
    return out


def _note_context(variant, out_ids, out_vals, assignment, codewords, w_t,
                  cw_scale) -> None:
    """Record the context dispatch ``variant`` names: one fused launch
    (none without neighbour slots), or one resident SpMM a branch."""
    if not trace_count.active():
        return
    b, deg = out_ids.shape
    nb, _, f_blk = codewords.shape
    form = "f32" if cw_scale is None else "q"
    if variant == "loop":
        if b > 0 and f_blk > 0:
            for i in range(nb):
                trace_count.note("spmm_ell", form, out_ids, out_vals,
                                 codewords[i],
                                 None if cw_scale is None else cw_scale[i])
        return
    f_out = nb * f_blk if w_t is None else w_t.shape[1]
    if deg > 0 and b > 0 and f_out > 0:
        entry = context_entry(codewords.dtype, assignment, w_t is not None)
        trace_count.note("context_ell", entry, out_ids, out_vals, assignment,
                         codewords, cw_scale, w_t)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@trace_count.dispatcher
def vq_assign(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """[nb, n, f] rows vs [nb, k, f] codewords -> [nb, n] int32."""
    if trace_count.active() and x.shape[0] > 0 and x.shape[1] > 0:
        wide = _vq_assign.uses_wide(codewords.shape[1], x.shape[-1])
        trace_count.note("vq_assign", "wide" if wide else "narrow", x,
                         codewords)
    if x.is_cuda:
        return vq_assign_cuda(x, codewords)
    return ref.vq_assign(x, codewords)


@trace_count.dispatcher
def vq_assign_update(x: torch.Tensor, codewords: torch.Tensor, *,
                     emit_dtype=torch.int32
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Fused assign + cluster stats: [nb, b, f] rows vs [nb, k, f]
    codewords -> (assignment [nb, b] ``emit_dtype``, qerr [nb, b], counts
    [nb, k], sums [nb, k, f]).  ``emit_dtype`` torch.uint8 (k <= 256) or
    ``"uint4"`` (k <= 16, a uint8 tensor of values < 16) emits the
    assignment in a narrow tier's table type; an emit dtype that cannot
    index k raises, on either device."""
    emit = check_emit(emit_dtype, codewords.shape[1])
    if trace_count.active() and x.shape[0] > 0 and x.shape[1] > 0:
        wide = _vq_update.uses_wide(codewords.shape[1], codewords.shape[-1])
        trace_count.note(
            "vq_update", f"{'wide' if wide else 'narrow'} "
            f"{'int32' if emit == 'int32' else 'uint8'}", x, codewords)
    if x.is_cuda:
        tuned = autotune.tuned_vq_update(
            x.shape[1], codewords.shape[1], x.shape[-1], x.shape[0],
            emit_dtype) \
            if x.dim() == 3 and codewords.dim() == 3 else None
        return vq_assign_update_cuda(
            x, codewords, emit_dtype,
            wgs=None if tuned is None else int(tuned["wgs"]))
    return ref.vq_assign_update(x, codewords, emit_dtype)


@trace_count.dispatcher
def spmm_ell_t(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
               g: torch.Tensor, n_src: int) -> torch.Tensor:
    """Transposed ELLPACK SpMM: [b, D] ids/values, g [b, f] -> [n_src, f]."""
    if trace_count.active() and min(nbr_idx.shape[0], nbr_idx.shape[1],
                                    g.shape[1]) > 0:
        trace_count.note("spmm_ell_t", "f32", nbr_idx, nbr_val, g)
    if g.is_cuda:
        return spmm_ell_t_cuda(nbr_idx, nbr_val, g, n_src)
    return ref.spmm_ell_t(nbr_idx, nbr_val, g, n_src)


class _SpmmEll(torch.autograd.Function):
    """``spmm_ell`` with its backward in ``x`` (the edge ids and values
    are constants of the graph and get no gradient).  The forward runs the
    variant ``spmm_ell_variant`` picks; ``spmm_ell_t`` is the backward of
    both (the reference has no backward kernel: JAX autodiff computes
    it)."""

    @staticmethod
    def forward(ctx, nbr_idx, nbr_val, x, stripe_index):
        ctx.save_for_backward(nbr_idx, nbr_val)
        ctx.n_src = x.shape[0]
        if x.is_cuda:
            return _spmm_cuda(nbr_idx, nbr_val, x, stripe_index, None)
        _note_spmm_cpu(nbr_idx, nbr_val, x, None)
        return ref.spmm_ell(nbr_idx, nbr_val, x)

    @staticmethod
    def backward(ctx, g):
        nbr_idx, nbr_val = ctx.saved_tensors
        return None, None, spmm_ell_t(nbr_idx, nbr_val, g.contiguous(),
                                      ctx.n_src), None


@trace_count.dispatcher
def spmm_ell(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
             x: torch.Tensor | QTensor,
             stripe_index: Optional[StripeIndex] = None, *,
             x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELLPACK SpMM: [b, D] ids/values into an [n_src, f] source -> [b, f],
    differentiable in an f32 ``x``.  ``x`` may also be a ``QTensor`` of
    int8 / float8_e4m3fn rows with [1, f] scales (or pass ``x_scale`` with
    a quantized ``x``): a constant source, read in its storage type with
    one scale multiply after the accumulate.  Edge values that require
    grad are refused: on every path they are degree constants of the
    graph.

    A CUDA source goes to the kernel ``spmm_ell_variant`` picks;
    ``stripe_index`` (from ``graph.batching.make_stripe_index``) is read
    by the staged kernel only, which otherwise builds one on the device.
    A CPU source goes to the plain ``ref.spmm_ell``, as in the
    reference."""
    if isinstance(x, QTensor):
        x, x_scale = x.q, x.scale
    if x_scale is not None:
        if x.is_cuda:
            return _spmm_cuda(nbr_idx, nbr_val, x, stripe_index, x_scale)
        _note_spmm_cpu(nbr_idx, nbr_val, x, x_scale)
        return ref.spmm_ell(nbr_idx, nbr_val, x, x_scale)
    if nbr_val.requires_grad and torch.is_grad_enabled():
        raise ValueError("spmm_ell: nbr_val requires grad; the kernel's "
                         "backward covers x only (edge values are constants)")
    return _SpmmEll.apply(nbr_idx, nbr_val, x, stripe_index)


@trace_count.dispatcher
def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor | PackedAssignment,
                codewords: torch.Tensor | QTensor,
                w_t: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-branch codeword context -> [b, nb * f_blk], or ``@ w_t``
    -> [b, f_out].  ``codewords`` f32 or a ``QTensor`` (int8 / fp8 +
    [nb, 1, f_blk] scales); ``assignment`` int32, uint8 or a
    ``PackedAssignment``.  On the card the variant ``context_ell_variant``
    picks: the fused kernel (one launch in every case, ``w_t`` in its
    epilogue) or the per-branch loop (:func:`_context_ell_loop`)."""
    cw_scale = None
    if isinstance(codewords, QTensor):
        codewords, cw_scale = codewords.q, codewords.scale
    if out_vals.is_cuda or trace_count.active():
        packed = isinstance(assignment, PackedAssignment)
        nb, n = assignment.shape
        itemsize = 0.5 if packed else assignment.element_size()
        dtype = "uint4" if packed else assignment.dtype
        variant = context_ell_variant(n, nb, itemsize, dtype,
                                      measure=out_vals.is_cuda)
        _note_context(variant, out_ids, out_vals, assignment, codewords, w_t,
                      cw_scale)
        if out_vals.is_cuda:
            if variant == "loop":
                return _context_ell_loop(out_ids, out_vals, assignment,
                                         codewords, w_t, cw_scale)
            return context_ell_cuda(out_ids, out_vals, assignment, codewords,
                                    w_t, cw_scale)
    return ref.context_ell(out_ids, out_vals, assignment, codewords, w_t,
                           cw_scale)


@trace_count.dispatcher
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention: q [b, h, sq, d], k/v [b, h, skv, d] ->
    [b, h, sq, d]; causal masks keys past ``i + (skv - sq)``."""
    if trace_count.active():
        trace_count.note("flash_attention", _flash_route(q, k, v), q, k, v)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)


@trace_count.dispatcher
def vq_attention_decode(q: torch.Tensor, cb_k: torch.Tensor,
                        cb_v: torch.Tensor, mass: torch.Tensor,
                        win_k: torch.Tensor, win_v: torch.Tensor,
                        win_mask: torch.Tensor) -> torch.Tensor:
    """One VQ-Attention decode step for n GQA groups: q [n, g, d],
    codewords [n, k, d] with masses [n, k], window [n, w, d] with its mask
    [n, w] -> [n, g, d]."""
    if trace_count.active():
        trace_count.note("vq_attention", "decode", q, cb_k, cb_v, mass,
                         win_k, win_v, win_mask)
    if q.is_cuda:
        return vq_attention_decode_cuda(q, cb_k, cb_v, mass, win_k, win_v,
                                        win_mask)
    return ref.vq_attention_decode(q, cb_k, cb_v, mass, win_k, win_v,
                                   win_mask)
