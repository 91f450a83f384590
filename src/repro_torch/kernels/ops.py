"""Dispatch between the CUDA kernels and their plain versions.

Decided by the operand's device alone: a CPU tensor goes to ``ref.py``, a
CUDA tensor goes to the hand-written kernel, whose wrapper validates it and
launches or raises.  There is no environment knob and no fallback: a CUDA
tensor that the kernel refuses is an error, never a silent plain-PyTorch
run.  ``spmm_ell`` is differentiable in ``x``: its backward is the
transposed kernel ``spmm_ell_t`` (dispatched the same way).  On the card
``spmm_ell`` has two kernels, as in the reference: the resident one and
the staged-stripe one for a source too large to stay on chip, picked by
the reference's precedence (``spmm_ell_variant``: a forced variant, then
a configured budget, then the default budget, here the H100's 50 MiB L2).  The LM side's
``vq_attention_decode`` and ``flash_attention`` follow the same rule: the
reference also sends ``flash_attention`` shapes with ``sq % 128 != 0`` to
its oracle, but here every CUDA tensor goes to the kernel, which handles
ragged tails itself.

The reference's context-variant and autotuner variables
(``REPRO_CONTEXT_VARIANT``, ``REPRO_CONTEXT_VMEM_BUDGET_MB``,
``REPRO_AUTOTUNE``, ``REPRO_AUTOTUNE_CACHE``) have no machinery here yet
(ROADMAP.md, modules to port, item 4): a setting that would change what
the reference runs raises instead of being ignored.

The precision tiers are data-driven here as in the reference: quantized
codewords arrive as a ``QTensor``, narrow tables as uint8 tensors or a
``PackedAssignment``, and each reaches its kernel form in its storage
type.  The tier setting (``configure_kernel_precision`` /
``REPRO_KERNEL_PRECISION``) only tells the functions that build VQ states
which storage to make (``core/conv.py``, ``models/gnn.py``,
``launch/serve_gnn.py``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.distributed.quantization import PackedAssignment, QTensor
from repro_torch.kernels import ref
from repro_torch.kernels.context_ell import context_ell_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
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
    return _check_precision(os.environ.get("REPRO_KERNEL_PRECISION", "fp32"),
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
# the reference's dispatch variables that the port does not honour yet
# ---------------------------------------------------------------------------

_ITEM_4 = ("the port has no context-variant dispatch or autotuner yet "
           "(ROADMAP.md, modules to port, item 4)")


def check_unported_env(*, context: bool = False) -> None:
    """Raise on the reference's autotuner switches (``REPRO_AUTOTUNE=1``,
    any ``REPRO_AUTOTUNE_CACHE``) and, with ``context``, on its context
    dispatch (``REPRO_CONTEXT_VARIANT`` other than auto / fused -- the
    port's one kernel is the fused variant -- and any
    ``REPRO_CONTEXT_VMEM_BUDGET_MB``), where the reference reads them."""
    env = os.environ
    if env.get("REPRO_AUTOTUNE", "0") == "1":
        raise ValueError(f"REPRO_AUTOTUNE=1: {_ITEM_4}")
    if "REPRO_AUTOTUNE_CACHE" in env:
        raise ValueError(f"REPRO_AUTOTUNE_CACHE is set: {_ITEM_4}")
    if not context:
        return
    variant = env.get("REPRO_CONTEXT_VARIANT", "auto")
    if variant not in ("auto", "fused", "loop"):
        raise ValueError(f"REPRO_CONTEXT_VARIANT={variant!r}: want auto, "
                         f"fused or loop")
    if variant == "loop":
        raise ValueError(f"REPRO_CONTEXT_VARIANT=loop: {_ITEM_4}")
    if "REPRO_CONTEXT_VMEM_BUDGET_MB" in env:
        raise ValueError(f"REPRO_CONTEXT_VMEM_BUDGET_MB is set: {_ITEM_4}")


# ---------------------------------------------------------------------------
# spmm_ell variant dispatch: the resident kernel or the staged-stripe one
# ---------------------------------------------------------------------------

SPMM_VARIANTS = ("auto", "resident", "hbm")
# The H100's L2 (NVIDIA's data sheet): a source that fits stays there
# between the resident kernel's gathers; a larger one is staged in stripes.
_DEFAULT_L2_BUDGET_MB = 50.0

# Programmatic overrides; they take precedence over the environment.
_dispatch_overrides: dict[str, object] = {}


def _l2_budget_mb() -> float:
    raw = _dispatch_overrides.get(
        "l2_budget_mb", os.environ.get("REPRO_SPMM_L2_BUDGET_MB",
                                       _DEFAULT_L2_BUDGET_MB))
    try:
        budget = float(raw)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        raise ValueError(f"REPRO_SPMM_L2_BUDGET_MB={raw!r}: want a positive "
                         f"float (MiB)") from None
    if budget <= 0.0:
        raise ValueError(f"REPRO_SPMM_L2_BUDGET_MB={raw!r}: want a positive "
                         f"float (MiB)")
    return budget


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


def spmm_ell_variant(n_src: int, f: int, itemsize: int = 4) -> str:
    """'resident' or 'hbm' for an [n_src, f] source of ``itemsize``-byte
    elements.  Precedence: a forced variant (``configure_spmm_dispatch``,
    else ``REPRO_SPMM_VARIANT``), then the budget (configured, else
    ``REPRO_SPMM_L2_BUDGET_MB``, else 50 MiB)."""
    check_unported_env()
    forced = _dispatch_overrides.get(
        "variant", os.environ.get("REPRO_SPMM_VARIANT", "auto"))
    if forced not in SPMM_VARIANTS:
        raise ValueError(
            f"REPRO_SPMM_VARIANT={forced!r}: want auto, resident or hbm")
    if forced != "auto":
        return str(forced)
    return "hbm" if n_src * f * itemsize > _l2_budget_mb() * 2 ** 20 \
        else "resident"


def _spmm_cuda(nbr_idx, nbr_val, x, stripe_index, x_scale):
    """The card's SpMM kernel for this source, by ``spmm_ell_variant``."""
    if spmm_ell_variant(x.shape[0], x.shape[1], x.element_size()) == "hbm":
        return spmm_ell_hbm_cuda(nbr_idx, nbr_val, x, stripe_index, x_scale)
    return spmm_ell_cuda(nbr_idx, nbr_val, x, x_scale)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def vq_assign(x: torch.Tensor, codewords: torch.Tensor) -> torch.Tensor:
    """[nb, n, f] rows vs [nb, k, f] codewords -> [nb, n] int32."""
    if x.is_cuda:
        return vq_assign_cuda(x, codewords)
    return ref.vq_assign(x, codewords)


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
    check_emit(emit_dtype, codewords.shape[1])
    check_unported_env()
    if x.is_cuda:
        return vq_assign_update_cuda(x, codewords, emit_dtype)
    return ref.vq_assign_update(x, codewords, emit_dtype)


def spmm_ell_t(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
               g: torch.Tensor, n_src: int) -> torch.Tensor:
    """Transposed ELLPACK SpMM: [b, D] ids/values, g [b, f] -> [n_src, f]."""
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
        return ref.spmm_ell(nbr_idx, nbr_val, x)

    @staticmethod
    def backward(ctx, g):
        nbr_idx, nbr_val = ctx.saved_tensors
        return None, None, spmm_ell_t(nbr_idx, nbr_val, g.contiguous(),
                                      ctx.n_src), None


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
        return ref.spmm_ell(nbr_idx, nbr_val, x, x_scale)
    if nbr_val.requires_grad and torch.is_grad_enabled():
        raise ValueError("spmm_ell: nbr_val requires grad; the kernel's "
                         "backward covers x only (edge values are constants)")
    return _SpmmEll.apply(nbr_idx, nbr_val, x, stripe_index)


def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor | PackedAssignment,
                codewords: torch.Tensor | QTensor,
                w_t: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-branch codeword context -> [b, nb * f_blk], or ``@ w_t``
    fused into the same kernel -> [b, f_out].  ``codewords`` f32 or a
    ``QTensor`` (int8 / fp8 + [nb, 1, f_blk] scales); ``assignment`` int32,
    uint8 or a ``PackedAssignment`` -- one launch in every case."""
    check_unported_env(context=True)
    cw_scale = None
    if isinstance(codewords, QTensor):
        codewords, cw_scale = codewords.q, codewords.scale
    if out_vals.is_cuda:
        return context_ell_cuda(out_ids, out_vals, assignment, codewords, w_t,
                                cw_scale)
    return ref.context_ell(out_ids, out_vals, assignment, codewords, w_t,
                           cw_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention: q [b, h, sq, d], k/v [b, h, skv, d] ->
    [b, h, sq, d]; causal masks keys past ``i + (skv - sq)``."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)


def vq_attention_decode(q: torch.Tensor, cb_k: torch.Tensor,
                        cb_v: torch.Tensor, mass: torch.Tensor,
                        win_k: torch.Tensor, win_v: torch.Tensor,
                        win_mask: torch.Tensor) -> torch.Tensor:
    """One VQ-Attention decode step for n GQA groups: q [n, g, d],
    codewords [n, k, d] with masses [n, k], window [n, w, d] with its mask
    [n, w] -> [n, g, d]."""
    if q.is_cuda:
        return vq_attention_decode_cuda(q, cb_k, cb_v, mass, win_k, win_v,
                                        win_mask)
    return ref.vq_attention_decode(q, cb_k, cb_v, mass, win_k, win_v,
                                   win_mask)
