"""Approximated forward and backward message passing (paper Eq. 6 / 7).

Torch twin of the fixed-convolution half of ``repro.core.message_passing``.
A mini-batch's messages split into

  * intra-batch messages  C_in X_B  -- exact, the ``spmm_ell`` kernel
    (its backward is the transposed ``spmm_ell_t`` kernel);
  * out-of-batch messages C~_out X~ -- from codewords, reconstruction form:
    neighbor j's features are rebuilt as concat_beta X~^beta[R^beta[j]]
    inside ONE ``context_ell`` launch for any branch count (or, in the
    sketch form of dense convolutions, C~_out = C_out R times the
    codewords, :func:`context_messages_sketch`).

Back-propagation uses the transposed approximated weights: the gradient
codewords G~ stand in for the messages that flow back from out-of-batch
nodes (Eq. 7).  Autograd cannot produce that rule (the codebook is
streaming EMA state), so :class:`InjectContextGrad` is a
``torch.autograd.Function``: identity on ``x_b`` in the forward pass, and
in the backward pass ONE ``context_ell`` launch with the fused ``@ W^T``
epilogue over the reverse edges.  Its residuals are lazy -- the edge
operands and the codebook, never a reconstructed [b, Dr, f_grad] tensor.

Under the precision tiers the codewords are ``QTensor`` snapshots (int8 /
fp8 values + f32 scales) and the table may be uint8 or a
``PackedAssignment``; both pass through to the kernels in their storage
types, the backward injection launching the quantized ``w_t`` form.

The learnable and dense convolutions (GAT, the Graph Transformer) mix the
branches through per-head weight maps, which the context kernel cannot
express: they rebuild out-of-batch rows with :func:`reconstruct` and
inject Eq. 7 with :func:`inject_context_grad_materialized` (an explicit
``[b, Dr, f]`` gradient tensor) or :func:`inject_context_grad_table` (a
``[m, f]`` table shared by every row), whose backward passes are plain
``einsum`` / ``@``, as the reference computes them outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed.quantization import PackedAssignment, QTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.spmm_ell_hbm import StripeIndex

Codewords = torch.Tensor | QTensor
Table = torch.Tensor | PackedAssignment


class InjectContextGrad(torch.autograd.Function):
    """Eq. 7's out-of-batch gradient messages as a custom backward.

    Forward: ``x_b`` unchanged; only the edge operands, the gradient
    codewords (values and, for a QTensor, scales), the assignment table
    (the packed buffer and its node count for a ``PackedAssignment``) and
    ``w`` are saved.  Backward: adds

        grad_X_B += (sum_d rev_vals[:, d] * G~[c(rev_ids[:, d])]) @ W^T

    where ``rev_vals[i, d] = C_{j_d, i}`` weighs the reverse (batch ->
    out-of-batch) edge and ``G~[c(j)]`` is node j's branch-concatenated
    gradient codeword -- the ``D_out G~ W^T`` term, one ``context_ell``
    launch with the ``w_t = W^T`` epilogue fused in.  ``w=None`` skips the
    W^T factor.  The saved operands get no gradient (the reference's
    custom_vjp returns zeros for them)."""

    @staticmethod
    def forward(ctx, x_b, rev_vals, rev_ids, cw, cw_scale, table, packed_n,
                w):
        ctx.save_for_backward(rev_vals, rev_ids, cw, cw_scale, table, w)
        ctx.packed_n = packed_n
        return x_b.view_as(x_b)

    @staticmethod
    def backward(ctx, g):
        rev_vals, rev_ids, cw, cw_scale, table, w = ctx.saved_tensors
        codewords = cw if cw_scale is None else QTensor(cw, cw_scale)
        assignment = table if ctx.packed_n is None \
            else PackedAssignment(table, ctx.packed_n)
        w_t = None if w is None else w.float().t().contiguous()
        phantom = kops.context_ell(rev_ids, rev_vals, assignment, codewords,
                                   w_t)
        return (g + phantom.to(g.dtype),) + (None,) * 7


def inject_context_grad(x_b: torch.Tensor, rev_vals: torch.Tensor,
                        rev_ids: torch.Tensor, grad_codewords: Codewords,
                        assignment: Table,
                        w: Optional[torch.Tensor]) -> torch.Tensor:
    """Identity on ``x_b`` with the Eq. 7 backward attached.  The codewords
    and ``w`` enter detached: the injection must add no gradient to them."""
    if isinstance(grad_codewords, QTensor):
        cw, cw_scale = grad_codewords.q, grad_codewords.scale
    else:
        cw, cw_scale = grad_codewords.detach(), None
    packed = isinstance(assignment, PackedAssignment)
    return InjectContextGrad.apply(
        x_b, rev_vals, rev_ids, cw, cw_scale,
        assignment.packed if packed else assignment,
        assignment.n if packed else None,
        None if w is None else w.detach())


class InjectContextGradDense(torch.autograd.Function):
    """Eq. 7 from an explicit gradient residual, for the convolutions that
    mix branches: identity on ``x_b`` in the forward pass; the backward
    adds the phantom term (``@ W^T`` when ``w`` is given) --
    ``einsum('bd,bdf->bf', rev_vals, grad)`` for a per-row ``[b, Dr, f]``
    residual (GAT: the reconstructed gradient codewords pass through the
    per-head value map before the edge weighting), ``rev_vals [b, m] @
    grad [m, f]`` for a table every row shares (the Graph Transformer:
    the receiving "neighbors" are the k clusters, so the residual is the
    table, not its [b, m, f] broadcast).  The saved operands get no
    gradient (the reference's custom_vjps return zeros for them)."""

    @staticmethod
    def forward(ctx, x_b, rev_vals, grad, w):
        ctx.save_for_backward(rev_vals, grad, w)
        return x_b.view_as(x_b)

    @staticmethod
    def backward(ctx, g):
        rev_vals, grad, w = ctx.saved_tensors
        rev, res = rev_vals.float(), grad.float()
        phantom = torch.einsum('bd,bdf->bf', rev, res) if res.dim() == 3 \
            else rev @ res
        if w is not None:
            phantom = phantom @ w.float().t()
        return g + phantom.to(g.dtype), None, None, None


def inject_context_grad_materialized(x_b: torch.Tensor,
                                     rev_vals: torch.Tensor,
                                     grad: torch.Tensor,
                                     w: Optional[torch.Tensor]
                                     ) -> torch.Tensor:
    """Identity on ``x_b``; the backward adds the phantom term of
    :class:`InjectContextGradDense` from a per-row ``[b, Dr, f]`` residual
    or a shared ``[m, f]`` table (``inject_context_grad_table``, the
    reference's name for the latter).  The other operands enter
    detached."""
    return InjectContextGradDense.apply(
        x_b, rev_vals.detach(), grad.detach(),
        None if w is None else w.detach())


inject_context_grad_table = inject_context_grad_materialized


def reconstruct(codewords: torch.Tensor, assignment: Table,
                node_ids: torch.Tensor) -> torch.Tensor:
    """Full-width rows of arbitrary nodes from product-VQ state:
    codewords [n_branches, k, f_blk] (feature or gradient codewords),
    assignment [n_branches, n] (int32, uint8 or packed), node_ids [...]
    -> [..., n_branches * f_blk], branch beta's codeword in columns
    beta * f_blk ..."""
    nb, _, fb = codewords.shape
    ids = assignment.gather(node_ids) \
        if isinstance(assignment, PackedAssignment) \
        else assignment[:, node_ids.long()]                   # [nb, ...]
    flat = ids.reshape(nb, -1).long()
    rows = torch.gather(codewords, 1,
                        flat[..., None].expand(nb, flat.shape[1], fb))
    return rows.transpose(0, 1).reshape(*node_ids.shape, nb * fb)


def context_messages_reconstruct(out_vals: torch.Tensor,
                                 out_ids: torch.Tensor,
                                 feat_codewords: Codewords,
                                 assignment: Table) -> torch.Tensor:
    """Out-of-batch forward messages, reconstruction form.

    out_vals: [b, D] C_{i, j_d} for out-of-batch neighbors (0 = padding)
    out_ids:  [b, D] their global node ids
    feat_codewords: [n_branches, k, f_blk] (or its QTensor snapshot);
    assignment: [n_branches, n] (int32, uint8 or packed)
    returns   [b, f] = sum_d out_vals[:, d] * X^_{j_d}
    """
    if isinstance(feat_codewords, torch.Tensor):
        feat_codewords = feat_codewords.detach()
    return kops.context_ell(out_ids, out_vals, assignment, feat_codewords)


def context_messages_sketch(c_out_sketch: torch.Tensor,
                            feat_codewords: torch.Tensor) -> torch.Tensor:
    """Out-of-batch forward messages, sketch form (dense convolutions):
    c_out_sketch [n_branches, b, k] (C~_out = C_out R, per branch),
    feat_codewords [n_branches, k, f_blk] -> [b, n_branches * f_blk].  An
    einsum outside any kernel, as in the reference; no gradient reaches
    the codewords."""
    cw = feat_codewords.detach().float()
    per_branch = torch.einsum("nbk,nkf->nbf", c_out_sketch.float(), cw)
    nb, b, fb = per_branch.shape
    return per_branch.transpose(0, 1).reshape(b, nb * fb)


def intra_messages(in_pos: torch.Tensor, in_vals: torch.Tensor,
                   x_b: torch.Tensor,
                   stripe_index: Optional[StripeIndex] = None
                   ) -> torch.Tensor:
    """Exact intra-mini-batch messages C_in X_B.

    in_pos: [b, D] int32 neighbor position inside the batch (-1 on padding
    and out-of-batch slots, which carry in_vals == 0); x_b: [b, f];
    ``stripe_index``: the staged SpMM kernel's index, when the batch's
    source is too large to stay on chip."""
    idx = torch.clamp(in_pos, min=0)
    return kops.spmm_ell(idx, in_vals, x_b, stripe_index)


class ConvOperands(NamedTuple):
    """Per-mini-batch operands of one convolution's approximated MP."""
    in_pos: torch.Tensor      # [b, D]   intra-batch neighbor positions (-1 pad)
    in_vals: torch.Tensor     # [b, D]   C_in values (0 on padding)
    out_ids: torch.Tensor     # [b, D]   out-of-batch neighbor global ids
    out_vals: torch.Tensor    # [b, D]   C_out values (0 on padding)
    rev_ids: torch.Tensor     # [b, Dr]  reverse-edge (batch -> out) target ids
    rev_vals: torch.Tensor    # [b, Dr]  C^T_out values (0 on padding)
    stripe_index: Optional[StripeIndex] = None  # the intra term's index


def approx_message_passing(ops_: ConvOperands, x_b: torch.Tensor,
                           feat_codewords: Codewords,
                           grad_codewords: Codewords,
                           assignment: Table,
                           w: Optional[torch.Tensor],
                           inject: bool = True) -> torch.Tensor:
    """Eq. 6 forward: M = C_in X_B + C~_out X~, shape [b, f], with the Eq. 7
    backward injection attached when ``inject`` (``grad_codewords`` and
    ``w`` feed only that injection)."""
    if inject:
        x_b = inject_context_grad(x_b, ops_.rev_vals, ops_.rev_ids,
                                  grad_codewords, assignment, w)
    m = intra_messages(ops_.in_pos, ops_.in_vals, x_b.contiguous(),
                       ops_.stripe_index)
    return m + context_messages_reconstruct(
        ops_.out_vals, ops_.out_ids, feat_codewords, assignment)
