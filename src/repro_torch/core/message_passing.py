"""Approximated forward message passing (paper Eq. 6).

Torch twin of the forward half of ``repro.core.message_passing``.  A
mini-batch's messages split into

  * intra-batch messages  C_in X_B  -- exact, the ``spmm_ell`` kernel;
  * out-of-batch messages C~_out X~ -- from codewords, reconstruction form:
    neighbor j's features are rebuilt as concat_beta X~^beta[R^beta[j]]
    inside ONE ``context_ell`` launch for any branch count.

The Eq. 7 backward injection (``inject_context_grad``, a
``torch.autograd.Function`` streaming the gradient codewords through the
same context kernel with a ``w_t`` epilogue) comes with the training
slice; ``approx_message_passing(inject=True)`` raises until then.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.runtime import TRAINING_SLICE


def context_messages_reconstruct(out_vals: torch.Tensor,
                                 out_ids: torch.Tensor,
                                 feat_codewords: torch.Tensor,
                                 assignment: torch.Tensor) -> torch.Tensor:
    """Out-of-batch forward messages, reconstruction form.

    out_vals: [b, D] C_{i, j_d} for out-of-batch neighbors (0 = padding)
    out_ids:  [b, D] their global node ids
    feat_codewords: [n_branches, k, f_blk];  assignment: [n_branches, n]
    returns   [b, f] = sum_d out_vals[:, d] * X^_{j_d}
    """
    return kops.context_ell(out_ids, out_vals, assignment,
                            feat_codewords.detach())


def intra_messages(in_pos: torch.Tensor, in_vals: torch.Tensor,
                   x_b: torch.Tensor) -> torch.Tensor:
    """Exact intra-mini-batch messages C_in X_B.

    in_pos: [b, D] int32 neighbor position inside the batch (-1 on padding
    and out-of-batch slots, which carry in_vals == 0); x_b: [b, f]."""
    idx = torch.clamp(in_pos, min=0)
    return kops.spmm_ell(idx, in_vals, x_b)


class ConvOperands(NamedTuple):
    """Per-mini-batch operands of one convolution's approximated MP."""
    in_pos: torch.Tensor      # [b, D]   intra-batch neighbor positions (-1 pad)
    in_vals: torch.Tensor     # [b, D]   C_in values (0 on padding)
    out_ids: torch.Tensor     # [b, D]   out-of-batch neighbor global ids
    out_vals: torch.Tensor    # [b, D]   C_out values (0 on padding)
    rev_ids: torch.Tensor     # [b, Dr]  reverse-edge (batch -> out) target ids
    rev_vals: torch.Tensor    # [b, Dr]  C^T_out values (0 on padding)


def approx_message_passing(ops_: ConvOperands, x_b: torch.Tensor,
                           feat_codewords: torch.Tensor,
                           grad_codewords: torch.Tensor,
                           assignment: torch.Tensor,
                           w: Optional[torch.Tensor],
                           inject: bool = True) -> torch.Tensor:
    """Eq. 6 forward: M = C_in X_B + C~_out X~, shape [b, f].

    ``grad_codewords`` and ``w`` only feed the Eq. 7 backward injection,
    which this slice does not carry: ``inject=True`` raises."""
    if inject:
        raise NotImplementedError(
            f"the Eq. 7 backward injection (inject=True) comes with "
            f"{TRAINING_SLICE}; serving and inference pass inject=False")
    m = intra_messages(ops_.in_pos, ops_.in_vals, x_b.contiguous())
    return m + context_messages_reconstruct(
        ops_.out_vals, ops_.out_ids, feat_codewords, assignment)
