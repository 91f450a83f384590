"""Generalized graph convolution operand builders (paper Sec. 2, Eq. 1-2).

Torch twin of the serving half of ``repro.core.conv``: the mini-batch pack,
the per-layer VQ state, the assignment histogram and refresh, the codeword
reads a layer feeds the context kernel, and the fixed-convolution edge
values (paper Table 1) that turn a pack into
:class:`~repro_torch.core.message_passing.ConvOperands`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import codebook as cbm
from repro_torch.core.codebook import CodebookConfig, CodebookState
from repro_torch.core.message_passing import ConvOperands
from repro_torch.runtime import PRECISION_SLICE, resolve_device


class MinibatchPack(NamedTuple):
    """Device-side mini-batch of nodes with padded (ELLPACK) neighbor lists.

    ``nbr_*`` are the in-edges (messages into batch nodes), ``rev_*`` the
    out-edges.  Positions are the index inside the batch if the other
    endpoint is also in the batch, else -1.  ``slot_mask`` (optional, [b])
    is 0 on the wrap-padded slots of a tail batch."""
    batch_ids: torch.Tensor   # [b]      global node ids, int32
    nbr_ids: torch.Tensor     # [b, D]   in-neighbor global ids (0 on padding)
    nbr_mask: torch.Tensor    # [b, D]   1.0 on real edges
    nbr_pos: torch.Tensor     # [b, D]   in-batch position or -1, int32
    rev_ids: torch.Tensor     # [b, Dr]  out-edge target global ids
    rev_mask: torch.Tensor    # [b, Dr]
    rev_pos: torch.Tensor     # [b, Dr]
    slot_mask: Optional[torch.Tensor] = None

    @property
    def b(self) -> int:
        return self.batch_ids.shape[0]


class LayerVQState(NamedTuple):
    """Per-layer VQ state: codebook + global assignment table.

    This slice keeps ``assignment`` int32 and ``qcw`` None; the quantized
    snapshot and the uint8/packed tables come with the precision tiers."""
    codebook: CodebookState
    assignment: torch.Tensor   # [n_branches, n] int32 codeword id per node
    counts: torch.Tensor       # [n_branches, k] f32 histogram of assignment
    qcw: Optional[Any] = None


def branch_histogram(ids: torch.Tensor, k: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-branch codeword histogram as ONE flattened segment-sum:
    ids [n_branches, m] -> [n_branches, k] f32 (branch beta's ids offset by
    beta * k).  Counts are whole numbers, so the f32 sum is exact in any
    order."""
    nb, m = ids.shape
    offs = k * torch.arange(nb, dtype=torch.int64, device=ids.device)
    flat = (ids.long() + offs[:, None]).reshape(-1)
    w = torch.ones(nb * m, dtype=torch.float32, device=ids.device) \
        if weights is None else weights.float().reshape(-1)
    hist = torch.zeros(nb * k, dtype=torch.float32, device=ids.device)
    return hist.index_add_(0, flat, w).reshape(nb, k)


def refresh_assignment(state: LayerVQState, batch_ids: torch.Tensor,
                       new_assign: torch.Tensor) -> LayerVQState:
    """Scatter refreshed batch assignments into the global table (Alg. 1
    line 16) and move the histogram with them: -1 on the evicted ids, +1 on
    the new ones, in one bincount.  Returns a new state (the old table is
    left untouched, as in the reference)."""
    if state.assignment.dtype != torch.int32:
        raise NotImplementedError(
            f"assignment tables of dtype {state.assignment.dtype} come "
            f"with {PRECISION_SLICE}")
    k = state.counts.shape[-1]
    idx = batch_ids.long()
    old = state.assignment[:, idx]                             # [nb, b]
    new = new_assign.to(torch.int32)
    delta = branch_histogram(
        torch.cat([old, new], dim=1), k,
        torch.cat([torch.full(old.shape, -1.0, device=old.device),
                   torch.ones(new.shape, device=new.device)], dim=1))
    assignment = state.assignment.index_copy(1, idx, new)
    return LayerVQState(state.codebook, assignment, state.counts + delta,
                        state.qcw)


def layer_codewords(vq: LayerVQState, f_feat: int, cfg: CodebookConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (feature, gradient) codeword tables a layer feeds the context
    kernel: dense f32 reads of the codebook."""
    if vq.qcw is not None:
        raise NotImplementedError(
            f"quantized codeword snapshots (qcw) come with {PRECISION_SLICE}")
    return (cbm.feature_codewords(vq.codebook, f_feat, cfg),
            cbm.gradient_codewords(vq.codebook, f_feat, cfg))


def init_layer_vq_state(n_nodes: int, f_feat: int, f_grad: int,
                        cfg: CodebookConfig, *,
                        generator: Optional[torch.Generator] = None,
                        device: str | torch.device = "cuda") -> LayerVQState:
    device = resolve_device(device)
    cb = cbm.init_codebook(f_feat, f_grad, cfg, generator=generator,
                           device=device)
    assignment = torch.randint(0, cfg.k, (cb.n_branches, n_nodes),
                               generator=generator,
                               dtype=torch.int32).to(device)
    return LayerVQState(cb, assignment, branch_histogram(assignment, cfg.k))


# ---------------------------------------------------------------------------
# fixed convolution edge values (paper Table 1)
# ---------------------------------------------------------------------------

def fixed_edge_values(kind: str, pack: MinibatchPack, degrees: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Edge values of a fixed convolution for a mini-batch.

    kind: 'gcn' (D~^-1/2 A~ D~^-1/2, self loop via ``self_vals``), 'mean'
    (SAGE-Mean, D^-1 A) or 'adj' (GIN, A).  degrees: [n] raw degrees.
    Returns (in_vals, out_vals, rev_vals, self_vals): the in-edge values
    split by in/out-of-batch, the reverse values on out-of-batch targets,
    and the [b] diagonal weight."""
    deg_i = degrees[pack.batch_ids.long()]                   # [b]
    deg_in = degrees[pack.nbr_ids.long()]                    # [b, D]
    deg_rev = degrees[pack.rev_ids.long()]                   # [b, Dr]

    if kind == 'gcn':
        dt_i = deg_i + 1.0
        vals = pack.nbr_mask / torch.sqrt(dt_i[:, None] * (deg_in + 1.0))
        rev = pack.rev_mask / torch.sqrt((deg_rev + 1.0) * dt_i[:, None])
        self_vals = 1.0 / dt_i
    elif kind == 'mean':
        vals = pack.nbr_mask / torch.clamp(deg_i, min=1.0)[:, None]
        rev = pack.rev_mask / torch.clamp(deg_rev, min=1.0)
        self_vals = torch.zeros_like(deg_i)
    elif kind == 'adj':
        vals = pack.nbr_mask
        rev = pack.rev_mask
        self_vals = torch.zeros_like(deg_i)
    else:
        raise ValueError(f"unknown fixed conv kind: {kind}")

    zero = vals.new_zeros(())
    in_vals = torch.where(pack.nbr_pos >= 0, vals, zero)
    out_vals = torch.where(pack.nbr_pos < 0, vals, zero)
    rev_vals = torch.where(pack.rev_pos < 0, rev, zero)
    return in_vals, out_vals, rev_vals, self_vals


def fixed_conv_operands(kind: str, pack: MinibatchPack, degrees: torch.Tensor
                        ) -> tuple[ConvOperands, torch.Tensor]:
    in_vals, out_vals, rev_vals, self_vals = fixed_edge_values(
        kind, pack, degrees)
    ops_ = ConvOperands(
        in_pos=pack.nbr_pos, in_vals=in_vals,
        out_ids=pack.nbr_ids, out_vals=out_vals,
        rev_ids=pack.rev_ids, rev_vals=rev_vals)
    return ops_, self_vals
