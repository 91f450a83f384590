"""Generalized graph convolution operand builders (paper Sec. 2, Eq. 1-2).

Torch twin of ``repro.core.conv``: the mini-batch pack, the per-layer VQ
state in every precision tier, the assignment histogram and refresh, the
tier's storage choices and quantized snapshot, the codeword reads a layer
feeds the context kernel (or, for the learnable and dense convolutions,
dense f32 tables), the fixed-convolution edge values (paper Table 1) that
turn a pack into :class:`~repro_torch.core.message_passing.ConvOperands`,
and the out-of-batch cluster masses of a dense convolution (Table 5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import codebook as cbm
from repro_torch.core.codebook import CodebookConfig, CodebookState
from repro_torch.core.message_passing import ConvOperands
from repro_torch.distributed.quantization import (PackedAssignment, QTensor,
                                                  last_positions)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.context_ell import is_node_major
from repro_torch.kernels.spmm_ell_hbm import StripeIndex
from repro_torch.runtime import resolve_device


class MinibatchPack(NamedTuple):
    """Device-side mini-batch of nodes with padded (ELLPACK) neighbor lists.

    ``nbr_*`` are the in-edges (messages into batch nodes), ``rev_*`` the
    out-edges.  Positions are the index inside the batch if the other
    endpoint is also in the batch, else -1.  ``slot_mask`` (optional, [b])
    is 0 on the wrap-padded slots of a tail batch.  ``stripe_index``
    (optional) is the intra-batch term's stripe index for the staged SpMM
    kernel; ``plan_batch`` leaves it None, as the reference's does."""
    batch_ids: torch.Tensor   # [b]      global node ids, int32
    nbr_ids: torch.Tensor     # [b, D]   in-neighbor global ids (0 on padding)
    nbr_mask: torch.Tensor    # [b, D]   1.0 on real edges
    nbr_pos: torch.Tensor     # [b, D]   in-batch position or -1, int32
    rev_ids: torch.Tensor     # [b, Dr]  out-edge target global ids
    rev_mask: torch.Tensor    # [b, Dr]
    rev_pos: torch.Tensor     # [b, Dr]
    stripe_index: Optional[StripeIndex] = None
    slot_mask: Optional[torch.Tensor] = None

    @property
    def b(self) -> int:
        return self.batch_ids.shape[0]


class QuantizedCodewords(NamedTuple):
    """int8 / fp8 kernel-operand snapshot of a layer's codeword tables:
    [nb, k, f_blk] values with [nb, 1, f_blk] f32 scales each."""
    feat: QTensor   # feature codewords X~ (Eq. 6 forward)
    grad: QTensor   # gradient codewords G~ (Eq. 7 backward)


class LayerVQState(NamedTuple):
    """Per-layer VQ state: codebook + global assignment table.

    ``assignment`` is int32, uint8 under the int8 / fp8 tiers (k <= 256)
    or a nibble-packed ``PackedAssignment`` under the '+a4' tiers
    (k <= 16).  ``qcw``, when present, is the int8 / fp8 snapshot of the
    codeword tables the layers feed the context kernel instead of dense
    f32 reads; the codebook update rebuilds it (quantize-on-update, in its
    own storage dtype) and assignment refreshes keep it.  On the card the
    table of a state with a snapshot is held node-major
    (:func:`hold_table`)."""
    codebook: CodebookState
    assignment: torch.Tensor | PackedAssignment   # [n_branches, n]
    counts: torch.Tensor       # [n_branches, k] f32 histogram of assignment
    qcw: Optional[QuantizedCodewords] = None


def branch_histogram(ids: torch.Tensor, k: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-branch codeword histogram as ONE flattened segment-sum:
    ids [n_branches, m] (int32 or uint8) -> [n_branches, k] f32 (branch
    beta's ids offset by beta * k).  Counts are whole numbers, so the f32
    sum is exact in any order."""
    nb, m = ids.shape
    offs = k * torch.arange(nb, dtype=torch.int64, device=ids.device)
    flat = (ids.long() + offs[:, None]).reshape(-1)
    w = torch.ones(nb * m, dtype=torch.float32, device=ids.device) \
        if weights is None else weights.float().reshape(-1)
    hist = torch.zeros(nb * k, dtype=torch.float32, device=ids.device)
    return hist.index_add_(0, flat, w).reshape(nb, k)


def hold_table(state: LayerVQState) -> LayerVQState:
    """The state with its table in the layout the context kernel reads
    fastest.  On the card, a state that carries a quantized codeword
    snapshot (a precision tier) holds its table node-major -- the same
    [n_branches, n] values (a packed table's bytes) over [n, n_branches]
    storage, a node's ids in every branch in one memory sector, as the
    Pallas kernel reads its transposed table: the kernel then stages the
    1-byte codewords in shared memory and waits on the table's reads,
    1.6-2.0x faster node-major at the training batch (PERF.md) -- where
    its offsets fit the kernel's 32 bits.  Every other table is row-major:
    an fp32 state's codewords are gathered from L2, where the two layouts
    measured within 1.2x, and nothing reads a table on the CPU in place."""
    table = state.assignment
    packed = isinstance(table, PackedAssignment)
    buf = table.packed if packed else table
    if buf.is_cuda and state.qcw is not None and buf.numel() < 2 ** 31:
        buf = buf if is_node_major(buf) else buf.t().contiguous().t()
    else:
        buf = buf.contiguous()
    return state._replace(
        assignment=PackedAssignment(buf, table.n) if packed else buf)


def refresh_assignment(state: LayerVQState, batch_ids: torch.Tensor,
                       new_assign: torch.Tensor) -> LayerVQState:
    """Scatter refreshed batch assignments into the global table (Alg. 1
    line 16) in its storage type (int32, uint8 or nibble-packed) and move
    the histogram with them: -1 on the evicted ids, +1 on the new ones, in
    one bincount.  Where an id repeats in ``batch_ids`` its last entry
    wins, as in the reference's sequential scatter, on every device.
    Returns a new state (the old table is left untouched, as in the
    reference) whose table keeps the old one's layout."""
    k = state.counts.shape[-1]
    idx = batch_ids.long()
    table = state.assignment
    packed = isinstance(table, PackedAssignment)
    old = table.gather(idx) if packed else table[:, idx]        # [nb, b]
    dtype = torch.uint8 if packed else table.dtype
    new = new_assign.to(dtype)
    delta = branch_histogram(
        torch.cat([old, new], dim=1), k,
        torch.cat([torch.full(old.shape, -1.0, device=old.device),
                   torch.ones(new.shape, device=new.device)], dim=1))
    if packed:
        assignment = table.scatter(idx, new)
    else:
        # every entry writes its id's last value: duplicates agree, and no
        # entry is selected by a mask, so nothing waits on the host
        new = new[:, last_positions(idx, table.shape[1])]
        if is_node_major(table):        # written along its storage rows
            assignment = table.t().index_copy(0, idx, new.t()).t()
        else:
            assignment = table.index_copy(1, idx, new)
    return LayerVQState(state.codebook, assignment, state.counts + delta,
                        state.qcw)


def assignment_dtype(cfg: CodebookConfig) -> torch.dtype:
    """Element type of the global assignment table under the active tier:
    uint8 when a quantized tier is on and k fits a byte (4x smaller than
    int32), else int32.  The '+a4' tiers also pack the uint8 values two a
    byte -- see :func:`assignment_packed`."""
    quantized = kops.precision_codeword_dtype() is not None and cfg.k <= 256
    return torch.uint8 if quantized else torch.int32


def assignment_packed(cfg: CodebookConfig) -> bool:
    """True when the active tier nibble-packs the table (a '+a4' tier and
    k <= 16; a larger k stays unpacked, as k > 256 stays int32)."""
    return kops.precision_packs_assignment() and cfg.k <= 16


def quantize_layer_state(state: LayerVQState, f_feat: int,
                         cfg: CodebookConfig,
                         dtype: torch.dtype = torch.int8) -> LayerVQState:
    """(Re)build the quantized codeword snapshot from the current codebook,
    reusing the previous snapshot's scales inside the drift band.
    ``dtype`` (int8 or float8_e4m3fn) only matters on the first build; an
    existing snapshot keeps its storage dtype."""
    prev = state.qcw
    qf, qg = cbm.quantized_codewords(
        state.codebook, f_feat, cfg,
        prev_feat=None if prev is None else prev.feat,
        prev_grad=None if prev is None else prev.grad, dtype=dtype)
    return state._replace(qcw=QuantizedCodewords(qf, qg))


def layer_codewords(vq: LayerVQState, f_feat: int, cfg: CodebookConfig, *,
                    dense: bool = False):
    """The (feature, gradient) codeword operands a layer feeds the context
    kernel: the int8 / fp8 QTensor snapshot when one is attached, else
    dense f32 reads of the codebook.  ``dense=True`` always reads the f32
    tables: GAT and the Graph Transformer mix the branches through per-head
    weight maps, so their math needs real tables."""
    if vq.qcw is not None and not dense:
        return vq.qcw.feat, vq.qcw.grad
    return (cbm.feature_codewords(vq.codebook, f_feat, cfg),
            cbm.gradient_codewords(vq.codebook, f_feat, cfg))


def init_layer_vq_state(n_nodes: int, f_feat: int, f_grad: int,
                        cfg: CodebookConfig, *,
                        generator: Optional[torch.Generator] = None,
                        device: str | torch.device = "cuda") -> LayerVQState:
    """A fresh layer state in the active tier's storage: the table uint8
    or nibble-packed where the tier and k allow (the ids are drawn as
    int32 either way, so a seed gives the same ids in every tier) and,
    under a quantized tier, the codeword snapshot."""
    device = resolve_device(device)
    cb = cbm.init_codebook(f_feat, f_grad, cfg, generator=generator,
                           device=device)
    assignment = torch.randint(0, cfg.k, (cb.n_branches, n_nodes),
                               generator=generator,
                               dtype=torch.int32).to(device)
    assignment = assignment.to(assignment_dtype(cfg))
    counts = branch_histogram(assignment, cfg.k)
    if assignment_packed(cfg):
        assignment = PackedAssignment.pack(assignment)
    state = LayerVQState(cb, assignment, counts)
    cw_dtype = kops.precision_codeword_dtype()
    if cw_dtype is not None:
        state = quantize_layer_state(state, f_feat, cfg, dtype=cw_dtype)
    return hold_table(state)


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
        rev_ids=pack.rev_ids, rev_vals=rev_vals,
        stripe_index=pack.stripe_index)
    return ops_, self_vals


# ---------------------------------------------------------------------------
# dense / global convolution sketch masses (Graph Transformer; Table 5)
# ---------------------------------------------------------------------------

def out_of_batch_cluster_mass(state: LayerVQState,
                              batch_ids: torch.Tensor) -> torch.Tensor:
    """The cluster sizes outside the batch, [n_branches, k] f32: for a
    dense convolution the fixed mask is all ones, so the sketch C_out R
    reduces per row to the global histogram minus the batch members'
    clusters -- O(k), not O(n).  Any table storage (int32, uint8 or
    nibble-packed)."""
    k = state.counts.shape[-1]
    table = state.assignment
    idx = batch_ids.long()
    batch = table.gather(idx) if isinstance(table, PackedAssignment) \
        else table[:, idx]                                    # [nb, b]
    return torch.clamp(state.counts - branch_histogram(batch, k), min=0.0)
