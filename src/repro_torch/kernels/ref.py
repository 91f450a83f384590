"""Plain PyTorch versions of the port's kernels.

Twins of ``repro.kernels.ref`` (``vq_assign``, ``vq_assign_update`` with
its narrow ``emit_dtype``, ``spmm_ell`` with its int8 / fp8 source and
``x_scale``, ``context_ell`` with its optional ``w_t`` epilogue, int8 /
fp8 codewords with ``cw_scale`` and uint8 or nibble-packed assignment
tables) plus
``spmm_ell_t``, the transposed SpMM that is ``spmm_ell``'s backward in
``x`` (the reference gets it from JAX autodiff), and ``spmm_ell_hbm``,
``spmm_ell`` summed in the staged-stripe kernel's order (the reference's
own oracle for its HBM kernel is ``spmm_ell``): the numerical ground
truth each CUDA kernel is held against, and the CPU execution path of
``ops.py``.  On a CUDA card nothing on the main path calls them;
``chip_smoke.py`` runs them there only to compare with the kernels.

Each sums in the kernel's order -- over the D neighbor slots, or over the
f feature dims, one separately rounded multiply and add at a time, as the
Pallas kernels' loops do -- so a CUDA kernel that keeps that order (and
rounds each step, ``__fmul_rn``/``__fadd_rn``) agrees with its plain
version bit for bit.  A 1-byte int8 or fp8 e4m3 value widens to f32
exactly, and the scale multiplies once, after the last slot (before the
``w_t`` columns are summed), so the quantized forms are bit-equal too.
The exceptions are the scatter-adds (the
``vq_assign_update`` cluster sums and ``spmm_ell_t``): their kernels add
with atomics in no fixed order, so they agree to a stated tolerance.

The LM side's two attention functions (``vq_attention_decode``,
``flash_attention``) are the reference oracles' plain softmax: their
kernels stream the keys with an online softmax, so they agree to a stated
tolerance (f32 ``rtol=1e-5, atol=1e-6``, bf16 two units in the last
place), not bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.quantization import PackedAssignment
from repro_torch.kernels.spmm_ell_hbm import check_index

# rows per [nb, rows, k] distance block of vq_assign: bounds the plain
# version's scratch to 256 MiB per temporary at any n (the kernel needs none)
_ASSIGN_BLOCK_ELEMS = 1 << 26


def _sq_norms(v: torch.Tensor) -> torch.Tensor:
    """sum_j v[..., j]^2 over the last dim, in j order: [..., f] -> [...]."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j] * v[..., j]
    return acc


def _min_dist_blocks(x: torch.Tensor, c32: torch.Tensor):
    """Yield (row slice, argmin [nb, r], min distance [nb, r]) over row
    blocks of ``|c|^2 - 2 x.c``, the dot summed over j in order."""
    nb, b, f = x.shape
    k = c32.shape[1]
    cn2 = _sq_norms(c32)[:, None, :]                           # [nb, 1, k]
    rows = max(1, _ASSIGN_BLOCK_ELEMS // max(1, nb * k))
    for s in range(0, b, rows):
        xs = x[:, s:s + rows].float()                          # [nb, r, f]
        dot = torch.zeros((nb, xs.shape[1], k), dtype=torch.float32,
                          device=x.device)
        for j in range(f):
            dot = dot + xs[:, :, j, None] * c32[:, None, :, j]
        dist = cn2 - 2.0 * dot
        arg = torch.argmin(dist, dim=2)          # first index on ties
        yield slice(s, s + rows), arg, dist.gather(2, arg[..., None])[..., 0]


def vq_assign(x: torch.Tensor, codewords: torch.Tensor,
              want_min: bool = False):
    """Nearest codeword by squared L2, every branch at once.

    x: [nb, b, f] (any strides), codewords: [nb, k, f] -> [nb, b] int32.
    The distance is ``|c|^2 - 2 x.c`` (``|x|^2`` is constant per row); ties
    keep the lowest index, as ``jnp.argmin`` does.  ``want_min`` also
    returns each row's squared distance to its codeword, [nb, b] f32:
    ``max(min + |x|^2, 0)``, the winning ``|c|^2 - 2 x.c`` completed as
    the reference's ``vq_assign_pallas(want_min=True)`` completes it (not
    a direct ``|x - c|^2``, which rounds differently)."""
    nb, b, _ = x.shape
    out = torch.empty((nb, b), dtype=torch.int32, device=x.device)
    mind = torch.empty((nb, b), dtype=torch.float32, device=x.device)
    for rows, arg, m in _min_dist_blocks(x, codewords.float()):
        out[:, rows] = arg.to(torch.int32)
        mind[:, rows] = m
    if not want_min:
        return out
    return out, torch.clamp(mind + _sq_norms(x.float()), min=0.0)


def vq_assign_update(x: torch.Tensor, codewords: torch.Tensor,
                     emit_dtype=torch.int32
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Fused assign + cluster statistics, every branch at once (the
    reference vmaps its one-branch oracle over the branches).

    x: [nb, b, f], codewords: [nb, k, f] -> (assignment [nb, b] int32,
    qerr [nb, b], counts [nb, k], sums [nb, k, f]).  The assignment is
    :func:`vq_assign`'s, from the same distances in the same order;
    ``qerr = max(min_dist + |x|^2, 0)`` completes the winning
    ``|c|^2 - 2 x.c`` to the squared error as the reference does (not a
    direct ``|x - c|^2``, which rounds differently); counts and sums are
    scatter-adds keyed by the assignment, no [b, k] one-hot.

    ``emit_dtype`` (``torch.int32``, ``torch.uint8`` or ``"uint4"``, whose
    result is a uint8 tensor of values < 16) is the assignment's storage
    type; the caller checks that k fits it (``ops.vq_assign_update``)."""
    nb, b, f = x.shape
    k = codewords.shape[1]
    dev = x.device
    idx, qerr = vq_assign(x, codewords, want_min=True)
    x32 = x.float()
    flat = (idx.long() + k * torch.arange(nb, device=dev)[:, None]
            ).reshape(-1)
    counts = torch.zeros(nb * k, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.ones(nb * b, dtype=torch.float32, device=dev))
    sums = torch.zeros((nb * k, f), dtype=torch.float32, device=dev
                       ).index_add_(0, flat, x32.reshape(nb * b, f))
    if emit_dtype != torch.int32:
        idx = idx.to(torch.uint8)
    return idx, qerr, counts.reshape(nb, k), sums.reshape(nb, k, f)


def spmm_ell(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
             x: torch.Tensor, x_scale: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Padded-neighbor (ELLPACK) sparse @ dense.

    nbr_idx: [b, D] int (padding entries point at a valid row, val 0)
    nbr_val: [b, D] float;  x: [n_src, f] f32, or int8 / float8_e4m3fn
    rows with ``x_scale`` [1, f] f32 per-channel scales, multiplied once
    after the last slot
    returns  [b, f] with out[i] = sum_d val[i,d] * x[idx[i,d]] (* scale)
    """
    b, deg = nbr_idx.shape
    idx = nbr_idx.long()
    val = nbr_val.float()
    x32 = x.float()
    acc = torch.zeros((b, x.shape[1]), dtype=torch.float32, device=x.device)
    for d in range(deg):
        acc = acc + val[:, d, None] * x32[idx[:, d]]
    if x_scale is not None:
        acc = acc * x_scale.float().reshape(1, -1)
    return acc


def spmm_ell_hbm(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                 x: torch.Tensor, stripe_index,
                 x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`spmm_ell` in the staged kernel's order, for a source staged
    in the stripes of ``stripe_index`` (a ``kernels.spmm_ell_hbm
    .StripeIndex``).

    Each row's live slots (val != 0, in a stripe its tile lists) are
    stably sorted by stripe and added one by one, each product and sum
    rounded on its own, vectorised over the rows; padding slots and slots
    of unlisted stripes add nothing, and neighbour ids are clamped into
    ``[0, n_src)``, as in the kernel.  ``x_scale`` multiplies once after
    the last slot.  An index built for another tiling or source raises
    the kernel's ``ValueError``."""
    b, deg = nbr_idx.shape
    n_src, f = x.shape
    check_index(stripe_index, b, n_src)
    bb, stripe = stripe_index.bb, stripe_index.stripe
    dev = x.device
    n_stripes = -(-n_src // stripe)
    idx = nbr_idx.long().clamp(0, n_src - 1)
    val = nbr_val.float()
    sid = idx // stripe
    ids, counts = stripe_index.ids.long(), stripe_index.counts.long()
    nt = ids.shape[0]
    listed = torch.zeros((nt, n_stripes + 1), dtype=torch.bool, device=dev)
    width = ids.shape[1]
    live_id = torch.arange(width, device=dev)[None, :] < counts[:, None]
    listed.scatter_(1, torch.where(live_id, ids, n_stripes), True)
    tile = torch.arange(b, device=dev) // bb
    live = (val != 0) & listed[tile[:, None], sid]
    key = torch.where(live, sid, n_stripes)
    order = torch.sort(key, dim=1, stable=True).indices
    idx, val, live = (idx.gather(1, order), val.gather(1, order),
                      live.gather(1, order))
    x32 = x.float()
    acc = torch.zeros((b, f), dtype=torch.float32, device=dev)
    for d in range(deg):
        acc = torch.where(live[:, d, None],
                          acc + val[:, d, None] * x32[idx[:, d]], acc)
    if x_scale is not None:
        acc = acc * x_scale.float().reshape(1, -1)
    return acc


def spmm_ell_t(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
               g: torch.Tensor, n_src: int) -> torch.Tensor:
    """Transposed ELLPACK SpMM, the backward of :func:`spmm_ell` in x:
    grad_x[idx[i, d]] += val[i, d] * g[i], over d in order.

    nbr_idx/nbr_val: [b, D]; g: [b, f] -> [n_src, f]."""
    idx = nbr_idx.long()
    val = nbr_val.float()
    g32 = g.float()
    out = torch.zeros((n_src, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for d in range(nbr_idx.shape[1]):
        out.index_add_(0, idx[:, d], val[:, d, None] * g32)
    return out


def context_ell(out_ids: torch.Tensor, out_vals: torch.Tensor,
                assignment: torch.Tensor | PackedAssignment,
                codewords: torch.Tensor, w_t: torch.Tensor | None = None,
                cw_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-branch VQ-context SpMM (the Eq. 6 out-of-batch term; with
    reverse-edge operands, gradient codewords and ``w_t`` the Eq. 7
    backward).

    out_ids/out_vals: [b, D] (padding entries carry val == 0)
    assignment: [nb, n] int32 or uint8 codeword id of every node per
                branch, or a nibble-packed ``PackedAssignment``
    codewords:  [nb, k, f_blk] f32, or int8 / float8_e4m3fn with
    cw_scale:   [nb, 1, f_blk] f32 per-branch/per-channel scales
    w_t:        optional [nb * f_blk, f_out] epilogue matrix
    out[i] = sum_d val[i, d] * concat_beta cw[beta, assignment[beta, ids[i, d]]]
    (then ``* cw_scale`` as one flat [nb * f_blk] row, then ``@ w_t``,
    summed over the nb * f_blk columns in order)
    """
    nb, _, f_blk = codewords.shape
    b, deg = out_ids.shape
    ids = out_ids.long()
    vals = out_vals.float()
    if isinstance(assignment, PackedAssignment):
        assignment = assignment.unpack()
    a = assignment.long()
    cw = codewords.float()
    beta = torch.arange(nb, device=codewords.device)[None, :]
    acc = torch.zeros((b, nb, f_blk), dtype=torch.float32,
                      device=out_vals.device)
    for d in range(deg):
        rows = cw[beta, a[:, ids[:, d]].t()]                  # [b, nb, fb]
        acc = acc + vals[:, d, None, None] * rows
    acc = acc.reshape(b, nb * f_blk)
    if cw_scale is not None:
        acc = acc * cw_scale.float().reshape(1, nb * f_blk)
    if w_t is None:
        return acc
    wt = w_t.float()
    out = torch.zeros((b, wt.shape[1]), dtype=torch.float32,
                      device=out_vals.device)
    for c in range(nb * f_blk):
        out = out + acc[:, c, None] * wt[c]
    return out


# ---------------------------------------------------------------------------
# LM attention (the reference's ``ref.flash_attention`` and the vmapped
# ``ref.vq_attention_decode`` of ``kernels/ops.py``)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain softmax attention.  q: [b, h, sq, d], k/v: [b, h, skv, d] ->
    [b, h, sq, d].  The causal mask lets query i see keys j <= i + (skv -
    sq) (the queries are the last sq positions); a query that sees no key
    gets NaN, as the reference's softmax over -inf does."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * sm_scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(ki <= qi), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bhqk,bhkd->bhqd', p, v.float()).to(q.dtype)


def vq_attention_decode(q: torch.Tensor, cb_k: torch.Tensor,
                        cb_v: torch.Tensor, mass: torch.Tensor,
                        win_k: torch.Tensor, win_v: torch.Tensor,
                        win_mask: torch.Tensor) -> torch.Tensor:
    """One VQ-Attention decode step for n GQA groups at once (paper Eq. 6
    on the token graph): one softmax over k codeword keys, each scored
    ``q.k~ + log m`` (a cluster of mass m counts m times, App. E) and
    masked where m <= 0, and w exact window keys masked where
    ``win_mask`` <= 0.

    q [n, g, d], cb_k/cb_v [n, k, d], mass [n, k] f32, win_k/win_v
    [n, w, d], win_mask [n, w] -> [n, g, d] in q's dtype."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kcb = cb_k.shape[1]
    q32 = q.float() * sm_scale
    s_cb = q32 @ cb_k.float().transpose(1, 2) \
        + torch.log(torch.clamp_min(mass, 1e-9))[:, None, :]   # [n, g, k]
    s_cb = s_cb.masked_fill(~(mass[:, None, :] > 0), float("-inf"))
    s_w = q32 @ win_k.float().transpose(1, 2)                  # [n, g, w]
    s_w = s_w.masked_fill(~(win_mask[:, None, :] > 0), float("-inf"))
    p = torch.softmax(torch.cat([s_cb, s_w], dim=2), dim=-1)
    out = p[..., :kcb] @ cb_v.float() + p[..., kcb:] @ win_v.float()
    return out.to(q.dtype)
