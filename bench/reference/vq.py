"""Product-VQ codebooks: codeword reads, nearest codewords and the
streaming EMA update with implicit whitening (VQ-GNN, Alg. 2, App. E).

A layer's codebook quantizes the rows ``V = X || G`` (layer input and the
gradient at the layer's output), split into ``nb`` branches; codewords
are kept whitened by EMA moments and read back un-whitened.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference.precision import Precision

# rows of [nb, rows, k] distances computed at once
_BLOCK_ELEMS = 1 << 27


class VQState(NamedTuple):
    codewords_w: torch.Tensor   # [nb, k, f_blk] whitened
    cluster_size: torch.Tensor  # [nb, k]
    cluster_sum: torch.Tensor   # [nb, k, f_blk]
    mean: torch.Tensor          # [nb, f_blk]
    var: torch.Tensor           # [nb, f_blk]
    table: torch.Tensor         # [nb, n] int64: every node's codeword


def split(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[b, f] -> [nb, b, f / nb], branch i on columns i*f/nb..."""
    b, f = x.shape
    return x.reshape(b, nb, f // nb).permute(1, 0, 2)


def codewords(st: VQState, fb: int, eps: float):
    """Un-whitened (feature [nb, k, fb], gradient [nb, k, gb]) codewords."""
    cw = st.codewords_w * torch.sqrt(st.var + eps)[:, None, :] \
        + st.mean[:, None, :]
    return cw[:, :, :fb], cw[:, :, fb:]


def reconstruct(cw: torch.Tensor, table: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Rows of nodes ``ids`` [...] from their codewords: [..., nb * f]."""
    nb, k, f = cw.shape
    c = table[:, ids.reshape(-1)]                                 # [nb, m]
    rows = torch.gather(cw, 1, c[..., None].expand(nb, c.shape[1], f))
    return rows.permute(1, 0, 2).reshape(*ids.shape, nb * f)


def nearest(v: torch.Tensor, cw: torch.Tensor, prec: Precision,
            chosen: torch.Tensor | None = None):
    """Nearest codeword of every row of every branch by squared distance,
    ``|c|^2 - 2 v.c`` (ties to the lowest index): v [nb, r, f], cw
    [nb, k, f] -> (ids [nb, r] int64, squared distance [nb, r]); with
    ``chosen`` [nb, r] also the squared distance to those codewords."""
    nb, r, f = v.shape
    k = cw.shape[1]
    cn = (cw * cw).sum(-1)[:, None, :]
    ids = torch.empty((nb, r), dtype=torch.int64, device=v.device)
    dist = torch.empty((nb, r), dtype=torch.float32, device=v.device)
    dist_chosen = torch.empty_like(dist) if chosen is not None else None
    step = max(1, _BLOCK_ELEMS // (nb * k))
    cwt = cw.transpose(1, 2).contiguous()
    for s in range(0, r, step):
        vs = v[:, s:s + step].contiguous()
        d = cn - 2.0 * prec.bmm(vs, cwt)
        m, i = torch.min(d, dim=2)
        vn = (vs * vs).sum(-1)
        ids[:, s:s + step] = i
        dist[:, s:s + step] = m + vn
        if chosen is not None:
            dist_chosen[:, s:s + step] = torch.gather(
                d, 2, chosen[:, s:s + step, None].long())[..., 0] + vn
    if chosen is None:
        return ids, torch.clamp(dist, min=0.0)
    return ids, torch.clamp(dist, min=0.0), torch.clamp(dist_chosen, min=0.0)


def excess(d_chosen: torch.Tensor, d_best: torch.Tensor,
           v: torch.Tensor) -> float:
    """How far chosen codewords lie beyond the nearest ones: the largest
    excess squared distance, as a share of the branch's mean squared row
    norm (0 where every choice is a nearest codeword)."""
    scale = (v * v).sum(-1).mean(1, keepdim=True)
    return float(((d_chosen - d_best) / scale).max())


def row_excess(d_chosen: torch.Tensor, d_best: torch.Tensor,
               v: torch.Tensor, cw: torch.Tensor, best: torch.Tensor
               ) -> float:
    """How far chosen codewords lie beyond the nearest ones, row by row:
    the largest excess squared distance as a share of the row's own
    |v|^2 + |c|^2 (c its nearest codeword), the scale of the rounding of
    a squared distance; 0 where every choice is a nearest codeword."""
    cn = torch.gather((cw * cw).sum(-1), 1, best)
    return float(((d_chosen - d_best) / ((v * v).sum(-1) + cn)).max())


def update(st: VQState, feats: torch.Tensor, grads: torch.Tensor, cb: dict,
           prec: Precision, chosen: torch.Tensor | None = None
           ) -> tuple[VQState, torch.Tensor, float]:
    """One EMA step of the codebook with a batch's rows (Alg. 2): the
    whitening moments, the nearest codewords under the OLD codewords, the
    cluster EMA, dead codewords kept in place, and codewords whose EMA size
    fell under the revival threshold moved onto the batch's worst-quantized
    rows.  ``chosen`` [nb, b] (another computation's choices, judged here)
    replaces the nearest codewords in everything that follows.  Returns
    (state with the table unchanged, the ids used, the choices' excess
    as (``excess``, ``row_excess``))."""
    nb = st.codewords_w.shape[0]
    k = st.codewords_w.shape[1]
    v = torch.cat([split(feats.float(), nb), split(grads.float(), nb)], -1)
    beta, gamma, eps = cb["beta"], cb["gamma"], cb["eps"]
    mean = st.mean * beta + v.mean(1) * (1 - beta)
    var = st.var * beta + v.var(1, correction=0) * (1 - beta)
    vw = (v - mean[:, None, :]) / torch.sqrt(var + eps)[:, None, :]
    gap = (0.0, 0.0)
    if chosen is None:
        ids, qerr = nearest(vw, st.codewords_w, prec)
    else:
        ids = chosen.long()
        best_ids, best, qerr = nearest(vw, st.codewords_w, prec, ids)
        gap = (excess(qerr, best, vw),
               row_excess(qerr, best, vw, st.codewords_w, best_ids))
    f = vw.shape[-1]
    flat = (ids + k * torch.arange(nb, device=ids.device)[:, None]).reshape(-1)
    counts = torch.zeros(nb * k, device=vw.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32)).reshape(nb, k)
    sums = torch.zeros(nb * k, f, device=vw.device).index_add_(
        0, flat, vw.reshape(-1, f)).reshape(nb, k, f)
    size = st.cluster_size * gamma + counts * (1 - gamma)
    csum = st.cluster_sum * gamma + sums * (1 - gamma)
    cw = csum / torch.clamp(size, min=eps)[..., None]
    cw = torch.where((size > 1e-3)[..., None], cw, st.codewords_w)
    dead = size < cb["revive_threshold"]
    if bool(dead.any()):
        n_rev = min(k, vw.shape[1])
        worst = torch.topk(qerr, n_rev, dim=1).indices          # [nb, n_rev]
        rank = torch.clamp(torch.cumsum(dead.long(), 1) - 1, 0, n_rev - 1)
        rows = torch.gather(vw, 1, torch.gather(worst, 1, rank)[..., None]
                            .expand(nb, k, f))
        cw = torch.where(dead[..., None], rows, cw)
        csum = torch.where(dead[..., None], rows, csum)
        size = torch.where(dead, torch.ones_like(size), size)
    return VQState(cw, size, csum, mean, var, st.table), ids, gap


def whiten_features(st: VQState, acts: torch.Tensor, fb: int,
                    eps: float) -> torch.Tensor:
    """Every node's feature half, whitened, by branch: [nb, n, fb]."""
    nb = st.codewords_w.shape[0]
    v = split(acts.float(), nb)
    return (v - st.mean[:, None, :fb]) \
        / torch.sqrt(st.var[:, :fb] + eps)[:, None]


def assign_features(st: VQState, acts: torch.Tensor, fb: int, eps: float,
                    prec: Precision) -> torch.Tensor:
    """Nearest codeword of every node from its feature half alone (the
    inductive refresh): acts [n, nb * fb] -> [nb, n]."""
    v = whiten_features(st, acts, fb, eps)
    return nearest(v, st.codewords_w[:, :, :fb].contiguous(), prec)[0]


def assignment_gap(st: VQState, acts: torch.Tensor, fb: int, eps: float,
                   chosen: torch.Tensor) -> float:
    """``excess`` of the codewords ``chosen`` [nb, n] for the nodes'
    feature halves."""
    v = whiten_features(st, acts, fb, eps)
    _, best, got = nearest(v, st.codewords_w[:, :, :fb].contiguous(),
                           Precision(), chosen)
    return excess(got, best, v)
