"""GAT layer on a mini-batch (Velickovic et al. 2018; VQ-GNN Table 1,
App. E), Eq. 6 forward with the Eq. 7 injection off.

Per head h: xw = x W_h; the weight of edge j -> i is
exp(clip(LeakyReLU_0.2(a_dst . xw_i + a_src . xw_j), -5, 5)) (App. E's
Lipschitz clip), self loop included, normalised over the row.  An
out-of-batch neighbour's row is rebuilt from its feature codewords before
W.  The probe is added to the per-head augmented message [numerator,
denominator] before the normalisation; its gradient is the G the
codebook learns.
"""
from __future__ import annotations

import torch

from bench.reference import vq as vqm


def layer_flops(c, sh, cfg: dict, *, train: bool, first: bool) -> float:
    """Model FLOPs of one layer on a batch of counts ``c``
    (``work.BatchCounts``): the GEMMs of the batch rows and of the e_out
    codeword-rebuilt neighbour rows, the two score halves, and the
    weighted sums over e_in + e_out + b edges; in training the backward
    once (twice each forward term, less the input gradient of the first
    layer)."""
    b, fi, fo = c.b, sh.f_in, sh.f_out
    gemm = 2.0 * (b + c.e_out) * fi * fo
    rest = 2.0 * fo * (2 * b + c.e_out) + 2.0 * (c.e_in + c.e_out + b) * fo
    if not train:
        return gemm + rest
    return gemm + rest + (gemm if first else 2 * gemm) + 2 * rest


def probe_width(sh, heads: int) -> int:
    return sh.f_out + heads


def _edge_weight(s: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(torch.nn.functional.leaky_relu(s, 0.2),
                                 -5.0, 5.0))


def forward(p, x_b, probe, bt, st, degrees, sh, cb, relu: bool,
            inject: bool, heads: int, prec):
    if inject:
        raise ValueError("the GAT reference covers Eq. 7 off only")
    b = x_b.shape[0]
    fh = sh.f_out // heads
    w = p["w"].reshape(sh.f_in, sh.f_out)
    fcw, _ = vqm.codewords(st, sh.fb, cb["eps"])
    xw = prec.mm(x_b, w).reshape(b, heads, fh)
    s_dst = (xw * p["a_dst"]).sum(-1)                            # [b, H]
    s_src = (xw * p["a_src"]).sum(-1)
    pos = torch.clamp(bt.npos, min=0)
    in_mask = ((bt.npos >= 0) * bt.nmask)[..., None]
    w_in = _edge_weight(s_dst[:, None] + s_src[pos]) * in_mask  # [b, D, H]
    x_out = vqm.reconstruct(fcw, st.table, bt.nbr)               # [b, D, fi]
    xw_out = prec.mm(x_out, w).reshape(b, -1, heads, fh)
    out_mask = ((bt.npos < 0) * bt.nmask)[..., None]
    w_out = _edge_weight(s_dst[:, None] + (xw_out * p["a_src"]).sum(-1)) \
        * out_mask
    w_self = _edge_weight(s_dst + s_src)
    num = (w_in[..., None] * xw[pos]).sum(1) \
        + (w_out[..., None] * xw_out).sum(1) + w_self[..., None] * xw
    den = w_in.sum(1) + w_out.sum(1) + w_self
    aug = torch.cat([num, den[..., None]], -1)                   # [b, H, fh+1]
    if probe is not None:
        aug = aug + probe.reshape(b, heads, fh + 1)
    y = aug[..., :fh] / torch.clamp(aug[..., fh:], min=1e-9)
    out = y.reshape(b, sh.f_out) + p["b"]
    return torch.relu(out) if relu else out
