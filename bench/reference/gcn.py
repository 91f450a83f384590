"""GCN layer on a mini-batch (VQ-GNN, Eq. 6 forward, Eq. 7 backward).

C = D~^-1/2 (A + I) D~^-1/2 with D~ = in-degree + 1.  In-batch neighbours
send their exact rows; an out-of-batch neighbour j sends the feature
codewords of its assignments, X~[c(j)].  With Eq. 7 on, the gradient that
the out-of-batch nodes j fed by batch node i would send back is stood in
for by their gradient codewords: the batch rows' input gradient gets
sum_j C[j, i] G~[c(j)] W^T added.  The probe is added at the layer's
pre-activation output; its gradient is the G the codebook learns.
"""
from __future__ import annotations

import torch

from bench import roofline
from bench.reference import vq as vqm


class _AddToGradient(torch.autograd.Function):
    """Identity forward; the backward adds a fixed tensor."""

    @staticmethod
    def forward(ctx, x, extra):
        ctx.save_for_backward(extra)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (extra,) = ctx.saved_tensors
        return g + extra, None


def layer_flops(c, sh, cfg: dict, *, train: bool, first: bool) -> float:
    """Model FLOPs of one layer on a batch of counts ``c``
    (``work.BatchCounts``): the GEMM, the aggregation over the e_in +
    e_out live in-edges and the self loop, and in training the backward
    once (the input gradient and the Eq. 7 injection only where the input
    has a gradient, i.e. after the first layer)."""
    b, fi, fo = c.b, sh.f_in, sh.f_out
    fwd = 2.0 * b * fi * fo + 2.0 * (c.e_in + c.e_out + b) * fi
    if not train:
        return fwd
    bwd = 2.0 * b * fi * fo
    if not first:
        bwd += 2.0 * b * fi * fo + 2.0 * (c.e_in + b) * fi
        if cfg["model"]["grad_inject"]:
            bwd += 2.0 * c.e_rev * sh.nb * sh.gb + 2.0 * b * sh.nb * sh.gb * fi
    return fwd + bwd


def message_least_s(c, sh, cfg: dict, *, train: bool, first: bool) -> float:
    """Least time of one layer's message kernels on a batch of counts
    ``c``: the codeword messages of the out-of-batch neighbours
    (``context_ell``) and the in-batch ones (``spmm_ell``), and in
    training after the first layer their backward (``spmm_ell_t``) and
    Eq. 7's injection (``context_ell``'s ``w_t`` form).  The codeword rows
    read are counted as every (branch, codeword) the neighbours can
    reach, nb x min(k, neighbours): the tables that pick them are the
    program's."""
    k = cfg["codebook"]["k"]
    w = [roofline.context_ell(c.b, c.deg, sh.nb, sh.fb, c.nodes_out,
                              sh.nb * min(k, c.nodes_out), c.e_out),
         roofline.spmm_ell(c.b, c.deg, sh.f_in, c.rows, c.e_in)]
    if train and not first:
        w.append(roofline.spmm_ell_t(c.b, c.deg, sh.f_in, c.b, c.e_in))
        if cfg["model"]["grad_inject"]:
            w.append(roofline.context_ell_wt(
                c.b, c.deg, sh.nb, sh.gb, sh.f_in, c.nodes_rev,
                sh.nb * min(k, c.nodes_rev), c.e_rev))
    return sum(x.least_s() for x in w)


def probe_width(sh, heads: int) -> int:
    return sh.f_out


def forward(p, x_b, probe, bt, st, degrees, sh, cb, relu: bool,
            inject: bool, heads: int, prec):
    fcw, gcw = vqm.codewords(st, sh.fb, cb["eps"])
    dt_i = degrees[bt.ids] + 1.0
    vals = bt.nmask / torch.sqrt(dt_i[:, None] * (degrees[bt.nbr] + 1.0))
    in_vals = torch.where(bt.npos >= 0, vals, 0.0)
    out_vals = torch.where(bt.npos < 0, vals, 0.0)
    if inject:
        rev = bt.rmask / torch.sqrt((degrees[bt.rev] + 1.0) * dt_i[:, None])
        rev = torch.where(bt.rpos < 0, rev, 0.0)
        g_hat = vqm.reconstruct(gcw, st.table, bt.rev)          # [b, D, fo]
        back = (rev[..., None] * g_hat).sum(1)
        x_b = _AddToGradient.apply(x_b, prec.mm(back, p["w"].detach().t()))
    x_in = x_b[torch.clamp(bt.npos, min=0)]                      # [b, D, fi]
    x_out = vqm.reconstruct(fcw, st.table, bt.nbr)
    m = (in_vals[..., None] * x_in).sum(1) \
        + (out_vals[..., None] * x_out).sum(1) + x_b / dt_i[:, None]
    z = prec.mm(m, p["w"]) + p["b"]
    if probe is not None:
        z = z + probe
    return torch.relu(z) if relu else z
