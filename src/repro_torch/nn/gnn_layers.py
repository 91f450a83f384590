"""GNN backbones as generalized graph convolutions (paper Tables 1 & 5).

Torch twin of ``repro.nn.gnn_layers``: GCN, SAGE-Mean, GIN, GAT (the
learnable row-normalized convolution, Lipschitz-clipped scores per App. E)
and the Graph Transformer (the dense learnable convolution: global
attention, which sampling cannot scale at all, paper Sec. 1/3), each with
two execution modes over one parameter dict (weights in the reference's
layouts: ``[f_in, f_out]``, GAT's ``w`` and the Transformer's
``wq / wk / wv`` ``[f_in, H, f_out / H]``):

  * ``full_apply`` -- exact message passing over the whole graph;
  * ``vq_apply``   -- the paper's approximated message passing on a
    mini-batch (Eq. 6 forward, Eq. 7 backward through the injection when
    ``inject``), with the probe-trick gradient tap whose gradient is
    G^(l+1) for the codebook update (GAT's at the per-head augmented
    message, before the normalization).  ``probe=None`` skips the tap
    (inference, serving, evaluation).  ``rows`` (a slice of the batch,
    probe-free and without the injection) computes only those target
    rows, every in-batch source still read from the whole ``x_b``: each
    row is what the whole batch's call gives it (the serving mesh's
    throughput mode, ``models.gnn.vq_serve_batch_rows``).

The fixed convolutions route their messages through the two kernels
(``spmm_ell`` and ``context_ell``).  GAT and the Transformer read dense
f32 codewords and gather, score and attend in plain PyTorch, as the
reference does in plain JAX; the dense products stay ``matmul`` /
``einsum``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.codebook import CodebookConfig
from repro_torch.core.conv import (LayerVQState, MinibatchPack,
                                   fixed_conv_operands, layer_codewords,
                                   out_of_batch_cluster_mass)
from repro_torch.core.message_passing import (approx_message_passing,
                                              inject_context_grad_materialized,
                                              inject_context_grad_table,
                                              reconstruct)
from repro_torch.graph.batching import FullGraphOperands
from repro_torch.kernels import ops as kops
from repro_torch.runtime import resolve_device

Params = dict[str, torch.Tensor]
SCORE_CLIP = 5.0   # App. E Lipschitz regularization of attention scores


def _dense(f_in: int, f_out: int, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    w = torch.randn((f_in, f_out), generator=generator, dtype=torch.float32)
    return (w / math.sqrt(f_in)).to(device)


def _tap(z: torch.Tensor, probe: Optional[torch.Tensor]) -> torch.Tensor:
    return z if probe is None else z + probe


def _target_rows(x_b: torch.Tensor, pack: MinibatchPack,
                 rows: Optional[slice], probe, inject: bool
                 ) -> tuple[torch.Tensor, MinibatchPack]:
    """The target rows' activations and pack (``rows`` of the batch; all
    of it when None): neighbour positions still index the whole batch.
    A row slice computes a probe-free forward only, on a pack without a
    stripe index (the staged SpMM's index covers every row)."""
    if rows is None:
        return x_b, pack
    if probe is not None or inject or pack.stripe_index is not None:
        raise ValueError("vq_apply(rows=) is the probe-free forward without "
                         "the Eq. 7 injection, on a pack without a stripe "
                         "index")
    return x_b[rows], pack._replace(
        batch_ids=pack.batch_ids[rows], nbr_ids=pack.nbr_ids[rows],
        nbr_mask=pack.nbr_mask[rows], nbr_pos=pack.nbr_pos[rows],
        rev_ids=pack.rev_ids[rows], rev_mask=pack.rev_mask[rows],
        rev_pos=pack.rev_pos[rows],
        slot_mask=None if pack.slot_mask is None else pack.slot_mask[rows])


def _gcn_edge_vals(ops_: FullGraphOperands
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    dt = ops_.degrees + 1.0
    vals = ops_.nbr_mask / torch.sqrt(dt[:, None] * dt[ops_.nbr_ids.long()])
    return vals, 1.0 / dt


class GCN:
    """Fixed convolution C = D~^-1/2 A~ D~^-1/2."""
    name = "gcn"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w": _dense(f_in, f_out, generator, device),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out          # gradient codewords live at the Z level

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        vals, self_vals = _gcn_edge_vals(ops_)
        m = kops.spmm_ell(ops_.nbr_ids, vals, x, ops_.stripe_index) \
            + self_vals[:, None] * x
        return act(m @ p["w"] + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack: MinibatchPack,
                 vq: LayerVQState, degrees, cfg: CodebookConfig, act,
                 f_in: int, f_out: int, inject: bool = True,
                 rows: Optional[slice] = None):
        x_t, pack = _target_rows(x_b, pack, rows, probe, inject)
        ops_, self_vals = fixed_conv_operands('gcn', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        m = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                   p["w"], inject)
        m = m + self_vals[:, None] * x_t
        return act(_tap(m @ p["w"] + p["b"], probe))


class SAGE:
    """Two fixed convolutions: C1 = I, C2 = D^-1 A (mean aggregator)."""
    name = "sage"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w1": _dense(f_in, f_out, generator, device),
                "w2": _dense(f_in, f_out, generator, device),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        vals = ops_.nbr_mask / torch.clamp(ops_.degrees, min=1.0)[:, None]
        mean_nbr = kops.spmm_ell(ops_.nbr_ids, vals, x, ops_.stripe_index)
        return act(x @ p["w1"] + mean_nbr @ p["w2"] + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack, vq, degrees, cfg, act,
                 f_in: int, f_out: int, inject: bool = True,
                 rows: Optional[slice] = None):
        x_t, pack = _target_rows(x_b, pack, rows, probe, inject)
        ops_, _ = fixed_conv_operands('mean', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        m2 = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                    p["w2"], inject)
        # the identity convolution is always intra-batch: exact autograd
        return act(_tap(x_t @ p["w1"] + m2 @ p["w2"] + p["b"], probe))


class GIN:
    """C1 = A fixed; C2 = (1 + eps) I learnable diagonal; MLP head."""
    name = "gin"

    @staticmethod
    def init(f_in: int, f_out: int, *, generator=None, device="cuda",
             **_) -> Params:
        device = resolve_device(device)
        return {"w1": _dense(f_in, f_out, generator, device),
                "b1": torch.zeros(f_out, device=device),
                "w2": _dense(f_out, f_out, generator, device),
                "b2": torch.zeros(f_out, device=device),
                "eps": torch.zeros((), device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        s = kops.spmm_ell(ops_.nbr_ids, ops_.nbr_mask, x,
                           ops_.stripe_index)
        m = (1.0 + p["eps"]) * x + s
        h = torch.relu(m @ p["w1"] + p["b1"])
        return act(h @ p["w2"] + p["b2"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack, vq, degrees, cfg, act,
                 f_in: int, f_out: int, inject: bool = True,
                 rows: Optional[slice] = None):
        x_t, pack = _target_rows(x_b, pack, rows, probe, inject)
        ops_, _ = fixed_conv_operands('adj', pack, degrees)
        fcw, gcw = layer_codewords(vq, f_in, cfg)
        s = approx_message_passing(ops_, x_b, fcw, gcw, vq.assignment,
                                   p["w1"], inject)
        m = (1.0 + p["eps"]) * x_t + s
        h = torch.relu(_tap(m @ p["w1"] + p["b1"], probe))
        return act(h @ p["w2"] + p["b2"])


def _randn(shape, generator, device, scale: float) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=generator,
                                dtype=torch.float32)).to(device)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] for an index tensor of any shape, as one ``index_select``:
    its backward adds the gradient rows with ``index_add_``, where
    advanced indexing's sorts the indices first -- 1.9 s a GAT step at
    batch 42,335 on an H100 80GB HBM3 at 700 W, most padding slots naming
    row 0."""
    return t.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                     *t.shape[1:])


def _gat_scores(xw: torch.Tensor, a_dst: torch.Tensor, a_src: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """xw [..., H, fh] -> the per-head destination and source score
    halves [..., H]."""
    return torch.einsum('...hf,hf->...h', xw, a_dst), \
        torch.einsum('...hf,hf->...h', xw, a_src)


def _gat_edge_weight(s_dst: torch.Tensor, s_src: torch.Tensor
                     ) -> torch.Tensor:
    """exp(clip(LeakyReLU(s_dst + s_src))): Lipschitz-clipped (App. E)."""
    e = torch.nn.functional.leaky_relu(s_dst + s_src, 0.2)
    return torch.exp(torch.clamp(e, -SCORE_CLIP, SCORE_CLIP))


class GAT:
    """Learnable row-normalized convolution (paper Table 1, App. E)."""
    name = "gat"
    heads = 4

    @staticmethod
    def init(f_in: int, f_out: int, heads: int = 4, *, generator=None,
             device="cuda", **_) -> Params:
        if f_out % heads:
            raise ValueError(f"GAT: f_out={f_out} is not a multiple of "
                             f"heads={heads}")
        device = resolve_device(device)
        fh = f_out // heads
        return {"w": _dense(f_in, f_out, generator, device).reshape(
                    f_in, heads, fh),
                "a_dst": _randn((heads, fh), generator, device, 0.1),
                "a_src": _randn((heads, fh), generator, device, 0.1),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, heads: int = 4, **_) -> int:
        # the probe sits at the per-head augmented message: H * (fh + 1)
        return f_out + heads

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, heads: int = 4,
                    **_) -> tuple[int, ...]:
        return (b, f_out + heads)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        n = ops_.nbr_ids.shape[0]
        heads, fh = p["a_dst"].shape
        ids = ops_.nbr_ids.long()
        xw = torch.einsum('nf,fhe->nhe', x, p["w"])            # [n, H, fh]
        s_dst, s_src = _gat_scores(xw, p["a_dst"], p["a_src"])
        w_edge = _gat_edge_weight(s_dst[:, None, :], _rows(s_src, ids)) \
            * ops_.nbr_mask[..., None]                          # [n, D, H]
        w_self = _gat_edge_weight(s_dst, s_src)                 # [n, H]
        num = torch.einsum('ndh,ndhe->nhe', w_edge, _rows(xw, ids)) \
            + w_self[..., None] * xw
        den = w_edge.sum(dim=1) + w_self                        # [n, H]
        y = num / torch.clamp(den, min=1e-9)[..., None]
        return act(y.reshape(n, heads * fh) + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack: MinibatchPack,
                 vq: LayerVQState, degrees, cfg: CodebookConfig, act,
                 f_in: int, f_out: int, inject: bool = True,
                 rows: Optional[slice] = None):
        b = x_b.shape[0]
        heads, fh = p["a_dst"].shape
        # dense f32 reads: GAT mixes the branches through its per-head
        # value map, which no dequantizing kernel epilogue can express
        fcw, gcw = layer_codewords(vq, f_in, cfg, dense=True)
        fcw, gcw = fcw.detach(), gcw.detach()

        # ---- Eq. 7 backward injection (before anything reads x_b) ----
        # reverse-edge weights C^h_{j,i} = w(s_dst(j), s_src(i)), the
        # out-of-batch endpoint j reconstructed from its codewords; the
        # per-head value map mixes the branches, so the injected gradient
        # is materialized, mapped back through W per head
        if inject:
            x_rev_hat = reconstruct(fcw, vq.assignment, pack.rev_ids)
            ghat = reconstruct(gcw, vq.assignment, pack.rev_ids)
            ghat = ghat.reshape(b, -1, heads, fh + 1)[..., :fh]
            with torch.no_grad():
                xw0 = torch.einsum('bf,fhe->bhe', x_b, p["w"])
                _, s_src0 = _gat_scores(xw0, p["a_dst"], p["a_src"])
                xw_rev = torch.einsum('bdf,fhe->bdhe', x_rev_hat, p["w"])
                s_dst_rev, _ = _gat_scores(xw_rev, p["a_dst"], p["a_src"])
                rev_vals = _gat_edge_weight(s_dst_rev, s_src0[:, None, :]) \
                    * torch.where(pack.rev_pos < 0, pack.rev_mask,
                                  torch.zeros_like(pack.rev_mask))[..., None]
                dr = rev_vals.shape[1]
                ghat_x = torch.einsum('bdhe,fhe->bdhf', ghat, p["w"])
            # rev_vals flattened head-major, ghat_x edge-major: the
            # reference's pairing, kept (ROADMAP.md, queue 3)
            x_b = inject_context_grad_materialized(
                x_b, rev_vals.transpose(1, 2).reshape(b, heads * dr),
                ghat_x.reshape(b, dr * heads, f_in), None)

        # ---- Eq. 6 forward: exact intra + codeword context, per head ----
        # every in-batch row is a source; the targets are ``rows`` of them
        xw_src = torch.einsum('bf,fhe->bhe', x_b, p["w"])       # [b, H, fh]
        s_dst, s_src_b = _gat_scores(xw_src, p["a_dst"], p["a_src"])
        xw, s_src = xw_src, s_src_b
        if rows is not None:
            _, pack = _target_rows(x_b, pack, rows, probe, inject)
            xw, s_dst, s_src = xw[rows], s_dst[rows], s_src[rows]
            b = xw.shape[0]
        pos = torch.clamp(pack.nbr_pos, min=0).long()
        in_mask = (pack.nbr_pos >= 0) * pack.nbr_mask
        w_in = _gat_edge_weight(s_dst[:, None, :], _rows(s_src_b, pos)) \
            * in_mask[..., None]                                # [b, D, H]
        xw_in = _rows(xw_src, pos)                              # [b, D, H, fh]
        x_out_hat = reconstruct(fcw, vq.assignment, pack.nbr_ids)
        xw_out = torch.einsum('bdf,fhe->bdhe', x_out_hat, p["w"])
        _, s_src_out = _gat_scores(xw_out, p["a_dst"], p["a_src"])
        out_mask = (pack.nbr_pos < 0) * pack.nbr_mask
        w_out = _gat_edge_weight(s_dst[:, None, :], s_src_out) \
            * out_mask[..., None]
        w_self = _gat_edge_weight(s_dst, s_src)                 # [b, H]
        num = torch.einsum('bdh,bdhe->bhe', w_in, xw_in) \
            + torch.einsum('bdh,bdhe->bhe', w_out, xw_out) \
            + w_self[..., None] * xw
        den = w_in.sum(1) + w_out.sum(1) + w_self               # [b, H]
        # the probe at the augmented (pre-normalization) message
        m_aug = torch.cat([num, den[..., None]], dim=-1)
        if probe is not None:
            m_aug = m_aug + probe.reshape(b, heads, fh + 1)
        y = m_aug[..., :fh] / torch.clamp(m_aug[..., fh:], min=1e-9)
        return act(y.reshape(b, heads * fh) + p["b"])


class GraphTransformer:
    """Global self-attention over all nodes each layer (paper Table 5,
    App. G): O(n^2) messages with no sparsity to sample; VQ-GNN reduces
    it to attention over the b in-batch nodes and the k codewords.  Needs
    a full-width codebook (one branch, ``GNNConfig.layer_codebook_cfg``).
    ``full_apply`` builds [H, n, n] scores, O(n^2) memory, as the
    reference's does."""
    name = "transformer"
    heads = 4

    @staticmethod
    def init(f_in: int, f_out: int, heads: int = 4, *, generator=None,
             device="cuda", **_) -> Params:
        if f_out % heads:
            raise ValueError(f"GraphTransformer: f_out={f_out} is not a "
                             f"multiple of heads={heads}")
        device = resolve_device(device)
        dh = f_out // heads
        return {"wq": _dense(f_in, f_out, generator, device).reshape(
                    f_in, heads, dh),
                "wk": _dense(f_in, f_out, generator, device).reshape(
                    f_in, heads, dh),
                "wv": _dense(f_in, f_out, generator, device).reshape(
                    f_in, heads, dh),
                "wo": _dense(f_out, f_out, generator, device),
                "b": torch.zeros(f_out, device=device)}

    @staticmethod
    def f_grad(f_in: int, f_out: int, **_) -> int:
        return f_out          # grad codewords at the attention output

    @staticmethod
    def probe_shape(b: int, f_in: int, f_out: int, **_) -> tuple[int, ...]:
        return (b, f_out)

    @staticmethod
    def full_apply(p: Params, x, ops_: FullGraphOperands, act):
        n = x.shape[0]
        heads, dh = p["wq"].shape[1:]
        q = torch.einsum('nf,fhe->hne', x, p["wq"]) / math.sqrt(dh)
        k = torch.einsum('nf,fhe->hne', x, p["wk"])
        v = torch.einsum('nf,fhe->hne', x, p["wv"])
        s = torch.clamp(torch.einsum('hne,hme->hnm', q, k),
                        -SCORE_CLIP, SCORE_CLIP)
        att = torch.softmax(s, dim=-1)
        y = torch.einsum('hnm,hme->nhe', att, v).reshape(n, heads * dh)
        return act(y @ p["wo"] + p["b"])

    @staticmethod
    def vq_apply(p: Params, x_b, probe, pack: MinibatchPack,
                 vq: LayerVQState, degrees, cfg: CodebookConfig, act,
                 f_in: int, f_out: int, inject: bool = True,
                 rows: Optional[slice] = None):
        b = x_b.shape[0]
        heads, dh = p["wq"].shape[1:]
        # the queries are the target rows; keys, values and the cluster
        # masses stay the whole batch's
        x_q, _ = _target_rows(x_b, pack, rows, probe, inject)
        if vq.codebook.n_branches != 1:
            raise ValueError("GraphTransformer needs a full-width codebook "
                             "(f_prod >= f_in: one branch)")
        dfcw, dgcw = layer_codewords(vq, f_in, cfg, dense=True)
        fcw, gcw = dfcw[0].detach(), dgcw[0].detach()   # [k, f_in], [k, f_out]
        mass = out_of_batch_cluster_mass(vq, pack.batch_ids)[0]   # [k]
        kk = fcw.shape[0]
        scale = math.sqrt(dh)

        # ---- Eq. 7 injection: cluster-level reverse attention weights ----
        # the receiving "neighbors" are the k clusters, the same for every
        # row, so the residual is the [H * k, f_in] table itself
        if inject:
            with torch.no_grad():
                q_cl = torch.einsum('kf,fhe->hke', fcw, p["wq"]) / scale
                k_cl = torch.einsum('kf,fhe->hke', fcw, p["wk"])
                k_b0 = torch.einsum('bf,fhe->hbe', x_b, p["wk"])
                s_cc = torch.clamp(torch.einsum('hke,hue->hku', q_cl, k_cl),
                                   -SCORE_CLIP, SCORE_CLIP)
                s_cb = torch.clamp(torch.einsum('hke,hbe->hkb', q_cl, k_b0),
                                   -SCORE_CLIP, SCORE_CLIP)
                # the cluster-level row normalizer: mass-weighted over the
                # clusters, exact over the in-batch keys
                z_cl = torch.einsum('hku,u->hk', torch.exp(s_cc),
                                    torch.clamp(mass, min=0.0)) \
                    + torch.exp(s_cb).sum(-1)                   # [H, k]
                rev_vals = torch.exp(s_cb) * (
                    mass[None, :, None]
                    / torch.clamp(z_cl, min=1e-9)[..., None])
                rev_vals = rev_vals.permute(2, 0, 1).reshape(b, heads * kk)
                # gradient codewords live at the attention output; the
                # value path maps them back to x per head: W_v,h G~_h
                ghat_x = torch.einsum('khe,fhe->hkf',
                                      gcw.reshape(kk, heads, dh), p["wv"])
            x_b = inject_context_grad_table(
                x_b, rev_vals, ghat_x.reshape(heads * kk, f_in), None)

        # ---- Eq. 6 forward: softmax over (b in-batch + k clusters) ----
        q = torch.einsum('bf,fhe->hbe', x_q, p["wq"]) / scale
        k_in = torch.einsum('bf,fhe->hbe', x_b, p["wk"])
        v_in = torch.einsum('bf,fhe->hbe', x_b, p["wv"])
        k_cw = torch.einsum('kf,fhe->hke', fcw, p["wk"])
        v_cw = torch.einsum('kf,fhe->hke', fcw, p["wv"])
        s_in = torch.clamp(torch.einsum('hbe,hue->hbu', q, k_in),
                           -SCORE_CLIP, SCORE_CLIP)             # [H, b, b]
        s_cw = torch.clamp(torch.einsum('hbe,hke->hbk', q, k_cw),
                           -SCORE_CLIP, SCORE_CLIP) \
            + torch.log(torch.clamp(mass, min=1e-9))[None, None, :]
        s_cw = torch.where(mass[None, None, :] > 0, s_cw,
                           torch.full_like(s_cw, -math.inf))    # [H, b, k]
        att = torch.softmax(torch.cat([s_in, s_cw], dim=-1), dim=-1)
        y = torch.einsum('hbu,hue->bhe', att[..., :b], v_in) \
            + torch.einsum('hbk,hke->bhe', att[..., b:], v_cw)
        y = y.reshape(x_q.shape[0], heads * dh)
        return act(_tap(y, probe) @ p["wo"] + p["b"])


BACKBONES = {c.name: c for c in [GCN, SAGE, GIN, GAT, GraphTransformer]}


def backbone(name: str):
    """The backbone class for ``name``."""
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; want one of "
                         f"{', '.join(BACKBONES)}")
    return BACKBONES[name]
