"""VQ codebook state, its reads and the streaming EMA update (Alg. 2).

Torch twin of ``repro.core.codebook``: the state containers, the
product-VQ branch layout, initialisation, the implicit whitening helpers,
the (un-whitened) codeword reads, the (X || G) assignment and the
feature-half one that the inductive refresh runs, the batch seeding
(:func:`kmeanspp_init`), the Theorem 2 epsilon (:func:`relative_error`),
and :func:`update` -- one streaming VQ update per
layer and training step, with exactly ONE fused distance pass for all
branches (``kops.vq_assign_update``, one kernel launch) whose assignment,
per-row quantization error and per-codeword (counts, sums) feed the EMA,
the dead-codeword revival and the relative-error monitor.

A codebook quantizes the concatenation ``V = X^(l) || G^(l+1)`` of a node's
layer input and its pre-activation gradient; codewords are stored in
whitened space and read back un-whitened.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import collectives, quantization
from repro_torch.kernels import ops as kops
from repro_torch.runtime import resolve_device


class CodebookState(NamedTuple):
    """One layer's product-VQ codebooks (``n_branches`` leading axis)."""

    codewords_w: torch.Tensor   # [n_branches, k, f_blk]   whitened codewords
    cluster_size: torch.Tensor  # [n_branches, k]          EMA cluster sizes
    cluster_sum: torch.Tensor   # [n_branches, k, f_blk]   EMA cluster sums
    mean: torch.Tensor          # [n_branches, f_blk]      smoothed E[V]
    var: torch.Tensor           # [n_branches, f_blk]      smoothed Var[V]
    step: torch.Tensor          # []                       update counter

    @property
    def n_branches(self) -> int:
        return self.codewords_w.shape[0]

    @property
    def k(self) -> int:
        return self.codewords_w.shape[1]

    @property
    def f_blk(self) -> int:
        return self.codewords_w.shape[2]


class UpdateStats(NamedTuple):
    """Per-batch byproducts of :func:`update`, in whitened concat space
    (the space assignments are made in), from the single fused pass."""

    assignment: torch.Tensor   # [n_branches, b] int32  nearest codeword
    qerr: torch.Tensor         # [n_branches, b]        ||v_w - c_assign||^2
    vnorm2: torch.Tensor       # [n_branches, b]        ||v_w||^2

    def relative_error(self) -> torch.Tensor:
        """Whitened-space VQ relative error ||V - R V~|| / ||V|| of this
        batch (the training loop's free convergence monitor)."""
        return torch.sqrt(self.qerr.sum() / (self.vnorm2.sum() + 1e-12))


class CodebookConfig(NamedTuple):
    k: int = 256                 # number of codewords per branch
    f_prod: int = 4              # feature dims per product-VQ branch
    gamma: float = 0.99          # EMA decay for codeword stats (Alg. 2)
    beta: float = 0.999          # EMA decay for whitening stats (Alg. 2)
    eps: float = 1e-5
    whiten: bool = True          # implicit whitening (App. E)
    revive_threshold: float = 0.05


def branch_layout(f_feat: int, f_grad: int,
                  f_prod: int) -> tuple[int, int, int]:
    """Return (n_branches, f_feat_blk, f_grad_blk): feature block i pairs
    with gradient block i under one assignment, so both sides get the same
    number of blocks (the larger side gets the wider block)."""
    cap = min(max(1, f_feat // f_prod), max(1, f_grad // f_prod))
    g = math.gcd(f_feat, f_grad)
    n_branches = 1
    for d in range(1, g + 1):
        if g % d == 0 and d <= cap:
            n_branches = d
    return n_branches, f_feat // n_branches, f_grad // n_branches


def init_codebook(f_feat: int, f_grad: int, cfg: CodebookConfig, *,
                  generator: Optional[torch.Generator] = None,
                  device: str | torch.device = "cuda") -> CodebookState:
    """Random whitened codewords (drawn on the CPU from ``generator``, so
    a seed gives the same codebook on every device)."""
    device = resolve_device(device)
    n_branches, fb, gb = branch_layout(f_feat, f_grad, cfg.f_prod)
    f_blk = fb + gb
    cw = 0.02 * torch.randn((n_branches, cfg.k, f_blk), generator=generator,
                            dtype=torch.float32).to(device)
    return CodebookState(
        codewords_w=cw,
        cluster_size=torch.ones((n_branches, cfg.k), device=device),
        cluster_sum=cw.clone(),
        mean=torch.zeros((n_branches, f_blk), device=device),
        var=torch.ones((n_branches, f_blk), device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# whitening helpers (Alg. 2 lines 2-4, 9); mean/var broadcast over rows
# ---------------------------------------------------------------------------

def _whiten(v: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float) -> torch.Tensor:
    return (v - mean) * torch.rsqrt(var + eps)


def _unwhiten(v: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              eps: float) -> torch.Tensor:
    return v * torch.sqrt(var + eps) + mean


def _split_branches(x: torch.Tensor, n_branches: int) -> torch.Tensor:
    """[b, f] -> [n_branches, b, f // n_branches] (a strided view)."""
    b, f = x.shape
    return x.reshape(b, n_branches, f // n_branches).transpose(0, 1)


# ---------------------------------------------------------------------------
# codeword reads
# ---------------------------------------------------------------------------

def _unwhitened_codewords(state: CodebookState, eps: float) -> torch.Tensor:
    """[n_branches, k, f_blk] in original (un-whitened) space."""
    return _unwhiten(state.codewords_w, state.mean[:, None, :],
                     state.var[:, None, :], eps)


def feature_codewords(state: CodebookState, f_feat: int,
                      cfg: CodebookConfig) -> torch.Tensor:
    """Per-branch feature codewords X~: [n_branches, k, f_feat_blk],
    contiguous (the kernels take contiguous tables; the slice is small)."""
    fb = f_feat // state.n_branches
    return _unwhitened_codewords(state, cfg.eps)[:, :, :fb].contiguous()


def gradient_codewords(state: CodebookState, f_feat: int,
                       cfg: CodebookConfig) -> torch.Tensor:
    """Per-branch gradient codewords G~: [n_branches, k, f_grad_blk]."""
    fb = f_feat // state.n_branches
    return _unwhitened_codewords(state, cfg.eps)[:, :, fb:].contiguous()


def quantized_codewords(state: CodebookState, f_feat: int,
                        cfg: CodebookConfig, *,
                        prev_feat: Optional[quantization.QTensor] = None,
                        prev_grad: Optional[quantization.QTensor] = None,
                        dtype: torch.dtype = torch.int8
                        ) -> tuple[quantization.QTensor,
                                   quantization.QTensor]:
    """Quantized kernel operands of the (feature, gradient) codeword
    tables: each a QTensor with [nb, 1, f_blk] per-branch/per-channel
    scales, the layout ``kops.context_ell`` dequantizes in one epilogue
    row.  ``dtype`` (int8 or float8_e4m3fn) picks a fresh snapshot's
    storage; the previous step's QTensors pin it to theirs and reuse their
    scales inside the drift band (quantize-on-update)."""
    fcw = feature_codewords(state, f_feat, cfg)
    gcw = gradient_codewords(state, f_feat, cfg)
    return (quantization.quantize_codewords(fcw, prev=prev_feat, dtype=dtype),
            quantization.quantize_codewords(gcw, prev=prev_grad, dtype=dtype))


# ---------------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------------

def _concat_rows(state: CodebookState, feats: torch.Tensor,
                 grads: torch.Tensor) -> torch.Tensor:
    """``V = X || G`` split into branches: [n_branches, b, f_blk]."""
    n = state.n_branches
    return torch.cat([_split_branches(feats.float(), n),
                      _split_branches(grads.float(), n)], dim=-1)


def assign(state: CodebookState, feats: torch.Tensor, grads: torch.Tensor,
           cfg: CodebookConfig) -> torch.Tensor:
    """Nearest codeword in whitened concat space: feats [b, f_feat], grads
    [b, f_grad] -> [n_branches, b] int32, ONE ``kops.vq_assign`` call for
    all branches (the narrow scan at f_blk <= 32, the wide build above)."""
    v = _concat_rows(state, feats, grads)
    if cfg.whiten:
        v = _whiten(v, state.mean[:, None, :], state.var[:, None, :],
                    cfg.eps)
    return kops.vq_assign(v, state.codewords_w.contiguous())


def assign_features_only(state: CodebookState, feats: torch.Tensor,
                         f_feat: int, cfg: CodebookConfig) -> torch.Tensor:
    """Nearest codeword using only the feature half (inference / inductive
    setting, paper Sec. 6): [n, f_feat] -> [n_branches, n] int32.

    ONE ``kops.vq_assign`` call for all branches.  The whitened rows stay in
    their natural [n, nb, fb] layout and reach the kernel as a strided
    [nb, n, fb] view, so no transposing copy of the [n, f] table is made."""
    n_br = state.n_branches
    fb = f_feat // n_br
    v = feats.float().reshape(feats.shape[0], n_br, fb)       # [n, nb, fb]
    if cfg.whiten:
        v = _whiten(v, state.mean[:, :fb], state.var[:, :fb], cfg.eps)
    return kops.vq_assign(v.transpose(0, 1),
                          state.codewords_w[:, :, :fb].contiguous())


# ---------------------------------------------------------------------------
# VQ-Update (Algorithm 2)
# ---------------------------------------------------------------------------

def whitened_rows(state: CodebookState, feats: torch.Tensor,
                  grads: torch.Tensor, cfg: CodebookConfig, *,
                  mesh=None) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Alg. 2 lines 2-4 for one batch: the concat rows ``V = X || G`` split
    into branches, the EMA whitening moments moved by the batch moments,
    and the rows whitened with them.  Returns (vw [nb, b, f_blk]
    contiguous, new_mean, new_var); without whitening the rows and moments
    pass through.  With a mesh the batch is this rank's share, and the
    moments come from the all-reduced row sums, sums of squares and row
    count (one collective), E[v^2] - E[v]^2 as the reference's
    ``axis_name`` form, on a mesh of any size."""
    v = _concat_rows(state, feats, grads)
    if not cfg.whiten:
        return v, state.mean, state.var
    if mesh is None:
        batch_mean = v.mean(dim=1)                     # [nb, f_blk]
        batch_var = v.var(dim=1, correction=0)         # population, as jnp
    else:
        nb, b, f_blk = v.shape
        cnt = torch.full((nb, 1), float(b), device=v.device)
        sums = collectives.all_reduce(
            torch.cat([v.sum(dim=1), (v * v).sum(dim=1), cnt], dim=1), mesh)
        s1, s2, cnt = sums[:, :f_blk], sums[:, f_blk:-1], sums[:, -1:]
        batch_mean = s1 / cnt
        batch_var = torch.clamp(s2 / cnt - batch_mean ** 2, min=0.0)
    new_mean = state.mean * cfg.beta + batch_mean * (1.0 - cfg.beta)
    new_var = state.var * cfg.beta + batch_var * (1.0 - cfg.beta)
    vw = _whiten(v, new_mean[:, None, :], new_var[:, None, :], cfg.eps)
    return vw, new_mean, new_var


def update(state: CodebookState, feats: torch.Tensor, grads: torch.Tensor,
           cfg: CodebookConfig, *, mesh=None
           ) -> tuple[CodebookState, UpdateStats]:
    """One streaming VQ update with a mini-batch of (features || gradients):
    feats [b, f_feat], grads [b, f_grad] -> (new state, UpdateStats).

    Whitening, then ONE ``kops.vq_assign_update`` launch for all branches
    (assignment, qerr, counts, sums), the cluster EMA, the ``alive`` mask
    (dead codewords keep their position) and dead-codeword revival:
    codewords whose EMA size fell under ``revive_threshold`` are parked on
    the batch rows with the largest quantization error, ranked by
    ``torch.topk(sorted=True)`` of the kernel's qerr.  Returns a new state;
    the old one is left untouched, as in the reference.

    With ``mesh`` (a :class:`~repro_torch.distributed.sharding.GraphMesh`)
    the rows are this rank's share of the batch and the ranks learn one
    codebook: the whitening moments come from all-reduced sums, the
    kernel's counts and sums are all-reduced after its one launch, and the
    revival candidates (the whitened rows and their qerr) are all-gathered
    along the rows in rank order before ``topk``, so every rank writes the
    same replacement codewords.  The stats stay this rank's."""
    vw, new_mean, new_var = whitened_rows(state, feats, grads, cfg,
                                          mesh=mesh)
    assignment, qerr, counts, sums = kops.vq_assign_update(
        vw, state.codewords_w.contiguous())
    if mesh is not None:
        counts, sums = collectives.psum_tree((counts, sums), mesh)
    new_size = state.cluster_size * cfg.gamma + counts * (1.0 - cfg.gamma)
    new_sum = state.cluster_sum * cfg.gamma + sums * (1.0 - cfg.gamma)
    new_cw = new_sum / torch.clamp(new_size, min=cfg.eps)[..., None]
    alive = (new_size > 1e-3)[..., None]
    new_cw = torch.where(alive, new_cw, state.codewords_w)

    if cfg.revive_threshold > 0:
        vw_rev, qerr_rev = vw, qerr
        if mesh is not None:
            # [ndev, nb, b_loc, f_blk + 1] -> [nb, ndev * b_loc, ...]: the
            # rows in rank order, as jax's all_gather(tiled=True) on axis 1
            g = collectives.all_gather(torch.cat([vw, qerr[..., None]], -1),
                                       mesh)
            g = g.transpose(0, 1).reshape(vw.shape[0], -1, vw.shape[2] + 1)
            vw_rev, qerr_rev = g[..., :-1], g[..., -1]
        nb, b, f_blk = vw_rev.shape
        n_rev = min(state.k, b)
        _, worst = torch.topk(qerr_rev, n_rev, dim=-1, sorted=True)
        worst_rows = torch.gather(vw_rev, 1, worst[..., None].expand(
            nb, n_rev, f_blk))
        dead = new_size < cfg.revive_threshold                 # [nb, k]
        # rank dead codewords so each picks a distinct worst row
        rank = torch.clamp(torch.cumsum(dead.int(), dim=1) - 1, 0, n_rev - 1)
        repl = torch.gather(worst_rows, 1, rank[..., None].expand(
            nb, state.k, f_blk))
        new_cw = torch.where(dead[..., None], repl, new_cw)
        new_size = torch.where(dead, torch.ones_like(new_size), new_size)
        new_sum = torch.where(dead[..., None], repl, new_sum)

    stats = UpdateStats(assignment=assignment, qerr=qerr,
                        vnorm2=(vw * vw).sum(-1))
    return CodebookState(new_cw, new_size, new_sum, new_mean, new_var,
                         state.step + 1), stats


def _kmeanspp_seed(state: CodebookState, v: torch.Tensor, rows: torch.Tensor,
                   noise: torch.Tensor, cfg: CodebookConfig) -> CodebookState:
    """The deterministic part of :func:`kmeanspp_init`: the concat rows
    ``v`` [nb, b, f_blk] whitened by their own batch moments, codeword j of
    branch i seeded on row ``rows[i, j]`` plus ``0.01 * noise[i, j]``."""
    mean = v.mean(dim=1)
    var = torch.clamp(v.var(dim=1, correction=0), min=0.0)
    vw = _whiten(v, mean[:, None, :], var[:, None, :], cfg.eps) \
        if cfg.whiten else v
    nb, k, f_blk = noise.shape
    seeds = torch.gather(vw, 1, rows.long()[..., None].expand(nb, k, f_blk))
    seeds = seeds + 0.01 * noise
    return CodebookState(
        codewords_w=seeds,
        cluster_size=torch.ones_like(state.cluster_size),
        cluster_sum=seeds.clone(),
        mean=mean if cfg.whiten else state.mean,
        var=var if cfg.whiten else state.var,
        step=state.step)


def kmeanspp_init(state: CodebookState, feats: torch.Tensor,
                  grads: torch.Tensor, cfg: CodebookConfig, *,
                  generator: torch.Generator) -> CodebookState:
    """Seed the codewords from a batch: random rows plus jitter, in the
    space of the batch's own whitening moments (the reference's light
    stand-in for k-means++ seeding).  The row ids and the jitter are drawn
    from ``generator``, which lives on the state's device."""
    v = _concat_rows(state, feats, grads)
    nb, b, f_blk = v.shape
    dev = v.device
    rows = torch.randint(0, b, (nb, state.k), generator=generator,
                         device=dev)
    noise = torch.randn((nb, state.k, f_blk), generator=generator,
                        device=dev)
    return _kmeanspp_seed(state, v, rows, noise, cfg)


def relative_error(state: CodebookState, feats: torch.Tensor,
                   grads: torch.Tensor, assignment: torch.Tensor,
                   f_feat: int, cfg: CodebookConfig) -> torch.Tensor:
    """VQ relative error  eps = ||X - R X~||_F / ||X||_F  on the feature
    half, the epsilon of Theorem 2 / Corollary 3: an offline check that
    rebuilds the batch's rows from their assigned un-whitened feature
    codewords (``assignment`` [n_branches, b]).  ``grads`` is unused, as
    in the reference; the training loop's monitor is
    :meth:`UpdateStats.relative_error`."""
    n = state.n_branches
    xcw = feature_codewords(state, f_feat, cfg)               # [n, k, fb]
    xb = _split_branches(feats.float(), n)                    # [n, b, fb]
    beta = torch.arange(n, device=xcw.device)[:, None]
    recon = xcw[beta, assignment.long()]                      # [n, b, fb]
    num = torch.sqrt(torch.sum((xb - recon) ** 2))
    den = torch.sqrt(torch.sum(xb ** 2)) + 1e-12
    return num / den
