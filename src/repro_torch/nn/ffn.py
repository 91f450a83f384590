"""Feed-forward layers of the LM stack: the SwiGLU MLP and the top-k
routed Mixture-of-Experts (twin of ``repro.nn.ffn``).

MoE dispatch is the reference's capacity-gather formulation:
  1. router -> top-k experts per token (+ softmax combine weights);
  2. each expert gathers its top-C tokens (C = tokens * k / E *
     capacity_factor);
  3. batched per-expert products [E, C, d] x [E, d, ff], in f32 as the
     reference casts them (TF32 off: ``runtime.resolve_device``);
  4. a scatter-add combine weighted by the renormalised router probs.
Plain PyTorch, as the reference's is plain XLA: no hand-written kernel.

Both top-k selections order ties as ``lax.top_k`` does, the lower index
first: a stable descending sort, so a token tied at an expert's capacity
boundary is kept or dropped as the reference keeps or drops it
(``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_constraints import is_dtensor
from repro_torch.nn.layers import _normal, dense_init, swiglu


class MLPParams(NamedTuple):
    w1: torch.Tensor   # [d, ff]
    w3: torch.Tensor   # [d, ff]   (gate)
    w2: torch.Tensor   # [ff, d]


def init_mlp(gen: Optional[torch.Generator], d: int, ff: int,
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None) -> MLPParams:
    return MLPParams(dense_init(gen, d, ff, dtype, device),
                     dense_init(gen, d, ff, dtype, device),
                     dense_init(gen, ff, d, dtype, device))


def apply_mlp(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p.w1, p.w3, p.w2)


class MoEParams(NamedTuple):
    router: torch.Tensor   # [d, E]      (f32 in every model dtype)
    w1: torch.Tensor       # [E, d, eff]
    w3: torch.Tensor       # [E, d, eff]
    w2: torch.Tensor       # [E, eff, d]


def init_moe(gen: Optional[torch.Generator], d: int, n_experts: int,
             expert_ff: int, dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None) -> MoEParams:
    """The reference's distributions: an N(0, 1/d) f32 router, N(0, 1/d)
    w1 / w3 and N(0, 1/eff) w2, drawn in f32 and stored in ``dtype``."""
    def experts(f_in, f_out):
        return (_normal(gen, (n_experts, f_in, f_out), device)
                / math.sqrt(f_in)).to(dtype)
    return MoEParams(router=dense_init(gen, d, n_experts, torch.float32,
                                       device),
                     w1=experts(d, expert_ff), w3=experts(d, expert_ff),
                     w2=experts(expert_ff, d))


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last dim, ties to the lower index (as
    ``lax.top_k``); the values carry the gradient to their positions."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(t: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Tokens an expert takes: min(T, max(1, int(T k cf / E)))."""
    return min(t, max(1, int(t * top_k * capacity_factor / n_experts)))


def apply_moe(p: MoEParams, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] (flattened tokens) -> (y [T, d] in x's dtype, the
    load-balance aux loss [] f32).

    Expert e processes the C highest-scoring tokens that routed to it;
    a token past an expert's capacity loses that expert.  Every expert
    runs on its C slots whether or not they hold a routed token (an
    empty slot scores 0 and its output is multiplied by 0), as in the
    reference.  The aux loss is E * sum(mean probs * mean routed one-hot)
    / k; its gradient flows through the probs only.

    On a mesh (DTensor ``x``) the token-expert selection is global over
    all T tokens, as the reference's: the tokens are gathered whole, the
    routing runs on every rank, and each rank runs its own experts' slots
    (the mesh dims that shard the experts: expert parallelism) and adds
    their outputs, the sum over those dims taken in f32
    (:func:`_apply_moe_ep`)."""
    if is_dtensor(x):
        return _apply_moe_ep(p, x, top_k, capacity_factor)
    score, aux = _route(x, p.router, top_k)
    y = _experts(x, score, p.w1, p.w3, p.w2,
                 moe_capacity(x.shape[0], top_k, p.router.shape[1],
                              capacity_factor), 0)
    return y.to(x.dtype), aux


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(score [T, E]: each token's renormalised router prob at its top-k
    experts, 0 elsewhere; the aux loss)."""
    t = x.shape[0]
    e = router.shape[1]
    logits = x.float() @ router                            # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top(probs, top_k)                      # [T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e, e).float().sum(1), dim=0)
    aux = e * torch.sum(me * ce) / top_k

    # per-expert top-C token selection: score[token, expert] = routed prob
    score = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    return score.scatter_add(1, top_e, top_p), aux


def _experts(x: torch.Tensor, score: torch.Tensor, w1: torch.Tensor,
             w3: torch.Tensor, w2: torch.Tensor, cap: int,
             first: int) -> torch.Tensor:
    """The f32 sum [T, d] of experts ``first`` .. ``first + w1.shape[0]``
    over their top-``cap`` tokens by ``score``."""
    t, d = x.shape
    gval, gidx = _top(score.T[first:first + w1.shape[0]], cap)   # [E, C]
    xe = x[gidx].float()                                   # [E, C, d]
    h = torch.bmm(xe, w1.float())
    gate = torch.bmm(xe, w3.float())
    ye = torch.bmm(F.silu(h) * gate, w2.float())           # [E, C, d]
    ye = ye * (gval > 0)[..., None].float()                # mask empty slots

    # scatter-add combine, weighted by the renormalised router probs
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    return y.index_add(0, gidx.reshape(-1),
                       (ye * gval[..., None]).reshape(-1, d))


def _apply_moe_ep(p: MoEParams, x: torch.Tensor, top_k: int,
                  capacity_factor: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` on DTensors (its docstring): the routing on the
    whole tokens on every rank, each rank's experts on its part of the
    expert dim; gradients of the tokens and scores from a rank's experts
    are partial sums over the expert-parallel dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    t = x.shape[0]
    e = p.router.shape[1]
    cap = moe_capacity(t, top_k, e, capacity_factor)
    ep = [i for i, pl in enumerate(p.w1.placements)
          if isinstance(pl, Shard) and pl.dim == 0]
    whole = [Replicate()] * mesh.ndim
    experts = [Shard(0) if i in ep else Replicate()
               for i in range(mesh.ndim)]
    partial = [Partial() if i in ep else Replicate()
               for i in range(mesh.ndim)]
    # this rank's first expert: its coordinate over the expert dims
    n_local, pos = e, 0
    for i in ep:
        n_local //= mesh.size(i)
        pos = pos * mesh.size(i) + mesh.get_local_rank(i)
    score, aux = local_map(
        lambda xl, rl: _route(xl, rl, top_k), out_placements=(whole, whole),
        in_placements=(whole, whole), device_mesh=mesh,
        redistribute_inputs=True)(x, p.router)
    y = local_map(
        lambda *a: _experts(*a, cap, pos * n_local)[None],
        out_placements=experts,
        in_placements=(whole, whole, experts, experts, experts),
        in_grad_placements=(partial, partial, experts, experts, experts),
        device_mesh=mesh, redistribute_inputs=True)(
            x, score, p.w1, p.w3, p.w2)
    # the experts' sum, reduced in f32, then cast
    y = y.sum(0).redistribute(mesh, whole)
    return y.to(x.dtype), aux
