"""Optimizers as pure functions over parameter trees (no torch.optim).

Torch twin of ``repro.train.optimizer``: Adam and RMSprop (paper App. F:
RMSprop for VQ-GNN, whose EMA-smoothed gradient statistics interact badly
with Adam's cumulative moments; Adam for the baselines), gradient clipping
by global norm, weight decay, and learning-rate schedules.  Written out
rather than wrapping ``torch.optim`` because the reference differs from
it: its Adam folds the bias correction into the step size and adds ``eps``
to the uncorrected ``sqrt(v)``, and both optimizers decay only the
``ndim >= 2`` params.

A tree is a tensor, or a list / tuple / dict of trees (the port's GNN
params are a list of ``{name: tensor}`` dicts, the LM's a dict of stacked
tensors and NamedTuples).  ``update`` returns new params and a new
:class:`OptState`; nothing is updated in place.  Adam updates leaf by
leaf, in slices, so its f32 temporaries stay small whatever a leaf's
size (a stacked [28, 3072, 8192] MLP weight of llama3.2-3b holds 704 M):
16 M elements on the card, 256 K on the CPU, where a slice's temporaries
then stay in cache (3x faster there than 16 M slices).  The arithmetic is
elementwise, so the slices change no result.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed.act_constraints import is_dtensor, match_layout

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor   # [] int32 update counter
    mu: Tree             # first moment (Adam) / unused zeros (RMSprop)
    nu: Tree             # second moment


class Optimizer(NamedTuple):
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple[Tree, OptState]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf by leaf over trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):                     # NamedTuple
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"tree_map: unsupported node {type(tree)}")


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in tree_leaves(v)]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(tree: Tree, max_norm: float) -> torch.Tensor:
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    """Leaves times min(1, max_norm / norm), in f32: the reference
    multiplies by an f32 scale, which promotes bf16 leaves to f32."""
    scale = _clip_scale(tree, max_norm)
    return tree_map(lambda x: x.float() * scale, tree)


class _Leaf(tuple):
    """Several results of one leaf, which ``tree_map`` must not descend
    into: unpacked by ``_unzip``."""


def _unzip(out: Tree, like: Tree, i: int) -> Tree:
    """``like``'s structure holding the ``i``-th result of each
    ``_Leaf`` of ``out`` (dicts matched by key)."""
    if isinstance(out, _Leaf):
        return out[i]
    if isinstance(like, dict):
        return {k: _unzip(out[k], v, i) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_unzip(o, v, i) for o, v in zip(out, like)))
    return type(like)(_unzip(o, v, i) for o, v in zip(out, like))


def tree_unflatten(tree: Tree, leaves: list) -> Tree:
    """``tree``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def constant_lr(base_lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup, warm, cos)
    return sched


def _step_of(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(params: Tree, dtype: torch.dtype = torch.float32) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), params)


def _full(x):
    """A replicated (or partial) DTensor scalar as its plain value."""
    return x.full_tensor() if is_dtensor(x) else x


# elements of one leaf updated at a time, by device type
_SLICE = {"cuda": 1 << 24, "cpu": 1 << 18}


def adam(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         clip_norm: Optional[float] = None,
         moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """The reference's Adam: ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``,
    ``p -= lr_t * m / (sqrt(v) + eps)`` (+ ``lr * wd * p`` on ndim >= 2).
    The moments are stored in ``moment_dtype`` (bf16 halves their bytes)
    and the update is computed in f32, the clipped gradient too."""
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return OptState(_step_of(params), _zeros(params, moment_dtype),
                        _zeros(params, moment_dtype))

    def update(grads, state, params):
        scale = None if clip_norm is None \
            else _full(_clip_scale(grads, clip_norm))
        step = state.step + 1
        t = _full(step).float()
        lr_s = sched(_full(step))
        lr_t = lr_s * torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))

        def upd(g, m, v, p):
            if is_dtensor(p):
                # elementwise: each rank updates its own shard, the
                # gradient first laid out as its parameter
                from torch.distributed.tensor import DTensor
                outs = upd(*(x.to_local() for x in (match_layout(g, p), m,
                                                    v, p)))
                return tuple(DTensor.from_local(
                    o, p.device_mesh, p.placements, run_check=False,
                    shape=p.shape, stride=p.stride()) for o in outs)
            p2 = torch.empty(p.shape, dtype=p.dtype, device=p.device)
            m2 = torch.empty(m.shape, dtype=moment_dtype, device=m.device)
            v2 = torch.empty(v.shape, dtype=moment_dtype, device=v.device)
            flat = [x.reshape(-1) for x in (g, m, v, p, p2, m2, v2)]
            n = _SLICE.get(p.device.type, _SLICE["cuda"])
            for a in range(0, p.numel(), n):
                gs, ms, vs, ps, po, mo, vo = (x[a:a + n] for x in flat)
                g32 = gs.float() if scale is None else gs.float() * scale
                m32 = b1 * ms.float() + (1 - b1) * g32
                v32 = b2 * vs.float() + (1 - b2) * g32 * g32
                delta = lr_t * m32 / (torch.sqrt(v32) + eps)
                if weight_decay and p.dim() >= 2:
                    delta = delta + lr_s * weight_decay * ps.float()
                po.copy_(ps.float() - delta)
                mo.copy_(m32)
                vo.copy_(v32)
            return p2, m2, v2

        out = tree_map(lambda *leaves: _Leaf(upd(*leaves)), grads,
                       state.mu, state.nu, params)
        return (_unzip(out, params, 0),
                OptState(step, _unzip(out, state.mu, 1),
                         _unzip(out, state.nu, 2)))

    return Optimizer(init, update)


def rmsprop(lr: float | Callable = 3e-3, alpha: float = 0.99,
            eps: float = 1e-8, weight_decay: float = 0.0,
            clip_norm: Optional[float] = None) -> Optimizer:
    """RMSprop(alpha=0.99), the paper's optimizer for VQ-GNN (App. F):
    ``p -= lr * g / (sqrt(v) + eps)`` (+ ``lr * wd * p`` on ndim >= 2)."""
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return OptState(_step_of(params), _zeros(params), _zeros(params))

    def update(grads, state, params):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        new_v = tree_map(lambda g, v: alpha * v + (1 - alpha) * g.float()
                         * g.float(), grads, state.nu)

        def upd(g, v, p):
            delta = lr_t * g.float() / (torch.sqrt(v) + eps)
            if weight_decay and p.dim() >= 2:
                delta = delta + lr_t * weight_decay * p.float()
            return (p.float() - delta).to(p.dtype)
        return (tree_map(upd, grads, new_v, params),
                OptState(step, state.mu, new_v))

    return Optimizer(init, update)


OPTIMIZERS = {"adam": adam, "rmsprop": rmsprop}
