"""LM training loop: gradient accumulation, checkpoint and restart,
failure drills (twin of ``repro.train.loop``).

  * every step's data is regenerated from (seed, step) -- no loader state;
  * checkpoints every ``ckpt_every`` steps (atomic, versioned);
  * on start, resume-from-latest is automatic, so a run can start from a
    checkpoint the reference wrote (the same layout, ``checkpoint.py``);
  * a step that raises ``RuntimeError`` is retried after restoring the
    latest checkpoint (the preemption drill, ``inject_failure_at``).

``init_lm`` draws from a torch generator seeded ``seed`` on the device:
JAX's PRNG cannot be replayed, so a run that must start from the
reference's weights starts from a reference checkpoint.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenStreamConfig, batch_shard
from repro_torch.distributed.act_constraints import (is_dtensor,
                                                     match_layout,
                                                     relayout_batch)
from repro_torch.models import lm
from repro_torch.runtime import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (Optimizer, adam, tree_leaves,
                                         tree_map, tree_unflatten,
                                         warmup_cosine)


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor       # [] int32


def loss_and_grads(params: Any, tokens: torch.Tensor, cfg: ArchConfig,
                   aux_embeds: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, Any]:
    """``lm.train_loss`` and its gradient in every parameter leaf (in the
    leaf's dtype), without touching the params' own ``requires_grad``.
    ``aux_embeds`` (the audio / vlm families' stub context) is an input,
    not differentiated, as in the reference."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = lm.train_loss(tree_unflatten(params, leaves), tokens, cfg,
                             aux_embeds)
        # a leaf the model does not read (the qk norms of an arch without
        # qk_norm) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    # on a mesh each gradient takes its parameter's layout
    grads = [match_layout(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt: Optimizer, accum: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """Returns ``train_step(state, tokens, aux_embeds=None) -> (state,
    metrics)``, metrics ``{"loss", "grad_norm"}`` (device tensors; the
    norm is of the averaged gradient before clipping).  ``aux_embeds``
    [B, F, d] is the audio / vlm families' stub context, one row a
    sequence.

    With ``accum > 1`` the batch is split into ``accum`` strided
    microbatches, as the reference splits it (``reshape(mb, accum,
    ...).swapaxes(0, 1)``: microbatch i holds rows i, i + accum, ...),
    ``aux_embeds`` the same way; losses and gradients are summed in
    ``accum_dtype``, then divided by ``accum``, before one optimizer
    update."""

    def split(t: Optional[torch.Tensor]) -> list:
        if t is None:
            return [None] * accum
        mb = t.shape[0] // accum
        if is_dtensor(t):
            # the strided rows cross the shards: the whole batch (tokens,
            # a stub context) is split, and each microbatch laid out as t
            whole = split(t.full_tensor())
            return [relayout_batch(m, t) for m in whole]
        return list(t.reshape(mb, accum, *t.shape[1:]).transpose(0, 1))

    def step_fn(state: TrainState, tokens: torch.Tensor,
                aux_embeds: Optional[torch.Tensor] = None):
        if accum == 1:
            loss, grads = loss_and_grads(state.params, tokens, cfg,
                                         aux_embeds)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), state.params)
            for tok, aux in zip(split(tokens), split(aux_embeds)):
                l, g = loss_and_grads(state.params, tok, cfg, aux)
                loss = loss + l
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(a.dtype))
                del g
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        new_params, new_opt = opt.update(grads, state.opt, state.params)
        return TrainState(new_params, new_opt, state.step + 1), \
            {"loss": loss, "grad_norm": gnorm}

    return step_fn


def train(cfg: ArchConfig, *, steps: int, batch: int, seq_len: int,
          lr: float = 3e-4, accum: int = 1, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          log_every: int = 10, inject_failure_at: Optional[int] = None,
          device: str | torch.device = "cuda") -> dict:
    """Single-device training driver: Adam under ``warmup_cosine(lr,
    max(10, steps // 20), steps)`` with ``clip_norm=1.0``.  Returns
    ``{"history": [{"step", "loss", "time"}, ...], "state": TrainState}``
    (a history entry every ``log_every`` steps and at the last)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_lm(cfg, gen, device=dev)
    opt = adam(warmup_cosine(lr, max(10, steps // 20), steps), clip_norm=1.0)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))

    start_step = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        state, manifest = ckpt.restore(ckpt_dir, state)
        start_step = manifest["step"]

    ds = TokenStreamConfig(vocab=cfg.vocab, seq_len=seq_len + 1,
                           global_batch=batch, seed=seed)
    step_fn = make_train_step(cfg, opt, accum)

    history = []
    t0 = time.time()
    s = start_step
    while s < steps:
        tokens = torch.from_numpy(batch_shard(ds, s, 0, 1)).to(dev)
        try:
            if inject_failure_at is not None and s == inject_failure_at:
                inject_failure_at = None
                raise RuntimeError("injected node failure (drill)")
            state, metrics = step_fn(state, tokens)
        except RuntimeError:
            # preemption drill: restore-from-latest and retry this step
            if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
                state, manifest = ckpt.restore(ckpt_dir, state)
                s = manifest["step"]
                continue
            raise
        s += 1
        if s % log_every == 0 or s == steps:
            history.append({"step": s, "loss": float(metrics["loss"]),
                            "time": time.time() - t0})
        if ckpt_dir is not None and s % ckpt_every == 0:
            ckpt.save(ckpt_dir, s,
                      TrainState(state.params, state.opt,
                                 torch.tensor(s, dtype=torch.int32)),
                      {"data_seed": seed}, async_write=False)
    return {"history": history, "state": state}
