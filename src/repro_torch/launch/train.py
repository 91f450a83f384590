"""LM training launcher: the sharded train loop on a device mesh (torch
twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        [--smoke] [--steps 100] [--batch 8] [--seq 128] [--accum 1] \
        [--lr 3e-4] [--production-mesh] [--multi-pod] [--ckpt-dir DIR] \
        [--ckpt-every 50] [--seed 0] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch ...

The mesh is the host mesh over the process group's ranks -- (1, 1) for a
plain run (a one-rank group), (N, 1) under ``torchrun`` with N ranks --
or, with ``--production-mesh``, the (16, 16) ("data", "model") mesh
(``--multi-pod``: (2, 16, 16), "pod" first), which raises unless the
group has exactly 256 (512) ranks.  ``build_sharded_step`` places the
``TrainState`` by ``distributed/sharding.py``'s rules (params and both
Adam moments alike, the step counters replicated) and each batch by
``token_sharding``, and runs the step on DTensors (NCCL on the card,
gloo on the CPU).  The reference's optimizer (Adam under
``warmup_cosine(lr, 10, steps)``, ``clip_norm=1.0``, bf16 moments) and
bf16 gradient accumulation; random weights from a generator seeded
``--seed`` on the device, the same on every rank, each rank keeping its
shard; or the latest checkpoint under ``--ckpt-dir`` (either package's:
rank 0 writes full tensors, every rank reads them and keeps its shard);
batches from the synthetic token stream, regenerated from (seed, step).
Rank 0 prints the reference's lines: ``resumed from step N``, ``step N
loss L  R it/s`` every 10 steps, ``done``; on the card, before ``done``,
``peak <bytes> B a rank`` (``max_memory_allocated``, the largest over the
ranks) with the world size and the mesh.

The dense, moe (``train_loss`` adds 0.01 x the routers' aux loss), ssm
and hybrid families train.  The audio and vlm families raise a
``ValueError``: their forward needs the stub context (``aux_embeds``),
which the reference's launcher does not pass either; they train through
``build_sharded_step(...)[0](state, tokens, aux_embeds)``, as the
reference's dry-run train cells do.
"""
from __future__ import annotations

import argparse
import time
from contextlib import contextmanager
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.data.tokens import TokenStreamConfig, batch_shard
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act_constraints import policy
from repro_torch.launch.mesh import (axis_names, dp_axes, launch_group,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import lm
from repro_torch.runtime import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainState, make_train_step
from repro_torch.train.optimizer import Optimizer, adam, warmup_cosine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: 512 ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs on the card; cpu the plain PyTorch "
                    "path")
    return ap


def config(args: argparse.Namespace) -> ArchConfig:
    cfg = SMOKES[args.arch]() if args.smoke else ARCHS[args.arch]
    lm.check_family(cfg)
    if cfg.family in lm.CROSS_FAMILIES:
        stub = "frame" if cfg.family == "audio" else "patch"
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family's forward needs "
            f"aux_embeds (its stub {stub} embeddings), which this launcher "
            f"does not make; train it through "
            f"make_train_step(...)(state, tokens, aux_embeds)")
    return cfg


def optimizer(lr: float, steps: int) -> Optimizer:
    """The launcher's optimizer: the reference's pod optimizer."""
    return adam(warmup_cosine(lr, 10, steps), clip_norm=1.0,
                moment_dtype=torch.bfloat16)


def make_step(cfg: ArchConfig, opt: Optimizer, accum: int,
              accum_dtype: torch.dtype = torch.bfloat16):
    return make_train_step(cfg, opt, accum=accum, accum_dtype=accum_dtype)


def make_mesh(args: argparse.Namespace, device: torch.device):
    """The launcher's mesh: the production mesh under ``--production-mesh``
    or ``--multi-pod``, else the host mesh over the group's ranks."""
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(args.multi_pod, device=device)
    return make_host_mesh(device=device)


def state_shardings(state: TrainState, cfg: ArchConfig, mesh,
                    strategy: str) -> TrainState:
    """The ``TrainState``'s shardings: params and both moments by the
    parameter rules, the step counters replicated."""
    return TrainState(
        params=shd.param_shardings(state.params, cfg, mesh, strategy),
        opt=type(state.opt)(
            step=shd.replicated(mesh),
            mu=shd.param_shardings(state.opt.mu, cfg, mesh, strategy),
            nu=shd.param_shardings(state.opt.nu, cfg, mesh, strategy)),
        step=shd.replicated(mesh))


@contextmanager
def on_mesh(mesh, cfg: ArchConfig, strategy: str,
            batch: int) -> Iterator[None]:
    """The context a step on DTensors runs in: activations pinned to the
    batch's layout (``token_sharding``: the data axes, or every axis
    under fsdp / replicate where the batch divides them) -- the
    reference's policy pins the data axes for tp_fsdp and moe_ep_dp and
    leaves the rest to GSPMD's propagation, which DTensor does not have
    -- each layer's params gathered over the axes without tensor or expert
    parallelism, and plain tensors made in the step (positions, masks,
    zeros) taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    axes = shd.token_sharding(batch, mesh, cfg, strategy).spec[0]
    # FSDP gathers over the axes that do not carry tensor or expert
    # parallelism: the data axes, or every axis without TP
    gather = dp_axes(mesh) if strategy in ("tp_fsdp", "moe_ep_dp") \
        else axis_names(mesh)
    with policy(mesh if axes else None, axes or (), gather), \
            implicit_replication():
        yield


def place_batch(t: torch.Tensor | None, mesh, cfg: ArchConfig,
                strategy: str):
    """A batch [B, ...] that every rank holds whole, as a DTensor laid out
    by ``token_sharding`` (each rank keeps its rows; no communication).
    None and DTensors pass as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if t is None or isinstance(t, DTensor):
        return t
    sh = shd.token_sharding(t.shape[0], mesh, cfg, strategy)
    return distribute_tensor(t, mesh, sh.placements, src_data_rank=None)


def build_sharded_step(cfg: ArchConfig, mesh, opt: Optimizer, accum: int,
                       strategy: str | None = None,
                       accum_dtype: torch.dtype = torch.bfloat16):
    """(step, the state's shardings): ``step(state, tokens, aux_embeds=
    None) -> (state, metrics)`` takes a state placed by the shardings
    (``shd.distribute``) and full [B, S + 1] tokens, the same on every
    rank, which it lays out by ``token_sharding`` (``aux_embeds`` too);
    it pins activations to the batch's layout (``on_mesh``) and returns
    the new state in the same layout and the metrics as plain tensors.
    ``strategy`` overrides ``strategy_for`` (tests force each one);
    ``accum_dtype`` is the microbatch gradients' accumulator (the
    launcher's bf16)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    strategy = strategy or shd.strategy_for(cfg, mesh)
    step_fn = make_step(cfg, opt, accum, accum_dtype)
    with FakeTensorMode():
        params = lm.init_lm(cfg, device="cpu")
        like = TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32))
    state_sh = state_shardings(like, cfg, mesh, strategy)

    def place(t):
        return place_batch(t, mesh, cfg, strategy)

    def step(state: TrainState, tokens: torch.Tensor,
             aux_embeds: torch.Tensor | None = None):
        with on_mesh(mesh, cfg, strategy, tokens.shape[0]):
            state, metrics = step_fn(state, place(tokens), place(aux_embeds))
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
    return step, state_sh


def main(argv: Sequence[str] | None = None) -> TrainState:
    """Run the launcher; returns the final state (plain tensors on a
    one-rank group, this rank's DTensors on a larger one)."""
    args = parser().parse_args(argv)
    cfg = config(args)
    dev = resolve_device(args.device)
    with launch_group(dev):
        state = run(args, cfg, dev)
        # one rank: its shards are the whole tensors, returned as such
        return shd.gather_full(state) if dist.get_world_size() == 1 \
            else state


def run(args: argparse.Namespace, cfg: ArchConfig,
        dev: torch.device) -> TrainState:
    """The launcher's loop on this rank of the initialised group."""
    mesh = make_mesh(args, dev)
    rank0 = dist.get_rank() == 0
    opt = optimizer(args.lr, args.steps)
    step, state_sh = build_sharded_step(cfg, mesh, opt, args.accum)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = shd.distribute(lm.init_lm(cfg, gen, device=dev),
                            state_sh.params, src_data_rank=None)
    # the moments made as the params' shards
    state = shd.distribute(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32, device=dev)),
        state_sh, src_data_rank=None)
    del params
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, manifest = ckpt.restore(args.ckpt_dir, state)
        start = manifest["step"]
        if rank0:
            print(f"resumed from step {start}")
    ds = TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                           global_batch=args.batch, seed=args.seed)
    t0 = time.time()
    for s in range(start, args.steps):
        tokens = torch.from_numpy(batch_shard(ds, s, 0, 1)).to(dev)
        state, metrics = step(state, tokens)
        if (s + 1) % 10 == 0 and rank0:
            print(f"step {s+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"{(s+1-start)/(time.time()-t0):.2f} it/s")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, state, {"seed": args.seed})
    if dev.type == "cuda":
        # the largest peak of device memory over the ranks
        peak = torch.tensor(torch.cuda.max_memory_allocated(dev),
                            dtype=torch.float64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        if rank0:
            print(f"peak {int(peak)} B a rank, {dist.get_world_size()} "
                  f"ranks, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if rank0:
        print("done")
    return state


if __name__ == "__main__":
    main()
