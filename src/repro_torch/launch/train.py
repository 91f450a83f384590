"""LM training launcher on one device (torch twin of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        [--smoke] [--steps 100] [--batch 8] [--seq 128] [--accum 1] \
        [--lr 3e-4] [--ckpt-dir DIR] [--ckpt-every 50] [--seed 0] \
        [--device cpu]

The reference's optimizer (Adam under ``warmup_cosine(lr, 10, steps)``,
``clip_norm=1.0``, bf16 moments) and bf16 gradient accumulation; random
weights from a generator seeded ``--seed`` on the device, or the latest
checkpoint under ``--ckpt-dir`` (either package's); batches from the
synthetic token stream, regenerated from (seed, step).  It prints the
reference's lines: ``resumed from step N``, ``step N  loss L  R it/s``
every 10 steps, ``done``.

The dense, moe (``train_loss`` adds 0.01 x the routers' aux loss), ssm
and hybrid families train.  Fault tolerance: a checkpoint every
``--ckpt-every`` steps (atomic, versioned); on start, resume from the
latest.  ``--production-mesh`` and ``--multi-pod`` raise, naming the
slice that brings the LM meshes.  The audio and vlm families raise a
``ValueError``: their forward needs the stub context (``aux_embeds``),
which the reference's launcher does not pass either; they train through
``make_train_step(...)(state, tokens, aux_embeds)``, as the reference's
dry-run train cells do.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.data.tokens import TokenStreamConfig, batch_shard
from repro_torch.models import lm
from repro_torch.runtime import MESH_SLICE, resolve_device
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
                    help="the production device mesh (not in this slice)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the multi-pod mesh (not in this slice)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs on the card; cpu the plain PyTorch "
                    "path")
    return ap


def config(args: argparse.Namespace) -> ArchConfig:
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            f"--production-mesh / --multi-pod come with {MESH_SLICE}")
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


def make_step(cfg: ArchConfig, opt: Optimizer, accum: int):
    return make_train_step(cfg, opt, accum=accum,
                           accum_dtype=torch.bfloat16)


def main(argv: Sequence[str] | None = None) -> TrainState:
    args = parser().parse_args(argv)
    cfg = config(args)
    dev = resolve_device(args.device)
    opt = optimizer(args.lr, args.steps)
    step = make_step(cfg, opt, args.accum)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device=dev)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, manifest = ckpt.restore(args.ckpt_dir, state)
        start = manifest["step"]
        print(f"resumed from step {start}")
    ds = TokenStreamConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                           global_batch=args.batch, seed=args.seed)
    t0 = time.time()
    for s in range(start, args.steps):
        tokens = torch.from_numpy(batch_shard(ds, s, 0, 1)).to(dev)
        state, metrics = step(state, tokens)
        if (s + 1) % 10 == 0:
            print(f"step {s+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"{(s+1-start)/(time.time()-t0):.2f} it/s")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, state, {"seed": args.seed})
    print("done")
    return state


if __name__ == "__main__":
    main()
