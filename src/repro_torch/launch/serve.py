"""LM serving launcher: batched greedy decode with an exact or a
VQ-compressed KV cache (torch twin of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        [--smoke] [--vq] [--tokens 32] [--batch 4] [--context 1024] \
        [--device cpu]

Random weights (a generator seeded 0 on the device), the decode cache of
``--context`` slots (exact) or of k = min(vq_k, 128) codewords and a
64-token window (``--vq``, as the reference sets them), one warm-up step,
then ``--tokens`` steps feeding back each step's argmax.  Every family
serves: dense, moe (qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b), ssm
(xlstm-350m: constant-size recurrent states; ``--vq`` has no attention to
act on, as in the reference), hybrid (zamba2-2.7b: ``--vq`` applies to
its shared attention block), audio (whisper-tiny) and vlm
(llama-3.2-vision-11b).  The last two decode as the reference's launcher
decodes them: from a fresh cache whose cross-attention keys and values
are zeros, with no encoder pass and no patch input (``--vq`` applies to
their decoder self-attention).  The printed line is the reference's:
``<arch> strategy=<s> vq=<b>: <tok/s> tok/s, cache <MB> MB``, the
strategy ``distributed/sharding.py`` picks for the mesh -- the host mesh
over the process group's ranks (a one-rank group for a plain run), or
the (16, 16) production mesh under ``--production-mesh``, which raises
unless the group has 256 ranks.  Decode itself stays unsharded, as in the
reference (its jitted step takes no shardings): each rank decodes the
whole batch.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.distributed.sharding import strategy_for
from repro_torch.launch.mesh import (launch_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.runtime import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--vq", action="store_true",
                    help="VQ-compressed KV cache (paper technique)")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: 256 ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    return ap


def config(args: argparse.Namespace) -> ArchConfig:
    """The served configuration: the arch (or its smoke), with
    VQ-Attention at k = min(vq_k, 128), window 64 under ``--vq``."""
    cfg = SMOKES[args.arch]() if args.smoke else ARCHS[args.arch]
    if args.vq:
        cfg = cfg.with_vq(k=min(cfg.vq_k, 128), window=64)
    return cfg


def cache_bytes(cache) -> int:
    """Bytes of every tensor of a decode cache (the reference's accounting:
    the sum over the tree's leaves, ``pos`` included): an entry is a
    NamedTuple of tensors (the attention and recurrent states) or one
    tensor (the cross-attention families' ``cross_k`` / ``cross_v``)."""
    leaves = [t for c in cache.values()
              for t in ((c,) if isinstance(c, torch.Tensor) else c)]
    return int(sum(t.numel() * t.element_size() for t in leaves))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode(params, cfg: ArchConfig, *, batch: int, context: int,
           tokens: int, device: str | torch.device = "cuda"
           ) -> tuple[torch.Tensor, dict, dict]:
    """A fresh cache, one warm-up step on token 0, then ``tokens`` greedy
    steps, each timed on the host clock up to a synchronise.  Returns the
    last logits, the cache and a report (tok/s over the timed steps, step
    p50 / p99 ms, cache bytes)."""
    dev = resolve_device(device)
    cache = lm.init_serve_cache(cfg, batch, context, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    logits, cache = lm.serve_step(params, tok, cache, cfg)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    steps = []
    t_start = time.perf_counter()
    for _ in range(tokens):
        t = time.perf_counter()
        logits, cache = lm.serve_step(params, tok, cache, cfg)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)
        steps.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_start
    ms = np.asarray(steps) * 1e3
    report = {
        "arch": cfg.name, "vq": cfg.vq_attn, "batch": batch,
        "tokens": tokens, "warmup_s": warm_s, "wall_s": wall,
        "tok_per_s": tokens * batch / wall if wall > 0 else float("inf"),
        "step_p50_ms": float(np.percentile(ms, 50)) if tokens else None,
        "step_p99_ms": float(np.percentile(ms, 99)) if tokens else None,
        "cache_bytes": cache_bytes(cache)}
    return logits, cache, report


def main(argv: Sequence[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    cfg = config(args)
    dev = resolve_device(args.device)
    with launch_group(dev):
        mesh = (make_production_mesh(device=dev) if args.production_mesh
                else make_host_mesh(device=dev))
        strategy = strategy_for(cfg, mesh)
    params = lm.init_lm(cfg, device=dev)
    _, _, report = decode(params, cfg, batch=args.batch,
                          context=args.context, tokens=args.tokens,
                          device=dev)
    report["strategy"] = strategy
    print(f"{cfg.name} strategy={strategy} vq={cfg.vq_attn}: "
          f"{report['tok_per_s']:.1f} tok/s, "
          f"cache {report['cache_bytes'] / 2**20:.1f} MB")
    return report


if __name__ == "__main__":
    main()
