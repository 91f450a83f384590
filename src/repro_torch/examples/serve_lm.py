"""Batched LM serving with a VQ-compressed KV cache against the exact
cache (torch twin of ``examples/serve_lm.py``).

The inference-side payoff of the paper: the KV state per sequence is
O(k + W) instead of O(t) -- constant memory, constant per-token work
whatever the context length.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --tokens 64 \
        --batch 4 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.serve import cache_bytes
from repro_torch.models.lm import init_lm, init_serve_cache, serve_step
from repro_torch.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=4096,
                    help="pre-allocated context length for the exact cache")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = ArchConfig(name="serve-demo", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab=2048, remat=False, dtype="float32")
    params = init_lm(base, torch.Generator().manual_seed(0), device=dev)
    vq_cfg = base.with_vq(k=128, window=64)

    for name, cfg in [("exact-kv", base), ("vq-kv", vq_cfg)]:
        cache = init_serve_cache(cfg, args.batch, args.context, device=dev)
        tok = torch.zeros((args.batch, 1), dtype=torch.long, device=dev)
        logits, cache = serve_step(params, tok, cache, cfg)   # warm-up
        t0 = time.time()
        outs = []
        for _ in range(args.tokens):
            logits, cache = serve_step(params, tok, cache, cfg)
            tok = torch.argmax(logits, -1)[:, None]
            outs.append(tok[:, 0].cpu())
        dt = time.time() - t0
        tps = args.tokens * args.batch / dt
        print(f"{name:9s}: {tps:8.1f} tok/s   cache "
              f"{cache_bytes(cache)/2**20:7.2f} MB   "
              f"sample: {[int(o[0]) for o in outs[:8]]}")
    print("\nvq-kv cache size is independent of --context; exact-kv grows "
          "linearly with it.")


if __name__ == "__main__":
    main()
