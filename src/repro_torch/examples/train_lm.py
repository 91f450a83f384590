"""End-to-end LM training driver: a dense decoder with VQ-Attention (the
paper's technique on the token graph) or exact attention, on the
synthetic token stream, with checkpoints and restart (torch twin of
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        [--vq] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
        --steps 300

The checkpoints go to ``--ckpt`` (default: ``repro_torch_lm_ckpt`` under
the temporary directory); a second run resumes from the latest one.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.train.loop import train

PRESETS = {
    "tiny": ArchConfig(name="tiny-lm", family="dense", n_layers=4,
                       d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                       vocab=2048, remat=False, dtype="float32"),
    "100m": ArchConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                       vocab=32768, remat=True, dtype="float32"),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vq", action="store_true",
                    help="enable VQ-Attention (codebook context)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    if args.vq:
        cfg = cfg.with_vq(k=64, window=64)
    n_params = cfg.param_count()
    print(f"arch {cfg.name}: ~{n_params/1e6:.1f}M params, "
          f"vq_attn={cfg.vq_attn}")

    out = train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
                lr=3e-4, ckpt_dir=args.ckpt, ckpt_every=50, log_every=10,
                device=args.device)
    for h in out["history"]:
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"({h['time']:.0f}s)")
    first, last = out["history"][0], out["history"][-1]
    print(f"\nloss: {first['loss']:.3f} -> {last['loss']:.3f} "
          f"({args.steps} steps, ckpts in {args.ckpt})")
    return out


if __name__ == "__main__":
    main()
