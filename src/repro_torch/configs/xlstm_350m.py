"""xlstm-350m [ssm]: 24L d1024 4H vocab 50304; sLSTM + mLSTM pairs.
[arXiv:2405.04517; unverified]
Attention-free: VQ-GNN technique inapplicable (DESIGN.md
Arch-applicability); long_500k runs natively (linear recurrence)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304)


def smoke() -> ArchConfig:
    return ArchConfig(name="xlstm-smoke", family="ssm", n_layers=4,
                      d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
                      vocab=256, remat=False, dtype="float32")
