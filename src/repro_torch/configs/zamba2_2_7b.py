"""zamba2-2.7b [hybrid]: 54L d2560 32H (GQA kv=32) ff10240 vocab 32000,
Mamba2 ssm_state=64 + shared attention block.  [arXiv:2411.15242; hf]
Mamba2 scan is attention-free (VQ inapplicable); the shared attention
block takes VQ-Attention for long_500k (DESIGN.md Arch-applicability)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
    ssm_state=64, attn_period=6)


def smoke() -> ArchConfig:
    return ArchConfig(name="zamba2-smoke", family="hybrid", n_layers=4,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=256, ssm_state=16, attn_period=2, remat=False,
                      dtype="float32")
