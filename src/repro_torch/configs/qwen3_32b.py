"""qwen3-32b [dense]: 64L d5120 64H (GQA kv=8) ff25600 vocab 151936, qk_norm.
[hf:Qwen/Qwen3-8B family; hf-verified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_ff=25600, vocab=151936, qk_norm=True)


def smoke() -> ArchConfig:
    return ArchConfig(name="qwen3-smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, qk_norm=True, remat=False, dtype="float32")
