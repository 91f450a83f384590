"""llama3.2-3b [dense]: 28L d3072 24H (GQA kv=8) ff8192 vocab 128256.
[hf:meta-llama/Llama-3.2-1B family; unverified]
24 heads do not divide the 16-way model axis -> FSDP sharding strategy
(DESIGN.md section 5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256)


def smoke() -> ArchConfig:
    return ArchConfig(name="llama3b-smoke", family="dense", n_layers=2,
                      d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
                      vocab=256, remat=False, dtype="float32")
