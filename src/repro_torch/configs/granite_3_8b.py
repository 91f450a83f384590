"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) ff12800 vocab 49155.
[hf:ibm-granite/granite-3.0-2b-base family; hf-verified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155)


def smoke() -> ArchConfig:
    return ArchConfig(name="granite-smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, remat=False, dtype="float32")
