"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) ff53248 vocab 128256.
[arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
    remat_group=14)


def smoke() -> ArchConfig:
    return ArchConfig(name="llama405b-smoke", family="dense", n_layers=3,
                      d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
                      vocab=256, remat=False, dtype="float32")
