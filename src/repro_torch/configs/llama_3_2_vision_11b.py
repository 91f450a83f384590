"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) ff14336
vocab 128256; cross-attention image layers every 5; patch frontend STUB.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    cross_attn_period=5, n_patches=1024)


def smoke() -> ArchConfig:
    return ArchConfig(name="llamavis-smoke", family="vlm", n_layers=4,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, cross_attn_period=2, n_patches=16,
                      remat=False, dtype="float32")
