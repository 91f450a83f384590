"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) expert_ff=768
vocab 151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf-verified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, qk_norm=True,
    n_experts=128, top_k=8)


def smoke() -> ArchConfig:
    return ArchConfig(name="qwen3moe-smoke", family="moe", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
                      vocab=256, qk_norm=True, n_experts=8, top_k=2,
                      remat=False, dtype="float32")
