"""whisper-tiny [audio]: 4L d384 6H ff1536 vocab 51865; enc-dec, conv
frontend STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]
6 heads do not divide the 16-way model axis -> replicated-DP strategy
(37M params).  Decode shapes exercise the decoder only."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    enc_layers=4, enc_seq=1500)


def smoke() -> ArchConfig:
    return ArchConfig(name="whisper-smoke", family="audio", n_layers=2,
                      d_model=48, n_heads=3, n_kv_heads=3, d_ff=96,
                      vocab=256, enc_layers=2, enc_seq=32, remat=False,
                      dtype="float32")
