"""Architecture configuration schema + input-shape sets (twin of
``repro.configs.base``; the port keeps its own copy of the data).

One ``ArchConfig`` per architecture lives in ``configs/<id>.py`` (the
published numbers); every config also provides ``smoke()`` -- a reduced
same-family variant for CPU tests.

Input shapes (LM shapes are seq_len x global_batch):
  train_4k      seq 4096,    batch 256  -> train_step
  prefill_32k   seq 32768,   batch 32   -> prefill_step
  decode_32k    seq 32768,   batch 128  -> serve_step (1 token, full cache)
  long_500k     seq 524288,  batch 1    -> serve_step; needs sub-quadratic
                attention: native for ssm/hybrid, via VQ-Attention for
                dense/moe/vlm/audio (the paper's technique)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    attn_period: int = 0        # hybrid: 1 shared attn block per N ssm layers
    # encoder-decoder (audio)
    enc_layers: int = 0
    enc_seq: int = 1500         # stub frame count
    # VLM
    cross_attn_period: int = 0
    n_patches: int = 1024       # stub patch count
    # VQ-Attention (the paper's technique as a first-class feature)
    vq_attn: bool = False
    vq_k: int = 1024
    vq_window: int = 512
    # engineering (read by the training slice; serving ignores them)
    remat: bool = True
    remat_group: int = 0        # >0: checkpoint groups of this many layers
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_vq(self, k: int = 1024, window: int = 512) -> "ArchConfig":
        return dataclasses.replace(self, vq_attn=True, vq_k=k,
                                   vq_window=window)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        mlp = 3 * d * ff
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + mlp + 2 * d
        elif self.family == "moe":
            per_layer = attn + 2 * d + d * self.n_experts \
                + self.n_experts * 3 * d * ff
        total = self.n_layers * per_layer
        if self.family == "hybrid":
            di = 2 * d
            n = self.ssm_state
            h = di // 64
            mamba = d * (2 * di + 2 * n + h) + 4 * (di + 2 * n) + di * d + di
            shared = attn + 3 * d * ff + 2 * d
            total = self.n_layers * mamba + shared
        if self.family == "ssm":
            mlstm = 3 * d * d + 2 * d * self.n_heads + 2 * d * d
            slstm = 8 * d * d + d * d
            total = (self.n_layers // 2) * (mlstm + slstm)
        if self.family == "audio":
            total += self.enc_layers * (attn + mlp + 2 * d) \
                + self.n_layers * (attn + 2 * d)   # decoder cross-attn
        if self.family == "vlm" and self.cross_attn_period:
            total += (self.n_layers // self.cross_attn_period) * (attn + 2 * d)
        total += v * d * 2 + d  # embed + head + final norm
        return total


SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
