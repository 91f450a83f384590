"""LM/speech/vision architecture registry: --arch <id> -> ArchConfig (twin
of ``repro.configs.registry``).  Kept apart from the GNN configurations:
only the LM launcher and the LM tests read it."""
from repro_torch.configs.base import ArchConfig

from repro_torch.configs import (granite_3_8b, llama3_405b, qwen3_32b,
                                 llama3_2_3b, xlstm_350m, qwen3_moe_30b_a3b,
                                 phi3_5_moe_42b_a6_6b, zamba2_2_7b,
                                 whisper_tiny, llama_3_2_vision_11b)

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "llama3-405b": llama3_405b,
    "qwen3-32b": qwen3_32b,
    "llama3.2-3b": llama3_2_3b,
    "xlstm-350m": xlstm_350m,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b_a6_6b,
    "zamba2-2.7b": zamba2_2_7b,
    "whisper-tiny": whisper_tiny,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
}

LM_ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}
ARCHS = LM_ARCHS
SMOKES = {name: m.smoke for name, m in _MODULES.items()}


def get_arch(name: str) -> ArchConfig:
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return SMOKES[name]()
