"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  A CUDA request without a card raises -- the port never
    carries on silently on the CPU.

    Also pins full-f32 matmuls: the reference computes its ``m @ w``
    products in f32, so TF32 (three decimal digits) stays off for both the
    cuBLAS and the cuDNN paths."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
