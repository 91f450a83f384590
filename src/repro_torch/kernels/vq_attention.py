"""Checked wrapper of the VQ-Attention decode CUDA kernel
(``csrc/vq_attention.cu``).

Counterpart of ``repro.kernels.vq_attention.vq_attention_decode_pallas``
as ``nn/vq_attention.py:vq_attention_decode`` calls it once per layer and
decode step: all n = batch x kv-heads GQA groups in one launch, f32 (the
smoke configs) or bf16 (the full ones) keys, values and queries, f32
masses and window mask.  The kernel splits each group's keys over
``split_count`` blocks and merges their partial softmaxes in the same
launch; the partials' workspace and the per-group counters are allocated
once per device, stream and shape and kept.  ``launches`` counts the
kernel launches of this process.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0

MAX_D = 256                   # widest head the kernel's registers hold
MAX_G = 16                    # most query heads per KV head
MAX_SPLITS = 64               # blocks a group's keys may be split over
MAX_WARPS = 4                 # warps a block: a workspace slot each
KEYS_PER_WARP = 16            # a warp's tile of keys (the mma's M)
_ENTRY = {torch.float32: "repro_vq_attention_f32",
          torch.bfloat16: "repro_vq_attention_bf16"}
_sms: dict[int, int] = {}
_workspaces: dict[tuple, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] \
    = {}


def split_count(n: int, kcb: int, w: int, sms: int) -> int:
    """Blocks per group: enough that n groups fill ``sms`` SMs, none
    without a 16-key tile, and no more than the tiles need (with ``per``
    tiles a split, ``ceil(tiles / per)`` splits)."""
    tiles = -(-(kcb + w) // KEYS_PER_WARP)
    if n >= sms or tiles <= 1:
        return 1
    s = min(-(-sms // n), tiles, MAX_SPLITS)
    per = -(-tiles // s)
    return -(-tiles // per)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sms[idx]


def _workspace(device: torch.device, stream: int, n: int, g: int, d: int,
               splits: int):
    """The partials, a slot for each warp of each block: [n, splits *
    MAX_WARPS, g, d] and [n, splits * MAX_WARPS, g, 2] (f32), and the
    per-group counters [n] (int32, zeroed once; the kernel leaves them
    zero), kept for this device, stream and shape."""
    key = (device, stream, n, g, d, splits)
    ws = _workspaces.get(key)
    if ws is None:
        slots = splits * MAX_WARPS
        ws = (torch.empty((n, slots, g, d), dtype=torch.float32,
                          device=device),
              torch.empty((n, slots, g, 2), dtype=torch.float32,
                          device=device),
              torch.zeros((n,), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def vq_attention_decode_cuda(q: torch.Tensor, cb_k: torch.Tensor,
                             cb_v: torch.Tensor, mass: torch.Tensor,
                             win_k: torch.Tensor, win_v: torch.Tensor,
                             win_mask: torch.Tensor, *,
                             splits: int | None = None) -> torch.Tensor:
    """q [n, g, d], cb_k / cb_v [n, k, d], win_k / win_v [n, w, d] of one
    dtype (f32 or bf16), mass [n, k] and win_mask [n, w] f32, all
    contiguous CUDA tensors -> [n, g, d] in q's dtype.  ``splits``: blocks
    per group (1..MAX_SPLITS), by default ``split_count`` for this card."""
    global launches
    entry = _ENTRY.get(q.dtype)
    if entry is None:
        raise TypeError(f"vq_attention: q of dtype {q.dtype}; the kernel "
                        f"takes {sorted(map(str, _ENTRY))}")
    dt = q.dtype
    _build.check_operands(
        "vq_attention", {"q": dt, "cb_k": dt, "cb_v": dt,
                         "mass": torch.float32, "win_k": dt, "win_v": dt,
                         "win_mask": torch.float32},
        q=q, cb_k=cb_k, cb_v=cb_v, mass=mass, win_k=win_k, win_v=win_v,
        win_mask=win_mask)
    if q.dim() != 3 or cb_k.dim() != 3 or win_k.dim() != 3:
        raise ValueError(f"vq_attention: want q [n, g, d], cb [n, k, d], "
                         f"win [n, w, d]; got {tuple(q.shape)}, "
                         f"{tuple(cb_k.shape)}, {tuple(win_k.shape)}")
    n, g, d = q.shape
    kcb, w = cb_k.shape[1], win_k.shape[1]
    if cb_k.shape != (n, kcb, d) or cb_v.shape != (n, kcb, d) \
            or mass.shape != (n, kcb) or win_k.shape != (n, w, d) \
            or win_v.shape != (n, w, d) or win_mask.shape != (n, w):
        raise ValueError(
            f"vq_attention: inconsistent shapes q {tuple(q.shape)}, cb_k "
            f"{tuple(cb_k.shape)}, cb_v {tuple(cb_v.shape)}, mass "
            f"{tuple(mass.shape)}, win_k {tuple(win_k.shape)}, win_v "
            f"{tuple(win_v.shape)}, win_mask {tuple(win_mask.shape)}")
    if not (1 <= d <= MAX_D and 1 <= g <= MAX_G and n >= 1
            and kcb + w >= 1):
        raise ValueError(f"vq_attention: d={d} (1..{MAX_D}), g={g} "
                         f"(1..{MAX_G}), n={n} (>= 1) or k + w = {kcb + w} "
                         f"(>= 1) outside what the kernel takes")
    if splits is None:
        splits = split_count(n, kcb, w, _sm_count(q.device))
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"vq_attention: splits={splits} outside "
                         f"1..{MAX_SPLITS}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = (0, 0, 0) if splits == 1 else tuple(
        t.data_ptr() for t in _workspace(q.device, stream, n, g, d, splits))
    out = torch.empty_like(q)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), cb_k.data_ptr(), cb_v.data_ptr(), mass.data_ptr(),
        win_k.data_ptr(), win_v.data_ptr(), win_mask.data_ptr(),
        out.data_ptr(), *ws, n, g, d, kcb, w, splits, 1.0 / math.sqrt(d),
        stream)
    _build.check(err, "vq_attention")
    launches += 1
    return out
