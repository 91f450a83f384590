"""Host-snapshot environment knobs (the env-read-once contract).

Torch twin of ``repro.hostenv``.  Every ``REPRO_*`` knob that steers a
kernel dispatch (``kernels/ops.py``, ``kernels/autotune.py``) is read
through :func:`env_knob` instead of ``os.environ``.

Torch has no jit trace, so a read is live: the snapshot refreshes on every
call.  The one exception is a CUDA graph capture: while the current CUDA
stream is being captured (``torch.cuda.is_current_stream_capturing()``) a
read returns the last host-side snapshot, because a captured graph replays
the kernels its capture chose whatever the environment says later.  A
knob whose first read in the process happens during a capture is
snapshotted there (there is no earlier host-side value to prefer), as the
reference snapshots a knob first read under a trace.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

# name -> raw value (None records "unset"); refreshed on every host-side
# read, frozen during a CUDA graph capture
_snapshot: dict[str, Optional[str]] = {}


def _capturing() -> bool:
    # no capture can run before CUDA is initialized (and a CPU-only build
    # has no capture to ask about)
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


def _refresh(name: str) -> None:
    if name not in _snapshot or not _capturing():
        _snapshot[name] = os.environ.get(name)


def env_knob(name: str, default=None):
    """``os.environ.get(name, default)``, frozen to the last host-side
    snapshot during a CUDA graph capture."""
    _refresh(name)
    val = _snapshot[name]
    return default if val is None else val


def env_knob_set(name: str) -> bool:
    """``name in os.environ`` under the same rule."""
    _refresh(name)
    return _snapshot[name] is not None


def reset_env_snapshot() -> None:
    """Drop every snapshotted knob (tests; forces fresh reads)."""
    _snapshot.clear()
