"""Carry weights and VQ state across packages and devices as numpy arrays.

``params_from_numpy`` takes the reference's parameter layout -- one
``{name: array}`` dict per layer, weights ``[f_in, f_out]`` -- and
``vq_states_from_numpy`` takes per-layer states whose fields are those of
``CodebookState`` / ``LayerVQState`` (any objects with those attributes
holding numpy-convertible arrays, so a reference state converts without
this package importing its framework).  ``opt_state_from_numpy`` takes
an optimizer state with ``step``, ``mu`` and ``nu`` (moments in the
params' layout).  ``to_device`` moves the port's own params, states and
optimizer states between devices.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.codebook import CodebookState
from repro_torch.core.conv import LayerVQState
from repro_torch.runtime import PRECISION_SLICE, resolve_device
from repro_torch.train.optimizer import OptState

_CODEBOOK_FIELDS = CodebookState._fields


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(params: Sequence[Mapping[str, np.ndarray]],
                      device: str | torch.device = "cuda"
                      ) -> list[dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    return [{name: _tensor(v, dev) for name, v in layer.items()}
            for layer in params]


def opt_state_from_numpy(state: Any, device: str | torch.device = "cuda"
                         ) -> OptState:
    """An optimizer state from an object with ``step`` (scalar) and ``mu``
    / ``nu`` (per-layer ``{name: array}`` moments, the params' layout)."""
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=params_from_numpy(state.mu, dev),
        nu=params_from_numpy(state.nu, dev))


def vq_states_from_numpy(states: Sequence[Any],
                         device: str | torch.device = "cuda"
                         ) -> list[LayerVQState]:
    """Per-layer VQ states from objects with ``codebook`` (the six
    ``CodebookState`` fields), ``assignment``, ``counts`` and ``qcw``.
    Only dense int32 assignment tables and no quantized snapshot are taken:
    the uint8 / nibble-packed tables and int8/fp8 snapshots raise."""
    dev = resolve_device(device)
    out = []
    for l, s in enumerate(states):
        if getattr(s, "qcw", None) is not None:
            raise NotImplementedError(
                f"layer {l}: a quantized codeword snapshot (qcw) comes with "
                f"{PRECISION_SLICE}")
        a = s.assignment
        if hasattr(a, "packed") and hasattr(a, "unpack"):
            raise NotImplementedError(
                f"layer {l}: a PackedAssignment (nibble-packed table) comes "
                f"with {PRECISION_SLICE}")
        a = np.asarray(a)
        if a.dtype != np.int32:
            raise NotImplementedError(
                f"layer {l}: {a.dtype} assignment tables come with "
                f"{PRECISION_SLICE}; this slice takes int32")
        cb = CodebookState(*(
            _tensor(getattr(s.codebook, f), dev) for f in _CODEBOOK_FIELDS))
        out.append(LayerVQState(cb, _tensor(a, dev), _tensor(s.counts, dev)))
    return out


def to_device(tree, device: str | torch.device):
    """Copy params (list of dicts) or VQ states (NamedTuples) to a device."""
    dev = resolve_device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    raise TypeError(f"to_device: unsupported {type(tree)}")
