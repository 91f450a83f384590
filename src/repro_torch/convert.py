"""Carry weights and VQ state across packages and devices as numpy arrays.

``params_from_numpy`` takes the reference's parameter layout -- one
``{name: array}`` dict per layer, weights ``[f_in, f_out]`` -- and
``vq_states_from_numpy`` takes per-layer states whose fields are those of
``CodebookState`` / ``LayerVQState`` (any objects with those attributes
holding numpy-convertible arrays, so a reference state converts without
this package importing its framework), in every precision tier: int32 or
uint8 tables, nibble-packed ones (``packed`` + ``n``) and int8 / fp8
codeword snapshots (``qcw.feat`` / ``qcw.grad`` with ``q`` and ``scale``;
fp8 values cross as their bytes).  ``opt_state_from_numpy`` takes
an optimizer state with ``step``, ``mu`` and ``nu`` (moments in the
params' layout).  ``to_device`` moves the port's own params, states and
optimizer states between devices.

The LM side: ``lm_params_from_numpy`` takes the reference's
``models.lm.init_lm`` tree of any family (``embed``, ``ln_f``, ``head``
and the family's stacks -- ``blocks``, ``pairs``, the two-deep ``mamba``
and ``shared``, the vlm's ``cross_blocks`` with their 0-d gates,
whisper's ``enc_blocks`` and decoder ``cross`` attention -- whose
NamedTuple nodes have the fields of ``AttnParams``, ``MLPParams``,
``MoEParams``, ``MLSTMParams``, ``SLSTMParams`` or ``Mamba2Params``) and
``serve_cache_from_numpy`` its ``init_serve_cache`` tree (``KVCache`` /
``VQKVCache`` / ``MLSTMState`` / ``SLSTMState`` / ``Mamba2State`` nodes,
stacked as the reference stacks them, and the plain ``cross_k`` /
``cross_v`` arrays); ``train_state_from_numpy`` its ``train.loop.TrainState(params,
OptState(step, mu, nu), step)``.  Every leaf keeps its own dtype: the f32
router and Mamba2 scalars of a bf16 model, bf16 Adam moments of f32
leaves; bf16 arrays cross as their bytes, like fp8.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.codebook import CodebookState
from repro_torch.core.conv import (LayerVQState, QuantizedCodewords,
                                   hold_table)
from repro_torch.distributed.quantization import PackedAssignment, QTensor
from repro_torch.nn.attention import AttnParams, KVCache
from repro_torch.nn.ffn import MLPParams, MoEParams
from repro_torch.nn.ssm import Mamba2Params, Mamba2State
from repro_torch.nn.vq_attention import VQKVCache
from repro_torch.nn.xlstm import (MLSTMParams, MLSTMState, SLSTMParams,
                                  SLSTMState)
from repro_torch.runtime import resolve_device
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import OptState

_CODEBOOK_FIELDS = CodebookState._fields
_TABLE_DTYPES = (np.int32, np.uint8)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        # numpy knows fp8 only through an extension dtype torch cannot
        # read: carry the bytes and reinterpret them
        return torch.from_numpy(a.view(np.uint8)).to(dev).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(dev).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def _qtensor(t, dev: torch.device) -> QTensor:
    return QTensor(_tensor(t.q, dev), _tensor(t.scale, dev))


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
    ``CodebookState`` fields), ``assignment`` (an int32 or uint8 array, or
    an object with ``packed`` and ``n``), ``counts`` and ``qcw`` (None, or
    ``feat`` / ``grad`` objects with ``q`` and ``scale``)."""
    dev = resolve_device(device)
    out = []
    for l, s in enumerate(states):
        a = s.assignment
        if hasattr(a, "packed") and hasattr(a, "n"):
            a = PackedAssignment(_tensor(a.packed, dev), a.n)
        else:
            a = np.asarray(a)
            if a.dtype not in _TABLE_DTYPES:
                raise TypeError(f"layer {l}: {a.dtype} assignment table; "
                                f"want int32 or uint8")
            a = _tensor(a, dev)
        qcw = getattr(s, "qcw", None)
        if qcw is not None:
            qcw = QuantizedCodewords(_qtensor(qcw.feat, dev),
                                     _qtensor(qcw.grad, dev))
        cb = CodebookState(*(
            _tensor(getattr(s.codebook, f), dev) for f in _CODEBOOK_FIELDS))
        out.append(hold_table(LayerVQState(cb, a, _tensor(s.counts, dev),
                                           qcw)))
    return out


_LM_TUPLES = {cls._fields: cls for cls in (
    AttnParams, MLPParams, MoEParams, MLSTMParams, SLSTMParams, Mamba2Params,
    KVCache, VQKVCache, MLSTMState, SLSTMState, Mamba2State)}


def _lm_tree(x, dev: torch.device):
    if isinstance(x, Mapping):
        return {k: _lm_tree(v, dev) for k, v in x.items()}
    fields = getattr(x, "_fields", None)
    if fields is not None:
        cls = _LM_TUPLES.get(tuple(fields))
        if cls is None:
            raise TypeError(f"unknown LM leaf {type(x).__name__} with "
                            f"fields {fields}")
        return cls(*(_tensor(getattr(x, f), dev) for f in fields))
    return _tensor(x, dev)


def lm_params_from_numpy(params: Mapping[str, Any],
                         device: str | torch.device = "cuda") -> dict:
    """The port's LM parameters from the reference's ``init_lm`` tree
    (numpy-convertible leaves; module docstring)."""
    return _lm_tree(params, resolve_device(device))


def serve_cache_from_numpy(cache: Mapping[str, Any],
                           device: str | torch.device = "cuda") -> dict:
    """The port's decode cache from the reference's ``init_serve_cache``
    tree (module docstring)."""
    return _lm_tree(cache, resolve_device(device))


def _int32(x, dev: torch.device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)


def train_state_from_numpy(state: Any, device: str | torch.device = "cuda"
                           ) -> TrainState:
    """The port's LM ``TrainState`` from the reference's: ``params`` (the
    ``init_lm`` tree), ``opt`` with ``step``, ``mu`` and ``nu`` (moments in
    the params' layout, in whatever dtype they are stored) and ``step``
    (numpy-convertible leaves)."""
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=_lm_tree(state.params, dev),
        opt=OptState(step=_int32(opt.step, dev), mu=_lm_tree(opt.mu, dev),
                     nu=_lm_tree(opt.nu, dev)),
        step=_int32(state.step, dev))


def to_device(tree, device: str | torch.device):
    """Copy params (list of dicts) or VQ states (NamedTuples, packed
    tables included) to a device, each layer's table in the layout the
    device's context kernel reads (``core.conv.hold_table``)."""
    dev = resolve_device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if tree is None:
        return None
    if isinstance(tree, PackedAssignment):
        return tree.to(dev)
    if isinstance(tree, LayerVQState):
        return hold_table(LayerVQState(*(to_device(v, dev) for v in tree)))
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    raise TypeError(f"to_device: unsupported {type(tree)}")
