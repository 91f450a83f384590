"""The VQ operand tiers: quantized codeword snapshots and nibble-packed
assignment tables.

Torch twin of the VQ half of ``repro.distributed.quantization``:
``quantize_codewords`` (int8 and ``torch.float8_e4m3fn`` codeword tables
with per-branch/per-channel f32 scales and the drift band of
quantize-on-update), the nibble-packed assignment machinery
(``pack_nibbles`` / ``unpack_nibbles`` / ``gather_nibbles`` /
``scatter_nibbles`` and :class:`PackedAssignment`) behind the ``+a4`` tiers
for k <= 16 product branches, ``dtype_nbits`` and ``tree_bytes`` (the
sub-byte-aware size accounting), and the weight-only quantizer of the
reference (``quantize_tensor`` / ``dequantize_tensor``, ``quantize_tree`` /
``dequantize_tree``: per-output-channel int8 or fp8 for every weight of a
nested dict / list / tuple of tensors).

Torch has no 4-bit tensor the kernels could take, so a uint4 value here
is a ``torch.uint8`` tensor holding values < 16 (one per byte), and the
packed form is the uint8 buffer with two ids per byte.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor        # int8 / float8_e4m3fn, the original's shape
    scale: torch.Tensor    # f32 scales, broadcast over the reduced axis


# HLO short dtype names (as compiled-module dumps print them) -> bits
_HLO_NBITS = {
    "pred": 8, "s4": 4, "u4": 4, "s8": 8, "u8": 8, "s16": 16, "u16": 16,
    "s32": 32, "u32": 32, "s64": 64, "u64": 64,
    "f8e4m3fn": 8, "f8e5m2": 8, "bf16": 16, "f16": 16, "f32": 32, "f64": 64,
    "c64": 64, "c128": 128,
}
_SUB_BYTE_NBITS = {"int4": 4, "uint4": 4}


def dtype_name(dt) -> str:
    """``torch.uint8`` / ``"uint8"`` -> ``"uint8"`` (the names the tiers use;
    ``"uint4"`` and ``"int4"`` name the sub-byte types)."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str):
        return dt
    raise TypeError(f"not a dtype: {dt!r}")


def dtype_nbits(dt) -> int:
    """Bits per element of a dtype, sub-byte aware: torch dtypes, their
    names (``"uint4"`` counts 4) and the HLO short names (``"f8e4m3fn"``,
    ``"s32"``, ...).  Unknown names raise KeyError."""
    if isinstance(dt, str) and dt in _HLO_NBITS:
        return _HLO_NBITS[dt]
    name = dtype_name(dt)
    if name in _SUB_BYTE_NBITS:
        return _SUB_BYTE_NBITS[name]
    d = getattr(torch, name, None)
    if not isinstance(d, torch.dtype):
        raise KeyError(f"unknown dtype {name!r}")
    return d.itemsize * 8


def quantize_tensor(w: torch.Tensor, dtype: torch.dtype = torch.int8
                    ) -> QTensor:
    """Per-output-channel (last axis) symmetric int8 or fp8: the amax
    reduces over every other axis, ``scale = amax / qmax + 1e-12``; int8
    rounds half to even and clips to +-127, fp8 clips to +-448 and rounds
    in the cast.  Both dequantize as ``q * scale``."""
    w32 = w.float()
    amax = torch.abs(w32)
    if w.dim() > 1:
        amax = torch.amax(amax, dim=tuple(range(w.dim() - 1)), keepdim=True)
    qmax = codeword_qmax(dtype)
    scale = amax / qmax + 1e-12
    scaled = w32 / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(dtype)
    return QTensor(q, scale)


def dequantize_tensor(t: QTensor, dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


# Drift band of quantize-on-update: the previous step's scale is reused
# while the new amax stays within [prev_amax / drift, prev_amax], so the
# grid only moves when the codebook really drifts.
CODEWORD_SCALE_DRIFT = 1.25

# largest representable magnitude per codeword storage dtype
_CODEWORD_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def codeword_qmax(dtype: torch.dtype) -> float:
    """amax -> grid-top mapping for a codeword storage dtype."""
    if dtype not in _CODEWORD_QMAX:
        raise ValueError(
            f"unsupported codeword storage dtype {dtype_name(dtype)!r}; want "
            f"one of {sorted(dtype_name(d) for d in _CODEWORD_QMAX)}")
    return _CODEWORD_QMAX[dtype]


def quantize_codewords(cw: torch.Tensor, prev: QTensor | None = None,
                       drift: float = CODEWORD_SCALE_DRIFT,
                       dtype: torch.dtype = torch.int8) -> QTensor:
    """Per-branch/per-channel symmetric int8 or fp8 codeword tables.

    cw [nb, k, f_blk] -> QTensor(q [nb, k, f_blk] int8 / float8_e4m3fn,
    scale [nb, 1, f_blk] f32): the amax reduces over the k codewords only,
    ``scale = amax / qmax + 1e-12``.  int8 rounds half to even and clips
    to +-127; fp8 clips to +-448 and rounds in the cast.  ``prev`` pins
    the storage dtype to its own and keeps its scale wherever the new amax
    lies in the drift band ``[prev_amax / drift, prev_amax]``, all in f32
    as the reference computes it, so the bytes agree with it."""
    if prev is not None:
        dtype = prev.q.dtype
    qmax = codeword_qmax(dtype)
    cw32 = cw.float()
    amax = torch.amax(torch.abs(cw32), dim=-2, keepdim=True)   # [nb, 1, fb]
    scale = amax / qmax + 1e-12
    if prev is not None:
        prev_amax = (prev.scale - 1e-12) * qmax
        keep = (amax <= prev_amax) & (amax >= prev_amax / drift)
        scale = torch.where(keep, prev.scale, scale)
    scaled = cw32 / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(dtype)
    return QTensor(q, scale)


# ---------------------------------------------------------------------------
# nibble-packed assignment tables (the +a4 tiers, k <= 16)
# ---------------------------------------------------------------------------

def pack_nibbles(ids: torch.Tensor) -> torch.Tensor:
    """Pack ids (< 16) along the last axis, two per byte:
    [..., m] -> [..., ceil(m / 2)] uint8; even index -> low nibble, odd
    index -> high nibble, an odd tail's last high nibble 0."""
    u = ids.to(torch.uint8)
    if u.shape[-1] % 2:
        u = torch.nn.functional.pad(u, (0, 1))
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """[..., ceil(n / 2)] uint8 -> [..., n] uint8 (each value < 16)."""
    out = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return out.reshape(*packed.shape[:-1], -1)[..., :n]


def gather_nibbles(packed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The ids' nibbles: packed [..., nbytes], ids [m] -> [..., m] uint8."""
    idx = ids.long()
    byte = packed[..., idx >> 1]
    return (byte >> ((idx & 1) * 4).to(torch.uint8)) & 0xF


def last_positions(ids: torch.Tensor, size: int) -> torch.Tensor:
    """[m]: for each entry of ``ids`` (every id in [0, size)) the position
    of its id's last entry -- the winner of a sequential scatter, found
    with an ``amax`` reduction over the entry numbers, which is
    deterministic on every device and needs no host synchronization."""
    idx = ids.long()
    order = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((size,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, idx, order, reduce="amax")
    return last[idx]


def last_occurrence(ids: torch.Tensor, size: int) -> torch.Tensor:
    """[m] mask of the entries that are the last of their id in ``ids``
    (every id in [0, size)): the winners of a sequential scatter."""
    return last_positions(ids, size) == torch.arange(ids.numel(),
                                                     device=ids.device)


def scatter_nibbles(packed: torch.Tensor, ids: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` (< 16) at node ``ids`` into a copy of a last-axis-
    packed table: packed [..., nbytes] uint8, ids [m], vals [..., m].

    The reference writes each parity in its own pass (read the byte, keep
    the sibling nibble, replace ours) and needs distinct ids.  Here the
    last entry of a repeated id wins, as in a sequential scatter, so the
    table does not depend on the order a device applies duplicate writes
    in; with distinct ids the two agree.  Each id's winner adds its nibble
    and its clear mask into per-byte sums (disjoint bits, so a sum is an
    OR): no entry is selected by a mask, so nothing waits on the host."""
    idx = ids.long()
    win = last_occurrence(idx, 2 * packed.shape[-1])
    shift = (idx & 1) * 4
    byte = idx >> 1
    nbytes = packed.shape[-1]
    dev = packed.device
    clear = torch.zeros(nbytes, dtype=torch.int32, device=dev).index_add_(
        0, byte, torch.where(win, 0xF << shift, 0).to(torch.int32))
    sets = torch.zeros(packed.shape, dtype=torch.int32, device=dev)
    sets.index_add_(-1, byte, torch.where(
        win, (vals.long() & 0xF) << shift, 0).to(torch.int32))
    return ((packed.to(torch.int32) & ~clear) | sets).to(torch.uint8)


class PackedAssignment:
    """Nibble-packed [n_branches, n] assignment table (k <= 16):
    ``packed`` [n_branches, ceil(n / 2)] uint8, two node ids per byte
    along the node axis (0.5 bytes an entry, 8x smaller than int32), and
    the node count ``n``."""

    def __init__(self, packed: torch.Tensor, n: int):
        self.packed = packed
        self.n = int(n)

    @classmethod
    def pack(cls, assignment: torch.Tensor) -> "PackedAssignment":
        return cls(pack_nibbles(assignment), assignment.shape[-1])

    @property
    def shape(self) -> tuple:
        return (*self.packed.shape[:-1], self.n)

    def unpack(self) -> torch.Tensor:
        return unpack_nibbles(self.packed, self.n)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        return gather_nibbles(self.packed, ids)

    def scatter(self, ids: torch.Tensor,
                vals: torch.Tensor) -> "PackedAssignment":
        return PackedAssignment(scatter_nibbles(self.packed, ids, vals),
                                self.n)

    def to(self, device) -> "PackedAssignment":
        return PackedAssignment(self.packed.to(device), self.n)

    def __repr__(self):
        return f"PackedAssignment(shape={self.shape}, packed={self.packed!r})"


def _is_weight(leaf) -> bool:
    """The reference's rule: a tensor of at least 2 dims, f32 or bf16."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 \
        and leaf.dtype in (torch.float32, torch.bfloat16)


def _tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, lists and tuples (named
    tuples rebuilt as their type); a ``QTensor`` is one leaf."""
    if isinstance(tree, QTensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return fn(tree)


def quantize_tree(params: Any, dtype: torch.dtype = torch.int8) -> Any:
    """``quantize_tensor`` on every weight leaf (:func:`_is_weight`) of a
    tree; other leaves, ``QTensor`` ones included, stay as they are."""
    return _tree_map(lambda w: quantize_tensor(w, dtype) if _is_weight(w)
                     else w, params)


def dequantize_tree(qparams: Any, dtype: torch.dtype = torch.bfloat16
                    ) -> Any:
    """Every ``QTensor`` leaf of a tree back to a dense ``dtype`` tensor."""
    return _tree_map(lambda t: dequantize_tensor(t, dtype)
                     if isinstance(t, QTensor) else t, qparams)


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, PackedAssignment):
        yield tree.packed
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        raise TypeError(f"tree_bytes: unsupported leaf {type(tree)}")


def tree_bytes(tree: Any) -> int:
    """Device-resident bytes of the tensors in a tree of tuples, lists,
    dicts, QTensors and PackedAssignments (a packed table counts its
    packed buffer)."""
    return sum((t.numel() * dtype_nbits(t.dtype) + 7) // 8
               for t in _leaves(tree))
