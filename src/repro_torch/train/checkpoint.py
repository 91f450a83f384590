"""Checkpointing: atomic, versioned, restart-safe (twin of
``repro.train.checkpoint``, on the same disk layout, so either package
restores the other's checkpoints).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to
``<dir>/.tmp_step_<N>`` and atomically renamed; the latest step is found
by scanning the step directories, so a crash mid-write never corrupts the
restore path; after a save the oldest steps beyond ``keep`` are removed.

The arrays are keyed by the reference's ``jax.tree_util`` path strings,
built here without jax: a NamedTuple field is ``.name``, a dict key
``['name']`` (dict keys in sorted order, as jax flattens them), a list or
tuple index ``[i]``, joined by ``/`` -- e.g. ``.params/['blocks']/
['attn']/.wq`` or ``.opt/.nu/['embed']``.  npz has no bf16, so bf16
leaves are stored as f32 and restored to the leaf's dtype (exact both
ways).

A state on a device mesh (DTensor leaves) is saved as full tensors:
every rank gathers each leaf in turn and rank 0 writes it before the
next is gathered (the others drop theirs), so a rank's host holds one
leaf at a time; the ranks meet at a barrier before ``save`` returns.
With ``async_write`` rank 0 keeps every gathered leaf on its host and
writes them in a thread, as a one-device save does.  ``restore`` reads the
full arrays on every rank and keeps each leaf's own shard, in the layout
of the ``state_like`` leaf.  The file is the one-device layout, so either
package, on a mesh or not, restores it.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import zipfile
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed.act_constraints import is_dtensor
from repro_torch.distributed.sharding import leaf_paths


_READERS = 4            # arrays a restore reads ahead, each in a thread


def _paths(tree: Any) -> list[tuple[str, Any]]:
    """(path string, leaf) in jax's flattening order, the components
    joined by "/"; None is an empty subtree, as in jax."""
    return leaf_paths(tree, "/")


def _sharded(tree: Any) -> bool:
    return any(is_dtensor(t) for _, t in _paths(tree))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if is_dtensor(t):                      # every rank gathers, in order
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:          # npz cannot store bf16
        t = t.float()                      # (on the leaf's device)
    return t.cpu().numpy()


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _host_arrays(state: Any) -> Iterator[tuple[str, np.ndarray]]:
    """(key, host array) of every leaf in order, the next leaf's copy to
    the host made in a thread while the caller writes the current one."""
    leaves = list(_paths(state))
    with ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(_to_numpy, leaves[0][1]) if leaves else None
        for i, (key, _) in enumerate(leaves):
            a = nxt.result()
            if i + 1 < len(leaves):
                nxt = pool.submit(_to_numpy, leaves[i + 1][1])
            yield key, a


def _write_npz(path: str, items: Iterable[tuple[str, np.ndarray]]) -> None:
    """``np.savez``'s file (an uncompressed zip of ``<key>.npy``), written
    an array at a time -- so a lazy ``items`` holds one array on the host
    at once -- and each array's bytes in one write (``np.savez`` copies
    them through 16 MiB chunks)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in items:
            if not a.flags.c_contiguous:
                a = a.copy(order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_2_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _read_member(zf: zipfile.ZipFile, path: str, key: str) -> np.ndarray:
    """Array ``key`` of the npz file at ``path``, an uncompressed member
    (as ``np.savez`` and ``_write_npz`` write them) read in one read
    straight from its offset, its CRC checked as ``np.load`` checks it."""
    info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{key}: compressed checkpoint member")
    with open(path, "rb") as raw:
        raw.seek(info.header_offset)
        local = raw.read(30)
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"{key}: bad local zip header")
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        raw.seek(info.header_offset + 30 + n_name + n_extra)
        data = np.empty(info.file_size, np.uint8)
        if raw.readinto(data) != info.file_size:
            raise ValueError(f"{key}: truncated zip member")
    if zlib.crc32(data) != info.CRC:
        raise ValueError(f"{key}: CRC mismatch in the checkpoint")
    f = io.BytesIO(data[:16].tobytes())
    version = np.lib.format.read_magic(f)
    if version not in ((1, 0), (2, 0)):
        raise ValueError(f"{key}: .npy format version {version}")
    n_len = 2 if version == (1, 0) else 4
    hlen = 8 + n_len + int.from_bytes(data[8:8 + n_len].tobytes(), "little")
    f = io.BytesIO(data[:hlen].tobytes())
    np.lib.format.read_magic(f)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0)(f)
    if dtype.hasobject:
        raise ValueError(f"{key}: object arrays are not read")
    count = int(np.prod(shape))
    if hlen + count * dtype.itemsize != len(data):
        raise ValueError(f"{key}: array data of the wrong size")
    a = np.frombuffer(data, dtype=dtype, count=count, offset=hlen)
    return a.reshape(shape[::-1]).T if fortran else a.reshape(shape)


def _unflatten(tree_like: Any, read, prefix: tuple = ()) -> Any:
    """``tree_like``'s structure with each leaf ``read(key)`` in that
    leaf's dtype and on its device.  Only the leaves' shape, dtype and
    device are used, so an expanded 0-d tensor stands in for a leaf at no
    cost."""
    if tree_like is None:
        return None
    if isinstance(tree_like, torch.Tensor):
        key = "/".join(prefix)
        a = read(key)
        if tuple(a.shape) != tuple(tree_like.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape}, state "
                             f"shape {tuple(tree_like.shape)}")
        t = torch.from_numpy(a).to(device=tree_like.device,
                                   dtype=tree_like.dtype)
        if is_dtensor(tree_like):          # this rank's shard of it
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, tree_like.device_mesh,
                                  tree_like.placements, src_data_rank=None)
        return t
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*(
            _unflatten(getattr(tree_like, f), read, prefix + (f".{f}",))
            for f in tree_like._fields))
    if isinstance(tree_like, dict):          # read in _paths' order
        vals = {k: _unflatten(tree_like[k], read, prefix + (f"[{k!r}]",))
                for k in sorted(tree_like)}
        return {k: vals[k] for k in tree_like}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, read, prefix + (f"[{i}]",))
            for i, v in enumerate(tree_like))
    raise TypeError(f"checkpoint: unsupported node {type(tree_like)}")


def save(ckpt_dir: str, step: int, state: Any,
         manifest_extra: Optional[dict] = None, *,
         keep: int = 3, async_write: bool = False
         ) -> threading.Thread | None:
    """Write checkpoint ``step``.  With ``async_write=True`` every leaf is
    copied to the host here and the disk write runs in a thread (returned)
    so it overlaps the next training steps; otherwise the leaves are
    copied and written one at a time (the host holds two leaves).  A
    state with DTensor leaves is gathered leaf by leaf on every rank and
    written by rank 0 (module docstring); a thread is returned on rank 0
    only."""
    sharded = _sharded(state)
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            # this rank's part of each leaf's gather, in rank 0's order;
            # the whole leaf is dropped
            for _, t in _paths(state):
                if is_dtensor(t):
                    t.detach().full_tensor()
            if not async_write:
                dist.barrier()
            return None
        gathered = ((k, _to_numpy(t)) for k, t in _paths(state))
        items = list(gathered) if async_write else gathered
    else:
        items = _flatten(state).items() if async_write \
            else _host_arrays(state)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        _write_npz(os.path.join(tmp, "arrays.npz"), items)
        manifest = {"step": step, **(manifest_extra or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic publish
        _gc(ckpt_dir, keep)

    if sharded and not async_write:
        _write()
        dist.barrier()
        return None
    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json"))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_like: Any,
            step: Optional[int] = None) -> tuple[Any, dict]:
    """Restore into the structure of ``state_like``: every leaf's shape
    must match, and each takes the dtype and device of its leaf there.
    Returns (state, manifest)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    npz = os.path.join(d, "arrays.npz")
    keys = [key for key, _ in _paths(state_like)]
    with zipfile.ZipFile(npz) as zf, \
            ThreadPoolExecutor(_READERS) as pool:
        names = set(zf.namelist())
        missing = [k for k in keys if k + ".npy" not in names]
        if missing:
            raise KeyError(f"checkpoint has no array {missing[0]!r}")
        # _READERS arrays read ahead (each read and its CRC release the
        # GIL) while the leaf before them is converted and moved
        pending = iter(keys)
        ahead = deque(pool.submit(_read_member, zf, npz, k)
                      for k in islice(pending, _READERS))

        def read(key: str) -> np.ndarray:
            a = ahead.popleft().result()
            nxt = next(pending, None)
            if nxt is not None:
                ahead.append(pool.submit(_read_member, zf, npz, nxt))
            return a
        return _unflatten(state_like, read), manifest
