"""Measure-and-cache tuner of the card kernels' dispatch knobs.

Torch twin of ``repro.kernels.autotune``, opt-in (``REPRO_AUTOTUNE=1``):

  * each (kind, shape bucket, dtype, card, kernel build) key is timed ONCE
    on the card: candidates race on a synthetic problem built on the
    device, with CUDA events -- one warm-up, then the best of ``_REPS``
    runs;
  * winners persist to a JSON cache (``REPRO_AUTOTUNE_CACHE``, default
    ``~/.cache/repro_torch/autotune.json``) keyed on next-power-of-two
    shape buckets, each entry with every candidate's time under ``"ms"``;
  * the key names the card (``torch.cuda.get_device_name``) and the hash
    of the kernels' sources and flags (``_build.source_hash``) where the
    reference names its backend, so an entry measured on another card or
    against another build of the kernels never serves this one;
  * the environment stays authoritative: ``ops.py`` asks the tuner only
    when no variant is forced and no budget is configured (precedence:
    programmatic override > environment > tuner > default budget).

The problems are sized so that the source sets the time, not the launch:
16,384 rows of 16 slots over a source of the bucket's size (the
reference's 256 rows over at most 8,192 source rows would time launch
overhead on the card, not the L2 crossover the dispatch turns on).
Measurements call the kernel wrappers directly, never ``ops.py``'s
dispatchers, which consult this module; the context loop's candidate is
``ops._context_ell_loop``, which calls the SpMM kernel without a
dispatch.  A candidate is left out only by its
wrapper's own checks before launch (``spmm_ell_hbm.tiles_error``,
``vq_update.tiles_error``); a failed launch fails the tuning.

Only CUDA tensors reach the tuner: ``ops.py`` sends a CPU tensor to its
plain version before any dispatch decision.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Any, Optional

import torch

from repro_torch import hostenv
from repro_torch.distributed.quantization import dtype_name

_ROWS = 16384         # rows of a measured SpMM / context problem
_DEG = 16             # slots a row
_F_BLK = 4            # a context problem's branch width (GCN's feature half)
_REPS = 5             # best-of runs after one warm-up
_SPMM_BB = (32, 64, 128)
_SPMM_STRIPES = (256, 512, 1024)

# in-memory cache: key -> config dict; None until the file is first read
_cache: Optional[dict[str, Any]] = None
# keys measured in this process (a cache hit measures nothing)
measured: list[str] = []


def enabled() -> bool:
    """Tuning is opt-in: ``REPRO_AUTOTUNE=1``."""
    return hostenv.env_knob("REPRO_AUTOTUNE", "0") == "1"


def cache_path() -> str:
    return hostenv.env_knob(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def shape_bucket(v: int) -> int:
    """Next power of two (0 -> 0): the shape-key granularity."""
    v = int(v)
    return 0 if v <= 0 else 1 << (v - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _kernels_hash() -> str:
    from repro_torch.kernels import _build
    return _build.source_hash()


def device_name() -> str:
    """The current card's name ("cpu" where there is none)."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device())


def cache_key(kind: str, shape: tuple, dtype,
              device: Optional[str] = None) -> str:
    """``kind|buckets|dtype|card|kernels hash``; ``dtype`` a torch dtype or
    its name (``"uint4"`` for a packed table)."""
    buckets = "x".join(str(shape_bucket(s)) for s in shape)
    return (f"{kind}|{buckets}|{dtype_name(dtype)}|"
            f"{device or device_name()}|{_kernels_hash()}")


def _load() -> dict[str, Any]:
    global _cache
    if _cache is None:
        try:
            with open(cache_path()) as fh:
                loaded = json.load(fh)
            _cache = dict(loaded) if isinstance(loaded, dict) else {}
        except (OSError, ValueError):
            _cache = {}
    return _cache


def lookup(key: str) -> Optional[dict[str, Any]]:
    hit = _load().get(key)
    return dict(hit) if isinstance(hit, dict) else None


def record(key: str, cfg: dict[str, Any]) -> None:
    cache = _load()
    cache[key] = dict(cfg)
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(cache, fh, indent=1, sort_keys=True)
    except OSError:
        pass  # the cache stays in memory for this process


def clear(*, memory_only: bool = False) -> None:
    """Drop the in-memory cache (tests); optionally keep the file."""
    global _cache
    _cache = None
    if not memory_only:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def _time(fn) -> float:
    """Best device ms of ``fn`` over ``_REPS`` runs after one warm-up,
    CUDA events around each run."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def _race(key: str, candidates: dict[str, Any]
          ) -> tuple[str, dict[str, float]]:
    """Time every candidate: (the winner's name, each one's ms)."""
    ms = {name: _time(fn) for name, fn in candidates.items()}
    measured.append(key)
    return min(ms, key=ms.get), ms


def _generator() -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(0)


def _source(n: int, f: int, dtype: torch.dtype, gen: torch.Generator):
    """A random [n, f] source in ``dtype`` and its [1, f] scale (None for
    f32)."""
    x = torch.randn((n, f), generator=gen, device="cuda")
    if dtype == torch.float32:
        return x, None
    if dtype == torch.int8:
        q = torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8)
    else:
        q = x.to(dtype)
    return q, torch.ones((1, f), device="cuda")


# ---------------------------------------------------------------------------
# per-kernel tuners (ops.py consumers)
# ---------------------------------------------------------------------------

def tuned_spmm(n_src: int, f: int, itemsize: int = 4, dtype=None, *,
               measure: bool = True) -> Optional[dict[str, Any]]:
    """{'variant': 'resident'|'hbm', 'bb': int, 'stripe': int, 'ms': ...}
    for an [n_src, f] source of ``itemsize``-byte elements, or None when
    tuning is off.  The candidates: the resident kernel, and the staged one
    at every row tile ``bb`` <= ``spmm_ell_hbm.MAX_BB`` and stripe in
    {256, 512, 1024} that its shared memory takes; a resident winner
    carries the default tiles.  ``dtype`` (the source's storage dtype)
    keys the entry: int8 and fp8 share an itemsize but not a winner.  A
    caller's precomputed ``StripeIndex`` still pins the staged tiles.
    With ``measure=False`` a missing entry is None, not a race."""
    if not enabled():
        return None
    from repro_torch.kernels import spmm_ell_hbm as hbm
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    if dtype is None:
        dtype = torch.int8 if itemsize == 1 else torch.float32
    key = cache_key("spmm", (n_src, f, itemsize), dtype)
    hit = lookup(key)
    if hit is not None or not measure:
        return hit
    gen = _generator()
    ns = shape_bucket(n_src)
    idx = torch.randint(0, ns, (_ROWS, _DEG), generator=gen, device="cuda",
                        dtype=torch.int32)
    val = torch.rand((_ROWS, _DEG), generator=gen, device="cuda")
    x, scale = _source(ns, f, dtype, gen)
    candidates = {"resident": lambda: spmm_ell_cuda(idx, val, x, scale)}
    for bb in _SPMM_BB:
        for stripe in _SPMM_STRIPES:
            t_bb, t_st = hbm.clamp_tiles(_ROWS, ns, bb, stripe)
            if hbm.tiles_error(t_bb, t_st, _DEG, ns, False) is None:
                candidates[f"hbm {bb} {stripe}"] = (
                    lambda bb=bb, st=stripe: hbm.spmm_ell_hbm_cuda(
                        idx, val, x, None, scale, bb=bb, stripe=st))
    win, ms = _race(key, candidates)
    if win == "resident":
        bb, stripe = hbm.DEFAULT_BB, hbm.DEFAULT_STRIPE
    else:
        bb, stripe = map(int, win.split()[1:])
    cfg = {"variant": win.split()[0], "bb": bb, "stripe": stripe, "ms": ms}
    record(key, cfg)
    return cfg


def tuned_context(n_nodes: int, n_branches: int, itemsize: float = 4,
                  dtype=None, *, measure: bool = True
                  ) -> Optional[dict[str, Any]]:
    """{'variant': 'fused'|'loop', 'ms': ...} for an [n_branches, n_nodes]
    assignment table, or None when tuning is off.  ``dtype`` keys the
    entry by the table's storage (``"uint4"`` for a packed table,
    ``itemsize`` 0.5).  The loop candidate is ``ops._context_ell_loop``
    itself, which calls the SpMM kernel without a dispatch; both race on
    the packed table, as the dispatch would run each.  With
    ``measure=False`` a missing entry is None, not a race."""
    if not enabled():
        return None
    from repro_torch.distributed.quantization import PackedAssignment
    from repro_torch.kernels.context_ell import context_ell_cuda
    from repro_torch.kernels.ops import _context_ell_loop
    if dtype is None:
        dtype = ("uint4" if itemsize == 0.5
                 else torch.uint8 if itemsize == 1 else torch.int32)
    name = dtype_name(dtype)
    key = cache_key("context", (n_nodes, n_branches), name)
    hit = lookup(key)
    if hit is not None or not measure:
        return hit
    gen = _generator()
    n, nb = shape_bucket(n_nodes), int(n_branches)
    k = {"uint4": 16, "uint8": 256}.get(name, 1024)
    ids = torch.randint(0, n, (_ROWS, _DEG), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.rand((_ROWS, _DEG), generator=gen, device="cuda")
    table = torch.randint(0, k, (nb, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    table = table if name == "int32" else table.to(torch.uint8)
    if name == "uint4":
        table = PackedAssignment.pack(table)
    cw = torch.randn((nb, k, _F_BLK), generator=gen, device="cuda")
    win, ms = _race(key, {
        "fused": lambda: context_ell_cuda(ids, vals, table, cw),
        "loop": lambda: _context_ell_loop(ids, vals, table, cw, None)})
    cfg = {"variant": win, "ms": ms}
    record(key, cfg)
    return cfg


def tuned_vq_update(b: int, k: int, f: int, nb: int = 1,
                    emit_dtype=torch.int32) -> Optional[dict[str, Any]]:
    """{'wgs': 1|2, 'ms': ...}: the wide build's row tile (64 or 128 rows
    a block) for [nb, b, f] rows against [nb, k, f] codewords, emitting
    ``emit_dtype`` (a uint8 or ``"uint4"`` emit races the uint8 entries),
    or None when tuning is off or the shape takes the narrow build, which
    has no knob."""
    if not enabled():
        return None
    from repro_torch.kernels import vq_update as vqu
    if not vqu.uses_wide(k, f):
        return None
    emit = "int32" if vqu.check_emit(emit_dtype, k) == "int32" else "uint8"
    # f keys the entry exactly: the wide build's shared-memory plan, and
    # with it the tiles' speed, changes with it
    key = cache_key(f"vq_update f={f}", (nb, b, k), emit)
    hit = lookup(key)
    if hit is not None:
        return hit
    gen = _generator()
    x = torch.randn((nb, shape_bucket(b), f), generator=gen, device="cuda")
    cw = torch.randn((nb, k, f), generator=gen, device="cuda")
    win, ms = _race(key, {
        str(wgs): (lambda wgs=wgs: vqu.vq_assign_update_wide_tiles_cuda(
            x, cw, wgs, emit)) for wgs in (1, 2)
        if vqu.tiles_error(f, wgs) is None})
    cfg = {"wgs": int(win), "ms": ms}
    record(key, cfg)
    return cfg
