"""Checked wrapper of the fused VQ assign + cluster-statistics CUDA kernel
(``csrc/vq_update.cuh``, entries in ``vq_update.cu`` and ``vq_update_u8.cu``).

Counterpart of ``repro.kernels.vq_update.vq_assign_update_pallas`` as
``core/codebook.py:update`` uses it: vmapped over the product-VQ branches,
which here is one launch for all branches.  The assignment is emitted as
int32, or narrow: uint8 (k <= 256) written by the kernel itself, and
uint4 (k <= 16), which the kernel writes through the same uint8 output --
the port's uint4 is a uint8 tensor of values < 16, so the wrapper's
narrowing is that k check.  ``launches`` counts the counted launches of
this process, ``launches_u8`` those with a narrow emit.

The kernel scans the distances on the tensor cores (TF32 split hi + lo),
rescores the winning group of codewords exactly (u, an exact distance),
and then every codeword whose approximate distance is at most
``u + candidate_bound(|x|, min(c_max, norm_cap(|x|, u)))``, so the
assignment and qerr are the plain version's bit for bit;
:func:`candidate_bound` and :func:`norm_cap` are the kernel's bounds, kept
here for the CPU emulation that tests them (``tests/test_torch_vq_scan.py``).

Two builds of the scan.  The narrow one holds a row in registers and the
branch's whole codebook in shared memory (f <= 32, k (f + 1) * 4 bytes);
the wide one (:func:`uses_wide`: f > 32, or a codebook too large for that)
streams tiles of 128 codewords, split into TF32 parts once per call by a
prologue into the wrapper's scratch (:func:`wide_scratch_floats`,
:func:`wide_split_layout`), past tiles of 64 or 128 rows on Hopper's
warpgroup products, and takes any f up to ``WIDE_MAX_F`` and any k.  Its
bound E adds the plain version's rounding at that width
(``candidate_bound(wide=True)``).  ``launches_wide`` counts the counted
launches that took the wide build, ``launches_wide_by_shape`` the same
launches by operand shape, ``(nb, n, k, f, emit)``; ``last_wide_scratch``
holds the last wide launch's scratch, whose first word counts the rows that
launch queued for its second pass (:func:`wide_queued_rows`, read after a
synchronize; no path of the package reads it).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.quantization import dtype_name
from repro_torch.kernels import _build

launches = 0
launches_u8 = 0
launches_wide = 0
launches_wide_by_shape: dict[tuple, int] = {}
last_wide_scratch: torch.Tensor | None = None

# narrow emit dtypes and the largest k each can index (int32: any k);
# signed int4 would wrap ids 8..15, so it is absent, as in the reference
EMIT_K_LIMITS = {"uint8": 256, "uint4": 16}


def check_emit(emit_dtype, k: int) -> str:
    """The emit dtype's name, after the reference's checks: an emit dtype
    that is not int32, uint8 or uint4, or a k it cannot index, raises."""
    emit = dtype_name(emit_dtype)
    limit = EMIT_K_LIMITS.get(emit)
    if emit != "int32" and limit is None:
        raise ValueError(
            f"emit_dtype={emit!r} is not a supported assignment storage "
            f"dtype; want int32 or one of {sorted(EMIT_K_LIMITS)}")
    if limit is not None and k > limit:
        raise ValueError(
            f"emit_dtype={emit!r} supports k <= {limit}, got k={k}; use "
            f"emit_dtype=int32 (always valid)"
            + (" or uint8 (k <= 256)" if emit == "uint4" else ""))
    return emit

MAX_F = 32                    # widest branch the narrow build holds
# the narrow build stages a branch's [k, f] codewords and their [k] squared
# norms in a block's shared memory, k (f + 1) * 4 bytes (k <= 2,641 at
# f 21), and its warps' rows where they fit beside
SMEM_LIMIT = _build.SMEM_LIMIT
# the wide build (csrc/vq_update.cuh: kWideMaxF, kWideBN, the ring's
# stages and K chunk): the widest branch, codewords a tile, stages
WIDE_MAX_F = 440
WIDE_BN = 128
WIDE_MIN_STAGES = 3
WIDE_MAX_STAGES = 6
WIDE_MAX_KC = 64
# the phases tools/wide_scan_phases.py stamps (the kernel's WIDE_PH buckets)
WIDE_PHASES = ("setup", "stage rows", "wait for codewords", "wgmma",
               "fold + merge", "exact u + threshold", "finish", "drain")
# the scan's bound: allowance per tensor-core accumulation, relative to the
# magnitudes it adds, and the floor for products a tensor core may flush
TC_EPS = 2.0 ** -20
TINY = 2.0 ** -118
# the margins of norm_cap's fp32 evaluation in the kernel
NORM_UP = 1.0 + 2.0 ** -14
DISC_SLACK = 2.0 ** -16


# the wide build's margins of norm_cap (kWideUp): the plain version's
# rounding rho = (2f + 3) 2^-24 reaches 2^-14.2 at WIDE_MAX_F
WIDE_UP = 1.0 + 2.0 ** -12


# units of 2^-20 (|c|^2 + 4 |x| |c|) the wide build's E adds to the tensor
# cores' allowance: its wgmma accumulation was probed at up to 1.08 of one
# unit in all (csrc/vq_update.cuh, PERF.md), past the narrow build's 0.6
WIDE_TC_EXTRA = 3


def candidate_bound(x_norm, c_max, f: int, wide: bool = False):
    """E(x) of ``csrc/vq_update.cuh``: an upper bound on |d~ - d| for every
    codeword of a branch, d the plain version's fp32 distance, d~ the
    tensor cores' (3 * ceil(f / 8) mma accumulations in both builds;
    ``vq_assign``'s f 4 scan takes two), for rows of norm ``x_norm`` against
    codewords of norm at most ``c_max``.  The narrow build's allowance of 6
    covers the split and the plain version's own rounding up to f 32; the
    wide build adds ceil((2f + 3) / 16) for that rounding at any f and
    ``WIDE_TC_EXTRA`` for its wgmma accumulation."""
    n_mma = 3 * -(-f // 8)
    coef = n_mma + 6 + (WIDE_TC_EXTRA + -(-(2 * f + 3) // 16) if wide
                        else 0)
    return coef * TC_EPS * (c_max * c_max + 4 * x_norm * c_max) \
        + TINY * (1 + x_norm + c_max)


def norm_cap(x_norm: torch.Tensor, u: torch.Tensor,
             wide: bool = False) -> torch.Tensor:
    """r of ``csrc/vq_update.cuh``: no codeword of norm above it has a plain
    fp32 distance of at most ``u`` to a row of norm ``x_norm``, with the
    kernel's margins (the wide build's wider ones with ``wide``)."""
    up, slack = (WIDE_UP, WIDE_UP - 1.0) if wide else (NORM_UP, DISC_SLACK)
    b = x_norm * up
    bb = b * b
    return (b + torch.sqrt(torch.clamp(bb + u, min=0.0)
                           + slack * (bb + u.abs()))) * up


def wide_fp(f: int) -> int:
    """f padded to the 8-deep k-steps of the products."""
    return -(-f // 8) * 8


def wide_kpad(k: int) -> int:
    """k padded to whole 128-codeword tiles."""
    return -(-k // WIDE_BN) * WIDE_BN


def wide_scratch_floats(nb: int, k: int, f: int) -> int:
    """fp32 scratch of a wide launch (``wide_scratch_floats``): the
    queued-row counter (4 floats), |c|^2 [nb, k_pad] and the codewords'
    TF32 hi / lo parts [nb, k_pad, 2 f_pad]."""
    return 4 + nb * wide_kpad(k) * (1 + 2 * wide_fp(f))


def wide_split_layout(codewords: torch.Tensor) -> torch.Tensor:
    """The scratch the wide build's prologue writes after its counter, in
    plain torch: per branch |c|^2 in the plain version's order (+inf past
    k), then per 128-codeword tile the hi parts and the lo parts of the
    codewords (TF32: the low 13 mantissa bits cleared; zeros past k and f),
    each in 4-column slabs of 16 core matrices of 8 codewords x 4 columns
    (``wide_split_off``).  -> [nb * k_pad * (1 + 2 f_pad)] fp32."""
    nb, k, f = codewords.shape
    fp, kp = wide_fp(f), wide_kpad(k)
    c = torch.zeros((nb, kp, fp), dtype=torch.float32,
                    device=codewords.device)
    c[:, :k, :f] = codewords
    acc = torch.zeros((nb, kp), dtype=torch.float32, device=c.device)
    for j in range(f):
        acc = acc + c[..., j] * c[..., j]
    acc[:, k:] = float("inf")
    hi = (c.view(torch.int32) & -8192).view(torch.float32)
    lo = ((c - hi).view(torch.int32) & -8192).view(torch.float32)

    def tiled(v):
        # [nb, tiles, 16 groups of 8, 8, fp / 4 slabs, 4] -> slab-major
        v = v.reshape(nb, kp // WIDE_BN, WIDE_BN // 8, 8, fp // 4, 4)
        return v.permute(0, 1, 4, 2, 3, 5).reshape(nb, kp // WIDE_BN, -1)
    parts = torch.stack([tiled(hi), tiled(lo)], dim=2)
    return torch.cat([acc.reshape(-1), parts.reshape(-1)])


def wide_misc_bytes(bm: int) -> int:
    """A wide block's bookkeeping (``sizeof(WideMisc<bm>)``): eleven [bm]
    arrays, the queue of 2 bm rows and thresholds, 2 x 6 mbarriers, 10
    floats of a reduction and 4 words."""
    return 60 * bm + 96 + 40 + 16


def wide_smem_bytes(f: int, wgs: int, ares: bool, kc: int,
                    stages: int) -> int:
    """Shared memory of a wide block (``wide_plan``): the bookkeeping
    (rounded up to 128 bytes), the rows' operand -- -2x split hi / lo
    (``ares``), or the fp32 rows at a stride of f_pad + 4 and a hi / lo
    buffer of one K chunk -- and ``stages`` ring stages of a K chunk of 128
    codewords' hi and lo parts and their |c|^2."""
    bm = 64 * wgs
    misc = -(-wide_misc_bytes(bm) // 128) * 128
    rows = bm * wide_fp(f) * 8 if ares \
        else bm * (wide_fp(f) + 4) * 4 + bm * kc * 8
    return misc + rows + stages * WIDE_BN * (2 * kc + 1) * 4


def wide_plan(f: int, wgs: int, limit: int = None) -> tuple | None:
    """The wide launch's plan (``wide_plan``): (ares, kc, stages, smem) --
    the rows split once where that fits beside a ring of
    ``WIDE_MIN_STAGES``, else a chunk at a time; the widest K chunk (a
    multiple of 8 up to ``WIDE_MAX_KC``) that fits; as many stages as fit
    up to ``WIDE_MAX_STAGES`` -- or None where none fits."""
    limit = SMEM_LIMIT if limit is None else limit
    fp = wide_fp(f)
    for ares in (True, False):
        for kc in range(min(fp, WIDE_MAX_KC), 7, -8):
            fixed = wide_smem_bytes(f, wgs, ares, kc, 0)
            if fixed >= limit:
                continue
            stages = min(WIDE_MAX_STAGES,
                         (limit - fixed) // (WIDE_BN * (2 * kc + 1) * 4))
            if stages >= WIDE_MIN_STAGES:
                return ares, kc, stages, wide_smem_bytes(f, wgs, ares, kc,
                                                         stages)
    return None


def wide_queued_rows() -> int:
    """Rows the last wide launch queued for its second pass (its scratch
    counter).  Synchronizes with the card: for tests and measurements, not
    for a model path."""
    if last_wide_scratch is None:
        raise RuntimeError("no wide launch yet")
    return int(last_wide_scratch[:1].view(torch.int32).item())


def queued_rows_est(x: torch.Tensor, cw: torch.Tensor) -> int:
    """Rows the wide build would queue with its rule applied to the plain
    distances (float64): a row settles when its runner-up lies above
    u + E(|x|, min(cmax, r(u))), u its smallest distance.  Where d~ = d
    (operands whose TF32 parts and sums are exact) it is the kernel's
    count; elsewhere an estimate, as d~ differs from d by up to E."""
    nb, b, f = x.shape
    c = cw.double()
    cn2 = (c * c).sum(-1)
    cmax = cn2.max(dim=1).values.sqrt()
    queued = 0
    for s in range(0, b, 4096):
        xs = x[:, s:s + 4096].double()
        d = cn2[:, None, :] - 2 * torch.einsum("bnf,bkf->bnk", xs, c)
        top = torch.topk(d, min(2, d.shape[2]), dim=2, largest=False).values
        u = top[..., 0]
        xn = xs.norm(dim=2)
        cm = torch.minimum(cmax[:, None], norm_cap(xn, u, wide=True))
        thr = u + candidate_bound(xn, cm, f, wide=True)
        if top.shape[2] > 1:
            queued += int((~(top[..., 1] > thr)).sum())
    return queued


def smem_bytes(k: int, f: int) -> int:
    """Shared memory the narrow build stages for one branch: its [k, f]
    codewords and their [k] squared norms."""
    return 4 * k * (f + 1)


def uses_wide(k: int, f: int, smem=smem_bytes) -> bool:
    """Whether the scan at (k, f) takes the wide build: a branch wider than
    the narrow build's registers, or a codebook beyond its shared memory,
    ``smem(k, f)`` bytes for the kernel at hand (``vq_assign`` stages
    more at f 4)."""
    return f > MAX_F or smem(k, f) > SMEM_LIMIT


def check_width(kernel: str, k: int, f: int) -> None:
    """Raise for a shape that neither build takes."""
    if not 1 <= f <= WIDE_MAX_F or k < 1:
        raise ValueError(f"{kernel}: branch width f={f} (k={k}) outside the "
                         f"kernel's 1..{WIDE_MAX_F} (k >= 1)")


def vq_assign_update_cuda(x: torch.Tensor, codewords: torch.Tensor,
                          emit_dtype=torch.int32, wgs: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """x [nb, n, f] and codewords [nb, k, f], contiguous f32 CUDA tensors
    -> (assignment [nb, n] int32 -- uint8 for ``emit_dtype`` uint8 or
    ``"uint4"`` --, qerr [nb, n], counts [nb, k], sums [nb, k, f]).  The
    assignment and qerr are the plain version's bit for bit.  The
    statistics are added with atomics into buffers zeroed here: counts are
    exact, sums depend on the order of the adds.  ``wgs`` (1 or 2, the
    wide build only) sets the wide build's row tile, 64 ``wgs`` rows a
    block; None leaves the launch its own choice."""
    narrow = check_emit(emit_dtype, codewords.shape[1]) != "int32"
    wide = uses_wide(codewords.shape[1], codewords.shape[-1])
    if wgs is not None and not wide:
        raise ValueError("vq_update: wgs sets the wide build's row tile; "
                         "the narrow build has none")
    tiles = "_tiles" if wgs is not None else ""
    return _run(f"repro_vq_update{'_wide' if wide else ''}{tiles}"
                f"{'_u8' if narrow else ''}_f32", x, codewords, count=True,
                tiles=() if wgs is None else (wgs,))


def vq_assign_update_generic_cuda(x: torch.Tensor, codewords: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """The same function through the narrow build's generic-width
    instantiation, whatever f <= 32 is: for timing it against the
    fixed-width builds.  No path of the package calls it, and ``launches``
    does not count it."""
    return _run("repro_vq_update_generic_f32", x, codewords, count=False)


def wide_scratch(nb: int, k: int, f: int, dev) -> torch.Tensor:
    """A wide launch's scratch (uninitialized: its prologue fills it), kept
    as ``last_wide_scratch`` for :func:`wide_queued_rows`."""
    global last_wide_scratch
    last_wide_scratch = torch.empty(wide_scratch_floats(nb, k, f),
                                    dtype=torch.float32, device=dev)
    return last_wide_scratch


def vq_assign_update_wide_tiles_cuda(x: torch.Tensor, codewords: torch.Tensor,
                                     wgs: int, emit_dtype=torch.int32):
    """The wide build with its row tile set: ``wgs`` warpgroups of 64 rows
    a block (1 or 2; the launch's own choice is 2 unless that leaves SMs
    idle), emitting ``emit_dtype``, for timing the two tilings (the
    tuner's race).  The counters do not count it."""
    narrow = check_emit(emit_dtype, codewords.shape[1]) != "int32"
    return _run(f"repro_vq_update_wide_tiles{'_u8' if narrow else ''}_f32",
                x, codewords, count=False, tiles=(wgs,))


def tiles_error(f: int, wgs: int) -> str | None:
    """Why the wide build would refuse ``wgs`` warpgroups of 64 rows at
    width f, or None: the wrapper's own check before launch, which the
    tuner applies to its candidates."""
    if wgs not in (1, 2):
        return f"wgs={wgs}, want 1 or 2"
    if wide_plan(f, wgs) is None:
        return (f"no shared-memory plan for {64 * wgs}-row tiles at "
                f"f={f}")
    return None


def _run(entry: str, x: torch.Tensor, codewords: torch.Tensor, count: bool,
         tiles: tuple = ()):
    global launches, launches_u8, launches_wide
    _build.check_operands("vq_update", {"x": torch.float32,
                                        "codewords": torch.float32},
                          x=x, codewords=codewords)
    if x.dim() != 3 or codewords.dim() != 3 \
            or x.shape[0] != codewords.shape[0] \
            or x.shape[2] != codewords.shape[2]:
        raise ValueError(f"vq_update: want x [nb, n, f] and codewords "
                         f"[nb, k, f]; got {tuple(x.shape)}, "
                         f"{tuple(codewords.shape)}")
    nb, n, f = x.shape
    k = codewords.shape[1]
    wide = "_wide" in entry
    if wide:
        check_width("vq_update", k, f)
    elif not 1 <= f <= MAX_F or k < 1 or uses_wide(k, f):
        raise ValueError(f"vq_update: the narrow build takes f <= {MAX_F} "
                         f"and a codebook in one block's shared memory "
                         f"({SMEM_LIMIT} B); got k={k}, f={f}")
    if tiles:
        err = tiles_error(f, tiles[0])
        if err is not None:
            raise ValueError(f"vq_update: {err}")
    dev = x.device
    narrow = "_u8" in entry
    idx = torch.empty((nb, n), dtype=torch.uint8 if narrow else torch.int32,
                      device=dev)
    qerr = torch.empty((nb, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((nb, k), dtype=torch.float32, device=dev)
    sums = torch.zeros((nb, k, f), dtype=torch.float32, device=dev)
    if nb == 0 or n == 0:
        return idx, qerr, counts, sums
    # the wide build's scratch, filled by its prologue
    scratch = wide_scratch(nb, k, f, dev) if wide else None
    err = getattr(_build.library(), entry)(
        x.data_ptr(), codewords.data_ptr(),
        *(() if scratch is None else (scratch.data_ptr(),)), idx.data_ptr(),
        qerr.data_ptr(), counts.data_ptr(), sums.data_ptr(), nb, n, k, f,
        *tiles, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vq_update")
    launches += count
    launches_u8 += count and narrow
    launches_wide += count and wide
    if count and wide:
        key = (nb, n, k, f, "uint8" if narrow else "int32")
        launches_wide_by_shape[key] = launches_wide_by_shape.get(key, 0) + 1
    return idx, qerr, counts, sums
