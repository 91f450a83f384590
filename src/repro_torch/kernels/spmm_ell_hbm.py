"""The staged-stripe ELLPACK SpMM (``csrc/spmm_ell_hbm.cu``): its stripe
index and its checked wrapper.

Counterpart of ``repro.kernels.spmm_ell_hbm``: the SpMM of ``spmm_ell``
for a source ``x`` too large to stay on chip, each row's slots summed in
(stripe, slot) order.  The TPU kernel stages, for each tile of ``bb``
output rows, the ``stripe``-row stripes of ``x`` that the tile touches
into VMEM; on the card every warp gathers its rows' source rows straight
from device memory through the L2, and the stripe is only the sort key of
a row's slots and the unit of the index.  Which stripes a tile lists is a
:class:`StripeIndex`: built on the host at pack time
(``repro_torch.graph.batching.make_stripe_index``) or on the call's device
by :func:`stripe_index_torch` (the twin of the reference's in-jit
``stripe_index_jnp``), at the reference's tiles by default (128 rows,
512-row stripes).  A call without an index needs none: the stripes an
index built from its own ids lists are every stripe a live slot touches,
so the kernel sorts by stripe and drops nothing, as the reference's
in-jit index would have it.

``launches`` counts every launch in this process, ``launches_q`` the
int8 / fp8 ones among them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
launches_q = 0

SMEM_LIMIT = _build.SMEM_LIMIT
DEFAULT_BB = 128              # the reference's row tile ...
DEFAULT_STRIPE = 512          # ... and stripe (repro/graph/batching.py)
MAX_BB = 128                  # rows a block's 8 warps take in turn
MAX_F = 256                   # 8 columns a lane

_ENTRY = {torch.float32: "repro_spmm_ell_hbm_f32",
          torch.int8: "repro_spmm_ell_hbm_q_i8",
          torch.float8_e4m3fn: "repro_spmm_ell_hbm_q_f8"}


class StripeIndex:
    """Per-row-tile stripe index of the staged SpMM.

    ``ids[t, :counts[t]]`` are the ascending ids of the stripes row tile
    ``t`` touches; the entries past the count are the untouched stripes,
    ascending.  ``bb`` / ``stripe`` / ``n_src`` pin the tiling the index
    was built for.  The contents are trusted: an index built from other
    neighbour ids than the call's drops the messages of unlisted
    stripes."""

    def __init__(self, ids: torch.Tensor, counts: torch.Tensor, *,
                 bb: int, stripe: int, n_src: int):
        self.ids = ids            # [num_tiles, max_stripes] int32
        self.counts = counts      # [num_tiles] int32
        self.bb = int(bb)
        self.stripe = int(stripe)
        self.n_src = int(n_src)

    def __repr__(self):
        return (f"StripeIndex(tiles={self.ids.shape[0]}, "
                f"max_stripes={self.ids.shape[1]}, bb={self.bb}, "
                f"stripe={self.stripe}, n_src={self.n_src})")


def _rup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def clamp_tiles(b: int, n_src: int, bb: int, stripe: int) -> tuple[int, int]:
    """Shared tile clamping so host-built indices match the kernel grid."""
    return min(bb, max(8, b)), min(stripe, _rup(n_src, 8))


def stripe_index_torch(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                       n_src: int, *, bb: int = DEFAULT_BB,
                       stripe: int = DEFAULT_STRIPE) -> StripeIndex:
    """The stripe index on the call's device (twin of the reference's
    ``stripe_index_jnp``).  Slots with ``val == 0`` (padding) touch no
    stripe: they are parked in an overflow column that is cut away.
    Neighbour ids are clamped into ``[0, n_src)``, as the kernel clamps
    them.  The ids width is min(n_stripes, bb * deg)."""
    b, deg = nbr_idx.shape
    bb, stripe = clamp_tiles(b, n_src, bb, stripe)
    bp = _rup(b, bb)
    nt = bp // bb
    n_stripes = _rup(n_src, stripe) // stripe
    dev = nbr_idx.device
    sid = torch.full((bp, deg), n_stripes, dtype=torch.int64, device=dev)
    sid[:b] = torch.where(nbr_val != 0,
                          nbr_idx.long().clamp(0, max(n_src - 1, 0))
                          // stripe, n_stripes)
    touched = torch.zeros((nt, n_stripes + 1), dtype=torch.bool, device=dev)
    touched.scatter_(1, sid.reshape(nt, bb * deg), True)
    touched = touched[:, :n_stripes]
    counts = touched.sum(1, dtype=torch.int32)
    # stable sort of ~touched: the touched stripes first, ascending id
    ids = torch.sort((~touched).to(torch.uint8), dim=1, stable=True).indices
    ids = ids[:, :min(n_stripes, bb * deg)].to(torch.int32).contiguous()
    return StripeIndex(ids, counts, bb=bb, stripe=stripe, n_src=n_src)


def smem_bytes(bb: int, stripe: int, deg: int, n_src: int,
               indexed: bool = True) -> int:
    """Dynamic shared memory of one block: the bitmap of the listed
    stripes (with an index), then each row's live slots (id, value) and
    its slot count."""
    n_stripes = -(-n_src // stripe)
    words = -(-n_stripes // 32) if indexed else 0
    return 4 * words + bb * deg * 8 + bb * 4


def tiles_error(bb: int, stripe: int, deg: int, n_src: int,
                indexed: bool) -> str | None:
    """Why the kernel would refuse a row tile ``bb`` and a ``stripe`` for
    [b, deg] slots over ``n_src`` source rows, or None: the wrapper's own
    checks before launch, which the tuner applies to its candidates."""
    if bb > MAX_BB:
        return f"row tile bb={bb} above the kernel's {MAX_BB}"
    smem = smem_bytes(bb, stripe, deg, n_src, indexed)
    if smem > SMEM_LIMIT:
        return (f"the stripe bitmap and the {bb} x {deg} slot lists need "
                f"{smem} bytes of shared memory, above a block's "
                f"{SMEM_LIMIT}; use a shorter row tile or a longer stripe")
    return None


def check_index(stripe_index: StripeIndex, b: int, n_src: int) -> None:
    """The reference's two checks: the index's tile count and source rows
    against the call's."""
    nt = _rup(b, stripe_index.bb) // stripe_index.bb
    if stripe_index.ids.shape[0] != nt:
        raise ValueError(
            f"stripe_index built for {stripe_index.ids.shape[0]} tiles, "
            f"kernel grid has {nt} (b={b}, bb={stripe_index.bb})")
    if stripe_index.n_src != n_src:
        raise ValueError(
            f"stripe_index built for n_src={stripe_index.n_src}, "
            f"x has {n_src} rows")


def spmm_ell_hbm_cuda(nbr_idx: torch.Tensor, nbr_val: torch.Tensor,
                      x: torch.Tensor,
                      stripe_index: StripeIndex | None = None,
                      x_scale: torch.Tensor | None = None, *,
                      bb: int | None = None,
                      stripe: int | None = None) -> torch.Tensor:
    """nbr_idx [b, D] int32, nbr_val [b, D] f32, x [n_src, f] f32 -- or
    int8 / float8_e4m3fn with ``x_scale`` [1, f] f32 -- all contiguous
    CUDA tensors -> [b, f] f32 with out[i] = sum over the slots d of
    val[i, d] * x[idx[i, d]] (then * x_scale), each row's slots taken in
    (stripe, slot) order.  Without ``stripe_index`` the tiles are ``bb``
    and ``stripe`` (by default the reference's, ``DEFAULT_BB`` and
    ``DEFAULT_STRIPE``) and every stripe a live slot touches is listed --
    the index ``stripe_index_torch`` would build from the same operands at
    those tiles, without building it.  An index pins its own tiles, so it
    takes no ``bb`` or ``stripe``."""
    global launches, launches_q
    quantized = x.dtype != torch.float32
    if x.dtype not in _ENTRY:
        raise TypeError(f"spmm_ell_hbm: x has dtype {x.dtype}, the kernel "
                        f"takes float32, int8 or float8_e4m3fn")
    if quantized != (x_scale is not None):
        raise ValueError("spmm_ell_hbm: an int8 / fp8 source takes x_scale "
                         "[1, f], an f32 one none")
    operands = dict(nbr_idx=nbr_idx, nbr_val=nbr_val, x=x)
    if quantized:
        operands["x_scale"] = x_scale
    dtypes = {"nbr_idx": torch.int32, "nbr_val": torch.float32,
              "x": x.dtype, "x_scale": torch.float32,
              "ids": torch.int32, "counts": torch.int32}
    _build.check_operands("spmm_ell_hbm", dtypes, **operands)
    if nbr_idx.dim() != 2 or nbr_val.shape != nbr_idx.shape or x.dim() != 2:
        raise ValueError(f"spmm_ell_hbm: want idx/val [b, D] and x "
                         f"[n_src, f], got {tuple(nbr_idx.shape)}, "
                         f"{tuple(nbr_val.shape)}, {tuple(x.shape)}")
    b, deg = nbr_idx.shape
    n_src, f = x.shape
    if quantized and x_scale.numel() != f:
        raise ValueError(f"spmm_ell_hbm: x_scale must be [1, {f}], got "
                         f"{tuple(x_scale.shape)}")
    if n_src == 0 or f == 0 or b == 0:
        raise ValueError(f"spmm_ell_hbm: empty operand (b={b}, "
                         f"n_src={n_src}, f={f})")
    if f > MAX_F:
        raise ValueError(f"spmm_ell_hbm: f={f} above the kernel's "
                         f"{MAX_F} columns")
    indexed = stripe_index is not None
    if indexed:
        if bb is not None or stripe is not None:
            raise ValueError("spmm_ell_hbm: a stripe index pins its own "
                             "tiles; pass no bb / stripe with it")
        check_index(stripe_index, b, n_src)
        _build.check_operands("spmm_ell_hbm", dtypes, x=x,
                              ids=stripe_index.ids,
                              counts=stripe_index.counts)
        bb, stripe = stripe_index.bb, stripe_index.stripe
    else:
        bb, stripe = clamp_tiles(b, n_src, bb or DEFAULT_BB,
                                 stripe or DEFAULT_STRIPE)
    err = tiles_error(bb, stripe, deg, n_src, indexed)
    if err is not None:
        raise ValueError(f"spmm_ell_hbm: {err}")
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    err = getattr(_build.library(), _ENTRY[x.dtype])(
        nbr_idx.data_ptr(), nbr_val.data_ptr(), x.data_ptr(),
        x_scale.data_ptr() if quantized else None,
        stripe_index.ids.data_ptr() if indexed else None,
        stripe_index.counts.data_ptr() if indexed else None,
        out.data_ptr(), b, deg, n_src, f, bb, stripe,
        stripe_index.ids.shape[1] if indexed else 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "spmm_ell_hbm")
    launches += 1
    launches_q += quantized
    return out
