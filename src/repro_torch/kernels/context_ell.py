"""Checked wrapper of the fused VQ-context CUDA kernel
(``csrc/context_ell.cu``).

Counterpart of ``repro.kernels.context_ell.context_ell_pallas`` in all its
forms: the plain accumulate (``_context_ell_kernel``), the fused ``@ w_t``
epilogue of the Eq. 7 backward (``_context_ell_wt_kernel``) and their
quantized twins (``_context_ell_q_kernel``, ``_context_ell_q_wt_kernel``:
int8 / fp8 codewords with [nb, 1, f_blk] f32 scales), each over an int32
or uint8 ``[nb, n]`` assignment table or a nibble-packed
``PackedAssignment``, every table read in place in its storage type and
layout: row-major, or node-major (the [nb, n] values over contiguous
[n, nb] storage, packed [ceil(n / 2), nb]: ``core.conv.hold_table`` holds
a tier state's table so on the card), which gives a node's id in every
branch from one memory sector, as the Pallas kernel's transposed table
does.  ``launches`` counts every launch of the kernel in this
process, ``launches_wt`` those of the ``w_t`` forms, ``launches_q`` those
with quantized codewords and ``launches_q_wt`` the quantized ``w_t`` ones;
``launches_by_entry`` counts them by the library entry launched
(``repro_context_ell[_wt]_<f32|i8|f8>_<i32|u8|a4>``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.quantization import PackedAssignment
from repro_torch.kernels import _build


def is_node_major(table: torch.Tensor) -> bool:
    """True for an [nb, n] table held as the transpose of a contiguous
    [n, nb] one (one branch is row-major either way)."""
    return table.dim() == 2 and not table.is_contiguous() \
        and table.t().is_contiguous()

launches = 0
launches_wt = 0
launches_q = 0
launches_q_wt = 0
launches_by_entry: dict[str, int] = {}

# the w_t form holds at least 8 rows of the [b, nb * f_blk] context in a
# block's shared memory (32 where they fit)
SMEM_LIMIT = _build.SMEM_LIMIT
WT_ROWS = 8
# codeword storage dtype -> entry name part; table kind -> (part, largest k)
_CW = {torch.float32: "f32", torch.int8: "i8", torch.float8_e4m3fn: "f8"}
_TABLE_K = {"i32": None, "u8": 256, "a4": 16}
_TABLE = {torch.int32: "i32", torch.uint8: "u8"}


def entry_name(cw_dtype, assignment, wt: bool) -> str:
    """The library entry launched for codewords of ``cw_dtype`` over
    ``assignment`` (a table or a ``PackedAssignment``), with or without the
    ``w_t`` epilogue: ``launches_by_entry``'s key."""
    tab = "a4" if isinstance(assignment, PackedAssignment) \
        else _TABLE.get(assignment.dtype, str(assignment.dtype))
    cw = _CW.get(cw_dtype, str(cw_dtype))
    return f"repro_context_ell{'_wt' if wt else ''}_{cw}_{tab}"


def context_ell_cuda(out_ids: torch.Tensor, out_vals: torch.Tensor,
                     assignment: torch.Tensor | PackedAssignment,
                     codewords: torch.Tensor,
                     w_t: torch.Tensor | None = None,
                     cw_scale: torch.Tensor | None = None) -> torch.Tensor:
    """out_ids [b, D] int32, out_vals [b, D] f32, assignment [nb, n] int32
    or uint8 (k <= 256) or a ``PackedAssignment`` (k <= 16), codewords
    [nb, k, f_blk] f32 -- or int8 / float8_e4m3fn with ``cw_scale``
    [nb, 1, f_blk] f32 -- all contiguous CUDA tensors, the table (a packed
    table's bytes) row-major or node-major -> [b, nb * f_blk] f32
    (branch-concatenated codeword context), or, with ``w_t``
    [nb * f_blk, f_out] contiguous f32, that context ``@ w_t``:
    [b, f_out]."""
    global launches, launches_wt, launches_q, launches_q_wt
    packed = isinstance(assignment, PackedAssignment)
    table = assignment.packed if packed else assignment
    operands = dict(out_ids=out_ids, out_vals=out_vals, assignment=table,
                    codewords=codewords)
    cw_name = _CW.get(codewords.dtype)
    if cw_name is None:
        raise TypeError(f"context_ell: codewords of dtype {codewords.dtype}; "
                        f"the kernel takes {sorted(map(str, _CW))}")
    quantized = cw_name != "f32"
    if quantized != (cw_scale is not None):
        raise ValueError("context_ell: int8 / fp8 codewords take cw_scale "
                         "[nb, 1, f_blk], f32 codewords none")
    if quantized:
        operands["cw_scale"] = cw_scale
    if w_t is not None:
        operands["w_t"] = w_t
    if packed:
        tab, a_dtype = "a4", torch.uint8
    else:
        tab = _TABLE.get(table.dtype)
        if tab is None:
            raise TypeError(f"context_ell: assignment of dtype {table.dtype}; "
                            f"the kernel takes int32, uint8 or a "
                            f"PackedAssignment")
        a_dtype = table.dtype
    _build.check_operands("context_ell", {"out_ids": torch.int32,
                                          "out_vals": torch.float32,
                                          "assignment": (a_dtype, "strided"),
                                          "codewords": codewords.dtype,
                                          "cw_scale": torch.float32,
                                          "w_t": torch.float32},
                          **operands)
    if out_ids.dim() != 2 or out_vals.shape != out_ids.shape \
            or table.dim() != 2 or codewords.dim() != 3 \
            or table.shape[0] != codewords.shape[0] \
            or (packed and table.shape[1] != (assignment.n + 1) // 2):
        raise ValueError(
            f"context_ell: want ids/vals [b, D], assignment [nb, n] (packed "
            f"[nb, ceil(n / 2)]), codewords [nb, k, f_blk]; got "
            f"{tuple(out_ids.shape)}, {tuple(out_vals.shape)}, "
            f"{tuple(table.shape)}, {tuple(codewords.shape)}")
    b, deg = out_ids.shape
    nb, n = assignment.shape
    _, k, f_blk = codewords.shape
    k_max = _TABLE_K[tab]
    if k_max is not None and k > k_max:
        raise ValueError(f"context_ell: a {'packed' if packed else 'uint8'} "
                         f"assignment table holds ids < {k_max}, got k={k}")
    node_major = is_node_major(table)
    if not (node_major or table.is_contiguous()):
        raise ValueError("context_ell: the assignment table must be "
                         "row-major or node-major (a contiguous [n, nb] "
                         "tensor's transpose)")
    if node_major and table.numel() >= 2 ** 31:
        # the kernels take a node's offset v * nb in 32 bits
        raise ValueError(f"context_ell: a node-major table takes fewer than "
                         f"2^31 entries, got {table.numel()}")
    if quantized and cw_scale.shape != (nb, 1, f_blk):
        raise ValueError(f"context_ell: cw_scale must be [{nb}, 1, {f_blk}], "
                         f"got {tuple(cw_scale.shape)}")
    if w_t is not None and (w_t.dim() != 2 or w_t.shape[0] != nb * f_blk):
        raise ValueError(f"context_ell: w_t must be [nb * f_blk = "
                         f"{nb * f_blk}, f_out], got {tuple(w_t.shape)}")
    if w_t is not None and WT_ROWS * nb * f_blk * 4 > SMEM_LIMIT:
        raise ValueError(f"context_ell: {nb * f_blk} context columns do not "
                         f"fit the w_t kernel's shared memory "
                         f"({SMEM_LIMIT} B for {WT_ROWS} rows)")
    f_out = nb * f_blk if w_t is None else w_t.shape[1]
    if deg == 0 or b == 0:
        # no neighbor slots: the context term is zero (no launch)
        return torch.zeros((b, f_out), dtype=torch.float32,
                           device=out_vals.device)
    if n == 0 or k == 0 or f_blk == 0:
        raise ValueError("context_ell: empty assignment or codeword table")
    out = torch.empty((b, f_out), dtype=torch.float32,
                      device=out_vals.device)
    if f_out == 0:
        return out
    stream = torch.cuda.current_stream(out.device).cuda_stream
    lib = _build.library()
    scale = cw_scale.data_ptr() if quantized else None
    # the table's strides: element (br, v) at br * s_br + v * s_id
    head = (out_ids.data_ptr(), out_vals.data_ptr(), table.data_ptr(),
            *table.stride(), codewords.data_ptr(), scale)
    entry = entry_name(codewords.dtype, assignment, w_t is not None)
    if w_t is None:
        err = getattr(lib, entry)(
            *head, out.data_ptr(), b, deg, n, nb, k, f_blk, stream)
    else:
        err = getattr(lib, entry)(
            *head, w_t.data_ptr(), out.data_ptr(), b, deg, n, nb, k, f_blk,
            f_out, stream)
    _build.check(err, "context_ell")
    launches_by_entry[entry] = launches_by_entry.get(entry, 0) + 1
    launches += 1
    launches_wt += w_t is not None
    launches_q += quantized
    launches_q_wt += quantized and w_t is not None
    return out


def smem_optin() -> int:
    """The card's opt-in shared memory a block
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), as the kernels read it
    (``repro_smem_optin``)."""
    import ctypes
    out = (ctypes.c_int * 1)()
    _build.check(_build.library().repro_smem_optin(out), "smem_optin")
    return int(out[0])
