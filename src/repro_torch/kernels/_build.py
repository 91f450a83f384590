"""Build and load the port's CUDA kernels (nvcc -> one .so -> ctypes).

The sources under ``csrc/`` have a plain C interface (pointers, ints, the
stream; each function returns its ``cudaError_t``), so they compile with
``nvcc`` alone in seconds -- no PyTorch headers.  The build runs on first
use, never at import: every ``.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library.  The library lives under ``build/repro_torch_kernels/<hash>/`` at
the repository root, keyed on a hash of the sources and flags, so a fresh
checkout (or an edited source) rebuilds and an unchanged one reuses it.
Each source's compiler output (ptxas' registers, shared memory and spills
of every kernel) is kept beside the library as ``<source>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch import hostenv

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "librepro_torch_kernels.so"
# dynamic shared memory one H100 block may use (the card's opt-in limit,
# cudaDevAttrMaxSharedMemoryPerBlockOptin): every wrapper sizes its blocks
# against it
SMEM_LIMIT = 232448

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_flt = ctypes.c_float
# name -> argtypes of every exported function (restype: cudaError_t as int)
SIGNATURES = {
    "repro_vq_assign_f32": [_vp, _ll, _ll, _vp, _vp, _vp, _int, _int, _int,
                            _int, _vp],
    "repro_spmm_ell_f32": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    "repro_spmm_ell_t_f32": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                             _vp],
    "repro_vq_update_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                            _int, _vp],
    "repro_vq_update_u8_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                               _int, _int, _vp],
    "repro_vq_update_generic_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                                    _int, _int, _vp],
    "repro_vq_assign_wide_f32": [_vp, _ll, _ll] + [_vp] * 4 + [_int] * 4
    + [_vp],
}
for _e in ("f32", "u8_f32"):
    SIGNATURES[f"repro_vq_update_wide_{_e}"] = [_vp] * 7 + [_int] * 4 + [_vp]
for _e in ("f32", "u8_f32"):
    SIGNATURES[f"repro_vq_update_wide_tiles_{_e}"] = [_vp] * 7 + [_int] * 5 \
        + [_vp]
SIGNATURES["repro_vq_wide_probe_f32"] = [_vp] * 4 + [_int] * 4 + [_vp]
SIGNATURES["repro_vq_wide_plan"] = [_int, _int, _vp]
SIGNATURES["repro_smem_optin"] = [_vp]
for _dt in ("f32", "bf16"):
    SIGNATURES[f"repro_vq_attention_{_dt}"] = [_vp] * 11 + [_int] * 6 \
        + [_flt, _vp]
    SIGNATURES[f"repro_flash_attention_{_dt}"] = [_vp] * 4 + [_int] * 5 \
        + [_flt, _vp]
SIGNATURES["repro_flash_attention_tc_bf16"] = \
    SIGNATURES["repro_flash_attention_bf16"]
for _cw in ("i8", "f8"):
    SIGNATURES[f"repro_spmm_ell_q_{_cw}"] = [_vp] * 5 + [_int] * 4 + [_vp]
for _x in ("f32", "q_i8", "q_f8"):
    SIGNATURES[f"repro_spmm_ell_hbm_{_x}"] = [_vp] * 7 + [_int] * 7 + [_vp]
for _cw in ("f32", "i8", "f8"):
    for _tab in ("i32", "u8", "a4"):
        SIGNATURES[f"repro_context_ell_{_cw}_{_tab}"] = \
            [_vp] * 3 + [_ll] * 2 + [_vp] * 3 + [_int] * 6 + [_vp]
        SIGNATURES[f"repro_context_ell_wt_{_cw}_{_tab}"] = \
            [_vp] * 3 + [_ll] * 2 + [_vp] * 4 + [_int] * 7 + [_vp]

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = hostenv.env_knob("CUDA_HOME") or hostenv.env_knob("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of repro_torch "
        "are built from source on first use and need the CUDA toolkit")


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the library for the current sources exists)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, obj, p in procs:
            log, _ = p.communicate()
            obj.with_suffix(".log").write_text(log)
            if p.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / LIB_NAME
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
                *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                               f"{res.stdout}")
        out.parent.mkdir(parents=True, exist_ok=True)
        for _, obj, _ in procs:
            os.replace(obj.with_suffix(".log"),
                       out.parent / (obj.stem + ".log"))
        os.replace(lib_tmp, out)      # atomic: concurrent builders agree
    return out


def build_log(stem: str) -> str:
    """The compiler output of source ``<stem>.cu`` in the current build."""
    return (library_path().parent / f"{stem}.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_operands(kernel: str, dtypes: dict, **tensors) -> None:
    """Wrapper-side validation before pointers reach the kernel: every
    operand on the current CUDA device, of the dtype ``dtypes`` names and
    contiguous (unless its dtype entry is a ``(dtype, "strided")`` pair)."""
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}; the CUDA "
                             f"kernel takes CUDA tensors only")
        if dev is None:
            dev = t.device
            if dev.index != torch.cuda.current_device():
                raise ValueError(
                    f"{kernel}: operands on {dev} but the current device is "
                    f"cuda:{torch.cuda.current_device()}")
        elif t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, other "
                             f"operands on {dev}")
        want = dtypes[name]
        strided = isinstance(want, tuple)
        want = want[0] if strided else want
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, the "
                            f"kernel takes {want}")
        if not strided and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous "
                             f"(call .contiguous() first)")


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err} "
                           f"({msg})")
