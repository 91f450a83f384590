#!/usr/bin/env python3
"""Phase split of the wide VQ scan (``vq_update.cuh``'s wide build) on one
CUDA card, and the card's L2 read rate.

    python3 tools/wide_scan_phases.py [--first PARENT_TREE] [--out FILE]

Builds, besides the port's own library, an instrumented copy of the wide
kernel into ``build/diag/<tag>/`` and runs it at the main paths' wide
shapes (random rows and codewords from a seed; k 1024).  Thread 0 of every
block stamps ``clock64()`` at each phase boundary and adds the cycles to
one of eight buckets; the script prints each bucket's share of the summed
block cycles beside the instrumented call's device time (CUDA events).

* this tree (``--tree``, default the repository root): its kernel carries
  the stamps itself (``WIDE_PH``, compiled in with ``-DREPRO_WIDE_PHASES``
  only);
* ``--first DIR``: a tree whose ``vq_update.cuh`` holds the first version
  of the wide kernel (e.g. ``git archive`` of a commit before its
  redesign); the stamps are inserted into a copy of it at fixed anchors.

The L2 read rate: 16-byte loads of an L2-resident 24 MiB buffer, read 40
times in one launch, bytes over device time (and one read of 1 GiB from
HBM beside it).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 42335, 1024, 65), (4, 42335, 1024, 43), (1, 5000, 1024, 256),
          (1, 5000, 1024, 168)]
BUCKETS_FIRST = ["setup", "stage + |x|^2", "copies + waits", "mma", "fold + merge",
                 "exact u + threshold", "finish", "drain"]

PRELUDE = r"""
#include <cuda_runtime.h>
#define WIDE_NPH 8
__device__ unsigned long long g_wide_ph[WIDE_NPH];
#define WIDE_PH_DECL long long _ph_t = clock64(); int _ph_drain = 0; \
  unsigned long long _ph_acc[WIDE_NPH] = {0, 0, 0, 0, 0, 0, 0, 0};
#define WIDE_PH(p) do { const long long _t = clock64(); \
  _ph_acc[_ph_drain ? 7 : (p)] += _t - _ph_t; _ph_t = _t; } while (0)
#define WIDE_PH_DRAIN(on) (_ph_drain = (on))
#define WIDE_PH_FLUSH() do { if (threadIdx.x == 0) \
  for (int _i = 0; _i < WIDE_NPH; ++_i) atomicAdd(&g_wide_ph[_i], _ph_acc[_i]); \
  } while (0)
"""

ENTRIES = r"""
#include "vq_update.cuh"
extern "C" cudaError_t diag_wide_update(const float* x, const float* cw,
    float* scratch, int* idx, float* qerr, float* counts, float* sums, int nb,
    int n, int k, int f, cudaStream_t stream) {
  return launch_wide<int, true>(x, (long long)n * f, f, cw, scratch, idx,
                                qerr, counts, sums, nb, n, k, f, stream);
}
// every block reads its share of an L2-resident buffer `reps` times in
// 16-byte loads; the sum keeps the loads live
__global__ void diag_l2_kernel(const float4* __restrict__ p, long long n4,
                               int reps, float* sink) {
  float a = 0.f;
  for (int r = 0; r < reps; ++r)
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n4; i += (long long)gridDim.x * blockDim.x) {
      const float4 v = __ldcg(p + i);
      a += v.x + v.y + v.z + v.w;
    }
  if (a == 12345.f) *sink = a;
}
extern "C" cudaError_t diag_l2_read(const float* p, long long n, int reps,
                                    float* sink, int blocks,
                                    cudaStream_t stream) {
  diag_l2_kernel<<<blocks, 512, 0, stream>>>(
      reinterpret_cast<const float4*>(p), n / 4, reps, sink);
  return cudaGetLastError();
}
extern "C" cudaError_t diag_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[WIDE_NPH] = {0};
    return cudaMemcpyToSymbol(g_wide_ph, z, sizeof(z));
  }
  return cudaMemcpyFromSymbol(out, g_wide_ph,
                              WIDE_NPH * sizeof(unsigned long long));
}
"""

# (anchor, text inserted after it) in the first version's vq_update.cuh
FIRST_PATCHES = [
    ("  WideMisc& ms = *reinterpret_cast<WideMisc*>(cn_s + 2 * BN);\n",
     "  WIDE_PH_DECL\n"),
    ("      __syncthreads();\n      const float* cb = c_s + buf * BN * s;\n",
     "      WIDE_PH(2);\n"),
    ("  auto drain = [&](int br, int cnt) {\n", "    WIDE_PH_DRAIN(1);\n"),
]
# (old, new) replacements in the first version
FIRST_REPLACE = [
    ("      if (!rescore) {\n#pragma unroll\n        for (int u = 0; u < NT; ++u) {\n"
     "#pragma unroll\n          for (int i = 0; i < 4; ++i) {\n"
     "            const int h = i >> 1, c = c0 + u * 8 + 2 * q + (i & 1);\n"
     "            const float d = acc[u][i];",
     "      WIDE_PH(3);\n      if (!rescore) {\n#pragma unroll\n"
     "        for (int u = 0; u < NT; ++u) {\n#pragma unroll\n"
     "          for (int i = 0; i < 4; ++i) {\n"
     "            const int h = i >> 1, c = c0 + u * 8 + 2 * q + (i & 1);\n"
     "            const float d = acc[u][i];"),
    ("      __syncthreads();                 // the buffer is free for tile t + 2\n",
     "      WIDE_PH(4);\n"
     "      __syncthreads();                 // the buffer is free for tile t + 2\n"),
    ("    __syncthreads();\n    stage(br);\n    pass(br, false, 0);\n",
     "    __syncthreads();\n    WIDE_PH(0);\n    stage(br);\n    WIDE_PH(1);\n"
     "    pass(br, false, 0);\n    WIDE_PH(4);\n"),
    ("    __syncthreads();\n    finish(br);\n    if (ms.q_n >= BM) drain(br, BM);\n",
     "    __syncthreads();\n    WIDE_PH(5);\n    finish(br);\n    WIDE_PH(6);\n"
     "    if (ms.q_n >= BM) drain(br, BM);\n"),
    ("    __syncthreads();\n    finish(br);\n  };\n",
     "    __syncthreads();\n    finish(br);\n    WIDE_PH(7);\n"
     "    WIDE_PH_DRAIN(0);\n  };\n"),
    ("  if (cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);\n}\n",
     "  if (cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);\n  WIDE_PH(0);\n"
     "  WIDE_PH_FLUSH();\n}\n"),
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
               / "nvcc")


def build(tree: Path, tag: str, first: bool) -> ctypes.CDLL:
    """The instrumented wide kernel of ``tree`` as a shared library."""
    src = tree / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "diag" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for p in src.glob("*.cuh"):
        shutil.copy(p, out / p.name)
    cuh = out / "vq_update.cuh"
    text = cuh.read_text()
    if first:
        for old, new in FIRST_REPLACE:
            if text.count(old) != 1:
                raise SystemExit(f"anchor not found once in {cuh}: {old!r}")
            text = text.replace(old, new)
        for anchor, add in FIRST_PATCHES:
            if text.count(anchor) != 1:
                raise SystemExit(f"anchor not found once in {cuh}: "
                                 f"{anchor!r}")
            text = text.replace(anchor, anchor + add)
    cuh.write_text(PRELUDE + text)
    (out / "diag.cu").write_text(ENTRIES)
    lib = out / "libdiag.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", "-shared", "-DREPRO_WIDE_PHASES",
           "-o", str(lib), str(out / "diag.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed for {tag}:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    vp, i = ctypes.c_void_p, ctypes.c_int
    dll.diag_wide_update.argtypes = [vp] * 7 + [i] * 4 + [vp]
    dll.diag_wide_update.restype = i
    dll.diag_phases.argtypes = [vp, i]
    dll.diag_phases.restype = i
    dll.diag_l2_read.argtypes = [vp, ctypes.c_longlong, i, vp, i, vp]
    dll.diag_l2_read.restype = i
    return dll


def device_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def operands(nb, n, k, f, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    cw = torch.randn((nb, k, f), generator=g, device="cuda")
    x = torch.randn((nb, n, f), generator=g, device="cuda")
    return x.contiguous(), cw.contiguous()


def split(dll, x, cw, scratch_floats: int, buckets) -> dict:
    import torch
    nb, n, f = x.shape
    k = cw.shape[1]
    scratch = torch.empty(scratch_floats, device="cuda")
    idx = torch.empty((nb, n), dtype=torch.int32, device="cuda")
    qerr = torch.empty((nb, n), device="cuda")
    counts = torch.zeros((nb, k), device="cuda")
    sums = torch.zeros((nb, k, f), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = dll.diag_wide_update(
            x.data_ptr(), cw.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
            qerr.data_ptr(), counts.data_ptr(), sums.data_ptr(), nb, n, k, f,
            stream)
        if err:
            raise SystemExit(f"diag launch failed: cudaError {err}")
    ms = device_ms(call)
    if dll.diag_phases(None, 1):
        raise SystemExit("diag_phases reset failed")
    call()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    if dll.diag_phases(ctypes.addressof(out), 0):
        raise SystemExit("diag_phases read failed")
    cyc = np.array(list(out), dtype=np.float64)
    share = cyc / max(cyc.sum(), 1.0)
    return {"instrumented_ms": ms,
            "share": {b: float(s) for b, s in zip(buckets, share)}}


def l2_read_rate(dll) -> dict:
    """Bytes read over device time: 16-byte loads (ld.global.cg, L2 only)
    of a 24 MiB buffer, read 40 times in one launch of 4 blocks an SM;
    and one read of a 1 GiB buffer (HBM)."""
    import torch
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for tag, floats, reps in (("l2", 6 * 2 ** 20, 40),
                              ("hbm", 2 ** 28, 1)):
        buf = torch.randn(floats, device="cuda")

        def call():
            if dll.diag_l2_read(buf.data_ptr(), floats, reps,
                                sink.data_ptr(), 4 * sms, stream):
                raise SystemExit("diag_l2_read failed")
        ms = device_ms(call)
        out[f"{tag}_bytes"] = floats * 4 * reps
        out[f"{tag}_ms"] = ms
        out[f"{tag}_read_tb_s"] = floats * 4 * reps / ms / 1e9
        del buf
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--first", type=Path, default=None,
                    help="a tree whose wide kernel is the first version")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_scan_phases: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    report = {"card": smi.stdout.strip(), "runs": {}}
    sys.path.insert(0, str(args.tree / "src"))
    trees = []
    if args.first is not None:
        trees.append(("first", args.first, True, BUCKETS_FIRST))
    new_buckets = None
    if "WIDE_PH(" in (args.tree / "src" / "repro_torch" / "kernels" / "csrc"
                      / "vq_update.cuh").read_text():
        from repro_torch.kernels import vq_update as tvu
        new_buckets = list(tvu.WIDE_PHASES)
        trees.append(("new", args.tree, False, new_buckets))
    for tag, tree, first, buckets in trees:
        dll = build(tree, tag, first)
        if "l2" not in report:
            report["l2"] = l2_read_rate(dll)
            print(json.dumps(report["l2"]), flush=True)
        for nb, n, k, f in SHAPES:
            x, cw = operands(nb, n, k, f, seed=nb * n + f)
            floats = nb * k + 16
            if not first:
                floats = tvu.wide_scratch_floats(nb, k, f)
            row = split(dll, x, cw, floats, buckets)
            key = f"{tag} [{nb}, {n}, {f}] k {k}"
            report["runs"][key] = row
            print(key, json.dumps(row), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
