#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and report the build time;
3. hold every kernel against its plain PyTorch version on the card, on
   operands taken from the served model's own state at the serving shapes
   (spmm_ell b=256 D=deg_cap f=128; context_ell with (nb, k, fb) =
   (32, 1024, 4) and (8, 1024, 16); vq_assign over all 169,343 nodes at
   both geometries), timing kernel, plain version and -- where one PyTorch
   call computes the same function -- that call, with CUDA events;
4. the main path at the paper's full width (GCN, hidden 128, 3 layers,
   k 1024, f_prod 4) on a 169,343-node ogbn-arxiv look-alike with random
   weights from seed 0: ``GNNServer.refresh``, then ``warmup`` and
   ``drain_requests`` over 200 requests of U[1, 64] nodes, with the
   kernels' launch counters reset before and read after each and checked
   exactly;
5. copy the served state to the CPU and serve the same requests through
   the plain versions there; the served rows must agree;
6. a torch.profiler window over 20 serve steps: the device's busy share
   of the wall time and the kernels that take it;
7. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

The script needs a CUDA card: without one (or outside a checkout of the
repository) it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_NODES = 169343          # ogbn-arxiv's node count
BATCH = 256
REQUESTS = 200
MAX_REQUEST = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, inner: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of ``fn``, medians over ``reps`` CUDA-event
    timings after a warm-up.

    device ms: ``inner`` calls queued behind a ``torch.cuda._sleep`` that
    outlasts their enqueueing, so they run back to back and the events see
    device time only.  call ms: one call on an idle device, host launch
    overhead included -- what a caller waiting on one result pays."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at 2.5 GHz (above the card's top clock) x 1.5: the sleep lasts
    # longer than the host takes to enqueue the inner calls
    cycles = int(host_s * 2.5e9 * 1.5) + 100_000
    dev, call = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / inner)
        a.record()
        fn()
        b.record()
        b.synchronize()
        call.append(a.elapsed_time(b))
    return float(np.median(dev)), float(np.median(call))


def bound(bytes_: float, flops: float) -> tuple[float, str]:
    t_b, t_f = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check_close(name: str, got, want, tol: dict) -> float:
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    if g.shape != w.shape or not np.all(np.isfinite(g)):
        raise SystemExit(f"{name}: bad output shape {g.shape} vs {w.shape} "
                         f"or non-finite values")
    err = float(np.abs(g - w).max()) if g.size else 0.0
    if not np.allclose(g, w, **tol):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {err})")
    return err


def assign_agreement(got, want, x, cw) -> tuple[float, float]:
    """(agreement rate, max |d(got) - d(want)|); every mismatch must be a
    near-tie of the plain version's own distances."""
    import torch
    agree = (got == want)
    rate = float(agree.float().mean())
    c = cw.float()
    cn2 = (c * c).sum(-1)                                     # [nb, k]
    g64, w64 = got.long(), want.long()
    nb = x.shape[0]
    beta = torch.arange(nb, device=x.device)[:, None]

    def dist(idx):
        cr = c[beta, idx]                                     # [nb, n, f]
        return cn2[beta, idx] - 2.0 * (x.float() * cr).sum(-1)
    dg, dw = dist(g64), dist(w64)
    err = float((dg - dw).abs().max())
    bad = (~agree) & ((dg - dw).abs() > 1e-5 * (1 + dw.abs()))
    if bool(bad.any()) or rate < 0.999:
        raise SystemExit(f"vq_assign: agreement {rate:.6f}, "
                         f"{int(bad.sum())} mismatches that are not near-ties")
    return rate, err


def phase_card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


def phase_build() -> float:
    from repro_torch.kernels import _build
    t0 = time.time()
    path = _build.build()
    _build.library()
    dt = time.time() - t0
    log(f"build: {path.relative_to(ROOT)} in {dt:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    return dt


def phase_kernels(server) -> list[dict]:
    """Each kernel vs its plain version on the served model's operands."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.graph.batching import plan_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    from repro_torch.kernels.vq_assign import vq_assign_cuda

    dev = server.device
    cfg = server.cfg.codebook
    rng = np.random.default_rng(SEED + 7)
    bids = torch.from_numpy(rng.choice(server.g.n, BATCH, replace=False)
                            .astype(np.int32)).to(dev)
    pack = plan_batch(server.plan, bids)
    ops_, _ = fixed_conv_operands("gcn", pack, server.ops.degrees)
    rows = []

    # --- spmm_ell: the intra-batch term of one serve step ---
    idx = torch.clamp(ops_.in_pos, min=0).contiguous()
    val = ops_.in_vals.contiguous()
    x_b = server.x[bids.long()].contiguous()
    got, want = spmm_ell_cuda(idx, val, x_b), ref.spmm_ell(idx, val, x_b)
    err = check_close("spmm_ell", got, want, TOL)
    b, deg = idx.shape
    f = x_b.shape[1]
    n_rows = int(torch.unique(idx).numel())
    byt = 8 * b * deg + 4 * n_rows * f + 4 * b * f
    bms, by = bound(byt, 2 * b * deg * f)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.arange(b, device=dev).repeat_interleave(deg),
                     idx.reshape(-1).long()]), val.reshape(-1),
        (b, x_b.shape[0]), check_invariants=True).coalesce()
    lib = torch.sparse.mm(coo, x_b)
    check_close("spmm_ell library call", lib, want, SERVE_TOL)
    ms, call_ms = cuda_ms(lambda: spmm_ell_cuda(idx, val, x_b), 10)
    row = dict(name="spmm_ell", route="cuda",
               source="src/repro_torch/kernels/csrc/spmm_ell.cu",
               replaces="src/repro/kernels/spmm_ell.py:56",
               max_abs_err=err, ms=ms,
               plain_ms=cuda_ms(lambda: ref.spmm_ell(idx, val, x_b), 5)[0],
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(lambda: torch.sparse.mm(coo, x_b), 10)[0],
               call_ms=call_ms, at=f"b={b} D={deg} f={f}")
    rows.append(row)
    log(f"spmm_ell {row['at']}: max_abs_err {err:.3g}  kernel "
        f"{ms:.5f} ms (one call {call_ms:.5f} ms)  plain "
        f"{row['plain_ms']:.5f} ms  sparse.mm {row['library_ms']:.5f} ms  "
        f"bound {bms:.6f} ms ({by})")

    # --- context_ell: the codeword context of layer 0 and layer 2 ---
    ctx = []
    for layer in (0, len(server.vq) - 1):
        vq = server.vq[layer]
        fi = server.cfg.layer_dims()[layer][0]
        cw = cbm.feature_codewords(vq.codebook, fi, cfg)
        ids, vals = ops_.out_ids.contiguous(), ops_.out_vals.contiguous()
        a = vq.assignment
        got = context_ell_cuda(ids, vals, a, cw)
        want = ref.context_ell(ids, vals, a, cw)
        err = check_close(f"context_ell layer {layer}", got, want, TOL)
        nb, k, fb = cw.shape
        uid = torch.unique(ids.long())
        pairs = torch.unique(a[:, uid].long()
                             + k * torch.arange(nb, device=dev)[:, None])
        byt = 8 * b * deg + 4 * nb * uid.numel() + 4 * fb * pairs.numel() \
            + 4 * b * nb * fb
        bms, by = bound(byt, 2 * b * deg * nb * fb)
        ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, cw), 10)
        ctx.append(dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, ms=ms,
            plain_ms=cuda_ms(lambda: ref.context_ell(ids, vals, a, cw), 5)[0],
            call_ms=call_ms,
            at=f"b={b} D={deg} n={a.shape[1]} nb={nb} k={k} fb={fb}"))
        c = ctx[-1]
        log(f"context_ell {c['at']}: max_abs_err {err:.3g}  kernel "
            f"{ms:.5f} ms (one call {call_ms:.5f} ms)  plain "
            f"{c['plain_ms']:.5f} ms  bound {bms:.6f} ms ({by})  "
            f"library none")
    rows.append(dict(name="context_ell", route="cuda",
                     source="src/repro_torch/kernels/csrc/context_ell.cu",
                     replaces="src/repro/kernels/context_ell.py:138",
                     max_abs_err=max(c["max_abs_err"] for c in ctx),
                     ms=ctx[0]["ms"], plain_ms=ctx[0]["plain_ms"],
                     bound_ms=ctx[0]["bound_ms"],
                     bound_by=ctx[0]["bound_by"], library_ms=None,
                     call_ms=ctx[0]["call_ms"], at=ctx[0]["at"],
                     also=ctx[1:]))

    # --- vq_assign: the inductive refresh over every node ---
    asg = []
    for layer in (0, len(server.vq) - 1):
        st = server.vq[layer].codebook
        nb = st.n_branches
        fb = server.x.shape[1] // nb
        v = server.x.reshape(server.g.n, nb, fb)
        v = cbm._whiten(v, st.mean[:, :fb], st.var[:, :fb], cfg.eps)
        x = v.transpose(0, 1)
        cw = st.codewords_w[:, :, :fb].contiguous()
        got, want = vq_assign_cuda(x, cw), ref.vq_assign(x, cw)
        torch.cuda.synchronize()
        rate, err = assign_agreement(got, want, x, cw)
        n, k = x.shape[1], cw.shape[1]
        byt = 4 * nb * n * fb + 4 * nb * k * fb + 4 * nb * n
        bms, by = bound(byt, 2 * nb * n * k * fb)
        ms, call_ms = cuda_ms(lambda: vq_assign_cuda(x, cw), 5, inner=2)
        asg.append(dict(
            max_abs_err=err, agreement=rate, bound_ms=bms, bound_by=by,
            ms=ms, call_ms=call_ms,
            plain_ms=cuda_ms(lambda: ref.vq_assign(x, cw), 3, inner=1)[0],
            at=f"x=[{nb}, {n}, {fb}] cw=[{nb}, {k}, {fb}]"))
        c = asg[-1]
        log(f"vq_assign {c['at']}: agreement {rate:.6f} max_abs_err "
            f"{err:.3g}  kernel {ms:.4f} ms (one call {call_ms:.4f} ms)  "
            f"plain {c['plain_ms']:.4f} ms  bound {bms:.4f} ms ({by})  "
            f"library none")
    rows.append(dict(name="vq_assign", route="cuda",
                     source="src/repro_torch/kernels/csrc/vq_assign.cu",
                     replaces="src/repro/kernels/vq_assign.py:83",
                     max_abs_err=max(c["max_abs_err"] for c in asg),
                     agreement=min(c["agreement"] for c in asg),
                     ms=asg[0]["ms"], plain_ms=asg[0]["plain_ms"],
                     bound_ms=asg[0]["bound_ms"],
                     bound_by=asg[0]["bound_by"], library_ms=None,
                     call_ms=asg[0]["call_ms"], at=asg[0]["at"],
                     also=asg[1:]))
    return rows


def _counters():
    from repro_torch.kernels import context_ell, spmm_ell, vq_assign
    return {"vq_assign": vq_assign, "spmm_ell": spmm_ell,
            "context_ell": context_ell}


def reset_counts() -> None:
    for m in _counters().values():
        m.launches = 0


def read_counts() -> dict:
    return {k: m.launches for k, m in _counters().items()}


def expect_counts(what: str, got: dict, want: dict) -> None:
    log(f"{what} launches: {got}")
    if got != want:
        raise SystemExit(f"{what}: launch counts {got}, expected {want}")


def phase_main_path(server, requests) -> tuple[dict, dict]:
    from repro_torch.launch.serve_gnn import drain_requests
    n_layers = server.cfg.n_layers
    steps_per_layer = -(-server.g.n // server.batch)
    reset_counts()
    t_refresh = server.refresh()
    refresh_counts = read_counts()
    expect_counts("refresh", refresh_counts, {
        "vq_assign": n_layers, "spmm_ell": n_layers * steps_per_layer,
        "context_ell": n_layers * steps_per_layer})
    log(f"refresh: {t_refresh:.3f} s for {server.g.n} nodes x {n_layers} "
        f"layers ({steps_per_layer} batches of {server.batch} per layer)")
    reset_counts()
    t_warm = server.warmup()
    rep = drain_requests(server, requests)
    serve_counts = read_counts()
    steps = rep["steps"] + 1                      # + the warm-up step
    expect_counts("serve", serve_counts, {
        "vq_assign": 0, "spmm_ell": n_layers * steps,
        "context_ell": n_layers * steps})
    rep.update(refresh_s=t_refresh, warmup_s=t_warm)
    log(f"serve: {rep['nodes']} nodes / {rep['requests']} requests in "
        f"{rep['steps']} steps, {rep['wall_s']:.4f} s -> "
        f"{rep['nodes_per_s']:.1f} nodes/s; step p50 "
        f"{rep['step_p50_ms']:.4f} ms p99 {rep['step_p99_ms']:.4f} ms; "
        f"request p50 {rep['request_p50_ms']:.4f} ms p99 "
        f"{rep['request_p99_ms']:.4f} ms; warmup {t_warm:.4f} s")
    total = {k: refresh_counts[k] + serve_counts[k] for k in refresh_counts}
    return rep, total


def phase_cpu_parity(server, requests) -> None:
    """The GPU server's state on the CPU, served through the plain
    versions: the same rows must come out."""
    from repro_torch.convert import to_device
    from repro_torch.launch.serve_gnn import GNNServer
    cpu = GNNServer(server.g, server.cfg, to_device(server.params, "cpu"),
                    to_device(server.vq, "cpu"), server.batch, device="cpu")
    batches = [np.concatenate(requests[:6]),
               np.arange(server.batch) % 100,       # duplicate ids
               np.asarray(requests[6])]
    worst = 0.0
    for i, ids in enumerate(batches):
        got, want = server.serve(ids), cpu.serve(ids)
        if got.shape != (len(ids), server.f_out) or \
                not np.all(np.isfinite(got)):
            raise SystemExit(f"served rows: shape {got.shape} or non-finite")
        if not np.allclose(got, want, **SERVE_TOL):
            raise SystemExit(f"batch {i}: GPU rows disagree with the CPU "
                             f"plain path (max abs err "
                             f"{np.abs(got - want).max()})")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"cpu parity: {sum(len(b) for b in batches)} served rows agree with "
        f"the CPU plain path, max abs err {worst:.3g} (rtol 1e-4, atol 1e-5)")


def phase_profile(server, requests) -> None:
    """Device busy share and kernel time by name over 20 serve steps (only
    device-side events count: an aten op's row repeats its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flat = np.concatenate(requests)[:20 * server.batch]
    steps = [flat[i:i + server.batch] for i in range(0, len(flat),
                                                      server.batch)]
    steps = [s for s in steps if len(s) == server.batch]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for s in steps:
            server.step(s)
        wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not evs:
        raise SystemExit("profiler recorded no device time")
    dev_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    log(json.dumps({"profile": {
        "steps": len(steps), "wall_ms": wall * 1e3,
        "device_ms": dev_us / 1e3, "device_busy_share": dev_us / 1e3 /
        (wall * 1e3), "kernels_per_step": sum(e.count for e in evs) /
        len(steps), "top": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top]}}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.vq_gnn_paper import paper_config
    from repro_torch.launch import serve_gnn

    phase_card()
    build_s = phase_build()

    t0 = time.time()
    args = serve_gnn.parser().parse_args(
        ["--n", str(N_NODES), "--batch", str(BATCH), "--hidden", "128",
         "--layers", "3", "--k", "1024", "--requests", str(REQUESTS),
         "--max-request", str(MAX_REQUEST), "--seed", str(SEED)])
    server = serve_gnn.build_server(args)
    if server.cfg != paper_config(server.g, full_scale=True):
        raise SystemExit(f"served config {server.cfg} is not the paper's "
                         f"full-scale config")
    log(f"setup: {server.g.n} nodes, {server.g.m} edges, deg_cap "
        f"{server.plan.nbr_ids.shape[1]}, config {server.cfg} "
        f"in {time.time() - t0:.2f} s")

    kernels = phase_kernels(server)
    requests = serve_gnn.make_requests(server.g.n, REQUESTS, MAX_REQUEST,
                                       SEED)
    rep, launches = phase_main_path(server, requests)
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise SystemExit(f"{row['name']} never launched on the main path")
    phase_cpu_parity(server, requests)
    phase_profile(server, requests)

    log(json.dumps({"serve": {k: rep[k] for k in (
        "refresh_s", "warmup_s", "nodes", "requests", "steps", "wall_s",
        "nodes_per_s", "step_p50_ms", "step_p99_ms", "request_p50_ms",
        "request_p99_ms")}, "build_s": build_s}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in r if k not in keys}} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
