#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one process per source, all started together) and report the
   build time;
3. training, the first main path, at the paper's full width (GCN, hidden
   128, 3 layers, k 1024, f_prod 4) on a 169,343-node ogbn-arxiv
   look-alike: ``train_vq`` for 70 epochs of 5 batches of 42,335 nodes
   (``paper_batch_size``; the fifth is the wrap-padded tail) from seed
   0, the kernels' launch counters reset before and read after and
   checked exactly; per-step loss and VQ error, epoch seconds, val/test
   accuracy; the losses must be finite and fall on average, and no
   layer's codebook may end collapsed; then 8 timed steps (step ms
   p50/p99) and a torch.profiler window over 2 steps;
4. hold every kernel against its plain PyTorch version on the card at
   every shape the main paths give it, on operands taken from the
   trained model: vq_update on the whitened (X || G) rows of a training
   batch at both branch geometries (its sums also exact on rows rounded
   so that fp32 sums are exact in any order), the w_t form of
   context_ell and spmm_ell_t on that batch's reverse-edge and
   intra-batch operands, spmm_ell on that batch's intra-batch operands
   and on the full graph (the evaluation's SpMM, whose 86.7 MB source
   the reference sends to its HBM-staged kernel), the plain form of
   context_ell on that batch's forward operands, and the serving shapes
   of vq_assign, spmm_ell and context_ell; timing kernel, plain version
   and -- where one PyTorch call computes the same function -- that
   call, with CUDA events;
5. one training step at batch 4,096 on the card and the same step on the
   CPU plain path from the trained state copied over: loss, params,
   optimizer and codebook state must agree;
6. serving, the second main path, with the trained weights:
   ``GNNServer.refresh``, then ``warmup`` and ``drain_requests`` over 200
   requests of U[1, 64] nodes, launch counters checked exactly;
7. copy the served state to the CPU and serve the same requests through
   the plain versions there; the served rows must agree;
8. a torch.profiler window over 20 serve steps: the device's busy share
   of the wall time and the kernels that take it;
9. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

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

T_START = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_NODES = 169343          # ogbn-arxiv's node count
BATCH = 256
REQUESTS = 200
MAX_REQUEST = 64
SEED = 0
DEVICE = "cuda"
TRAIN_EPOCHS = 70             # 350 steps: past the revival at step ~300
EVAL_EVERY = 5
MAX_CLUSTER_SHARE = 0.5       # of a layer's nodes on one codeword, at the end
TIMED_STEPS = 8
PARITY_BATCH = 4096
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
U32 = 2.0 ** -24              # fp32 unit roundoff


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


def check_scatter(name: str, got, want, abs_sum, terms) -> float:
    """A scatter-add against its plain version: two fp32 sums of the same
    ``terms`` terms in different orders differ by at most
    ``2 * terms * 2^-24 * sum |term|`` per element."""
    import torch
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SystemExit(f"{name}: bad output shape {tuple(g.shape)} vs "
                         f"{tuple(w.shape)} or non-finite values")
    err = (g - w).abs()
    tol = 2 * terms.detach().cpu().double() * U32 \
        * abs_sum.detach().cpu().double()
    if bool((err > tol).any()):
        raise SystemExit(f"{name}: {int((err > tol).sum())} elements beyond "
                         f"the scatter-order bound (max abs err "
                         f"{float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


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


class Model:
    """The graph's device tables for the training phases."""

    def __init__(self, g, cfg, batch: int, dev):
        import torch
        from repro_torch.graph.batching import build_epoch_plan, full_operands
        self.g, self.cfg, self.batch, self.dev = g, cfg, batch, dev
        self.ops = full_operands(g, device=dev)
        self.plan = build_epoch_plan(g, full_ops=self.ops, device=dev)
        self.x = torch.from_numpy(g.features).to(dev)
        self.labels = torch.from_numpy(g.labels).to(dev)
        mask = np.zeros(g.n, np.float32)
        mask[g.train_idx] = 1.0
        self.train_mask = torch.from_numpy(mask).to(dev)

    def batch_inputs(self, bids_np: np.ndarray):
        """(pack, x_b, labels_b, loss mask) of one batch of node ids."""
        import torch
        from repro_torch.graph.batching import plan_batch
        bids = torch.from_numpy(bids_np.astype(np.int32)).to(self.dev)
        i = bids.long()
        return (plan_batch(self.plan, bids), self.x[i], self.labels[i],
                self.train_mask[i])


def largest_cluster_share(vq_states) -> list[float]:
    """Per layer: the largest share of the nodes that one codeword of one
    branch holds in the assignment table (1.0 is a collapsed codebook)."""
    import torch
    out = []
    for st in vq_states:
        nb, n = st.assignment.shape
        k = st.codebook.k
        flat = st.assignment.long() + k * torch.arange(
            nb, device=st.assignment.device)[:, None]
        counts = torch.bincount(flat.reshape(-1), minlength=nb * k)
        out.append(float(counts.max()) / n)
    return out


def phase_train(g, cfg, batch: int) -> tuple[dict, dict]:
    """The training main path: ``train_vq`` at the paper's batch size for
    TRAIN_EPOCHS epochs, paper-faithful (Eq. 7 injection on), with the
    launch counts of every step and of the full-graph evaluations checked
    exactly and every step's loss and VQ error printed.

    Gates: every loss and VQ error finite; the mean loss of the last 5
    epochs under that of the first 5; no layer's codebook collapsed at
    the end (at most MAX_CLUSTER_SHARE of the nodes on one codeword).
    The run is long enough for the last two: while the injection reads
    the random initial gradient codewords the loss rises and the last
    layer's codebook collapses -- the reference does the same
    (tests/test_torch_train.py) -- until the codewords nobody picks have
    decayed under ``revive_threshold`` (0.99^t < 0.05 at step ~300) and
    are re-seeded from the worst-quantized rows."""
    import torch
    from repro_torch.train.gnn_trainer import train_vq
    n_layers = cfg.n_layers
    steps = TRAIN_EPOCHS * -(-g.n // batch)
    inject = n_layers - 1 if cfg.grad_inject else 0
    reset_counts()
    t0 = time.time()
    r = train_vq(g, cfg, epochs=TRAIN_EPOCHS, batch_size=batch, seed=SEED,
                 eval_every=EVAL_EVERY, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    # per step: every layer's forward runs spmm_ell and context_ell and its
    # codebook update vq_update; the backward of every layer but the first
    # (whose input needs no gradient) runs spmm_ell_t and, with the Eq. 7
    # injection, the w_t form of context_ell.  Each full-graph evaluation
    # runs spmm_ell once per layer.
    evals = -(-TRAIN_EPOCHS // EVAL_EVERY)
    expect_counts("train", counts, {
        "vq_assign": 0, "vq_update": n_layers * steps,
        "spmm_ell": n_layers * steps + n_layers * evals,
        "spmm_ell_t": (n_layers - 1) * steps,
        "context_ell": (n_layers + inject) * steps,
        "context_ell_wt": inject * steps})
    losses, errs = r["step_losses"], r["step_vq_errs"]
    if losses.shape != (steps,) or errs.shape != (steps, n_layers):
        raise SystemExit(f"train: {losses.shape} losses, {errs.shape} VQ "
                         f"errors for {steps} steps")
    for i, (loss, e) in enumerate(zip(losses, errs)):
        log(f"train step {i}: loss {loss:.6f} vq_err "
            f"{' '.join(f'{v:.4f}' for v in e)}")
    for h in r["history"]:
        log(f"train epoch {h['epoch']}: {r['epoch_s'][h['epoch'] - 1]:.3f} "
            f"s, val {h['val']:.4f} test {h['test']:.4f} vq_err "
            f"{h['vq_err']:.4f}")
    epoch_loss = losses.reshape(TRAIN_EPOCHS, -1).mean(1)
    share = largest_cluster_share(r["vq_states"])
    r.update(wall_s=wall, epoch_loss=epoch_loss.tolist(),
             epoch_vq_err=errs.reshape(TRAIN_EPOCHS, -1).mean(1).tolist(),
             largest_cluster_share=share)
    log(f"train: {steps} steps of {batch} nodes in {wall:.3f} s (incl. "
        f"{evals} full-graph evaluations); mean loss per epoch "
        f"{[round(v, 4) for v in r['epoch_loss']]}; largest cluster share "
        f"per layer at the end {[round(v, 4) for v in share]}")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(errs))):
        raise SystemExit("train: non-finite loss or VQ error")
    first, last = float(epoch_loss[:5].mean()), float(epoch_loss[-5:].mean())
    if not last < first:
        raise SystemExit(f"train: mean loss of the last 5 epochs {last} not "
                         f"under that of the first 5 {first}")
    if max(share) > MAX_CLUSTER_SHARE:
        raise SystemExit(f"train: a codebook collapsed, largest cluster "
                         f"share per layer {share} (cap "
                         f"{MAX_CLUSTER_SHARE})")
    return r, counts


def phase_step_timing(m: Model, params, vq, ost) -> dict:
    """Host-clock time of single training steps, each synchronised, on
    fresh batches from the trained state (outside the counted main path;
    the states they produce are dropped)."""
    import torch
    from repro_torch.graph.batching import epoch_slices
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 11)
    ids = np.concatenate([epoch_slices(rng.permutation(m.g.n), m.batch)[0]
                          for _ in range(-(-TIMED_STEPS * m.batch // m.g.n)
                                         + 1)])[:TIMED_STEPS]
    times = []
    for bids in ids:
        pack, x_b, y_b, lm = m.batch_inputs(bids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, vq, ost, loss, _, _ = vq_train_step(
            params, vq, ost, pack, x_b, y_b, m.ops.degrees, m.cfg, opt,
            loss_mask=lm)
        float(loss)                              # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    t = np.sort(times)
    rep = {"steps": len(t), "step_p50_ms": float(np.percentile(t, 50)),
           "step_p99_ms": float(np.percentile(t, 99)),
           "step_ms": [float(v) for v in times]}
    log(f"train step timing: {len(t)} steps of {m.batch} nodes, p50 "
        f"{rep['step_p50_ms']:.3f} ms p99 {rep['step_p99_ms']:.3f} ms")
    return rep


def _vq_update_row(name, vw, cw, generic: bool = False) -> dict:
    """vq_update against its plain version on one layer's rows; with
    ``generic`` also the kernel's generic-width instantiation, which must
    give the same result, timed beside the fixed-width build."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_update import (vq_assign_update_cuda,
                                               vq_assign_update_generic_cuda)
    got = vq_assign_update_cuda(vw, cw)
    want = ref.vq_assign_update(vw, cw)
    torch.cuda.synchronize()
    nb, b, f = vw.shape
    k = cw.shape[1]
    if not torch.equal(got[0], want[0]):
        raise SystemExit(f"{name}: assignment differs from the plain version "
                         f"({int((got[0] != want[0]).sum())} rows)")
    if not torch.equal(got[1], want[1]):
        raise SystemExit(f"{name}: qerr not bit-equal to the plain version "
                         f"(max abs err {float((got[1] - want[1]).abs().max())})")
    if not torch.equal(got[2], want[2]):
        raise SystemExit(f"{name}: counts differ from the plain version")
    flat = (want[0].long() + k * torch.arange(nb, device=vw.device)[:, None]
            ).reshape(-1)
    abs_sum = torch.zeros((nb * k, f), device=vw.device).index_add_(
        0, flat, vw.abs().reshape(-1, f)).reshape(nb, k, f)
    err = check_scatter(f"{name} sums", got[3], want[3], abs_sum,
                        want[2][..., None])
    # The bound above grows with a codeword's row count and is loose on a
    # codeword thousands of rows share.  On rows rounded to multiples of
    # 2^-6 within [-4, 4], every partial sum of at most 2^16 rows is a
    # multiple of 2^-6 under 2^18, 24 significant bits: exact in fp32 in any
    # order, so there the sums must equal the float64 sums bit for bit.
    assert b <= 1 << 16
    vq_ = ((vw * 64).round().clamp(-256, 256) / 64).contiguous()
    gq = vq_assign_update_cuda(vq_, cw)
    wq = ref.vq_assign_update(vq_, cw)
    flat_q = (gq[0].long() + k * torch.arange(nb, device=vw.device)[:, None]
              ).reshape(-1)
    exact = torch.zeros((nb * k, f), dtype=torch.float64,
                        device=vw.device).index_add_(
        0, flat_q, vq_.double().reshape(-1, f)).reshape(nb, k, f)
    if not (torch.equal(gq[0], wq[0]) and torch.equal(gq[2], wq[2])
            and torch.equal(gq[3].double(), exact)):
        raise SystemExit(f"{name}: on rows with exact fp32 sums the kernel's "
                         f"assignment, counts or sums are not exact")
    byt = 4 * nb * b * f + 4 * nb * k * f + 8 * nb * b + 4 * nb * k * (f + 1)
    bms, by = bound(byt, 2 * nb * b * k * f)
    ms, call_ms = cuda_ms(lambda: vq_assign_update_cuda(vw, cw), 5, inner=4)
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms, bound_ms=bms,
               bound_by=by,
               plain_ms=cuda_ms(lambda: ref.vq_assign_update(vw, cw), 3,
                                inner=1)[0],
               hot_share=float(want[2].max()) / b,
               at=f"x=[{nb}, {b}, {f}] cw=[{nb}, {k}, {f}]")
    if generic:
        gen = vq_assign_update_generic_cuda(vq_, cw)
        if not all(torch.equal(u, v) for u, v in zip(gen, gq)):
            raise SystemExit(f"{name}: the generic-width instantiation "
                             f"differs from the fixed-width build")
        row["generic_ms"] = cuda_ms(
            lambda: vq_assign_update_generic_cuda(vw, cw), 5, inner=4)[0]
        log(f"{name}: generic-width instantiation {row['generic_ms']:.4f} "
            f"ms against the fixed-width build's {ms:.4f} ms")
    log(f"{name} {row['at']}: idx/qerr/counts equal, sums max_abs_err "
        f"{err:.3g} (exact on grid rows)  kernel {ms:.4f} ms (one call {call_ms:.4f} ms)  plain "
        f"{row['plain_ms']:.4f} ms  bound {bms:.4f} ms ({by})  largest "
        f"cluster {row['hot_share']:.4f} of the rows  library none")
    return row


def phase_train_kernels(m: Model, params, vq) -> tuple[list[dict], dict]:
    """Every kernel of the training path against its plain version at the
    shapes training gives it, on one training batch of the trained model:
    vq_update (also on the untrained model's rows -- early training, the
    atomic hot spot of rows crowding few codewords), the w_t form of
    context_ell and spmm_ell_t, and the forward kernels at the training
    batch (spmm_ell's intra-batch term, context_ell's plain form) and on
    the full graph (the evaluation's spmm_ell).  Returns the vq_update and
    spmm_ell_t rows and, by kernel name, the rows that go under the
    spmm_ell and context_ell rows' ``also``."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    from repro_torch.kernels.spmm_ell import spmm_ell_t_cuda
    from repro_torch.models.gnn import (init_gnn, init_vq_states,
                                        vq_loss_and_grads)
    cfg, dev = m.cfg, m.dev
    cb = cfg.layer_codebook_cfg()
    last = cfg.n_layers - 1
    rng = np.random.default_rng(SEED + 5)
    pack, x_b, y_b, lm = m.batch_inputs(rng.permutation(m.g.n)[:m.batch])
    ops_, _ = fixed_conv_operands("gcn", pack, m.ops.degrees)
    b, deg = ops_.in_pos.shape

    # --- vq_update: each layer's whitened (X || G) rows ---
    upd = []
    init = (init_gnn(cfg, torch.Generator().manual_seed(SEED), device=dev),
            init_vq_states(cfg, m.g.n, torch.Generator().manual_seed(
                SEED + 1), device=dev))
    for tag, (p, v) in (("trained", (params, vq)), ("untrained", init)):
        _, _, acts, _, gprobes = vq_loss_and_grads(
            p, v, pack, x_b, y_b, m.ops.degrees, cfg, lm)
        for layer in (0, last):
            st = v[layer].codebook
            vw = cbm.whitened_rows(st, acts[layer], gprobes[layer], cb)[0]
            cw = st.codewords_w.contiguous()
            row = _vq_update_row(f"vq_update layer {layer} {tag}", vw, cw,
                                 generic=tag == "trained")
            row["at"] += f" layer {layer} {tag}"
            upd.append(row)
            if tag == "trained":
                # the hot spot: every row of a branch on one codeword, as
                # in a collapsed codebook (each branch's first row repeated)
                hot = vw[:, :1].expand_as(vw).contiguous()
                row = _vq_update_row(f"vq_update layer {layer} hot spot",
                                     hot, cw)
                row["at"] += f" layer {layer} hot spot (rows all alike)"
                upd.append(row)
    rows = [dict(name="vq_update", route="cuda",
                 source="src/repro_torch/kernels/csrc/vq_update.cu",
                 replaces="src/repro/kernels/vq_update.py:106",
                 **{k: upd[0][k] for k in upd[0] if k != "max_abs_err"},
                 max_abs_err=max(c["max_abs_err"] for c in upd),
                 library_ms=None, also=upd[1:])]

    # --- context_ell w_t: the Eq. 7 backward of layers 1..L-1 ---
    wt = []
    ids, vals = ops_.rev_ids.contiguous(), ops_.rev_vals.contiguous()
    dr = ids.shape[1]
    for layer in range(1, cfg.n_layers):
        fi = cfg.layer_dims()[layer][0]
        gcw = cbm.gradient_codewords(vq[layer].codebook, fi, cb)
        w_t = params[layer]["w"].t().contiguous()
        a = vq[layer].assignment
        got = context_ell_cuda(ids, vals, a, gcw, w_t)
        want = ref.context_ell(ids, vals, a, gcw, w_t)
        err = check_close(f"context_ell w_t layer {layer}", got, want, TOL)
        nb, k, gb = gcw.shape
        f_out = w_t.shape[1]
        uid = torch.unique(ids.long())
        pairs = torch.unique(a[:, uid].long()
                             + k * torch.arange(nb, device=dev)[:, None])
        byt = 8 * b * dr + 4 * nb * uid.numel() + 4 * gb * pairs.numel() \
            + 4 * nb * gb * f_out + 4 * b * f_out
        bms, by = bound(byt, 2 * b * dr * nb * gb + 2 * b * nb * gb * f_out)
        ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, gcw,
                                                       w_t), 5)
        wt.append(dict(
            form="w_t", max_abs_err=err, bound_ms=bms, bound_by=by, ms=ms,
            call_ms=call_ms, library_ms=None,
            plain_ms=cuda_ms(lambda: ref.context_ell(ids, vals, a, gcw, w_t),
                             3, inner=2)[0],
            at=f"b={b} Dr={dr} n={a.shape[1]} nb={nb} k={k} fb={gb} "
               f"f_out={f_out} (layer {layer} backward)"))
        c = wt[-1]
        log(f"context_ell w_t {c['at']}: max_abs_err {err:.3g}  kernel "
            f"{ms:.5f} ms (one call {call_ms:.5f} ms)  plain "
            f"{c['plain_ms']:.5f} ms  bound {bms:.6f} ms ({by})  "
            f"library none")

    # --- spmm_ell_t: the intra-batch SpMM's backward ---
    idx = torch.clamp(ops_.in_pos, min=0).contiguous()
    val = ops_.in_vals.contiguous()
    f = cfg.hidden
    gr = torch.randn((b, f), generator=torch.Generator(device=dev)
                     .manual_seed(SEED), device=dev)
    got = spmm_ell_t_cuda(idx, val, gr, b)
    want = ref.spmm_ell_t(idx, val, gr, b)
    err = check_scatter("spmm_ell_t", got, want,
                        ref.spmm_ell_t(idx, val.abs(), gr.abs(), b),
                        ref.spmm_ell_t(idx, (val != 0).float(),
                                       torch.ones_like(gr), b))
    nz = val != 0
    nnz = int(nz.sum())
    byt = 8 * b * deg + 4 * b * f + 4 * b * f
    bms, by = bound(byt, 2 * nnz * f)
    rows_i = torch.arange(b, device=dev)[:, None].expand(b, deg)
    coo_t = torch.sparse_coo_tensor(
        torch.stack([idx.long()[nz], rows_i[nz]]), val[nz], (b, b),
        check_invariants=True).coalesce()
    lib = torch.sparse.mm(coo_t, gr)
    check_close("spmm_ell_t library call", lib, want, SERVE_TOL)
    ms, call_ms = cuda_ms(lambda: spmm_ell_t_cuda(idx, val, gr, b), 10)
    row = dict(name="spmm_ell_t", route="cuda",
               source="src/repro_torch/kernels/csrc/spmm_ell.cu",
               replaces="src/repro/kernels/spmm_ell.py:56 (backward in x; "
                        "JAX autodiff, no Pallas kernel)",
               max_abs_err=err, ms=ms, call_ms=call_ms,
               plain_ms=cuda_ms(lambda: ref.spmm_ell_t(idx, val, gr, b), 5,
                                inner=2)[0],
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(lambda: torch.sparse.mm(coo_t, gr), 10)[0],
               at=f"b={b} D={deg} f={f} nnz={nnz} n_src={b}")
    rows.append(row)
    log(f"spmm_ell_t {row['at']}: max_abs_err {err:.3g}  kernel {ms:.5f} ms "
        f"(one call {call_ms:.5f} ms)  plain {row['plain_ms']:.5f} ms  "
        f"sparse.mm {row['library_ms']:.5f} ms  bound {bms:.6f} ms ({by})")

    # --- spmm_ell and context_ell's plain form at the training shapes ---
    from repro_torch.nn.gnn_layers import _gcn_edge_vals
    spmm = [_spmm_row(idx, val, x_b.contiguous(),
                      "(training forward, intra-batch)"),
            _spmm_row(m.ops.nbr_ids.contiguous(),
                      _gcn_edge_vals(m.ops)[0].contiguous(), m.x,
                      "(full-graph evaluation)")]
    for row in spmm:       # both sources exceed the reference's VMEM budget
        row["replaces"] = ("src/repro/kernels/spmm_ell_hbm.py:168 (the "
                           "reference's dispatch, src/repro/kernels/ops.py:"
                           "241, sends a source above 8 MB there)")
    ctx = []
    for layer in (0, last):
        fi = cfg.layer_dims()[layer][0]
        ctx.append(_context_row(
            ops_.out_ids.contiguous(), ops_.out_vals.contiguous(),
            vq[layer].assignment,
            cbm.feature_codewords(vq[layer].codebook, fi, cb),
            f"(training forward, layer {layer})"))
    return rows, {"spmm_ell": spmm, "context_ell": wt + ctx}


def _codeword_mismatch(a, b) -> "torch.Tensor":
    """[nb, k] mask of codewords whose state differs between two layer
    states beyond STEP_TOL."""
    import torch
    cb_a, cb_b = a.codebook, b.codebook
    bad = torch.zeros(cb_a.cluster_size.shape, dtype=torch.bool)
    for fa, fb in ((cb_a.codewords_w, cb_b.codewords_w),
                   (cb_a.cluster_sum, cb_b.cluster_sum)):
        bad |= ~torch.isclose(fa, fb, **STEP_TOL).all(-1)
    for fa, fb in ((cb_a.cluster_size, cb_b.cluster_size),
                   (a.counts, b.counts)):
        bad |= ~torch.isclose(fa, fb, **STEP_TOL)
    return bad


def phase_train_parity(m: Model, params, vq, ost) -> dict:
    """One training step at batch PARITY_BATCH on the card and on the CPU
    plain path from the same (trained) state.  Loss, output, params,
    optimizer state, VQ errors and whitening moments agree within
    STEP_TOL; the refreshed assignments agree on >= 99.9 % of the batch's
    entries and every mismatch is a near-tie; codeword statistics agree
    except on codewords a flipped row touched or that were revived."""
    import torch
    from repro_torch.convert import to_device
    from repro_torch.core import codebook as cbm
    from repro_torch.models.gnn import vq_loss_and_grads, vq_train_step
    from repro_torch.train.optimizer import rmsprop
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    opt = rmsprop(PAPER_LR)
    bids = np.random.default_rng(SEED + 3).choice(
        m.g.n, PARITY_BATCH, replace=False)
    cpu = Model(m.g, m.cfg, PARITY_BATCH, "cpu")
    state_c = to_device((params, vq, ost), "cpu")
    res = {}
    for tag, mm, (p, v, o) in (("cuda", m, (params, vq, ost)),
                               ("cpu", cpu, state_c)):
        pack, x_b, y_b, lm = mm.batch_inputs(bids)
        t0 = time.time()
        out = vq_train_step(p, v, o, pack, x_b, y_b, mm.ops.degrees, m.cfg,
                            opt, loss_mask=lm)
        out = to_device(out, "cpu")
        res[tag] = (out, time.time() - t0)
    (pg, vg, og, lg, yg, eg), t_gpu = res["cuda"]
    (pc, vc, oc, lc, yc, ec), t_cpu = res["cpu"]
    if not np.isfinite(float(lg)):
        raise SystemExit("train parity: non-finite loss")
    worst = 0.0
    for name, a, b in [("loss", lg, lc), ("output", yg, yc),
                       ("vq_errs", eg, ec)] + [
            (f"param {l}.{k}", pg[l][k], pc[l][k])
            for l in range(len(pg)) for k in pg[l]] + [
            (f"rmsprop nu {l}.{k}", og.nu[l][k], oc.nu[l][k])
            for l in range(len(pg)) for k in pg[l]]:
        worst = max(worst, check_close(f"train parity {name}", a, b,
                                       STEP_TOL))
    cb = m.cfg.layer_codebook_cfg()
    bids_t = torch.from_numpy(bids).long()
    outside = ~torch.isin(torch.arange(m.g.n), bids_t)
    vw_c = None
    summary = []
    for l, (a, b) in enumerate(zip(vg, vc)):
        for name in ("mean", "var"):
            check_close(f"train parity layer {l} {name}",
                        getattr(a.codebook, name), getattr(b.codebook, name),
                        STEP_TOL)
        if int(a.codebook.step) != int(b.codebook.step):
            raise SystemExit(f"train parity layer {l}: codebook step")
        ag, ac = a.assignment[:, bids_t], b.assignment[:, bids_t]
        flip = ag != ac
        agree = 1.0 - float(flip.float().mean())
        if not torch.equal(a.assignment[:, outside],
                           b.assignment[:, outside]):
            raise SystemExit(f"train parity layer {l}: assignments outside "
                             f"the batch changed")
        if bool(flip.any()):
            if vw_c is None:     # the CPU step's own whitened rows
                pack, x_b, y_b, lm = cpu.batch_inputs(bids)
                _, _, acts, _, gpr = vq_loss_and_grads(
                    state_c[0], state_c[1], pack, x_b, y_b,
                    cpu.ops.degrees, m.cfg, lm)
                vw_c = [cbm.whitened_rows(state_c[1][i].codebook, acts[i],
                                          gpr[i], cb)[0]
                        for i in range(len(acts))]
            c = state_c[1][l].codebook.codewords_w.double()
            x = vw_c[l].double()
            beta = torch.arange(c.shape[0])[:, None]

            def dist(idx):
                cr = c[beta, idx.long()]
                return (cr * cr).sum(-1) - 2 * (x * cr).sum(-1)
            dg, dc = dist(ag), dist(ac)
            far = flip & ((dg - dc).abs() > 1e-5 * (1 + dc.abs()))
            if bool(far.any()):
                raise SystemExit(f"train parity layer {l}: {int(far.sum())} "
                                 f"assignment mismatches are not near-ties")
        if agree < 0.999:
            raise SystemExit(f"train parity layer {l}: assignment agreement "
                             f"{agree:.6f} < 0.999")
        k = a.codebook.k
        touched = torch.zeros((ag.shape[0], k), dtype=torch.bool)
        rows_b = torch.arange(ag.shape[0])[:, None].expand_as(ag)
        touched[rows_b[flip], ag[flip].long()] = True
        touched[rows_b[flip], ac[flip].long()] = True
        revived = (a.codebook.cluster_size == 1.0) | \
            (b.codebook.cluster_size == 1.0)
        bad = _codeword_mismatch(a, b)
        if bool((bad & ~(touched | revived)).any()):
            raise SystemExit(f"train parity layer {l}: "
                             f"{int((bad & ~(touched | revived)).sum())} "
                             f"codewords differ that no flipped or revived "
                             f"row explains")
        if int(bad.sum()) > max(4, 0.001 * bad.numel()):
            raise SystemExit(f"train parity layer {l}: {int(bad.sum())} "
                             f"codewords differ")
        summary.append(dict(layer=l, agreement=agree, flips=int(flip.sum()),
                            codewords_differ=int(bad.sum()),
                            revived=int(revived.sum())))
        log(f"train parity layer {l}: assignment agreement {agree:.6f} "
            f"({int(flip.sum())} near-tie flips), {int(bad.sum())} of "
            f"{bad.numel()} codewords differ (flipped or revived rows), "
            f"{int(revived.sum())} revived")
    log(f"train parity: one step at batch {PARITY_BATCH}, card vs CPU plain "
        f"path: loss {float(lg):.6f} vs {float(lc):.6f}, max abs err "
        f"{worst:.3g} (rtol 1e-4, atol 1e-5); card {t_gpu:.3f} s, CPU "
        f"{t_cpu:.3f} s")
    return {"layers": summary, "max_abs_err": worst}


def _spmm_row(idx, val, x, at: str) -> dict:
    """spmm_ell against its plain version and ``torch.sparse.mm`` on one
    set of operands: idx/val [b, D], source x [n_src, f]."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    got, want = spmm_ell_cuda(idx, val, x), ref.spmm_ell(idx, val, x)
    err = check_close(f"spmm_ell {at}", got, want, TOL)
    b, deg = idx.shape
    f = x.shape[1]
    n_rows = int(torch.unique(idx).numel())
    bms, by = bound(8 * b * deg + 4 * n_rows * f + 4 * b * f, 2 * b * deg * f)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.arange(b, device=x.device).repeat_interleave(deg),
                     idx.reshape(-1).long()]), val.reshape(-1),
        (b, x.shape[0]), check_invariants=True).coalesce()
    check_close(f"spmm_ell library call {at}", torch.sparse.mm(coo, x), want,
                SERVE_TOL)
    big = b * deg * f > 1e7              # fewer repetitions of the big ones
    ms, call_ms = cuda_ms(lambda: spmm_ell_cuda(idx, val, x), 5 if big else 10)
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
               plain_ms=cuda_ms(lambda: ref.spmm_ell(idx, val, x),
                                3 if big else 5, inner=1 if big else 20)[0],
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(lambda: torch.sparse.mm(coo, x),
                                  5 if big else 10)[0],
               at=f"b={b} D={deg} f={f} n_src={x.shape[0]} "
                  f"({4 * x.shape[0] * f / 1e6:.1f} MB source) {at}")
    log(f"spmm_ell {row['at']}: max_abs_err {err:.3g}  kernel {ms:.5f} ms "
        f"(one call {call_ms:.5f} ms)  plain {row['plain_ms']:.5f} ms  "
        f"sparse.mm {row['library_ms']:.5f} ms  bound {bms:.6f} ms ({by})")
    return row


def _context_row(ids, vals, a, cw, at: str) -> dict:
    """The plain form of context_ell against its plain version on one set
    of operands: ids/vals [b, D], assignment a [nb, n], codewords cw
    [nb, k, fb]."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    got, want = context_ell_cuda(ids, vals, a, cw), ref.context_ell(
        ids, vals, a, cw)
    err = check_close(f"context_ell {at}", got, want, TOL)
    b, deg = ids.shape
    nb, k, fb = cw.shape
    uid = torch.unique(ids.long())
    pairs = torch.unique(a[:, uid].long()
                         + k * torch.arange(nb, device=a.device)[:, None])
    byt = 8 * b * deg + 4 * nb * uid.numel() + 4 * fb * pairs.numel() \
        + 4 * b * nb * fb
    bms, by = bound(byt, 2 * b * deg * nb * fb)
    big = b * deg * nb * fb > 1e7
    ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, cw),
                          5 if big else 10)
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by, ms=ms,
               call_ms=call_ms, library_ms=None,
               plain_ms=cuda_ms(lambda: ref.context_ell(ids, vals, a, cw), 3
                                if big else 5, inner=2 if big else 20)[0],
               at=f"b={b} D={deg} n={a.shape[1]} nb={nb} k={k} fb={fb} {at}")
    log(f"context_ell {row['at']}: max_abs_err {err:.3g}  kernel {ms:.5f} ms "
        f"(one call {call_ms:.5f} ms)  plain {row['plain_ms']:.5f} ms  "
        f"bound {bms:.6f} ms ({by})  library none")
    return row


def phase_kernels(server) -> list[dict]:
    """Each kernel vs its plain version on the served model's operands."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.graph.batching import plan_batch
    from repro_torch.kernels import ref
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
    x_b = server.x[bids.long()].contiguous()
    row = _spmm_row(torch.clamp(ops_.in_pos, min=0).contiguous(),
                    ops_.in_vals.contiguous(), x_b, "(serve step)")
    rows.append(dict(name="spmm_ell", route="cuda",
                     source="src/repro_torch/kernels/csrc/spmm_ell.cu",
                     replaces="src/repro/kernels/spmm_ell.py:56", **row))

    # --- context_ell: the codeword context of layer 0 and layer 2 ---
    ctx = []
    for layer in (0, len(server.vq) - 1):
        vq = server.vq[layer]
        fi = server.cfg.layer_dims()[layer][0]
        ctx.append(_context_row(
            ops_.out_ids.contiguous(), ops_.out_vals.contiguous(),
            vq.assignment, cbm.feature_codewords(vq.codebook, fi, cfg),
            f"(serve step, layer {layer})"))
    rows.append(dict(name="context_ell", route="cuda",
                     source="src/repro_torch/kernels/csrc/context_ell.cu",
                     replaces="src/repro/kernels/context_ell.py:138",
                     **{k: v for k, v in ctx[0].items() if k != "max_abs_err"},
                     max_abs_err=max(c["max_abs_err"] for c in ctx),
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


def _counters() -> dict:
    """Kernel name -> (wrapper module, counter attribute)."""
    from repro_torch.kernels import context_ell, spmm_ell, vq_assign, vq_update
    return {"vq_assign": (vq_assign, "launches"),
            "vq_update": (vq_update, "launches"),
            "spmm_ell": (spmm_ell, "launches"),
            "spmm_ell_t": (spmm_ell, "launches_t"),
            "context_ell": (context_ell, "launches"),
            "context_ell_wt": (context_ell, "launches_wt")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


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
        "vq_assign": n_layers, "vq_update": 0,
        "spmm_ell": n_layers * steps_per_layer, "spmm_ell_t": 0,
        "context_ell": n_layers * steps_per_layer, "context_ell_wt": 0})
    log(f"refresh: {t_refresh:.3f} s for {server.g.n} nodes x {n_layers} "
        f"layers ({steps_per_layer} batches of {server.batch} per layer)")
    reset_counts()
    t_warm = server.warmup()
    rep = drain_requests(server, requests)
    serve_counts = read_counts()
    steps = rep["steps"] + 1                      # + the warm-up step
    expect_counts("serve", serve_counts, {
        "vq_assign": 0, "vq_update": 0, "spmm_ell": n_layers * steps,
        "spmm_ell_t": 0, "context_ell": n_layers * steps,
        "context_ell_wt": 0})
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


def _profile(what: str, steps: list, run) -> None:
    """Device busy share and kernel time by name over ``run(s)`` for each
    of ``steps`` (only device-side events count: an aten op's row repeats
    its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for s in steps:
            run(s)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not evs:
        raise SystemExit(f"{what}: profiler recorded no device time")
    dev_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    log(json.dumps({"profile": {
        "what": what, "steps": len(steps), "wall_ms": wall * 1e3,
        "device_ms": dev_us / 1e3, "device_busy_share": dev_us / 1e3 /
        (wall * 1e3), "kernels_per_step": sum(e.count for e in evs) /
        len(steps), "top": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top]}}))


def phase_profile(server, requests) -> None:
    """The profile of 20 serve steps."""
    flat = np.concatenate(requests)[:20 * server.batch]
    steps = [flat[i:i + server.batch] for i in range(0, len(flat),
                                                      server.batch)]
    _profile("serve", [s for s in steps if len(s) == server.batch],
             server.step)


def phase_train_profile(m: Model, params, vq, ost) -> None:
    """The profile of 2 training steps from the trained state (their
    results are dropped)."""
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 13)
    batches = [rng.permutation(m.g.n)[:m.batch] for _ in range(2)]

    def step(bids):
        pack, x_b, y_b, lm = m.batch_inputs(bids)
        vq_train_step(params, vq, ost, pack, x_b, y_b, m.ops.degrees, m.cfg,
                      opt, loss_mask=lm)
    step(batches[0])                      # warm: allocator, first launches
    _profile("train", batches, step)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.vq_gnn_paper import (paper_batch_size,
                                                  paper_config)
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.launch import serve_gnn

    phase_card()
    build_s = phase_build()

    t0 = time.time()
    g = synthetic_arxiv(n=N_NODES, seed=SEED)
    cfg = paper_config(g, full_scale=True)
    batch = paper_batch_size(g)
    m = Model(g, cfg, batch, torch.device(DEVICE))
    log(f"setup: {g.n} nodes, {g.m} edges, deg_cap "
        f"{m.plan.nbr_ids.shape[1]}, config {cfg}, training batch {batch} "
        f"in {time.time() - t0:.2f} s")

    r, train_counts = phase_train(g, cfg, batch)
    params, vq, ost = r["params"], r["vq_states"], r["opt_state"]
    timing = phase_step_timing(m, params, vq, ost)
    phase_train_profile(m, params, vq, ost)
    train_rows, train_also = phase_train_kernels(m, params, vq)
    parity = phase_train_parity(m, params, vq, ost)

    server = serve_gnn.GNNServer(g, cfg, params, vq, BATCH, device=DEVICE)
    serve_rows = phase_kernels(server)
    requests = serve_gnn.make_requests(g.n, REQUESTS, MAX_REQUEST, SEED)
    rep, serve_counts = phase_main_path(server, requests)
    launches = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    by_name = {row["name"]: row for row in serve_rows + train_rows}
    by_name["spmm_ell"].setdefault("also", [])
    for name, extra in train_also.items():
        by_name[name]["also"] += extra
    for c in by_name["context_ell"]["also"]:
        if c.get("form") == "w_t":
            c["launches"] = launches["context_ell_wt"]
    kernels = [by_name[n] for n in ("vq_assign", "spmm_ell", "spmm_ell_t",
                                    "context_ell", "vq_update")]
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise SystemExit(f"{row['name']} never launched on the main path")
    if launches["context_ell_wt"] < 1:
        raise SystemExit("context_ell's w_t form never launched on the main "
                         "path")
    phase_cpu_parity(server, requests)
    phase_profile(server, requests)

    log(json.dumps({"train": {
        "steps": int(r["step_losses"].shape[0]), "batch": batch,
        "wall_s": r["wall_s"], "epoch_s": r["epoch_s"],
        "epoch_loss": r["epoch_loss"], "epoch_vq_err": r["epoch_vq_err"],
        "step_loss": r["step_losses"].tolist(),
        "largest_cluster_share": r["largest_cluster_share"],
        "history": r["history"], "final": r["final"], **{k: timing[k] for k in (
            "step_p50_ms", "step_p99_ms", "step_ms")},
        "parity": parity}}))
    log(json.dumps({"serve": {k: rep[k] for k in (
        "refresh_s", "warmup_s", "nodes", "requests", "steps", "wall_s",
        "nodes_per_s", "step_p50_ms", "step_p99_ms", "request_p50_ms",
        "request_p99_ms")}, "build_s": build_s}))
    log(f"chip_smoke: {time.time() - T_START:.1f} s from start to the "
        f"result lines, the kernels' build included")
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
