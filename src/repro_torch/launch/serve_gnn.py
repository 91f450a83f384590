"""GNN serving endpoint on the H100: codeword-context inference as a
traffic-shaped service (torch twin of ``repro.launch.serve_gnn``).

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --n 169343 \
        --hidden 128 --layers 3 --k 1024 --batch 256 --requests 200 \
        [--backbone {gcn,sage,gat,gin,transformer}] \
        [--precision {fp32,int8,fp8,int8+a4,fp8+a4}] [--device cpu] \
        [--json out.json]

The server keeps params, per-layer VQ states, node features and the
pack-once :class:`~repro_torch.graph.batching.EpochPlan` on the device.
Start-up is one ``refresh`` -- the inference executor with feature-half
assignment (``vq_infer_epoch(inductive=True)``), so every node holds a
fresh codeword -- then the request loop: requests are coalesced onto the
static [batch] shape by the micro-batcher (small requests share a step,
large ones span several), and the report gives nodes/s plus p50/p99 step
and request latency.  Each step's latency includes the ``.cpu()`` copy of
its output, which synchronises with the card.

``--train-epochs N`` first trains the model with ``train_vq`` (batch
``--batch``, N epochs) and serves the trained weights; without it the
weights are random from ``--seed``.

``--precision`` picks the operand tier: the states are built (and
trained) under it, then converted by ``quantize_vq_states`` -- uint8
tables (k <= 256), nibble-packed under the '+a4' tiers (k <= 16), and an
int8 / fp8 codeword snapshot -- and the report's ``vq_state_bytes`` counts
the tables and snapshots the kernels read.

Every backbone serves, GAT and the Graph Transformer from dense f32
codewords (their layers read no quantized snapshot).  Not in this slice
(it raises, naming the slice that brings it): ``--mesh`` /
``--shard-graph``.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.codebook import CodebookConfig
from repro_torch.distributed.quantization import tree_bytes
from repro_torch.graph.batching import (build_epoch_plan, full_operands,
                                        inference_slices)
from repro_torch.graph.structure import Graph
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn import (GNNConfig, _layer_out_dims, init_gnn,
                                    init_vq_states, quantize_vq_states,
                                    vq_infer_epoch, vq_serve_batch)
from repro_torch.runtime import MESH_SLICE, resolve_device
from repro_torch.train.gnn_trainer import train_vq


class GNNServer:
    """Device-resident serving state + the O(b) serve step."""

    def __init__(self, g: Graph, cfg: GNNConfig, params, vq_states,
                 batch: int, *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if batch > g.n:
            batch = g.n            # the id pool bounds a useful micro-batch
        self.g, self.cfg, self.batch = g, cfg, batch
        self.ops = full_operands(g, device=self.device)
        self.plan = build_epoch_plan(g, full_ops=self.ops)
        self.x = torch.from_numpy(g.features).to(self.device)
        self.params = params
        self.vq = list(vq_states)
        self.f_out = _layer_out_dims(cfg)[-1][1]

    def graph_state_bytes_per_device(self) -> int:
        """Bytes of the serving graph state (plan + features + degrees)."""
        return int(sum(
            t.numel() * t.element_size()
            for t in (self.plan.nbr_ids, self.plan.nbr_mask,
                      self.plan.rev_ids, self.plan.rev_mask, self.x,
                      self.ops.degrees)))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refresh(self) -> float:
        """Refresh every layer's codeword assignment from the current
        features (inductive inference executor, paper Sec. 6).  Returns
        wall seconds, synchronised with the device."""
        t0 = time.time()
        ids, sm = inference_slices(self.g.n, self.batch)
        _, self.vq = vq_infer_epoch(
            self.params, self.vq, self.plan,
            torch.from_numpy(ids.astype(np.int32)).to(self.device),
            torch.from_numpy(sm).to(self.device),
            self.x, self.ops.degrees, self.cfg, inductive=True)
        self._sync()
        return time.time() - t0

    def warmup(self) -> float:
        """One step on the static batch shape (first-use costs: kernel
        library load, allocator growth); returns wall seconds."""
        t0 = time.time()
        self.step(np.zeros(self.batch, np.int64))
        return time.time() - t0

    def step(self, bids: np.ndarray) -> np.ndarray:
        """One device step over exactly ``batch`` node-id slots."""
        if len(bids) != self.batch:
            raise ValueError(
                f"serve step needs exactly {self.batch} id slots, got "
                f"{len(bids)} (use serve() for arbitrary request sizes)")
        ids_d = torch.from_numpy(
            np.asarray(bids).astype(np.int32)).to(self.device)
        y = vq_serve_batch(self.params, self.vq, self.plan, ids_d, self.x,
                           self.ops.degrees, self.cfg)
        return y.cpu().numpy()

    def serve(self, node_ids: np.ndarray) -> np.ndarray:
        """Serve one request of arbitrary size (pads the tail step by
        repeating id 0; duplicate ids are safe, see ``vq_serve_batch``)."""
        node_ids = np.asarray(node_ids)
        if len(node_ids) == 0:
            return np.zeros((0, self.f_out), np.float32)
        outs = []
        for s in range(0, len(node_ids), self.batch):
            chunk = node_ids[s:s + self.batch]
            pad = self.batch - len(chunk)
            step_ids = np.concatenate(
                [chunk, np.zeros(pad, chunk.dtype)]) if pad else chunk
            outs.append(self.step(step_ids)[:len(chunk)])
        return np.concatenate(outs, axis=0)


def drain_requests(server: GNNServer, requests: Sequence[np.ndarray]
                   ) -> dict:
    """Closed-loop micro-batching drain: every queued request contributes
    slots to the next static [batch] step until the step is full.  A
    request completes when its last slot's step returns; latency is
    measured against the drain start (all requests enqueued at t0)."""
    b = server.batch
    pend = deque((i, np.asarray(r, np.int64)) for i, r in enumerate(requests))
    remaining = [len(np.asarray(r)) for r in requests]
    done = np.zeros(len(requests))
    step_lat: list[float] = []
    n_nodes = 0
    t0 = time.time()
    while pend:
        slots, members, filled = [], [], 0
        while pend and filled < b:
            i, ids = pend.popleft()
            take = min(b - filled, len(ids))
            slots.append(ids[:take])
            members.append((i, take))
            filled += take
            if take < len(ids):
                pend.appendleft((i, ids[take:]))
        flat = np.concatenate(slots)
        if filled < b:
            flat = np.concatenate([flat, np.zeros(b - filled, np.int64)])
        ts = time.time()
        server.step(flat)
        now = time.time()
        step_lat.append(now - ts)
        n_nodes += filled
        for i, take in members:
            remaining[i] -= take
            if remaining[i] == 0:
                done[i] = now - t0
    wall = time.time() - t0
    lat = np.sort(done)
    sl = np.sort(np.asarray(step_lat))

    def pct(a, q):
        return float(a[min(len(a) - 1, int(q * len(a)))]) if len(a) else 0.0
    return {
        "requests": len(requests), "steps": len(step_lat),
        "nodes": int(n_nodes), "wall_s": wall,
        "nodes_per_s": n_nodes / max(wall, 1e-9),
        "requests_per_s": len(requests) / max(wall, 1e-9),
        "step_p50_ms": pct(sl, 0.50) * 1e3,
        "step_p99_ms": pct(sl, 0.99) * 1e3,
        "request_p50_ms": pct(lat, 0.50) * 1e3,
        "request_p99_ms": pct(lat, 0.99) * 1e3,
    }


def make_requests(n: int, count: int, max_request: int,
                  seed: int) -> list[np.ndarray]:
    """``count`` requests of U[1, max_request] node ids each, from ``seed``
    (the reference's request stream, draw for draw)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_request + 1, count)
    return [rng.integers(0, n, sz) for sz in sizes]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256,
                    help="static serve micro-batch (node slots per step)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-request", type=int, default=64,
                    help="request sizes ~ U[1, max-request] nodes")
    ap.add_argument("--backbone", default="gcn",
                    choices=["gcn", "sage", "gat", "gin", "transformer"])
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--train-epochs", type=int, default=0,
                    help="train the model with train_vq for N epochs "
                    "(batch --batch) before serving")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data mesh over N devices (not in this slice)")
    ap.add_argument("--shard-graph", action="store_true",
                    help="row-shard the graph state (not in this slice)")
    ap.add_argument("--precision", default="fp32",
                    choices=list(kops.PRECISIONS),
                    help="kernel operand precision tier: int8/fp8 serve "
                    "uint8 assignment tables + int8/fp8 codeword "
                    "snapshots; the '+a4' tiers nibble-pack the tables "
                    "(k <= 16, 2 ids/byte)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    return ap


def _reject_unported(args: argparse.Namespace) -> None:
    if args.mesh or args.shard_graph:
        raise NotImplementedError(
            f"--mesh / --shard-graph come with {MESH_SLICE}")


def build_server(args: argparse.Namespace) -> GNNServer:
    """Graph, config, weights (random from ``--seed``, or trained for
    ``--train-epochs``) and the server, the VQ states built under
    ``--precision`` and converted to its storage.  The tier setting holds
    while the states are built and is reset after: serving reads the
    storage types, not the setting."""
    _reject_unported(args)
    dev = resolve_device(args.device)
    from repro_torch.graph.datasets import synthetic_arxiv
    g = synthetic_arxiv(n=args.n, seed=args.seed)
    cfg = GNNConfig(backbone=args.backbone, f_in=g.f, hidden=args.hidden,
                    n_out=g.num_classes, n_layers=args.layers,
                    codebook=CodebookConfig(k=args.k, f_prod=4))
    kops.configure_kernel_precision(args.precision)
    try:
        if args.train_epochs > 0:
            r = train_vq(g, cfg, epochs=args.train_epochs,
                         batch_size=args.batch, eval_every=args.train_epochs,
                         device=dev)
            params, vq = r["params"], r["vq_states"]
        else:
            gen = torch.Generator().manual_seed(args.seed)
            params = init_gnn(cfg, gen, device=dev)
            vq = init_vq_states(cfg, g.n, gen, device=dev)
        if args.precision != "fp32":
            vq = quantize_vq_states(vq, cfg, precision=args.precision)
    finally:
        kops.configure_kernel_precision(reset=True)
    return GNNServer(g, cfg, params, vq, args.batch, device=dev)


def vq_state_bytes(vq_states) -> int:
    """Bytes of the VQ operands the serve step's kernels read: every
    layer's assignment table and, under a quantized tier, its codeword
    snapshot (values and scales), as the reference counts them."""
    return int(sum(tree_bytes((s.assignment,) if s.qcw is None
                              else (s.assignment, s.qcw)) for s in vq_states))


def run(args: argparse.Namespace) -> tuple[GNNServer, dict]:
    """Build, refresh, warm up and drain ``--requests`` requests."""
    server = build_server(args)
    t_refresh = server.refresh()
    t_warm = server.warmup()
    requests = make_requests(server.g.n, args.requests, args.max_request,
                             args.seed)
    report = drain_requests(server, requests)
    report.update({
        "graph_n": server.g.n, "batch": server.batch,
        "backbone": args.backbone, "precision": args.precision,
        "device": str(server.device),
        "device_name": torch.cuda.get_device_name(server.device)
        if server.device.type == "cuda" else "cpu",
        "graph_state_bytes_per_device":
            server.graph_state_bytes_per_device(),
        "vq_state_bytes": vq_state_bytes(server.vq),
        "refresh_s": t_refresh, "warmup_s": t_warm})
    return server, report


def main(argv: Sequence[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    _, report = run(args)
    print(f"serve_gnn {args.backbone} n={report['graph_n']} "
          f"batch={report['batch']} device={report['device_name']} "
          f"precision={args.precision} (vq operand bytes "
          f"{report['vq_state_bytes']}): refresh {report['refresh_s']:.2f}s, "
          f"warmup {report['warmup_s']:.2f}s")
    print(f"  {report['nodes']} nodes / {report['requests']} requests in "
          f"{report['wall_s']:.3f}s -> {report['nodes_per_s']:.0f} nodes/s, "
          f"{report['requests_per_s']:.1f} req/s")
    print(f"  step   p50 {report['step_p50_ms']:.2f} ms   "
          f"p99 {report['step_p99_ms']:.2f} ms")
    print(f"  request p50 {report['request_p50_ms']:.2f} ms   "
          f"p99 {report['request_p99_ms']:.2f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return report


if __name__ == "__main__":
    main()
