"""GNN serving endpoint on the H100: codeword-context inference as a
traffic-shaped service (torch twin of ``repro.launch.serve_gnn``).

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --n 169343 \
        --hidden 128 --layers 3 --k 1024 --batch 256 --requests 200 \
        [--backbone {gcn,sage,gat,gin,transformer}] \
        [--precision {fp32,int8,fp8,int8+a4,fp8+a4}] [--device cpu] \
        [--mesh N [--shard-graph] [--share-device]] [--json out.json]

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
codewords (their layers read no quantized snapshot).

``--mesh N`` serves from N ranks, one process each
(``distributed.ranks.run_ranks``: gloo on the CPU, NCCL with a card per
rank, or gloo with every rank on the one card under ``--share-device``).
Rank 0 draws the requests and drives ``drain_requests``; the ids of each
step are broadcast to the other ranks.  Without ``--shard-graph`` the mesh
is a throughput knob: every rank holds the whole graph state and plans
the whole step, computes b/N of its rows at every layer from the whole
batch's activations and all-gathers them (``vq_serve_batch_rows``), so
the rows are ``--mesh 1``'s.  ``--shard-graph`` makes it a
capacity knob (DESIGN.md section 14): plan and feature tables are
row-sharded over the ranks (``ShardedGraphState``), the refresh sweeps
the ranks' shares of the batches, each step's ids are replicated and its
rows gathered cross-shard, and the forward is exact -- the rows are
``--mesh 1``'s.  The report gains ``mesh``, ``shard_graph`` and the
per-rank graph-state bytes, and ``rows_sha256``, a digest of every served
row in order (equal digests, equal rows).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.codebook import CodebookConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.data_parallel import (ShardedGraphState,
                                                   vq_infer_epoch_sharded,
                                                   vq_serve_batch_sharded)
from repro_torch.distributed.quantization import tree_bytes
from repro_torch.distributed.ranks import run_ranks
from repro_torch.distributed.sharding import per_device_bytes
from repro_torch.graph.batching import (build_epoch_plan, full_operands,
                                        inference_slices)
from repro_torch.graph.structure import Graph
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn import (GNNConfig, _layer_out_dims, init_gnn,
                                    init_vq_states, quantize_vq_states,
                                    vq_infer_epoch, vq_serve_batch,
                                    vq_serve_batch_rows)
from repro_torch.runtime import resolve_device
from repro_torch.train.gnn_trainer import train_vq


class GNNServer:
    """Device-resident serving state + the O(b) serve step.

    With ``mesh`` every rank of it builds its own server with the same
    arguments (on the mesh's device): rank 0 drives ``step`` and the
    others run ``follow`` until rank 0's ``release``.  Without
    ``shard_graph`` each rank computes b/N rows of a step at every layer
    (``batch`` must divide); with it the graph state is row-sharded.  Both
    serve the unsharded server's rows."""

    def __init__(self, g: Graph, cfg: GNNConfig, params, vq_states,
                 batch: int, *, device: str | torch.device = "cuda",
                 mesh=None, shard_graph: bool = False):
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        if batch > g.n:
            batch = g.n            # the id pool bounds a useful micro-batch
        if mesh is not None and not shard_graph \
                and batch % mesh.world_size != 0:
            # the throughput mode splits the batch axis; the sharded-state
            # mode replicates the ids, so any batch size serves
            raise ValueError(
                f"serve micro-batch {batch} is not divisible by the "
                f"{mesh.world_size}-rank data mesh")
        if shard_graph and mesh is None:
            raise ValueError(
                "shard_graph=True row-shards the graph state over a "
                "mesh -- pass mesh= (graph_dp_mesh) as well")
        self.g, self.cfg, self.batch, self.mesh = g, cfg, batch, mesh
        self.ops = full_operands(g, device=self.device)
        self.plan = build_epoch_plan(g, full_ops=self.ops)
        self.x = torch.from_numpy(g.features).to(self.device)
        self.params = params
        self.vq = list(vq_states)
        self.f_out = _layer_out_dims(cfg)[-1][1]
        self.sstate = None
        if shard_graph:
            self.sstate = ShardedGraphState(mesh, self.plan, self.x,
                                            self.ops.degrees)
            # only the blocks are served from; the whole tables go
            self.ops = self.plan = self.x = None

    def graph_state_bytes_per_device(self) -> int:
        """Bytes of the serving graph state (plan + features + degrees) on
        this rank: the --mesh capacity metric."""
        if self.sstate is not None:
            return self.sstate.per_device_bytes()
        return per_device_bytes([self.plan, self.x, self.ops.degrees])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refresh(self) -> float:
        """Refresh every layer's codeword assignment from the current
        features (inductive inference executor, paper Sec. 6): on a mesh
        every rank calls it, and each derives the same states (the
        sharded executor splits the batches over the ranks; the
        throughput mode runs the whole sweep on each).  Returns wall
        seconds, synchronised with the device."""
        t0 = time.time()
        ids, sm = inference_slices(self.g.n, self.batch)
        ids_d = torch.from_numpy(ids.astype(np.int32)).to(self.device)
        sm_d = torch.from_numpy(sm).to(self.device)
        if self.sstate is not None:
            _, self.vq = vq_infer_epoch_sharded(
                self.sstate, self.params, self.vq, ids_d, sm_d, self.cfg,
                inductive=True)
        else:
            _, self.vq = vq_infer_epoch(
                self.params, self.vq, self.plan, ids_d, sm_d, self.x,
                self.ops.degrees, self.cfg, inductive=True)
        self._sync()
        return time.time() - t0

    def warmup(self) -> float:
        """One step on the static batch shape (first-use costs: kernel
        library load, allocator growth); returns wall seconds."""
        t0 = time.time()
        self.step(np.zeros(self.batch, np.int64))
        return time.time() - t0

    def step(self, bids: np.ndarray) -> np.ndarray:
        """One device step over exactly ``batch`` node-id slots (on a mesh:
        rank 0's call, broadcasting the ids to the following ranks)."""
        if len(bids) != self.batch:
            raise ValueError(
                f"serve step needs exactly {self.batch} id slots, got "
                f"{len(bids)} (use serve() for arbitrary request sizes)")
        if self.mesh is not None:
            self._broadcast(np.concatenate([[1], np.asarray(bids)]))
        return self._step(np.asarray(bids))

    def _broadcast(self, msg: np.ndarray | None) -> np.ndarray:
        t = torch.zeros(self.batch + 1, dtype=torch.int64,
                        device=self.device)
        if msg is not None:
            t.copy_(torch.from_numpy(msg.astype(np.int64)))
        return collectives.broadcast(t, self.mesh).cpu().numpy()

    def follow(self) -> int:
        """A following rank's loop: serve every step rank 0 broadcasts until
        its ``release``; returns the number of steps served."""
        steps = 0
        while True:
            msg = self._broadcast(None)
            if msg[0] == 0:
                return steps
            self._step(msg[1:])
            steps += 1

    def release(self) -> None:
        """Rank 0's end of the serving loop: the following ranks return
        from ``follow`` (no-op without a mesh)."""
        if self.mesh is not None:
            self._broadcast(np.zeros(self.batch + 1, np.int64))

    def _step(self, bids: np.ndarray) -> np.ndarray:
        ids_d = torch.from_numpy(bids.astype(np.int32)).to(self.device)
        if self.sstate is not None:
            y = vq_serve_batch_sharded(self.sstate, self.params, self.vq,
                                       ids_d, self.cfg)
        elif self.mesh is not None:
            y = vq_serve_batch_rows(self.params, self.vq, self.plan, ids_d,
                                    self.x, self.ops.degrees, self.cfg,
                                    mesh=self.mesh)
        else:
            y = vq_serve_batch(self.params, self.vq, self.plan, ids_d,
                               self.x, self.ops.degrees, self.cfg)
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


def drain_requests(server: GNNServer, requests: Sequence[np.ndarray],
                   outputs: list | None = None) -> dict:
    """Closed-loop micro-batching drain: every queued request contributes
    slots to the next static [batch] step until the step is full.  A
    request completes when its last slot's step returns; latency is
    measured against the drain start (all requests enqueued at t0).
    ``outputs``, when given, receives each step's rows of its filled
    slots, in order."""
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
        y = server.step(flat)
        now = time.time()
        step_lat.append(now - ts)
        if outputs is not None:
            outputs.append(y[:filled])
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
                    help="serve from an N-rank data mesh, one process a "
                    "rank (throughput mode: each rank computes b/N rows "
                    "of every layer)")
    ap.add_argument("--shard-graph", action="store_true",
                    help="with --mesh N: row-shard the graph state over "
                    "the ranks (capacity mode -- per-rank graph bytes "
                    "drop ~1/N, DESIGN.md section 14)")
    ap.add_argument("--share-device", action="store_true",
                    help="with --mesh N and --device cuda: every rank on "
                    "the one card, over gloo (NCCL needs a card a rank)")
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


def build_server(args: argparse.Namespace, mesh=None) -> GNNServer:
    """Graph, config, weights (random from ``--seed``, or trained for
    ``--train-epochs``) and the server, the VQ states built under
    ``--precision`` and converted to its storage.  The tier setting holds
    while the states are built and is reset after: serving reads the
    storage types, not the setting.  On a mesh (``--shard-graph`` read
    from ``args``) each rank builds the same weights on its device."""
    if args.shard_graph and not args.mesh:
        raise ValueError("--shard-graph row-shards the graph state over a "
                         "mesh -- pass --mesh N as well")
    dev = mesh.device if mesh is not None else resolve_device(args.device)
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
    return GNNServer(g, cfg, params, vq, args.batch, device=dev, mesh=mesh,
                     shard_graph=args.shard_graph)


def vq_state_bytes(vq_states) -> int:
    """Bytes of the VQ operands the serve step's kernels read: every
    layer's assignment table and, under a quantized tier, its codeword
    snapshot (values and scales), as the reference counts them."""
    return int(sum(tree_bytes((s.assignment,) if s.qcw is None
                              else (s.assignment, s.qcw)) for s in vq_states))


def rows_digest(rows: Sequence[np.ndarray]) -> str:
    """sha256 of served rows in order (-0.0 read as +0.0)."""
    if not rows:
        return hashlib.sha256(b"").hexdigest()
    flat = np.ascontiguousarray(np.concatenate(rows), np.float32)
    return hashlib.sha256((flat + np.float32(0.0)).tobytes()).hexdigest()


def run(args: argparse.Namespace, mesh=None
        ) -> tuple[GNNServer, dict | None]:
    """Build, refresh, warm up and drain ``--requests`` requests; on a
    mesh every rank calls it, rank 0 drives and returns the report, the
    others follow and return None."""
    server = build_server(args, mesh)
    t_refresh = server.refresh()
    if mesh is not None and mesh.rank != 0:
        server.follow()
        return server, None
    rows: list[np.ndarray] = []
    try:
        t_warm = server.warmup()
        requests = make_requests(server.g.n, args.requests, args.max_request,
                                 args.seed)
        report = drain_requests(server, requests, rows)
    finally:
        server.release()
    report.update({
        "graph_n": server.g.n, "batch": server.batch,
        "backbone": args.backbone, "precision": args.precision,
        "device": str(server.device),
        "device_name": torch.cuda.get_device_name(server.device)
        if server.device.type == "cuda" else "cpu",
        "mesh": args.mesh or 1, "shard_graph": bool(args.shard_graph),
        "graph_state_bytes_per_device":
            server.graph_state_bytes_per_device(),
        "vq_state_bytes": vq_state_bytes(server.vq),
        "refresh_s": t_refresh, "warmup_s": t_warm,
        "rows_sha256": rows_digest(rows)})
    return server, report


def _serve_rank(mesh, args: argparse.Namespace) -> dict | None:
    return run(args, mesh)[1]


def serve_on_mesh(args: argparse.Namespace) -> dict:
    """``run`` on ``--mesh`` ranks (gloo on the CPU or, with
    ``--share-device``, on the one card; NCCL otherwise); rank 0's
    report."""
    return run_ranks(_serve_rank, args.mesh, None, args.device, args,
                     share_device=args.share_device)[0]


def main(argv: Sequence[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    report = serve_on_mesh(args) if args.mesh else run(args)[1]
    print(f"serve_gnn {args.backbone} n={report['graph_n']} "
          f"batch={report['batch']} device={report['device_name']} "
          f"mesh={report['mesh']}"
          f"{' (row-sharded graph state)' if args.shard_graph else ''} "
          f"precision={args.precision} (vq operand bytes "
          f"{report['vq_state_bytes']}, graph state "
          f"{report['graph_state_bytes_per_device']} B/device): refresh "
          f"{report['refresh_s']:.2f}s, warmup {report['warmup_s']:.2f}s")
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
