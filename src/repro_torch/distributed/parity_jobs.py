"""Rank-side halves of the multi-device checks.

Each job takes a rank's :class:`~repro_torch.distributed.sharding.
GraphMesh` and numpy inputs, runs the port's sharded code on that rank
and returns numpy outputs, so a caller can run every job on ranks spawned
by :func:`repro_torch.distributed.ranks.run_ranks` (one spawn for all of
them, :func:`run_jobs`) and hold the results against a reference in its
own process.  States cross as numpy: params as lists of ``{name: array}``
dicts, VQ states as objects with the fields ``convert.vq_states_from_
numpy`` reads (``types.SimpleNamespace`` pickles without importing any
other package), and come back as :func:`np_states` dicts.
"""
from __future__ import annotations

import contextlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import codebook as cbm
from repro_torch.core.codebook import CodebookConfig, CodebookState
from repro_torch.distributed import collectives as col
from repro_torch.distributed import data_parallel as dp
from repro_torch.distributed.sharding import GraphMesh, shard_rows
from repro_torch.graph.batching import build_epoch_plan, full_operands
from repro_torch.graph.datasets import synthetic_arxiv
from repro_torch.models.gnn import (GNNConfig, init_gnn, init_vq_states,
                                    vq_serve_batch_rows)
from repro_torch.train.gnn_trainer import train_vq
from repro_torch.train.optimizer import rmsprop


def np_params(params) -> list[dict]:
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]


def np_states(states) -> list[dict]:
    """Per layer: the codebook's fields, the assignment table (int32) and
    the counts, as numpy."""
    out = []
    for st in states:
        d = {f: getattr(st.codebook, f).cpu().numpy()
             for f in CodebookState._fields}
        d["assignment"] = st.assignment.cpu().numpy()
        d["counts"] = st.counts.cpu().numpy()
        out.append(d)
    return out


def state_namespace(codebook: dict, assignment, counts) -> SimpleNamespace:
    """A picklable VQ state for ``convert.vq_states_from_numpy``."""
    return SimpleNamespace(codebook=SimpleNamespace(**codebook),
                           assignment=np.asarray(assignment),
                           counts=np.asarray(counts), qcw=None)


def _np_opt(ost) -> dict:
    return {"step": int(ost.step), "mu": np_params(ost.mu),
            "nu": np_params(ost.nu)}


def _epoch_out(res) -> dict:
    params, states, ost, losses, errs = res
    return {"params": np_params(params), "states": np_states(states),
            "opt": _np_opt(ost), "losses": losses.cpu().numpy(),
            "errs": errs.cpu().numpy()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives_job(mesh: GraphMesh, gathers: dict, scatters: dict,
                    psums: dict) -> dict:
    """``gathers``: name -> (padded global table, ids [ndev, b], compress);
    each rank passes its row block and its ids row.  ``scatters``: name ->
    (padded table, ids [ndev, b], rows [ndev, b, ...]).  ``psums``: name ->
    (x [ndev, ...], residual [ndev, ...] or None), through
    ``compressed_psum``, plus the tree form over all of them.  Fp8 tables
    cross as ``(uint8 bytes, "fp8")``."""
    r = mesh.rank
    out = {}
    for name, (table, ids, compress) in gathers.items():
        fp8 = isinstance(table, tuple)
        raw = torch.from_numpy(table[0] if fp8 else table)
        blk = shard_rows(raw, mesh, raw.shape[0])
        if fp8:
            blk = blk.view(torch.float8_e4m3fn)
        got = col.gather_from_shards(blk, torch.from_numpy(ids[r]), mesh,
                                     compress=compress)
        out[f"gather/{name}"] = (got.view(torch.uint8) if fp8
                                 else got).numpy()
    for name, (table, ids, rows) in scatters.items():
        blk = shard_rows(torch.from_numpy(table), mesh, table.shape[0])
        got = col.shard_scatter_rows(blk, torch.from_numpy(ids[r]),
                                     torch.from_numpy(rows[r]), mesh)
        out[f"scatter/{name}"] = col.all_gather_rows(got, mesh).numpy()
    xs, rs = [], []
    for name, (x, res) in psums.items():
        s, nr = col.compressed_psum(
            torch.from_numpy(x[r]), mesh,
            None if res is None else torch.from_numpy(res[r]))
        out[f"psum/{name}"] = (s.numpy(), nr.numpy())
        xs.append(torch.from_numpy(x[r]))
        rs.append(None if res is None else torch.from_numpy(res[r]))
    if xs:
        tree = {str(i): x for i, x in enumerate(xs)}
        res = None if any(r_ is None for r_ in rs) else \
            {str(i): r_ for i, r_ in enumerate(rs)}
        sums, news = col.compressed_grad_allreduce(tree, mesh, res)
        out["tree"] = ([sums[str(i)].numpy() for i in range(len(xs))],
                       [news[str(i)].numpy() for i in range(len(xs))])
        exact = col.psum_tree(tree, mesh)
        out["psum_tree"] = [exact[str(i)].numpy() for i in range(len(xs))]
    return out


def codebook_job(mesh: GraphMesh, codebook: dict, feats: np.ndarray,
                 grads: np.ndarray, cfg: dict) -> dict:
    """``codebook.update(mesh=)`` on this rank's rows ``feats[rank]`` /
    ``grads[rank]``; the new state's fields and this rank's stats."""
    state = CodebookState(*(torch.from_numpy(np.asarray(codebook[f]))
                            for f in CodebookState._fields))
    new, stats = cbm.update(state, torch.from_numpy(feats[mesh.rank]),
                            torch.from_numpy(grads[mesh.rank]),
                            CodebookConfig(**cfg), mesh=mesh)
    return {"state": {f: getattr(new, f).numpy()
                      for f in CodebookState._fields},
            "assignment": stats.assignment.numpy(),
            "qerr": stats.qerr.numpy()}


# ---------------------------------------------------------------------------
# the GNN executors
# ---------------------------------------------------------------------------

class _Setup:
    """One rank's copy of a parity setup: graph, config, tables and the
    carried state, from the numpy ``spec``."""

    def __init__(self, mesh: GraphMesh, spec: dict):
        dev = mesh.device
        self.g = synthetic_arxiv(n=spec["n"], seed=spec["graph_seed"])
        self.cfg = GNNConfig(f_in=self.g.f, n_out=self.g.num_classes,
                             codebook=CodebookConfig(**spec["codebook"]),
                             **spec["model"])
        self.ops = full_operands(self.g, device=dev)
        self.plan = build_epoch_plan(self.g, full_ops=self.ops)
        self.x = torch.from_numpy(self.g.features).to(dev)
        self.labels = torch.from_numpy(self.g.labels).to(dev)
        tm = np.zeros(self.g.n, np.float32)
        tm[self.g.train_idx] = 1.0
        self.tm = torch.from_numpy(tm).to(dev)
        self.opt = rmsprop(spec["lr"])
        self.spec, self.dev = spec, dev

    def state(self):
        s = self.spec
        return (convert.params_from_numpy(s["params"], self.dev),
                convert.vq_states_from_numpy(s["states"], self.dev),
                convert.opt_state_from_numpy(SimpleNamespace(**s["opt"]),
                                             self.dev))

    def sharded(self, mesh: GraphMesh, labels: bool = True):
        return dp.ShardedGraphState(
            mesh, self.plan, self.x, self.ops.degrees,
            labels=self.labels if labels else None,
            train_mask=self.tm if labels else None)


def epoch_job(mesh: GraphMesh, spec: dict, sharded: bool = True) -> dict:
    """From the carried state of ``spec``: one ``vq_train_epoch_dp`` and
    (with ``sharded``) one ``vq_train_epoch_sharded`` over ``spec["perm"]``
    / ``spec["smask"]``, and one with the feature rows moved as int8
    (``compress=True``)."""
    su = _Setup(mesh, spec)
    perm = torch.from_numpy(spec["perm"])
    smask = torch.from_numpy(spec["smask"])
    out = {"dp": _epoch_out(dp.vq_train_epoch_dp(
        mesh, *su.state(), su.plan, perm, smask, su.x, su.labels, su.tm,
        su.ops.degrees, su.cfg, su.opt))}
    if sharded:
        st = su.sharded(mesh)
        out["sharded"] = _epoch_out(dp.vq_train_epoch_sharded(
            st, *su.state(), perm, smask, su.cfg, su.opt))
        out["compressed"] = _epoch_out(dp.vq_train_epoch_sharded(
            st, *su.state(), perm, smask, su.cfg, su.opt, compress=True))
    return out


def infer_serve_job(mesh: GraphMesh, spec: dict) -> dict:
    """From the state of ``spec``: the inductive ``vq_infer_epoch_sharded``
    over ``spec["infer_perm"]`` / ``spec["infer_smask"]`` (the whole [n,
    f_out] table and the refreshed states) and ``vq_serve_batch_sharded``
    of ``spec["serve_ids"]``, on a state built without labels; with the
    graph-state bytes of this rank."""
    su = _Setup(mesh, spec)
    params, states, _ = su.state()
    st = su.sharded(mesh, labels=False)
    acts, new_states = dp.vq_infer_epoch_sharded(
        st, params, states, torch.from_numpy(spec["infer_perm"]),
        torch.from_numpy(spec["infer_smask"]), su.cfg, inductive=True)
    rows = dp.vq_serve_batch_sharded(st, params, states,
                                     torch.from_numpy(spec["serve_ids"]),
                                     su.cfg)
    return {"acts": st.unshard(acts), "states": np_states(new_states),
            "serve": rows.cpu().numpy(), "bytes": st.per_device_bytes(),
            "n_local": st.n_local}


def seeded_model(cfg: GNNConfig, n: int, device) -> tuple:
    """Params from seed 0 and VQ states from seed 1 (CPU draws)."""
    return (init_gnn(cfg, torch.Generator().manual_seed(0), device=device),
            init_vq_states(cfg, n, torch.Generator().manual_seed(1),
                           device=device))


def serve_rows_job(mesh: GraphMesh, spec: dict, backbone: str) -> np.ndarray:
    """``vq_serve_batch_rows`` (the serving mesh's throughput mode) of
    ``spec["serve_ids"]`` on a ``backbone`` model of ``spec``'s widths,
    weights and states from :func:`seeded_model`."""
    su = _Setup(mesh, dict(spec, model=dict(spec["model"],
                                            backbone=backbone)))
    params, states = seeded_model(su.cfg, su.g.n, su.dev)
    return vq_serve_batch_rows(
        params, states, su.plan,
        torch.from_numpy(spec["serve_ids"]).to(su.dev), su.x,
        su.ops.degrees, su.cfg, mesh=mesh).cpu().numpy()


def train_job(mesh: GraphMesh, spec: dict, epochs: int, batch: int) -> dict:
    """``train_vq(mesh=)`` and ``train_vq(mesh=, shard_graph=True)`` for
    ``epochs`` epochs at ``batch`` from seed 0."""
    su = _Setup(mesh, spec)
    out = {}
    for name, shard in (("dp", False), ("sharded", True)):
        r = train_vq(su.g, su.cfg, epochs=epochs, batch_size=batch,
                     eval_every=epochs, mesh=mesh, shard_graph=shard)
        out[name] = {"params": np_params(r["params"]),
                     "states": np_states(r["vq_states"]),
                     "losses": r["step_losses"], "errs": r["step_vq_errs"],
                     "final": {k: v for k, v in r["final"].items()
                               if k != "time"}}
    return out


JOBS = {"collectives": collectives_job, "codebook": codebook_job,
        "epoch": epoch_job, "infer_serve": infer_serve_job,
        "serve_rows": serve_rows_job, "train": train_job}


def run_jobs(mesh: GraphMesh, jobs: dict) -> dict:
    """Every job of ``jobs`` (name -> (job in :data:`JOBS`, kwargs)) on
    this rank, in order; their outputs by name."""
    return {name: JOBS[job](mesh, **kw) for name, (job, kw) in jobs.items()}


# ---------------------------------------------------------------------------
# the LM mesh: one sharded training step on a (data, model) host mesh
# ---------------------------------------------------------------------------

def lm_state_numpy(state) -> dict:
    """{reference path string: array} of every leaf of an LM state (full
    tensors; bf16 as f32)."""
    from repro_torch.distributed.sharding import leaf_paths
    from repro_torch.train.checkpoint import _to_numpy
    return {p: _to_numpy(t) for p, t in leaf_paths(state)}


def lm_state_like(cfg, opt):
    """The structure, shapes and dtypes of ``cfg``'s LM ``TrainState``
    under ``opt``, as fake tensors (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainState
    with FakeTensorMode():
        params = lm.init_lm(cfg, device="cpu")
        return TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32))


def lm_state_from_numpy(like, flat: dict, device) -> "TrainState":
    """``like``'s structure with each leaf from ``flat`` (by path), in the
    leaf's dtype on ``device``."""
    from repro_torch.distributed.sharding import map_with_path
    return map_with_path(lambda p, t: torch.from_numpy(
        np.array(flat[p])).to(device=device, dtype=t.dtype), like)


def lm_step_job(mesh: GraphMesh, arch: str, strategy: str, flat: dict,
                tokens: np.ndarray, accum: int, model: int,
                lr: float, clip_norm: float | None = None,
                sync: bool = False, ckpt: bool | None = None) -> dict:
    """One ``launch.train.build_sharded_step`` step of ``arch``'s smoke
    config from the carried state ``flat`` on a (world / model, model)
    host mesh over the ranks, the strategy forced, with Adam under
    ``warmup_cosine(lr, 2, 20)`` and ``clip_norm`` (None: no clipping),
    ``accum`` microbatches accumulated in f32 (the reference's
    ``make_train_step`` default):
    loss, gradient norm, the new state gathered whole, and each leaf's
    local shape.  ``sync`` routes DTensor's collectives through the
    synchronous calls for the step (``ranks.sync_functional_collectives``,
    as ranks sharing a card run).  ``ckpt`` (True: ``async_write``) then
    saves the new state to a directory of rank 0's, shared by the ranks,
    and restores it into the sharded layout: the file's arrays
    (``file``, rank 0) and the restored state gathered whole
    (``restored``)."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.distributed.sharding import distribute, gather_full
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_sharded_step
    from repro_torch.distributed.ranks import sync_functional_collectives
    from repro_torch.train.optimizer import adam, warmup_cosine
    cfg = SMOKES[arch]()
    dmesh = make_host_mesh(model=model, device=mesh.device)
    opt = adam(warmup_cosine(lr, 2, 20), clip_norm=clip_norm)
    step, state_sh = build_sharded_step(cfg, dmesh, opt, accum, strategy,
                                        accum_dtype=torch.float32)
    state = distribute(lm_state_from_numpy(lm_state_like(cfg, opt), flat,
                                           mesh.device), state_sh)
    with sync_functional_collectives(mesh.device.type) if sync \
            else contextlib.nullcontext():
        new, metrics = step(state, torch.as_tensor(tokens).to(mesh.device))
    from repro_torch.distributed.sharding import leaf_paths
    local = {p: tuple(t.to_local().shape) for p, t in leaf_paths(new)}
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "state": lm_state_numpy(gather_full(new)), "local": local}
    if ckpt is not None:
        out.update(_ckpt_round_trip(new, ckpt))
    return out


def _ckpt_round_trip(state, async_write: bool) -> dict:
    """``state`` (DTensor leaves) saved as checkpoint 1 under a directory
    that rank 0 makes and broadcasts, then restored into its own layout;
    the file's arrays by reference path on rank 0, and the restored state
    gathered whole."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.train import checkpoint as ckpt
    name = [tempfile.mkdtemp(prefix="repro_torch_ckpt_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    try:
        t = ckpt.save(name[0], 1, state, async_write=async_write)
        if t is not None:
            t.join()
        dist.barrier()
        restored, manifest = ckpt.restore(name[0], state)
        assert manifest["step"] == 1
        out = {"restored": lm_state_numpy(gather_full(restored))}
        if dist.get_rank() == 0:
            with np.load(os.path.join(name[0], "step_1",
                                      "arrays.npz")) as z:
                # the file's "/"-joined paths as reference path strings
                out["file"] = {k.replace("/", ""): z[k] for k in z.files}
        dist.barrier()
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(name[0], ignore_errors=True)
    return out


def lm_step_jobs(mesh: GraphMesh, runs: list[dict]) -> list[dict]:
    """:func:`lm_step_job` for each keyword set of ``runs``, in order, in
    one spawn of the ranks."""
    return [lm_step_job(mesh, **r) for r in runs]
