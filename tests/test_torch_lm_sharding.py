"""The LM mesh of the PyTorch port against the JAX reference: the sharding
rules, the input specs, the analytic roofline, the spec-to-placement
translation, one sharded training step on four gloo CPU ranks, the
fake-rank dry-run and the launchers' meshes.

The rules' checks use the reference's pattern
(``tests/test_distributed.py:49-95``): an abstract mesh of the production
shapes (16, 16), (2, 16, 16) and the small (2, 2), no device touched.
Trees come from each package's own ``init_lm`` / ``opt.init`` /
``init_serve_cache``, abstractly (``jax.eval_shape``; the port's under a
``FakeTensorMode``), and leaves meet by the reference's path strings.

Tolerances:
  * strategies, specs, input shapes and dtypes: equal;
  * the analytic roofline: equal (the same float arithmetic);
    ``terms_from_cell`` equal up to the ratio of the two packages'
    hardware constants (``rtol=1e-12``);
  * the placement translation: each rank's shard array-equal to the
    slice JAX gives that device;
  * the sharded step: loss, gradient norm and every updated leaf
    (params and both Adam moments) ``rtol=1e-5, atol=1e-6`` against the
    unsharded port step and against the reference's step, all three from
    the reference's carried state (``tests/test_torch_lm_train.py:64``).
    f32, Adam at lr 1e-4 without clipping: at step 1 Adam moves a param
    by lr_t m / (sqrt(v) + eps), which for a gradient near the effective
    eps (~3e-7 here) amplifies a rounding difference of the gradient
    (the sharded reductions add in another order: ~1e-8 on gradients of
    order 1e-2) by ~2e5 x lr; clipping by a norm of ~12 multiplies that
    by ~140.  At lr 1e-4 the amplified rounding stays under 1e-7; the
    gradients themselves are held to ``rtol=1e-5, atol=1e-6`` through
    the first moment.
    With clipping, or two microbatches (the launcher's), the sharded
    step's params are held at the same tolerance on every element where
    the update is well-conditioned: lr_t / (sqrt(v) + eps), the gain from
    the first moment to its param, times the moment's tolerance within
    the param's (``chip_smoke.split_step_check``'s rule); the first
    moment, held on every element, holds the rest.  The sharded
    checkpoint (rank 0 writes full tensors, every rank restores its
    shard) round-trips the new state exactly, synchronous and async.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import registry as jreg                   # noqa: E402
from repro.distributed import sharding as jshd               # noqa: E402
from repro.launch import input_specs as jspecs               # noqa: E402
from repro.launch import roofline as jroof                   # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.train import loop as jloop                        # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.configs.base import SHAPES                  # noqa: E402
from repro_torch.distributed import parity_jobs as pj        # noqa: E402
from repro_torch.distributed import sharding as tshd         # noqa: E402
from repro_torch.distributed.ranks import run_ranks          # noqa: E402
from repro_torch.launch import input_specs as tspecs         # noqa: E402
from repro_torch.launch import roofline as troof             # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch import train as ttrain               # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ARCHS = list(treg.ARCHS)
STRATEGIES = ("tp_fsdp", "moe_ep_dp", "fsdp", "replicate")
DECODE = [s for s, v in SHAPES.items() if v["kind"] == "decode"]
STEP_RUNS = [("granite-3-8b", "tp_fsdp"), ("qwen3-moe-30b-a3b", "moe_ep_dp"),
             ("llama3.2-3b", "fsdp")]
# the launcher's clipping and microbatches, each on a sharded step
STEP_VARIANTS = [("llama3.2-3b", "tp_fsdp", {"clip_norm": 1.0}),
                 ("granite-3-8b", "tp_fsdp", {"accum": 2})]
STEP_LR = 1e-4


class FakeMesh:
    """The reference's abstract mesh: axis names and sizes."""

    def __init__(self, dims, names):
        self.axis_names = names
        self.shape = dict(zip(names, dims))


@pytest.fixture
def abstract_named(monkeypatch):
    """The reference's ``NamedSharding`` binds a real device mesh; its
    rules only pair a mesh with a spec, so on an abstract mesh the pair
    is kept as it is."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec:
                        types.SimpleNamespace(mesh=mesh, spec=spec))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(spec) -> tuple:
    """A spec's entries as None or a tuple of axis names (JAX keeps a
    one-axis entry as a name or a 1-tuple, as given)."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _jpaths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"".join(str(p) for p in path): leaf for path, leaf in flat}


_TREES: dict = {}


def _train_trees(arch: str):
    """(reference, port) abstract train states of ``arch``, once."""
    if arch not in _TREES:
        jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
        jp = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
        jo = jax.eval_shape(jopt.adam(moment_dtype=jnp.bfloat16).init, jp)
        _TREES[arch] = (jp, jo,
                        tspecs.input_specs(tc, "train_4k")["state"])
    return _TREES[arch]


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_strategies_and_leaf_specs_match_reference(arch):
    """``strategy_for`` and every leaf's spec -- params and both Adam
    moments, under every strategy -- equal the reference's on the three
    mesh shapes; the leaves' path strings and shapes equal too, and every
    sharded dim divides."""
    jp, jo, ts = _train_trees(arch)
    jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
    for what, jtree, ttree in (("params", jp, ts.params),
                               ("mu", jo.mu, ts.opt.mu),
                               ("nu", jo.nu, ts.opt.nu)):
        jl, tl = _jpaths(jtree), dict(tshd.leaf_paths(ttree))
        assert list(jl) == list(tl), what
        for dims, names in MESHES.values():
            fm = ms = FakeMesh(dims, names)
            assert tshd.strategy_for(tc, ms) == jshd.strategy_for(jc, fm)
            sizes = dict(zip(names, dims))
            for strategy in STRATEGIES + (tshd.strategy_for(tc, ms),):
                got = tshd.param_shardings(ttree, tc, ms, strategy)
                for path, sh in tshd.leaf_paths(got):
                    shape = tuple(tl[path].shape)
                    assert shape == tuple(jl[path].shape), path
                    want = jshd._spec_for_leaf(path, shape, strategy, fm, jc)
                    assert _norm(sh.spec) == _norm(want), (path, strategy)
                    for d, e in zip(shape, _norm(sh.spec)):
                        n = int(np.prod([sizes[a] for a in e or ()]))
                        assert d % n == 0, (path, shape, sh.spec)


def test_production_strategies_as_the_reference_names_them():
    """The reference's table (``tests/test_distributed.py:49-66``)."""
    ms = FakeMesh((16, 16), ("data", "model"))
    want = {"granite-3-8b": "tp_fsdp", "qwen3-moe-30b-a3b": "moe_ep_dp",
            "llama3.2-3b": "fsdp", "whisper-tiny": "replicate"}
    assert {a: tshd.strategy_for(treg.ARCHS[a], ms) for a in want} == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_token_sharding_matches_reference(mesh, abstract_named):
    dims, names = MESHES[mesh]
    fm = ms = FakeMesh(dims, names)
    cfg = treg.ARCHS["granite-3-8b"]
    for batch in (1, 2, 4, 16, 32, 128, 256, 512, 3):
        for strategy in STRATEGIES:
            got = tshd.token_sharding(batch, ms, cfg, strategy)
            want = jshd.token_sharding(batch, fm, jreg.ARCHS["granite-3-8b"],
                                       strategy)
            assert _norm(got.spec) == _norm(want.spec), (batch, strategy)
            assert got.mesh is ms
    for seq in (1, 7, 16, 32768, 524288):
        for batch in (1, 2, 16, 32, 128):
            assert jshd._seq_axes_for(seq, batch, fm) == \
                tshd._seq_axes_for(seq, batch, ms)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, abstract_named):
    """``cache_shardings`` of every decode cell (the VQ cache of
    long_500k for the attention families) on the three meshes."""
    jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
    for shape in DECODE:
        sh = SHAPES[shape]
        b, s = sh["global_batch"], sh["seq_len"]
        jcell = jspecs.arch_for_cell(jc, shape)
        jcache = jax.eval_shape(lambda: jlm.init_serve_cache(jcell, b, s))
        tcache = tspecs.input_specs(tc, shape)["cache"]
        tcell = tspecs.arch_for_cell(tc, shape)
        jl = _jpaths(jcache)
        for dims, names in MESHES.values():
            fm = ms = FakeMesh(dims, names)
            want = _jpaths(jshd.cache_shardings(jcache, jcell, fm, b, s))
            got = dict(tshd.leaf_paths(tshd.cache_shardings(
                tcache, tcell, ms, b, s)))
            assert list(got) == list(jl) == list(want)
            for path in got:
                assert _norm(got[path].spec) == _norm(want[path].spec), \
                    (shape, path)


# ---------------------------------------------------------------------------
# input specs and the analytic roofline
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every leaf's shape and dtype, for every input-shape cell, equal the
    reference's ``jax.eval_shape`` stand-ins; the port's are fake tensors
    (no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor
    jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
    for shape in SHAPES:
        want = jspecs.input_specs(jc, shape)
        got = tspecs.input_specs(tc, shape)
        assert sorted(got) == sorted(want), shape
        for key in want:
            jl = _jpaths(want[key])
            tl = dict(tshd.leaf_paths(got[key]))
            assert list(tl) == list(jl), (shape, key)
            for path, leaf in tl.items():
                assert isinstance(leaf, FakeTensor)
                assert tuple(leaf.shape) == tuple(jl[path].shape), path
                assert _dtype_name(leaf.dtype) == \
                    np.dtype(jl[path].dtype).name, (shape, path)
        assert tspecs.arch_for_cell(tc, shape).vq_attn == \
            jspecs.arch_for_cell(jc, shape).vq_attn


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_analytic_model_matches_reference(arch):
    jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
    assert troof.active_params(tc) == jroof.active_params(jc)
    for shape in SHAPES:
        assert troof.model_flops(tc, shape) == jroof.model_flops(jc, shape)
        for strategy in STRATEGIES:
            for chips, accum in ((256, 1), (512, 8)):
                assert troof.model_hbm_bytes(tc, shape, chips, accum,
                                             strategy) == \
                    jroof.model_hbm_bytes(jc, shape, chips, accum, strategy)
                tp, dp = 16, chips // 16
                assert troof.model_collective_bytes(
                    tc, shape, chips, tp, dp, accum, strategy) == \
                    jroof.model_collective_bytes(jc, shape, chips, tp, dp,
                                                 accum, strategy)


def test_terms_from_cell_agree_up_to_the_constants():
    """The same cell through both ``terms_from_cell``: the analytic terms
    scale by the ratio of the hardware constants; with trip hints of 1
    the dry-run's flops and collectives enter both alike (the port counts
    executed ops and applies no trips; the reference's HLO counts are
    trip-corrected)."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    coll = {"all-gather": 3e9, "all-reduce": 2e9, "reduce-scatter": 1e9,
            "all-to-all": 5e8, "collective-permute": 1e8}
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in ("pod16x16", "pod2x16x16"):
                cell = {"mesh": mesh, "strategy": "tp_fsdp", "shape": shape,
                        "trip_hints": {"accum": 4, "layer_trips": 1,
                                       "inner_attn_trips": 2},
                        "cost": {"flops": 1.5e13},
                        "collectives": {"bytes": coll}}
                t = troof.terms_from_cell(cell, treg.ARCHS[arch])
                j = jroof.terms_from_cell(cell, jreg.ARCHS[arch])
                assert t.model_flops == j.model_flops
                assert_allclose(t.compute_s * troof.PEAK_FLOPS,
                                j.compute_s * jroof.PEAK_FLOPS, rtol=1e-12)
                assert_allclose(t.memory_s * troof.HBM_BW,
                                j.memory_s * jroof.HBM_BW, rtol=1e-12)
                assert_allclose(t.collective_s * troof.LINK_BW,
                                j.collective_s * jroof.ICI_BW, rtol=1e-12)
                # the reference multiplies the flops by layer_trips x
                # accum (here 4); the port takes the count as executed
                assert t.hlo_flops * 4 == j.hlo_flops
                for k in ("hbm_bytes", "coll_bytes", "chips", "accum",
                          "layer_trips", "inner_attn_trips"):
                    assert t.details[k] == j.details[k], k
                assert t.details["hlo_coll_bytes"] == sum(
                    r * coll[k] for k, r in {
                        "all-gather": 15 / 16, "reduce-scatter": 15 / 16,
                        "all-reduce": 30 / 16, "all-to-all": 1 / 16,
                        "collective-permute": 1.0}.items())


def test_out_of_order_axis_tuples_raise():
    ms = FakeMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tshd.to_placements(tshd.P(("model", "data")), ms)
    assert tshd.shard_shape((8, 6), tshd.P(("data", "model"), None),
                            ms) == (2, 6)


# ---------------------------------------------------------------------------
# one sharded training step on four gloo CPU ranks
# ---------------------------------------------------------------------------

def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in _jpaths(tree).items()}


def _ref_state(jc, jo, flat: dict):
    """The reference's ``TrainState`` of ``jc`` under ``jo`` holding the
    carried arrays ``flat`` (by path)."""
    like = jax.eval_shape(lambda: jloop.TrainState(
        jlm.init_lm(jax.random.PRNGKey(0), jc),
        jo.init(jlm.init_lm(jax.random.PRNGKey(0), jc)),
        jnp.zeros((), jnp.int32)))
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["".join(str(p) for p in path)], leaf.dtype)
        for path, leaf in paths])


@pytest.fixture(scope="module")
def sharded_steps():
    """Each run's state (the port's init, carried to the reference) and
    tokens, the sharded step of every run in one spawn of four ranks
    ((2, 2) host mesh; started first, in a thread that waits on the
    ranks), the reference's step and the unsharded port step."""
    runs = []
    for i, (arch, strategy, kw) in enumerate(
            [(a, s, {}) for a, s in STEP_RUNS] + STEP_VARIANTS):
        tc = treg.get_smoke(arch)
        to = topt.adam(topt.warmup_cosine(STEP_LR, 2, 20))
        params = tlm.init_lm(tc, torch.Generator().manual_seed(i),
                             device="cpu")
        runs.append(dict(dict(arch=arch, strategy=strategy,
                              flat=pj.lm_state_numpy(tloop.TrainState(
                                  params, to.init(params),
                                  torch.zeros((), dtype=torch.int32))),
                              tokens=np.random.default_rng(10 + i).integers(
                                  0, tc.vocab, (4, 33)).astype(np.int32),
                              accum=1, model=2, lr=STEP_LR), **kw))
    # the variants save and restore their new state, sync and async
    for r, async_write in zip(runs[len(STEP_RUNS):], (False, True)):
        r["ckpt"] = async_write
    # last, the first run again with DTensor's collectives routed through
    # the synchronous calls (as ranks sharing a card run them)
    sync = dict(runs[0], sync=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, pj.lm_step_jobs, 4, "gloo", "cpu",
                            runs + [sync], timeout_s=300)
        cases = []
        for r in runs:
            tc, jc = treg.get_smoke(r["arch"]), jreg.get_smoke(r["arch"])
            clip, accum = r.get("clip_norm"), r["accum"]
            to = topt.adam(topt.warmup_cosine(STEP_LR, 2, 20),
                           clip_norm=clip)
            jo = jopt.adam(jopt.warmup_cosine(STEP_LR, 2, 20),
                           clip_norm=clip)
            tnew, tm = tloop.make_train_step(tc, to, accum)(
                pj.lm_state_from_numpy(pj.lm_state_like(tc, to), r["flat"],
                                       "cpu"), torch.from_numpy(r["tokens"]))
            jstate, jm = jax.jit(jloop.make_train_step(jc, jo, accum))(
                _ref_state(jc, jo, r["flat"]), r["tokens"])
            cases.append({"ref": (_flat_np(jstate), float(jm["loss"]),
                                  float(jm["grad_norm"])),
                          "port": (pj.lm_state_numpy(tnew),
                                   float(tm["loss"]),
                                   float(tm["grad_norm"]))})
        return cases, ranks.result()


@pytest.mark.parametrize("run", range(len(STEP_RUNS)),
                         ids=[f"{a}-{s}" for a, s in STEP_RUNS])
def test_sharded_step_matches_unsharded_and_reference(run, sharded_steps):
    """``build_sharded_step`` with the strategy forced, as the
    reference's slow dry-run test forces it: every rank returns the same
    gathered state; loss, gradient norm and every leaf of the new state
    agree with the unsharded port step and the reference's step; the
    params really are sharded (a rank holds a quarter or half of each
    stacked weight)."""
    cases, outs = sharded_steps
    arch, strategy = STEP_RUNS[run]
    got = outs[0][run]
    for o in outs[1:]:
        assert o[run]["loss"] == got["loss"]
        for k, v in got["state"].items():
            assert np.array_equal(o[run]["state"][k], v), k
    for name in ("ref", "port"):
        state, loss, gnorm = cases[run][name]
        assert_allclose(got["loss"], loss, **TOL, err_msg=name)
        assert_allclose(got["grad_norm"], gnorm, **TOL, err_msg=name)
        assert sorted(state) == sorted(got["state"])
        for k, v in state.items():
            assert_allclose(got["state"][k], v, **TOL,
                            err_msg=f"{name} {strategy} {k}")
    local = got["local"]
    full = {k: v.shape for k, v in got["state"].items()}
    w1 = [k for k in full if k.endswith(".w1") and k.startswith(".params")]
    assert w1 and all(np.prod(local[k]) * 2 <= np.prod(full[k])
                      for k in w1), (local, full)
    assert local[".step"] == ()


def _lr_t(step: int) -> float:
    """Adam's step size at ``step`` under the runs' schedule."""
    lr = STEP_LR * min(step / 2, 1.0)
    return lr * np.sqrt(1 - 0.999 ** step) / (1 - 0.9 ** step)


@pytest.mark.parametrize("run", range(len(STEP_VARIANTS)),
                         ids=[f"{a}-{s}-" + "-".join(f"{k}{v}" for k, v in
                                                     kw.items())
                              for a, s, kw in STEP_VARIANTS])
def test_sharded_step_with_clipping_or_microbatches(run, sharded_steps):
    """``build_sharded_step`` with ``clip_norm=1.0`` (the clip scale from
    the DTensor gradients' global norm) and with ``accum=2`` (each strided
    microbatch relaid from the whole batch): every rank the same state;
    loss, gradient norm, both moments and the step counters at ``TOL``
    against the unsharded port step and the reference's step, and the
    params at ``TOL`` wherever the update is well-conditioned (module
    docstring), on most of their elements."""
    cases, outs = sharded_steps
    i = len(STEP_RUNS) + run
    got = outs[0][i]
    for o in outs[1:]:
        assert o[i]["loss"] == got["loss"]
        for k, v in got["state"].items():
            assert np.array_equal(o[i]["state"][k], v), k
    lr_t = _lr_t(1)
    for name in ("ref", "port"):
        state, loss, gnorm = cases[i][name]
        assert_allclose(got["loss"], loss, **TOL, err_msg=name)
        assert_allclose(got["grad_norm"], gnorm, **TOL, err_msg=name)
        assert sorted(state) == sorted(got["state"])
        checked = total = 0
        for k, v in state.items():
            if not k.startswith(".params"):
                assert_allclose(got["state"][k], v, **TOL,
                                err_msg=f"{name} {k}")
                continue
            mu = state[".opt.mu" + k[len(".params"):]]
            nu = state[".opt.nu" + k[len(".params"):]]
            gain = lr_t / (np.sqrt(nu) + 1e-8)
            ok = gain * (TOL["atol"] + TOL["rtol"] * np.abs(mu)) \
                <= TOL["atol"] + TOL["rtol"] * np.abs(v)
            assert_allclose(got["state"][k][ok], v[ok], **TOL,
                            err_msg=f"{name} {k}")
            checked += int(ok.sum())
            total += ok.size
        assert checked >= 0.5 * total, (name, checked, total)


def test_sharded_checkpoint_round_trip(sharded_steps):
    """``train/checkpoint.py`` on a (2, 2) mesh: the file rank 0 wrote
    (leaf by leaf, synchronously; or from its host in a thread) holds the
    new state's full tensors, and each rank's restore into the sharded
    layout gathers back to the same state, exactly."""
    _, outs = sharded_steps
    for run in range(len(STEP_VARIANTS)):
        i = len(STEP_RUNS) + run
        got = outs[0][i]
        for o in outs:
            assert sorted(o[i]["restored"]) == sorted(got["state"])
            for k, v in got["state"].items():
                assert np.array_equal(o[i]["restored"][k], v), k
                assert np.array_equal(got["file"][k], v), k


def test_synchronous_collectives_restore_torch_kernels():
    """``ranks.sync_functional_collectives`` replaces the functional
    collectives' CPU kernels only within its context."""
    from repro_torch.distributed.ranks import sync_functional_collectives
    ops = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
           "all_to_all_single", "broadcast", "wait_tensor")
    table = [torch._C._dispatch_dump_table(f"_c10d_functional::{op}")
             for op in ops]
    with sync_functional_collectives("cpu"):
        inside = [torch._C._dispatch_dump_table(f"_c10d_functional::{op}")
                  for op in ops]
    assert all(a != b for a, b in zip(inside, table))
    assert table == [torch._C._dispatch_dump_table(
        f"_c10d_functional::{op}") for op in ops]


def test_synchronous_collectives_give_the_same_step(sharded_steps):
    """``ranks.sync_functional_collectives`` (DTensor's collectives as the
    synchronous calls, which ranks sharing a card need: gloo's
    asynchronous ones crash on CUDA tensors) gives granite's sharded step
    bit for bit: the same gloo reductions in the same order."""
    _, outs = sharded_steps
    native, sync = outs[0][0], outs[0][-1]
    assert sync["loss"] == native["loss"]
    assert sync["grad_norm"] == native["grad_norm"]
    for k, v in native["state"].items():
        assert np.array_equal(sync["state"][k], v), k


# ---------------------------------------------------------------------------
# fake ranks (one subprocess: it makes itself a rank of fake groups)
# ---------------------------------------------------------------------------

_FAKE_RANKS = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as JP
from repro_torch.configs.registry import SMOKES
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

# the placements: each of 8 fake ranks against JAX's device order
names = ("pod", "data", "model")
jmesh = jax.make_mesh((2, 2, 2), names)
specs = [(), (None, "model"), ("data", None), (("pod", "data"), "model"),
         (("pod", "data", "model"), None), ("pod", ("data", "model")),
         (None, ("pod", "model")), ("model", "pod"),
         (("data", "model"), None, "pod")]
x = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
checked = 0
for rank in range(8):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=names)
    dev = jmesh.devices.reshape(-1)[rank]
    for spec in specs:
        idx = NamedSharding(jmesh, JP(*spec)).devices_indices_map(x.shape)
        want = x[idx[dev]]
        pl = shd.to_placements(shd.P(*spec), mesh)
        got = distribute_tensor(torch.from_numpy(x), mesh, pl,
                                src_data_rank=None).to_local().numpy()
        assert np.array_equal(got, want), (rank, spec, got.shape,
                                           want.shape)
        assert got.shape == shd.shard_shape(x.shape, shd.P(*spec), mesh)
        checked += 1
dist.destroy_process_group()
print("PLACEMENTS_OK", checked, flush=True)

# the dry-run: granite's smoke cell on (4, 4), granite-3-8b through the CLI
out = {"smoke": dryrun.trace_step(SMOKES["granite-3-8b"](), "train", 8, 32,
                                  (4, 4), ("data", "model"), accum=2,
                                  strategy="tp_fsdp")}
out["rc"] = dryrun.main(["--arch", "granite-3-8b", "--shape", "prefill_32k",
                         "--layers", "2", "--out", sys.argv[1]])
# a VQ-Attention decode cell (its cache gathered whole on every rank)
out["rc_vq"] = dryrun.main(["--arch", "granite-3-8b", "--shape",
                            "long_500k", "--layers", "2", "--out",
                            sys.argv[1]])
print("DRYRUN " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _FAKE_RANKS, str(out_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    return res, out_dir


def test_placements_follow_jax_device_order(fake_ranks):
    """Each of 8 fake ranks of a (2, 2, 2) mesh holds, for specs with
    single axes, axis tuples (major to minor) and unsharded dims, the
    slice JAX gives the device at the same mesh position."""
    res, _ = fake_ranks
    assert "PLACEMENTS_OK 72" in res.stdout, res.stderr[-3000:]


REF_KEYS = {"cell", "arch", "shape", "mesh", "strategy", "kind", "seq_len",
            "global_batch", "vq_attn", "param_count", "trip_hints",
            "memory", "cost", "collectives", "wall_s"}


def test_fake_rank_dryrun(fake_ranks):
    """granite's smoke cell on a (4, 4) mesh (the reference's
    ``tests/test_distributed.py:97-138`` cell: train, accum 2, tp_fsdp)
    and granite-3-8b at 2 layers on (16, 16) through the CLI (its
    prefill_32k cell, and its long_500k VQ decode cell traces too): the
    reference's keys (``trace_s`` for ``lower_s`` / ``compile_s``),
    flops > 0, argument bytes equal to the spec-derived shard sum, and
    collectives on the model axis."""
    res, tmp_path = fake_ranks
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("DRYRUN ")]
    assert line, res.stderr[-3000:]
    out = json.loads(line[0][len("DRYRUN "):])
    assert out["rc"] == 0 and out["rc_vq"] == 0
    cell = json.load(open(tmp_path /
                          "granite-3-8b__prefill_32k__pod16x16__l2.json"))
    assert REF_KEYS <= set(cell) and "trace_s" in cell
    assert cell["strategy"] == "tp_fsdp" and cell["n_layers"] == 2
    assert set(cell["collectives"]["bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"} <= set(cell["memory"])
    for r in (out["smoke"], cell):
        assert r["cost"]["flops"] > 0
        assert r["memory"]["argument_bytes"] == \
            r["memory"]["spec_argument_bytes"] > 0
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"]
        assert sum(r["collectives"]["by_axis"]["model"].values()) > 0
    # a rank holds 1/16 of the smoke's sharded weights at most: far less
    # than the 0.3 MB of the whole f32 state
    assert out["smoke"]["memory"]["argument_bytes"] < 300_000


# ---------------------------------------------------------------------------
# the launchers' meshes
# ---------------------------------------------------------------------------

def test_production_meshes_need_their_rank_counts():
    """``--production-mesh`` / ``--multi-pod`` on a one-rank world raise,
    naming the ranks the mesh wants; nothing falls back."""
    base = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu"]
    with pytest.raises(ValueError, match="needs 256 ranks"):
        ttrain.main(base + ["--production-mesh"])
    with pytest.raises(ValueError, match="needs 512 ranks"):
        ttrain.main(base + ["--production-mesh", "--multi-pod"])
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tserve.main(base + ["--production-mesh"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_serve_prints_the_reference_strategy(capsys):
    rep = tserve.main(["--arch", "llama3.2-3b", "--smoke", "--tokens", "2",
                       "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("llama3b-smoke strategy=replicate vq=False: ")
    assert rep["strategy"] == "replicate"
