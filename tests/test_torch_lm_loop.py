"""LM training of the PyTorch port through its loop, checkpoints and entry
points, against the JAX reference where it has a twin: checkpoints read
across both packages (the reference's key strings, bf16 stored as f32),
the writer's garbage collection, asynchronous write and CRC check,
``train``'s loss history from a shared reference checkpoint, the failure
drill and restart, the reference's two LM system tests, the launcher and
the example, and a static check that no port module imports jax.  The
parity of the functions under them is ``tests/test_torch_lm_train.py``.

Tolerances: checkpoints leaf-equal (dtype and value) both ways; a loss
history over 6 steps ``rtol=1e-4`` (f32 sums in another order compound
over the steps); the drill's losses equal to the undisturbed run's (the
CPU path is deterministic and the checkpoint exact).
"""
import ast
import dataclasses
import glob
import os
import shutil

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.configs import registry as jreg                   # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.train import checkpoint as jckpt                  # noqa: E402
from repro.train import loop as jloop                        # noqa: E402
from repro.train import optimizer as jopt                    # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.configs import registry as treg             # noqa: E402
from repro_torch.launch import train as tlaunch              # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.train import checkpoint as tckpt            # noqa: E402
from repro_torch.train import loop as tloop                  # noqa: E402
from repro_torch.train import optimizer as topt              # noqa: E402

HIST_TOL = dict(rtol=1e-4, atol=0)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: these small shapes run
    many times slower on a thread pool that shares the cores with other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(key, cfg):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jlm.init_lm, static_argnums=1)(key, cfg))


def _ref_state(params, opt):
    return jloop.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))


# ---------------------------------------------------------------------------
# checkpoints across both packages
# ---------------------------------------------------------------------------

def _bf16_states():
    """The llama smoke in bf16: a reference TrainState with bf16 moments,
    and a port state of the same structure to restore into."""
    jc = dataclasses.replace(jreg.get_smoke("llama3.2-3b"), dtype="bfloat16")
    tc = dataclasses.replace(treg.get_smoke("llama3.2-3b"), dtype="bfloat16")
    opt = jopt.adam(1e-3, moment_dtype=jnp.bfloat16)
    p = _init(jax.random.PRNGKey(1), jc)
    rng = np.random.default_rng(0)
    mu = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.bfloat16), p)
    ref = jloop.TrainState(p, jopt.OptState(jnp.asarray(7, jnp.int32), mu,
                                            mu), jnp.asarray(7, jnp.int32))
    port_like = tloop.TrainState(
        tlm.init_lm(tc, torch.Generator().manual_seed(9), device="cpu"),
        topt.adam(1e-3, moment_dtype=torch.bfloat16).init(
            tlm.init_lm(tc, torch.Generator().manual_seed(9), device="cpu")),
        torch.zeros((), dtype=torch.int32))
    return ref, port_like


def test_checkpoint_keys_and_cross_package_restore(tmp_path):
    ref, port_like = _bf16_states()
    port = convert.train_state_from_numpy(ref, "cpu")
    assert list(tckpt._flatten(port)) == list(jckpt._flatten(ref))
    # the reference writes, the port reads
    jckpt.save(str(tmp_path / "ref"), 7, ref, {"seed": 0})
    got, manifest = tckpt.restore(str(tmp_path / "ref"), port_like)
    assert manifest == {"step": 7, "seed": 0}
    assert got.params["embed"].dtype == torch.bfloat16
    for key, leaf in tckpt._paths(got):
        want = dict(tckpt._paths(port))[key]
        assert leaf.dtype == want.dtype and torch.equal(leaf, want), key
    # the port writes, the reference reads
    tckpt.save(str(tmp_path / "port"), 8, port, {"seed": 1})
    assert sorted(os.listdir(tmp_path / "port")) == ["step_8"]
    back, manifest = jckpt.restore(str(tmp_path / "port"), ref)
    assert manifest == {"step": 8, "seed": 1}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a).astype(np.float32),
            np.asarray(b).astype(np.float32)), path


def test_checkpoint_gc_and_async_write(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), s, state, keep=2)
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    t = tckpt.save(str(tmp_path), 6, {"w": torch.ones(2)}, async_write=True)
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = tckpt.restore(str(tmp_path), state)
    assert torch.equal(got["w"], torch.ones(2))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), {"w": torch.zeros(3)})
    # a flipped byte in an array's data is caught by the member's CRC
    npz = tmp_path / "step_6" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(np.ones(2, np.float32).tobytes())
    raw[at] ^= 1
    npz.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        tckpt.restore(str(tmp_path), state)


# ---------------------------------------------------------------------------
# train(): loss history, failure drill, restart
# ---------------------------------------------------------------------------

def _granite():
    return jreg.get_smoke("granite-3-8b"), treg.get_smoke("granite-3-8b")


def test_train_from_reference_checkpoint_gives_its_history(tmp_path):
    """Both loops resume from the reference's step-0 state (its own init
    and Adam) and train 6 steps on the same stream."""
    jc, tc = _granite()
    p = _init(jax.random.PRNGKey(0), jc)
    opt = jopt.adam(jopt.warmup_cosine(3e-3, 10, 6), clip_norm=1.0)
    jckpt.save(str(tmp_path / "ref"), 0, _ref_state(p, opt))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    kw = dict(steps=6, batch=2, seq_len=32, lr=3e-3, ckpt_every=100,
              log_every=1)
    want = jloop.train(jc, ckpt_dir=str(tmp_path / "ref"), **kw)["history"]
    got = tloop.train(tc, ckpt_dir=str(tmp_path / "port"), device="cpu",
                      **kw)["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(
        range(1, 7))
    assert_allclose([h["loss"] for h in got], [h["loss"] for h in want],
                    **HIST_TOL)


def test_failure_drill_repeats_the_undisturbed_run(tmp_path):
    """Twin of the reference's drill: a failure before step 6 restores
    step 4, redoes step 5 (logged again, as the reference logs it) and
    ends at step 6, every loss the undisturbed run's."""
    _, tc = _granite()
    kw = dict(steps=6, batch=2, seq_len=32, ckpt_every=2, log_every=1,
              device="cpu")
    clean = tloop.train(tc, ckpt_dir=str(tmp_path / "a"), **kw)["history"]
    drill = tloop.train(tc, ckpt_dir=str(tmp_path / "b"),
                        inject_failure_at=5, **kw)["history"]
    assert [h["step"] for h in drill] == [1, 2, 3, 4, 5, 5, 6]
    want = {h["step"]: h["loss"] for h in clean}
    assert [h["loss"] for h in drill] == [want[h["step"]] for h in drill]


def test_restart_resumes_from_checkpoint(tmp_path):
    """Twin of the reference's kill-and-restart drill."""
    _, tc = _granite()
    kw = dict(batch=2, seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=3,
              device="cpu")
    tloop.train(tc, steps=6, log_every=2, **kw)
    assert tckpt.latest_step(str(tmp_path)) == 6
    r2 = tloop.train(tc, steps=8, log_every=1, **kw)
    steps = [h["step"] for h in r2["history"]]
    assert min(steps) >= 7 and max(steps) == 8


@pytest.mark.parametrize("vq", [False, True])
def test_lm_training_loss_decreases(vq):
    """Twins of the reference's system tests: 80 steps of the granite
    smoke, exact and VQ-Attention (k 16, window 16)."""
    _, tc = _granite()
    if vq:
        tc = tc.with_vq(k=16, window=16)
    out = tloop.train(tc, steps=80, batch=8, seq_len=64, lr=3e-3,
                      log_every=20, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] - 0.4, losses


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_launcher_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5", "--accum", "2"]
    state = tlaunch.main(argv + ["--steps", "10"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    10  loss ") and out[0].endswith(
        "it/s") and out[-1] == "done"
    assert state.opt.mu["head"].dtype == torch.bfloat16
    assert tckpt.latest_step(str(tmp_path)) == 10
    tlaunch.main(argv + ["--steps", "12"])
    out = capsys.readouterr().out.splitlines()
    assert out == ["resumed from step 10", "done"]


def test_train_launcher_refuses_later_slices():
    """The production meshes on a one-rank world raise, naming the ranks
    they need (the meshes themselves: ``tests/test_torch_lm_sharding.py``);
    the cross-attention families raise naming their stub context."""
    for argv, match in [(["--production-mesh"], "needs 256 ranks"),
                        (["--multi-pod"], "needs 512 ranks")]:
        with pytest.raises(ValueError, match=match):
            tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                          "cpu", *argv])
    # the cross-attention families need their stub context, which the
    # launcher (like the reference's) does not make
    for arch in ("whisper-tiny", "llama-3.2-vision-11b"):
        with pytest.raises(ValueError, match="aux_embeds"):
            tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_train_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA requests are honoured")
    _, tc = _granite()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.train(tc, steps=1, batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1"])


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm
    out = train_lm.main(["--steps", "20", "--batch", "2", "--seq", "64",
                         "--vq", "--device", "cpu", "--ckpt",
                         str(tmp_path)])
    text = capsys.readouterr().out
    assert "vq_attn=True" in text and "loss:" in text
    assert [h["step"] for h in out["history"]] == [10, 20]


def test_port_modules_import_no_jax_statically():
    """Every module of the port, read as source: no import of jax, jaxlib
    or repro (the subprocess check in test_torch_kernels imports them)."""
    files = glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"),
                      recursive=True)
    assert any(f.endswith(os.path.join("data", "tokens.py")) for f in files)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, n)
