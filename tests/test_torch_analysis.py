"""The port's static contract checker (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.  Each rule must (a) stay
silent on the clean tree and (b) fire on a seeded regression -- a host
dequantization before the kernel, a per-branch dispatch explosion, an
over-limit shared-memory plan, a dense residual saved for backward, an env
read moved into a hot function, and so on.  The seeded fixtures are the
checker's own acceptance tests, as in ``tests/test_analysis.py``.

Where the reference can run, the port is held to it: the ``Finding``
strings and baseline suppression byte for byte, the AST rules at the same
lines on the torch form of the reference's fixtures, the per-step
dispatches of every pinned entry by kernel body (the reference's jaxprs
walked with ``jax.extend.core`` under ``REPRO_FORCE_PALLAS=1``, each
``pallas_call`` named by its body's ``debug_info.func_src_info``), the
REPRO106 residuals and the dispatch crossovers at a configured budget.
The sync pass (REPRO102) needs the card: ``tests/test_torch_cuda.py``.
"""
import ast
import collections
import os
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
from jax.extend import core as jcore                         # noqa: E402

from repro import analysis as janalysis                      # noqa: E402
from repro.analysis import ast_checks as jast                # noqa: E402
from repro.analysis import jaxpr_checks as jjaxpr            # noqa: E402
from repro.analysis import registry as jregistry             # noqa: E402
from repro.analysis import trace_count as jtrace             # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro_torch.analysis import (Finding, ast_checks,       # noqa: E402
                                  dispatch_checks, load_baseline, registry,
                                  smem_checks, suppress, trace_count)
from repro_torch.analysis.__main__ import main as cli_main   # noqa: E402
from repro_torch.distributed.quantization import QTensor     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _rules(findings):
    return {f.rule for f in findings}


@pytest.fixture
def clean_dispatch():
    """Every programmatic dispatch override dropped after the test."""
    yield
    ops.configure_spmm_dispatch(reset=True)
    ops.configure_context_dispatch(reset=True)
    jops.configure_spmm_dispatch(reset=True)
    jops.configure_context_dispatch(reset=True)


# ---------------------------------------------------------------------------
# Finding plumbing and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    ("REPRO001", "src/repro/x.py", 7, "msg"),
    ("REPRO101", "<entry:e>", 0, "m, with: punctuation"),
    ("REPRO203", "<crossover:context_ell>", 3, "")])
def test_finding_strings_and_baseline_match_reference(tmp_path, fields):
    f, jf = Finding(*fields), janalysis.Finding(*fields)
    for fmt in ("text", "github"):
        assert f.format(fmt) == jf.format(fmt)
    assert f.key() == jf.key()
    base = tmp_path / "baseline.txt"
    other = ("REPRO002",) + fields[1:]
    base.write_text(f"# comment\n{f.key()}  # trailing\n\n")
    keys = load_baseline(str(base))
    assert keys == janalysis.load_baseline(str(base))
    assert suppress([f, Finding(*other)], keys) == [Finding(*other)]
    assert janalysis.suppress([jf, janalysis.Finding(*other)], keys) == \
        [janalysis.Finding(*other)]


def test_trace_counter_matches_reference():
    a, b = trace_count.TraceCounter(layer=0), jtrace.TraceCounter(layer=0)
    before, jbefore = a.snapshot(), b.snapshot()
    for c in (a, b):
        c.bump("layer")
        c.bump("serve")
    assert dict(a) == dict(b)
    assert a.delta(before) == b.delta(jbefore)


def test_recorder_is_off_outside_a_recording(monkeypatch):
    """Outside a recording a CPU tensor goes to ``ref.py`` without
    consulting any variant: a setting that makes the variant raise changes
    nothing there, and nothing is recorded."""
    monkeypatch.setenv("REPRO_SPMM_VMEM_BUDGET_MB", "8")
    monkeypatch.setenv("REPRO_CONTEXT_VMEM_BUDGET_MB", "8")
    ids = torch.zeros((4, 3), dtype=torch.int32)
    vals = torch.ones((4, 3))
    ops.spmm_ell(ids, vals, torch.ones((10, 8)))
    ops.context_ell(ids, vals, torch.zeros((2, 10), dtype=torch.int32),
                    torch.ones((2, 4, 3)))
    assert not trace_count.active()
    with trace_count.recording() as rec, pytest.raises(ValueError,
                                                       match="L2"):
        ops.spmm_ell(ids, vals, torch.ones((10, 8)))
    assert rec.records == []


def test_recorder_notes_kernel_form_shapes_and_span():
    ids = torch.zeros((4, 3), dtype=torch.int32)
    vals = torch.ones((4, 3))
    x = torch.ones((10, 8), requires_grad=True)
    spans = []
    with trace_count.recording() as rec:
        spans.append(rec.in_span)
        ops.spmm_ell(ids, vals, x).sum().backward()
        ops.context_ell(ids, vals, torch.zeros((2, 10), dtype=torch.uint8),
                        QTensor(torch.ones((2, 4, 3), dtype=torch.int8),
                                torch.ones((2, 1, 3))))
    assert not spans[0] and not rec.in_span
    assert dict(rec) == {("spmm_ell", "f32"): 1, ("spmm_ell_t", "f32"): 1,
                         ("context_ell", "repro_context_ell_i8_u8"): 1}
    ctx = rec.records[-1]
    assert ctx.shapes == ((4, 3), (4, 3), (2, 10), (2, 4, 3), (2, 1, 3))
    assert ctx.dtypes == ("int32", "float32", "uint8", "int8", "float32")
    assert trace_count.launch_counts() == {}      # nothing ran on a card


# ---------------------------------------------------------------------------
# AST rules: the torch form of each reference fixture, at the same line
# ---------------------------------------------------------------------------

def _lines(findings):
    return [(f.rule, f.line) for f in findings]


def _env_pair(jax_src, torch_src):
    j = jast._env_findings([("src/repro/fake.py",
                             ast.parse(textwrap.dedent(jax_src)))])
    t = ast_checks._env_findings([("src/repro_torch/fake.py",
                                   ast.parse(textwrap.dedent(torch_src)))])
    return _lines(j), _lines(t)


ENV_FIXTURES = {
    "direct": ("""
        import os, jax
        @jax.jit
        def hot(x):
            return x * float(os.environ.get("SCALE", "1"))
    """, """
        import os, torch
        @torch.compile
        def hot(x):
            return x * float(os.environ.get("SCALE", "1"))
    """),
    # the env read sits in a helper the hot body merely references
    "transitive": ("""
        import os, jax
        def helper():
            return os.getenv("KNOB")
        @jax.jit
        def hot(x):
            return x if helper() else x
    """, """
        import os, torch
        def helper():
            return os.getenv("KNOB")
        @torch.compile
        def hot(x):
            return x if helper() else x
    """),
    # same read, but nothing hot references the function
    "host_side": ("""
        import os
        def host_config():
            return os.environ.get("KNOB")
    """, """
        import os
        def host_config():
            return os.environ.get("KNOB")
    """),
    # a function handed to a combinator is a root
    "combinator_root": ("""
        import os, jax
        def body(c, x):
            return c + float(os.environ.get("S", "0")), None
        def epoch(xs):
            return jax.lax.scan(body, 0.0, xs)
    """, """
        import os, torch
        def body(c, x):
            return c + float(os.environ.get("S", "0")), None
        def epoch(xs):
            return torch.utils.checkpoint.checkpoint(body, 0.0, xs)
    """),
}


@pytest.mark.parametrize("case", sorted(ENV_FIXTURES))
def test_repro001_fixtures_fire_where_the_reference_does(case):
    want, got = _env_pair(*ENV_FIXTURES[case])
    assert got == want
    assert (want == []) == (case == "host_side")


@pytest.mark.parametrize("root_src", [
    # an autograd Function's forward and a kernel dispatcher are roots
    """
    import os, torch
    class Hot(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * float(os.environ.get("S", "1"))
    """,
    """
    import os
    def spmm_ell(idx, val, x):
        return x if os.getenv("K") else x
    """])
def test_repro001_port_roots(root_src):
    rel = "src/repro_torch/kernels/ops.py"
    fs = ast_checks._env_findings([(rel, ast.parse(
        textwrap.dedent(root_src)))])
    assert [f.rule for f in fs] == ["REPRO001"]
    # the same read in hostenv.py is the sanctioned chokepoint
    assert ast_checks._env_findings([("src/repro_torch/hostenv.py",
                                      ast.parse(textwrap.dedent(
                                          root_src)))]) == []


def _sub_pair(jax_src, torch_src, jrel, trel):
    def run(mod, src, rel):
        tree = ast.parse(textwrap.dedent(src))
        return _lines(mod._banned_call_findings(rel, tree)
                      + mod._import_side_effect_findings(rel, tree))
    return run(jast, jax_src, jrel), run(ast_checks, torch_src, trel)


SUB_FIXTURES = {
    "one_hot_hot": ("""
        import jax
        def assign_dense(idx, k):
            return jax.nn.one_hot(idx, k)
    """, """
        import torch
        def assign_dense(idx, k):
            return torch.nn.functional.one_hot(idx, k)
    """, "core/codebook.py", True),
    "one_hot_cold": ("""
        import jax
        def assign_dense(idx, k):
            return jax.nn.one_hot(idx, k)
    """, """
        import torch
        def assign_dense(idx, k):
            return torch.nn.functional.one_hot(idx, k)
    """, "nn/ffn.py", False),
    "einsum_conv": ("""
        import jax.numpy as jnp
        def ctx(a, c):
            return jnp.einsum('nbk,nkf->nbf', a, c)
    """, """
        import torch
        def ctx(a, c):
            return torch.einsum('nbk,nkf->nbf', a, c)
    """, "core/conv.py", True),
    # the sketch-form einsum of message_passing.py stays sanctioned
    "einsum_sketch": ("""
        import jax.numpy as jnp
        def ctx(a, c):
            return jnp.einsum('nbk,nkf->nbf', a, c)
    """, """
        import torch
        def ctx(a, c):
            return torch.einsum('nbk,nkf->nbf', a, c)
    """, "core/message_passing.py", False),
    "env_import_time": ("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_foo"
    """, """
        import os
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
    """, "launch/bad.py", True),
    "env_main_guard": ("""
        import os
        if __name__ == "__main__":
            os.environ["XLA_FLAGS"] = "--xla_foo"
    """, """
        import os
        if __name__ == "__main__":
            os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
    """, "launch/dryrun.py", False),
}


@pytest.mark.parametrize("case", sorted(SUB_FIXTURES))
def test_repro002_005_fixtures_fire_where_the_reference_does(case):
    jsrc, tsrc, sub, fires = SUB_FIXTURES[case]
    want, got = _sub_pair(jsrc, tsrc, f"src/repro/{sub}",
                          f"src/repro_torch/{sub}")
    assert got == want
    assert bool(got) == fires


def test_ast_pass_clean_tree():
    assert ast_checks.run(ROOT) == []


# ---------------------------------------------------------------------------
# dispatch counts: every pinned entry against the reference's jaxpr
# ---------------------------------------------------------------------------

def _sub_jaxprs(eqn):
    subs = []
    for v in eqn.params.values():
        for leaf in jax.tree_util.tree_leaves(v, is_leaf=lambda x: isinstance(
                x, (jcore.Jaxpr, jcore.ClosedJaxpr))):
            if isinstance(leaf, jcore.ClosedJaxpr):
                subs.append(leaf.jaxpr)
            elif isinstance(leaf, jcore.Jaxpr):
                subs.append(leaf)
    return subs


def _pallas_bodies(jaxpr, in_kernel=False):
    """Kernel body names of the pallas_calls outside kernel bodies."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call" and not in_kernel:
            info = eqn.params["jaxpr"].debug_info.func_src_info
            yield info.split(" at ")[0]
        inner = in_kernel or eqn.primitive.name == "pallas_call"
        for sub in _sub_jaxprs(eqn):
            yield from _pallas_bodies(sub, inner)


def _reference_bodies(name):
    entry = {e.name: e for e in jregistry.entries()}[name]
    return collections.Counter(_pallas_bodies(entry.jaxpr().jaxpr))


def _body_of(kernel, form):
    """The reference's kernel body for a port dispatch."""
    if kernel == "context_ell":
        q = "_q" if not form.split("_")[-2] == "f32" else ""
        wt = "_wt" if "_wt_" in form else ""
        return f"_context_ell{q}{wt}_kernel"
    if kernel in ("spmm_ell", "spmm_ell_hbm"):
        return f"_{kernel}{'_q' if form == 'q' else ''}_kernel"
    return f"_{kernel}_kernel"


PINNED = [e.name for e in registry.pinned()]


def test_registry_covers_all_tiers_and_both_widths():
    names = [e.name for e in registry.entries()]
    rename = {"dp_epoch": "vq_train_epoch_dp",
              "sharded_epoch": "vq_train_epoch_sharded"}
    jnames = [rename.get(e.name, e.name) for e in jregistry.entries()]
    assert [n for n in names if n in jnames] == jnames
    assert set(names) == set(jnames) | set(rename.values())
    for tier in ops.PRECISIONS:
        assert f"vq_infer_layer[{tier}]" in PINNED
        assert f"vq_serve_batch[{tier}]" in PINNED
    assert sorted(PINNED) == sorted(
        e.name for e in jregistry.entries() if e.pallas_count is not None)
    assert any("@f_prod=2" in n for n in PINNED)
    assert registry.DISPATCH_COUNTS == jregistry.PALLAS_COUNTS


@pytest.mark.parametrize("name", PINNED)
def test_dispatches_per_step_match_reference_pallas_calls(name):
    entry = {e.name: e for e in registry.entries()}[name]
    run = dispatch_checks.recorded(entry, "cpu")
    got = collections.Counter(_body_of(d.kernel, d.form)
                              for d in run.records)
    want = _reference_bodies(name)
    assert sum(want.values()) == entry.dispatch_count
    assert got == {k: v * entry.steps for k, v in want.items()}
    assert dispatch_checks.check_entry(entry, run=run) == []


def test_dispatch_and_smem_passes_clean_tree():
    assert dispatch_checks.run(device="cpu") == []
    assert smem_checks.run(device="cpu") == []


def test_repro101_forced_loop_explodes_the_context_dispatch(clean_dispatch):
    """Forcing the per-branch loop turns the ONE context dispatch a layer
    step into one SpMM a branch."""
    entry = registry._serve_entry("int8")
    branches = [st.assignment.shape[0] for st in entry.args("cpu")[1]]
    before = dispatch_checks.check_entry(entry)
    ops.configure_context_dispatch(variant="loop")
    rec = dispatch_checks._record(entry, "cpu")
    findings = dispatch_checks.check_entry(entry, run=rec)
    assert before == []
    assert "REPRO101" in _rules(findings)
    # per layer: the intra-batch SpMM, then one quantized SpMM a branch
    assert dispatch_checks.dispatch_counts(rec.records) == {
        ("spmm_ell", "f32"): len(branches), ("spmm_ell", "q"): sum(branches)}


def test_repro103_host_dequant_before_kernel():
    """Host-level int8 -> f32 upcast of a QTensor ahead of the kernel: both
    halves of the dtype-flow contract fire (storage dtype never reaches
    the kernel; an out-of-kernel conversion dequantizes)."""
    ids = torch.zeros((8, 4), dtype=torch.int32)
    vals = torch.ones((8, 4))
    table = torch.zeros((2, 40), dtype=torch.uint8)
    qt = QTensor(torch.ones((2, 8, 4), dtype=torch.int8),
                 torch.ones((2, 1, 4)))

    def entry(call):
        return registry.Entry("fixture:dequant", make=lambda dev: (),
                              call=call, quantized_dtypes=("int8", "uint8"))

    bad = dispatch_checks.check_entry(entry(
        lambda: ops.context_ell(ids, vals, table, qt.q.float() * qt.scale)))
    assert _rules(bad) == {"REPRO103"} and len(bad) == 2
    assert any("int8 never reaches" in f.message for f in bad)
    assert dispatch_checks.check_entry(entry(
        lambda: ops.context_ell(ids, vals, table, qt))) == []


class _DenseSave(torch.autograd.Function):
    """Saves the dense [b, Dr, f] reconstruction the lazy form avoids."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x[:, None, :].expand(16, 8, 8) * 1.0)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (res,) = ctx.saved_tensors
        return g + res.sum(1)


def test_repro106_saved_residuals():
    x = torch.ones((16, 8), requires_grad=True)
    seeded = dispatch_checks.saved_tensor_findings(
        lambda: _DenseSave.apply(x), 16 * 8 * 8 * 4, "<fixture>")
    assert _rules(seeded) == {"REPRO106"}
    assert dispatch_checks.residual_findings() == []
    assert jjaxpr.residual_findings() == []
    # rev_vals, rev_ids, the codewords, the table and w: 2,688 bytes
    fn, dense = dispatch_checks.injection_forward()
    assert dense == 16 * 8 * 16 * 4
    assert sorted(dispatch_checks.saved_bytes(fn)) == [512] * 4 + [640]


# ---------------------------------------------------------------------------
# shared memory and the crossovers
# ---------------------------------------------------------------------------

def test_repro201_over_limit_plan():
    big = trace_count.Dispatch("vq_update", "narrow int32",
                               ((1, 16, 32), (1, 2000, 32)),
                               ("float32", "float32"))
    fine = big._replace(form="wide int32")
    assert _rules(smem_checks.check_dispatches([big], "<fixture>")) == \
        {"REPRO201"}
    assert smem_checks.check_dispatches([fine], "<fixture>") == []
    # the w_t form holds WT_ROWS rows of the context: 8 x 7,272 floats
    wide_ctx = trace_count.Dispatch(
        "context_ell", "repro_context_ell_wt_f32_i32",
        ((16, 4), (16, 4), (8, 40), (8, 8, 909), (7272, 8)),
        ("int32", "float32", "int32", "float32", "float32"))
    assert _rules(smem_checks.check_dispatches([wide_ctx], "<fixture>")) \
        == {"REPRO201"}


@pytest.mark.parametrize("budget_mb", [0.5, 4.0])
def test_repro203_variants_match_reference_at_a_configured_budget(
        clean_dispatch, budget_mb):
    ops.configure_spmm_dispatch(l2_budget_mb=budget_mb)
    ops.configure_context_dispatch(l2_budget_mb=budget_mb)
    jops.configure_spmm_dispatch(vmem_budget_mb=budget_mb)
    jops.configure_context_dispatch(vmem_budget_mb=budget_mb)
    budget = budget_mb * 2 ** 20
    for scale in (0.9, 1.2):
        n = int(budget * scale) // (16 * 4)
        assert ops.spmm_ell_variant(n, 16) == jops.spmm_ell_variant(n, 16)
        n = int(budget * scale) // (4 * 4)
        assert ops.context_ell_variant(n, 4) == \
            jops.context_ell_variant(n, 4)
    assert smem_checks.crossover_findings() == []


def test_repro203_forced_variant_mismatch(clean_dispatch):
    """Pinning the resident / loop variants past their crossovers is the
    heuristic-vs-kernel mismatch the rule exists for."""
    ops.configure_spmm_dispatch(variant="resident")
    ops.configure_context_dispatch(variant="loop")
    findings = smem_checks.crossover_findings()
    assert _rules(findings) == {"REPRO203"}
    assert {f.path for f in findings} == {"<crossover:spmm_ell>",
                                          "<crossover:context_ell>"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_on_the_cpu(capsys):
    assert cli_main(["--device", "cpu", "--format", "github"]) == 0
    err = capsys.readouterr().err
    assert "passes ast, dispatch, smem on cpu" in err
    assert "clean" in err
    with pytest.raises(ValueError, match="sync"):
        cli_main(["--device", "cpu", "--pass", "sync"])
    with pytest.raises(ValueError, match="card only"):
        dispatch_checks.sync_findings(registry.entries()[0], "cpu")


def test_cli_reports_findings_and_honours_a_baseline(tmp_path, capsys,
                                                     clean_dispatch):
    ops.configure_spmm_dispatch(variant="resident")
    assert cli_main(["--device", "cpu", "--pass", "smem"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out and all("REPRO203" in line for line in out)
    base = tmp_path / "baseline"
    base.write_text("REPRO203|<crossover:spmm_ell>|0\n")
    assert cli_main(["--device", "cpu", "--pass", "smem", "--baseline",
                     str(base)]) == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_default_device_needs_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main([])
