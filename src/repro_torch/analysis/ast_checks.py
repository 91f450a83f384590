"""Pass 3: repo lint rules (REPRO00x) on ``src/repro_torch/`` -- pure AST.

  REPRO001  ``os.environ`` / ``os.getenv`` read inside a function
            reachable from a hot root.  The roots are the ``forward`` /
            ``backward`` of ``torch.autograd.Function`` subclasses, the
            functions handed to (or decorated by) ``checkpoint``,
            ``torch.func``'s transforms, ``torch.cuda.graph`` /
            ``make_graphed_callables``, ``torch.compile`` and
            ``torch.jit``, and the public dispatchers of
            ``kernels/ops.py`` (the ``pallas_call`` analogue: every kernel
            launch passes through one).  A CUDA graph replays the kernels
            its capture chose, so a live env read under capture is the
            desync this rule guards against; ``repro_torch/hostenv.py`` is
            the single sanctioned chokepoint (frozen during a capture) and
            is exempt.  Reachability is the reference's name-based
            over-approximation: any function whose NAME is referenced
            inside a reachable function body counts as called.  The tree
            is expected to be exactly clean, so over-approximating costs
            nothing and misses nothing.
  REPRO002  dense VQ materializations in the hot modules: ``one_hot``
            under ``core/``, ``kernels/`` and ``models/gnn.py`` (the
            [n, k] indicator the paper's sparse-assignment design avoids),
            and ``einsum`` in ``core/codebook.py`` / ``core/conv.py`` (the
            [n, b, k] contraction path; the sketch-form einsums of
            ``message_passing.py`` and the plain versions' einsums in
            ``kernels/`` are outside the banned files).
  REPRO005  import-time process mutation: assigning/updating
            ``os.environ`` (or ``os.putenv``) at module top level.
            Mutations under ``if __name__ == "__main__":`` are the CLI
            pattern and exempt.

REPRO003 (Python loops in a Pallas kernel body) and REPRO004 (unregistered
pytrees) have no counterpart -- the port's kernels are ``.cu`` sources and
its state trees are NamedTuples and dicts walked by its own ``tree_map``
-- and stay reserved (ROADMAP's divergences).
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from repro_torch.analysis import Finding

# modules where the [n, k] one-hot indicator is banned
_HOT_PREFIXES = ("core/", "kernels/", "models/gnn.py")
# modules where einsum itself is banned (dense-assignment contraction)
_NO_EINSUM = ("core/codebook.py", "core/conv.py")
_ENV_EXEMPT = ("hostenv.py",)
# the module whose public functions are the kernel dispatchers
_DISPATCH_MODULE = "kernels/ops.py"

# calls and decorators whose function arguments run under autograd's
# recomputation, a functional transform, a CUDA graph capture or a compiler
_ROOT_TAKERS = {
    "checkpoint", "checkpoint_sequential", "grad", "grad_and_value", "vjp",
    "jvp", "jacrev", "jacfwd", "hessian", "vmap", "functional_call",
    "make_graphed_callables", "graph", "compile", "script", "trace",
}


def _py_files(root: str) -> Iterator[tuple[str, str]]:
    src = os.path.join(root, "src", "repro_torch")
    for dirpath, dirs, names in os.walk(src):
        dirs.sort()
        for name in sorted(names):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield full, os.path.relpath(full, root)


def _sub(rel: str) -> str:
    return rel.replace(os.sep, "/").split("src/repro_torch/", 1)[-1]


def _callee_name(func) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_root_deco(deco) -> bool:
    """@torch.compile / @torch.jit.script / @checkpoint-style decorators,
    bare or called (``@torch.compile(mode=...)``)."""
    if isinstance(deco, ast.Call):
        deco = deco.func
    return _callee_name(deco) in _ROOT_TAKERS


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(_callee_name(b) == "Function" for b in cls.bases)


class _FnInfo:
    def __init__(self, rel: str, node: ast.AST):
        self.rel = rel
        self.node = node
        self.refs: set[str] = set()      # every identifier referenced
        self.env_reads: list[int] = []   # lines touching os.environ

    def scan(self):
        for sub in ast.walk(self.node):
            if isinstance(sub, ast.Name):
                self.refs.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                self.refs.add(sub.attr)
                if sub.attr == "environ" and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == "os":
                    self.env_reads.append(sub.lineno)
            elif isinstance(sub, ast.Call) and \
                    _callee_name(sub.func) == "getenv":
                self.env_reads.append(sub.lineno)


def _collect(tree: ast.Module, rel: str, fns: dict, roots: set):
    """Index every function; seed the roots from autograd Functions,
    decorators, names passed to root-taking calls, and the dispatchers."""
    dispatch_module = _sub(rel) == _DISPATCH_MODULE
    for node in tree.body:
        if dispatch_module and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not node.name.startswith("_"):
            roots.add(node.name)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = _FnInfo(rel, node)
            info.scan()
            fns.setdefault(node.name, []).append(info)
            if any(_is_root_deco(d) for d in node.decorator_list):
                roots.add(node.name)
        elif isinstance(node, ast.ClassDef) and _is_autograd_function(node):
            roots.update(m.name for m in node.body
                         if isinstance(m, ast.FunctionDef)
                         and m.name in ("forward", "backward"))
        elif isinstance(node, ast.Call) and \
                _callee_name(node.func) in _ROOT_TAKERS:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if (n := _callee_name(arg)):
                    roots.add(n)


def _reachable(fns: dict, roots: set) -> set:
    seen: set[str] = set()
    frontier = [r for r in roots if r in fns]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for info in fns[name]:
            for ref in info.refs:
                if ref in fns and ref not in seen:
                    frontier.append(ref)
    return seen


def _env_findings(parsed: list) -> list[Finding]:
    fns: dict[str, list[_FnInfo]] = {}
    roots: set[str] = set()
    for rel, tree in parsed:
        _collect(tree, rel, fns, roots)
    findings = []
    for name in sorted(_reachable(fns, roots)):
        for info in fns[name]:
            if info.rel.endswith(_ENV_EXEMPT) or not info.env_reads:
                continue
            for line in sorted(set(info.env_reads)):
                findings.append(Finding(
                    "REPRO001", info.rel, line,
                    f"os.environ read in '{name}', reachable from a hot "
                    f"root (an autograd Function, a transform / capture / "
                    f"compile target or a kernel dispatcher) -- route it "
                    f"through repro_torch.hostenv.env_knob (frozen during "
                    f"a CUDA graph capture)"))
    return findings


def _banned_call_findings(rel: str, tree: ast.Module) -> list[Finding]:
    sub = _sub(rel)
    findings = []
    hot = sub.startswith(_HOT_PREFIXES)
    no_einsum = sub in _NO_EINSUM
    if not (hot or no_einsum):
        return findings
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee_name(node.func)
        if hot and callee == "one_hot":
            findings.append(Finding(
                "REPRO002", rel, node.lineno,
                "one_hot in a hot module materializes the dense [n, k] "
                "assignment indicator; use gather/scatter ops on the "
                "sparse assignment instead"))
        if no_einsum and callee == "einsum":
            findings.append(Finding(
                "REPRO002", rel, node.lineno,
                "einsum in the codebook/conv hot path (dense [n, b, k] "
                "contraction form); use the kernel dispatchers"))
    return findings


def _import_side_effect_findings(rel: str,
                                 tree: ast.Module) -> list[Finding]:
    findings = []

    def _is_main_guard(node) -> bool:
        return (isinstance(node, ast.If) and
                isinstance(node.test, ast.Compare) and
                isinstance(node.test.left, ast.Name) and
                node.test.left.id == "__name__")

    def _visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if _is_main_guard(node):
                continue
            if isinstance(node, (ast.If, ast.Try, ast.With)):
                for attr in ("body", "orelse", "finalbody"):
                    _visit(getattr(node, attr, []) or [])
                for h in getattr(node, "handlers", []):
                    _visit(h.body)
                continue
            for sub in ast.walk(node):
                target = None
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tgts = (sub.targets if isinstance(sub, ast.Assign)
                            else [sub.target])
                    for t in tgts:
                        if isinstance(t, ast.Subscript) and \
                                isinstance(t.value, ast.Attribute) and \
                                t.value.attr == "environ":
                            target = sub
                elif isinstance(sub, ast.Call):
                    cn = _callee_name(sub.func)
                    if cn == "putenv" or (
                            cn in ("update", "setdefault", "pop") and
                            isinstance(sub.func, ast.Attribute) and
                            isinstance(sub.func.value, ast.Attribute) and
                            sub.func.value.attr == "environ"):
                        target = sub
                if target is not None:
                    findings.append(Finding(
                        "REPRO005", rel, target.lineno,
                        "process environment mutated at import time; "
                        "move it under `if __name__ == '__main__':` "
                        "(importing a module must be side-effect free)"))

    _visit(tree.body)
    return findings


def run(root: str | None = None) -> list[Finding]:
    root = root or os.getcwd()
    parsed = []
    findings: list[Finding] = []
    for full, rel in _py_files(root):
        with open(full) as fh:
            try:
                tree = ast.parse(fh.read(), filename=rel)
            except SyntaxError as exc:
                findings.append(Finding(
                    "REPRO005", rel, exc.lineno or 0,
                    f"unparseable module: {exc.msg}"))
                continue
        parsed.append((rel, tree))
        findings.extend(_banned_call_findings(rel, tree))
        findings.extend(_import_side_effect_findings(rel, tree))
    findings.extend(_env_findings(parsed))
    return findings
