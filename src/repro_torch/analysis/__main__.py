"""CLI: ``python -m repro_torch.analysis [--format text|github] [--baseline
F] [--pass ast|dispatch|smem|sync ...] [--root .] [--device cuda|cpu]``.

Runs the passes (the AST lint first, then the dispatch pass, then the
shared-memory pass, which reads the dispatch pass's recorded runs, then on
the card the sync pass), prints the passes it ran and every unsuppressed
finding in the chosen format, and exits 1 if any remain.  The device is
resolved by ``runtime.resolve_device``: the card by default, which raises
without one.  The default passes are all four on the card and ``ast``,
``dispatch`` and ``smem`` on the CPU; asking for ``sync`` on the CPU
raises.  ``--baseline`` names a suppression file of ``Finding.key()``
lines; the repo policy is an EMPTY baseline (fix the tree, not the
checker), but the flag exists so a downstream fork can adopt the gate
incrementally.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

from repro_torch.analysis import Finding, load_baseline, suppress

_PASSES = ("ast", "dispatch", "smem", "sync")


def _run_pass(name: str, root: str, device) -> list[Finding]:
    if name == "ast":
        from repro_torch.analysis import ast_checks
        return ast_checks.run(root)
    if name == "dispatch":
        from repro_torch.analysis import dispatch_checks
        return dispatch_checks.run(root, device)
    if name == "smem":
        from repro_torch.analysis import smem_checks
        return smem_checks.run(root, device)
    from repro_torch.analysis import dispatch_checks
    return dispatch_checks.run_sync(root, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract checks: dispatch contracts, shared "
                    "memory footprints, repo lint rules")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text")
    ap.add_argument("--baseline", metavar="FILE",
                    help="suppression file (one finding key per line)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=_PASSES, metavar="|".join(_PASSES),
                    help="run only the named pass(es); default: all that "
                         "the device runs")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entries run (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.runtime import resolve_device
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    passes = args.passes or [p for p in _PASSES if card or p != "sync"]
    if "sync" in passes and not card:
        raise ValueError("--pass sync needs the card: "
                         "torch.cuda.set_sync_debug_mode watches CUDA "
                         "synchronizations")
    print(f"repro_torch.analysis: passes {', '.join(passes)} on {dev}",
          file=sys.stderr)
    findings: list[Finding] = []
    with contextlib.ExitStack() as stack:
        if set(passes) - {"ast"}:
            # one process group for every pass's data-parallel entries
            from repro_torch.analysis import registry
            stack.enter_context(registry.one_rank_group(dev))
        for name in passes:
            t0 = time.time()
            found = _run_pass(name, args.root, dev)
            print(f"repro_torch.analysis: pass {name}: {len(found)} "
                  f"finding(s), {time.time() - t0:.2f} s", file=sys.stderr)
            findings.extend(found)
    if args.baseline:
        findings = suppress(findings, load_baseline(args.baseline))

    for f in findings:
        print(f.format(args.format))
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("repro_torch.analysis: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
