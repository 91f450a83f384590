"""Static contract checking for the port (DESIGN.md sec. 16).

Torch twin of ``repro.analysis``, with its rule ids, its :class:`Finding`
format and its CLI shape.  Three passes on the CPU and a fourth on the
card, each emitting :class:`Finding` rows:

  * ``ast_checks``       (REPRO00x) -- repo lint rules on
    ``src/repro_torch/`` (env reads reachable from a hot root, banned
    one-hot / einsum shapes in hot modules, import-time side effects).
  * ``dispatch_checks``  (REPRO10x) -- run the registered entry points
    (``registry``) on a tiny setup under the dispatch recorder
    (``trace_count.recording``) and prove the dispatch-count,
    quantized-dtype-flow and Eq. 7 residual contracts from what the
    dispatchers of ``kernels/ops.py`` chose; on the card also that no
    entry synchronizes the host (REPRO102, the ``sync`` pass).
  * ``smem_checks``      (REPRO20x) -- the shared memory of every
    recorded dispatch against a block's limit, by the kernel wrappers' own
    sizing, and the dispatch crossovers of ``kernels/ops.py``.

CLI: ``python -m repro_torch.analysis [--format text|github] [--baseline
FILE] [--pass ast|dispatch|smem|sync ...] [--root .] [--device cuda|cpu]``
-- exits non-zero on any unsuppressed finding.  This module stays
import-light (no torch, no pass imports): ``trace_count`` is imported by
``kernels/ops.py``, so pulling the passes in eagerly would be a cycle.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: a rule id, a location, and a message."""
    rule: str          # "REPRO001" ... "REPRO2xx"
    path: str          # repo-relative source path, or "<entry:NAME>" for
    #                    dispatch-level findings with no single source line
    line: int          # 1-based; 0 when not tied to a line
    message: str

    def key(self) -> str:
        """Stable identity for baseline suppression (message-insensitive,
        so rewording a diagnostic never invalidates a baseline)."""
        return f"{self.rule}|{self.path}|{self.line}"

    def format(self, fmt: str = "text") -> str:
        if fmt == "github":
            # GitHub Actions workflow-command annotation syntax
            loc = f"file={self.path},line={max(self.line, 1)}"
            return f"::error {loc},title={self.rule}::{self.message}"
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def load_baseline(path: str) -> set[str]:
    """Suppression keys, one ``Finding.key()`` per line; '#' comments."""
    keys: set[str] = set()
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if line:
                keys.add(line)
    return keys


def suppress(findings: list[Finding], baseline: set[str]) -> list[Finding]:
    return [f for f in findings if f.key() not in baseline]
