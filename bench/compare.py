"""The numbers the correctness check compares, from the program's
readings and the reference's.

Norms are compared leaf by leaf: the gap between the program's norm and
the reference's, as a share of the reference's norm of that leaf or of
the median leaf's, whichever is larger (some leaves are all but zero),
and the worst leaf is the number.
"""
from __future__ import annotations

import statistics

import torch


def norm_gaps(prog: list[float], ref: list[float],
              keep: list[bool] | None = None) -> list[float]:
    """Each leaf's gap (left out where ``keep`` is false)."""
    floor = statistics.median(ref)
    return [abs(p - r) / max(r, floor, 1e-30)
            for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]


def worst_norm_gap(prog: list[float], ref: list[float],
                   keep: list[bool] | None = None) -> float:
    return max(norm_gaps(prog, ref, keep))


def rel_gaps(prog: list[float], ref: list[float]) -> list[float]:
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]


def worst_rel_gap(prog: list[float], ref: list[float]) -> float:
    return max(rel_gaps(prog, ref))


def moved(grad_norms: list[float], share: float = 1e-3) -> list[bool]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's; the rest move under the optimizer by round-off."""
    floor = share * statistics.median(grad_norms)
    return [g >= floor for g in grad_norms]


def frobenius_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.to(prog.device)
    return float((prog - ref).norm() / ref.norm())
