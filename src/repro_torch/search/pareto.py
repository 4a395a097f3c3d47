"""Pareto dominance over (energy, accuracy-proxy) scored candidates (a
copy of ``repro/search/pareto.py``: pure Python)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    """One evaluated policy: lower is better on both axes."""

    candidate: object          # candidates.Candidate
    energy_j: float            # analytical model energy (J) under policy
    error: float               # accuracy proxy (fake-quant vs fp32 oracle)
    energy_saving: float = 0.0  # vs the INT32-PSUM float baseline
    detail: dict = dataclasses.field(default_factory=dict)

    def report(self) -> dict:
        return {**self.candidate.describe(),
                "energy_j": self.energy_j, "error": self.error,
                "energy_saving": self.energy_saving, **self.detail}


def dominates(a: ScoredCandidate, b: ScoredCandidate) -> bool:
    """a dominates b: no worse on both axes, strictly better on one."""
    return (a.energy_j <= b.energy_j and a.error <= b.error
            and (a.energy_j < b.energy_j or a.error < b.error))


def pareto_front(points: list) -> list:
    """Non-dominated subset, sorted by ascending energy.

    Duplicate (energy, error) points keep only the first occurrence so a
    re-discovered candidate doesn't pad the front.
    """
    front, seen = [], set()
    for p in points:
        key = (p.energy_j, p.error)
        if key in seen:
            continue
        if any(dominates(q, p) for q in points if q is not p):
            continue
        seen.add(key)
        front.append(p)
    return sorted(front, key=lambda p: (p.energy_j, p.error))
