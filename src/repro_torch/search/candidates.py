"""Candidate ``QuantPolicy`` generation for the (gs, n_p) co-exploration
(a copy of ``repro/search/candidates.py`` over the port's ``QuantConfig``
and ``QuantPolicy``: the same seeded ``random.Random`` gives the same
children).

A candidate is an *assignment*: one ``(mode, gs, n_p)`` choice per layer
class found in the architecture's GEMM inventory (``inventory.layer_classes``
— ``*.mix.*``, ``*.ffn.*``, ``encoder.*``, ``rem.*``, ``head``...).  The
assignment is a hashable tuple so the search can dedupe across iterations;
``Candidate.policy()`` lowers it to the ``QuantPolicy`` the quant/energy/
serving stacks consume.

Generation follows the QUIDAM/MVQ playbook:
  * ``uniform_baselines`` — the global-policy anchors every heterogeneous
    candidate must beat (W8A8, APSQ at each gs, PSQ);
  * ``seed_candidates``   — structured heterogeneous points spanning the
    energy axis (attention tight / FFN loose, FFN-only, per-class grid
    corners);
  * ``mutate``            — local moves on Pareto-front members (bump one
    class's gs or n_p a step, or toggle its mode), the evolutionary
    refinement loop of ``repro_torch.search.driver``.
"""
from __future__ import annotations

import dataclasses
import itertools
import random

from repro_torch.core import QuantConfig
from repro_torch.quant.policy import QuantPolicy

W8A8 = ("w8a8",)          # per-class choice: weights/activations only
MODES = ("w8a8", "apsq", "psq")


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The per-class choice grid."""

    gs_choices: tuple = (1, 2, 4)
    n_p_choices: tuple = (4, 8, 16)

    def class_choices(self) -> list:
        """Every per-class (mode[, gs, n_p]) choice, W8A8 included."""
        out = [W8A8]
        out += [("apsq", gs, n_p) for gs, n_p
                in itertools.product(self.gs_choices, self.n_p_choices)]
        out += [("psq", 0, n_p) for n_p in self.n_p_choices]
        return out


def _choice_config(choice: tuple) -> QuantConfig:
    if choice[0] == "w8a8":
        return QuantConfig.w8a8()
    if choice[0] == "apsq":
        return QuantConfig.apsq(gs=choice[1], n_p=choice[2])
    return QuantConfig.psq(n_p=choice[2])


def _choice_label(choice: tuple) -> str:
    if choice[0] == "w8a8":
        return "w8a8"
    if choice[0] == "apsq":
        return f"apsq(gs={choice[1]},np={choice[2]})"
    return f"psq(np={choice[2]})"


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the policy search space.

    ``assignment`` is ``((class_pattern, choice), ...)`` in rule-precedence
    order; unmatched quantizable layers fall through to W8A8 so every
    candidate is at least weight/activation-quantized (the paper's QAT
    baseline).
    """

    name: str
    assignment: tuple
    origin: str = "seed"       # baseline | seed | mutation

    def policy(self) -> QuantPolicy:
        return QuantPolicy.of(
            *((pat, _choice_config(choice))
              for pat, choice in self.assignment),
            default=QuantConfig.w8a8())

    @property
    def heterogeneous(self) -> bool:
        """More than one distinct per-class choice (the RAE reconfigures)."""
        return len({choice for _, choice in self.assignment}) > 1

    def describe(self) -> dict:
        return {"name": self.name, "origin": self.origin,
                "heterogeneous": self.heterogeneous,
                "assignment": {pat: _choice_label(choice)
                               for pat, choice in self.assignment}}


@dataclasses.dataclass(frozen=True)
class FixedCandidate:
    """A hand-written ``QuantPolicy`` entered into the search as-is.

    Lets the hand-tuned ``repro_torch.quant.policy_presets`` compete on the
    same Pareto plot as generated candidates (``cli --include-presets``).
    Not mutated — it has no per-class assignment to move in.
    """

    name: str
    fixed_policy: object         # QuantPolicy
    origin: str = "preset"

    @property
    def assignment(self) -> tuple:
        return ("fixed", self.name)

    def policy(self):
        return self.fixed_policy

    @property
    def heterogeneous(self) -> bool:
        return len(getattr(self.fixed_policy, "rules", ())) > 0

    def describe(self) -> dict:
        from .evaluate import describe_policy
        return {"name": self.name, "origin": self.origin,
                "heterogeneous": self.heterogeneous,
                "assignment": dict(describe_policy(self.fixed_policy))}


def _named(assignment: tuple, origin: str) -> Candidate:
    label = "+".join(f"{pat}={_choice_label(choice)}"
                     for pat, choice in assignment)
    return Candidate(name=label, assignment=assignment, origin=origin)


def uniform_baselines(classes: dict, space: SearchSpace) -> list:
    """Global policies: the anchors heterogeneous candidates must beat."""
    patterns = tuple(classes)
    out = []
    np_mid = space.n_p_choices[len(space.n_p_choices) // 2]
    choices = [W8A8]
    choices += [("apsq", gs, np_mid) for gs in space.gs_choices]
    choices += [("psq", 0, np_mid)]
    for choice in choices:
        assignment = tuple((p, choice) for p in patterns)
        cand = _named(assignment, "baseline")
        out.append(dataclasses.replace(
            cand, name=f"uniform_{_choice_label(choice)}"))
    return out


def seed_candidates(classes: dict, space: SearchSpace) -> list:
    """Structured heterogeneous points spanning the energy axis.

    Built from the classes actually present: attention/mix tight with FFN
    loose (the Fig. 6 sweet spot), FFN-only PSUM quantization (attention
    stays W8A8), n_p fine-vs-coarse splits, and remainder/encoder-specific
    variants when those classes exist.
    """
    patterns = tuple(classes)
    if not patterns:
        return []
    gs_lo, gs_hi = space.gs_choices[0], space.gs_choices[-1]
    np_lo, np_hi = space.n_p_choices[0], space.n_p_choices[-1]
    np_mid = space.n_p_choices[len(space.n_p_choices) // 2]

    def per_class(default, **by_pattern):
        return tuple((p, by_pattern.get(p, default)) for p in patterns)

    seeds = [
        # attention projections tight, FFN loose
        per_class(("apsq", gs_lo, np_mid),
                  **{"*.ffn.*": ("apsq", gs_hi, np_mid)}),
        # PSUM-quantize only the FFN GEMMs (the energy-dominant class)
        per_class(W8A8, **{"*.ffn.*": ("apsq", gs_lo + 1 if gs_lo + 1 in
                                       space.gs_choices else gs_lo, np_mid)}),
        # everything quantized, FFN tiled coarse (less PSUM traffic)
        per_class(("apsq", gs_lo, np_mid),
                  **{"*.ffn.*": ("apsq", gs_lo, np_lo)}),
        # fine K-tiling on mix, coarse on FFN
        per_class(("apsq", gs_lo, np_hi),
                  **{"*.ffn.*": ("apsq", gs_lo, np_lo)}),
        # PSQ on mix (independent tiles), APSQ on FFN
        per_class(("psq", 0, np_mid),
                  **{"*.ffn.*": ("apsq", gs_lo, np_mid)}),
    ]
    if "head" in classes:
        seeds.append(per_class(("apsq", gs_lo, np_mid),
                               **{"head": W8A8}))
    if "encoder.*" in classes:
        seeds.append(per_class(("apsq", gs_hi, np_mid),
                               **{"encoder.*": ("apsq", gs_lo, np_mid)}))
    if "rem.*" in classes:
        seeds.append(per_class(("apsq", gs_lo, np_mid),
                               **{"rem.*": W8A8}))
    out, seen = [], set()
    for a in seeds:
        if a not in seen:
            seen.add(a)
            out.append(_named(a, "seed"))
    return out


def mutate(candidate: Candidate, rng: random.Random,
           space: SearchSpace) -> Candidate:
    """One local move: change a random class's gs, n_p, or mode."""
    assignment = list(candidate.assignment)
    idx = rng.randrange(len(assignment))
    pat, choice = assignment[idx]
    moves = []
    if choice[0] == "apsq":
        gi = space.gs_choices.index(choice[1]) \
            if choice[1] in space.gs_choices else 0
        ni = space.n_p_choices.index(choice[2]) \
            if choice[2] in space.n_p_choices else 0
        for step in (-1, 1):
            if 0 <= gi + step < len(space.gs_choices):
                moves.append(("apsq", space.gs_choices[gi + step], choice[2]))
            if 0 <= ni + step < len(space.n_p_choices):
                moves.append(("apsq", choice[1], space.n_p_choices[ni + step]))
        moves += [W8A8, ("psq", 0, choice[2])]
    elif choice[0] == "psq":
        moves = [("apsq", space.gs_choices[0], choice[2]), W8A8]
    else:  # w8a8 -> start PSUM-quantizing this class
        moves = [c for c in space.class_choices() if c != W8A8]
    assignment[idx] = (pat, moves[rng.randrange(len(moves))])
    return _named(tuple(assignment), "mutation")
