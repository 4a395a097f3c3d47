"""The co-exploration loop: candidates -> scores -> Pareto -> mutate (port
of ``repro/search/driver.py``).

QUIDAM-style accelerator/model co-exploration specialized to APSQ's
per-layer knobs: each iteration scores every new candidate policy on
(analytical energy, fake-quant accuracy proxy), keeps the Pareto front,
and breeds the next generation by locally mutating front members.  The
search is deterministic (seeded RNG, deduped assignments) and ends with
servability proofs: the front's best-accuracy policy and its best
PSUM-quantized one are calibrated, exported, and executed through the
CUDA kernels vs the torch oracle (``evaluate.roundtrip_report``).

Energy is scored on the *full-size* architecture (the analytical model is
O(#GEMM names), so TinyLlama at seq 4096 costs microseconds); the
accuracy proxy runs the arch's smoke-scale sibling.  Both sides resolve
the SAME policy against the SAME layer namespace, which is the point of
``repro_torch.search.inventory``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.energy import AcceleratorConfig
from repro_torch.quant.policy import resolve_quant

from .candidates import (
    Candidate,
    FixedCandidate,
    SearchSpace,
    mutate,
    seed_candidates,
    uniform_baselines,
)
from .evaluate import (
    accuracy_proxy,
    energy_report,
    make_eval_batch,
    oracle_logits,
    roundtrip_report,
)
from .inventory import layer_classes, model_inventory
from .pareto import ScoredCandidate, pareto_front

_NO_QUANT = QuantConfig()     # resolve() fallthrough: psum.mode == "none"


@dataclasses.dataclass(frozen=True)
class SearchBudget:
    """How much exploration one ``run_search`` spends."""

    iterations: int = 3          # mutation rounds after the seed round
    mutations_per_iter: int = 6  # children bred from the front per round
    seq_len: int = 4096          # energy-side sequence length
    stage: str = "prefill"       # energy-side stage (prefill | decode)
    dataflow: str = "WS"         # energy-side dataflow
    eval_batch: int = 2          # accuracy-proxy calibration batch
    eval_seq: int = 32
    seed: int = 0

    @staticmethod
    def smoke() -> "SearchBudget":
        """CI budget: 2 iterations, tiny eval shapes."""
        return SearchBudget(iterations=2, mutations_per_iter=3,
                            eval_batch=1, eval_seq=16)


@dataclasses.dataclass
class SearchResult:
    arch: str
    front: list                  # ScoredCandidate, ascending energy
    scored: list                 # every evaluated ScoredCandidate
    baselines: dict              # name -> ScoredCandidate (uniform anchors)
    roundtrip: dict              # servability proof of the front's best
    # servability proof of the front's best PSUM-quantized policy — the
    # APSQ kernel path itself, in case the best-accuracy member is plain
    # W8A8 (it usually is: least quantization noise)
    roundtrip_psum: dict = dataclasses.field(default_factory=dict)
    budget: SearchBudget = dataclasses.field(default_factory=SearchBudget)
    elapsed_s: float = 0.0
    device: str = ""

    def report(self) -> dict:
        front_names = {p.candidate.name for p in self.front}
        het_front = [p for p in self.front if p.candidate.heterogeneous]
        base_energies = {n: s.energy_j for n, s in self.baselines.items()}
        dominated = {
            n for n, e in base_energies.items()
            if any(p.energy_j < e for p in het_front)}
        return {
            "arch": self.arch,
            "device": self.device,
            "n_evaluated": len(self.scored),
            "front": [p.report() for p in self.front],
            "n_heterogeneous_on_front": len(het_front),
            "uniform_baselines": {n: s.report()
                                  for n, s in self.baselines.items()},
            "baselines_energy_dominated": sorted(dominated),
            "dominated_points": [p.report() for p in self.scored
                                 if p.candidate.name not in front_names],
            "roundtrip": self.roundtrip,
            "roundtrip_psum": self.roundtrip_psum,
            "budget": dataclasses.asdict(self.budget),
            "elapsed_s": round(self.elapsed_s, 1),
        }

    def save(self, out_dir: str = "experiments/search") -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.arch}__pareto.json")
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1, default=str)
        return path


def has_psum(candidate, classes: dict) -> bool:
    """Whether ``candidate``'s policy PSUM-quantizes any layer of
    ``classes`` (the APSQ kernel path)."""
    policy = candidate.policy()
    return any((resolve_quant(policy, n) or _NO_QUANT).psum.mode != "none"
               for names in classes.values() for n in names)


def run_search(arch: str, budget: SearchBudget | None = None,
               space: SearchSpace | None = None, *,
               acc: AcceleratorConfig | None = None,
               extra_policies: dict | None = None,
               verbose: bool = True, device=None) -> SearchResult:
    """Search per-layer (gs, n_p) policies for one architecture.

    ``extra_policies`` ({label: QuantPolicy}) enters hand-written
    policies — e.g. ``repro_torch.quant.policy_presets`` via
    ``evaluate.policy_sweep("all")`` — into the same Pareto plot.  The
    accuracy proxy and the round trips run on ``device`` (``None``: the
    card).
    """
    t0 = time.time()
    device = resolve_device(device)
    budget = budget or SearchBudget()
    space = space or SearchSpace()
    log = print if verbose else (lambda *_: None)

    cfg_full = get_config(arch)
    cfg_eval = get_smoke(arch)
    inventory = model_inventory(cfg_full, budget.seq_len, budget.stage)
    classes = layer_classes(inventory)
    log(f"[search] {arch}: {len(inventory)} GEMMs, "
        f"{len(classes)} layer classes: {sorted(classes)}")

    batch = make_eval_batch(cfg_eval, budget.eval_batch, budget.eval_seq,
                            budget.seed, device=device)
    ref = oracle_logits(cfg_eval, batch, budget.seed, device=device)

    scored: list = []
    seen: set = set()

    def score(cand) -> ScoredCandidate | None:
        if cand.assignment in seen:
            return None
        seen.add(cand.assignment)
        policy = cand.policy()
        e = energy_report(cfg_full, policy, seq_len=budget.seq_len,
                          stage=budget.stage, dataflow=budget.dataflow,
                          acc=acc, inventory=inventory)
        a = accuracy_proxy(cfg_eval, policy, batch, ref, budget.seed,
                           device=device)
        sc = ScoredCandidate(
            candidate=cand, energy_j=e["energy_j"], error=a["error"],
            energy_saving=e["saving"],
            detail={"psum_j": e["psum_j"],
                    "top1_agreement": a["top1_agreement"], "kl": a["kl"]})
        scored.append(sc)
        log(f"[search]   {cand.origin:9s} {cand.name[:64]:64s} "
            f"E={sc.energy_j:.3e}J (save {sc.energy_saving:+.1%}) "
            f"err={sc.error:.4f}")
        return sc

    baselines = {}
    for cand in uniform_baselines(classes, space):
        sc = score(cand)
        if sc is not None:
            baselines[cand.name] = sc
    for cand in seed_candidates(classes, space):
        score(cand)
    for label, policy in (extra_policies or {}).items():
        score(FixedCandidate(name=label, fixed_policy=policy))

    rng = random.Random(budget.seed)
    for it in range(budget.iterations):
        front = pareto_front(scored)
        log(f"[search] iter {it}: front size {len(front)} "
            f"({sum(p.candidate.heterogeneous for p in front)} "
            f"heterogeneous)")
        # fixed presets have no per-class assignment to mutate
        parents = [p for p in front if isinstance(p.candidate, Candidate)]
        if not parents:
            break
        children = 0
        attempts = 0
        while children < budget.mutations_per_iter and attempts < 50:
            attempts += 1
            parent = parents[rng.randrange(len(parents))]
            child = mutate(parent.candidate, rng, space)
            if score(child) is not None:
                children += 1

    front = pareto_front(scored)
    best_acc = min(front, key=lambda p: p.error)
    log(f"[search] final front: {len(front)} points; best-accuracy "
        f"{best_acc.candidate.name!r} -> roundtrip")
    rt = roundtrip_report(cfg_eval, best_acc.candidate.policy(), batch,
                          budget.seed, device=device)
    log(f"[search] roundtrip: ok={rt['ok']} backends={rt['backends']} "
        f"decode={rt['decode']}")

    # The best-accuracy member is usually plain W8A8 (least quantization
    # noise), which never touches the APSQ PSUM kernel path — also prove
    # the front's best PSUM-quantized policy serves.
    rt_psum: dict = {}
    psum_members = [p for p in front
                    if p is not best_acc and has_psum(p.candidate, classes)]
    if has_psum(best_acc.candidate, classes):
        rt_psum = {"same_as_best_accuracy": True, "ok": rt["ok"]}
    elif psum_members:
        best_psum = min(psum_members, key=lambda p: p.error)
        log(f"[search] best PSUM-quantized front member "
            f"{best_psum.candidate.name!r} -> roundtrip")
        rt_psum = roundtrip_report(cfg_eval, best_psum.candidate.policy(),
                                   batch, budget.seed, device=device)
        rt_psum["candidate"] = best_psum.candidate.name
        log(f"[search] psum roundtrip: ok={rt_psum['ok']} "
            f"decode={rt_psum['decode']}")
    return SearchResult(arch=arch, front=front, scored=scored,
                        baselines=baselines, roundtrip=rt,
                        roundtrip_psum=rt_psum, budget=budget,
                        elapsed_s=time.time() - t0, device=str(device))
