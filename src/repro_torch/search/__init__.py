"""repro_torch.search — per-layer (gs, n_p) policy co-exploration (Pareto)
(port of ``repro.search``).

Generate candidate per-layer policies from a model's actual GEMM
inventory, score each on (analytical energy, fake-quant accuracy proxy),
return the Pareto front, and prove the winner serves through
calibrate -> export -> the CUDA kernels.

    from repro_torch.search import SearchBudget, run_search
    result = run_search("tinyllama-1.1b", SearchBudget.smoke())
    result.save()        # experiments/search/<arch>__pareto.json

CLI: ``python -m repro_torch.search.cli --arch tinyllama-1.1b
--budget-smoke``.
"""
from .candidates import Candidate, FixedCandidate, SearchSpace
from .driver import SearchBudget, SearchResult, run_search
from .evaluate import (
    accuracy_proxy,
    backend_parity_report,
    describe_policy,
    energy_report,
    make_eval_batch,
    oracle_logits,
    policy_sweep,
    roundtrip_report,
)
from .inventory import (
    GemmEntry,
    energy_specs,
    layer_classes,
    model_inventory,
    quantizable_names,
)
from .pareto import ScoredCandidate, dominates, pareto_front

__all__ = [
    "Candidate", "FixedCandidate", "GemmEntry", "ScoredCandidate",
    "SearchBudget", "SearchResult", "SearchSpace", "accuracy_proxy",
    "backend_parity_report", "describe_policy", "dominates",
    "energy_report", "energy_specs", "layer_classes", "make_eval_batch",
    "model_inventory", "oracle_logits", "pareto_front", "policy_sweep",
    "quantizable_names", "roundtrip_report", "run_search",
]
