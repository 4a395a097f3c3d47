"""CLI: search per-layer (gs, n_p) policies and print the Pareto front
(port of ``repro/search/cli.py``).

    PYTHONPATH=src python -m repro_torch.search.cli --arch tinyllama-1.1b \
        --budget-smoke [--include-presets] [--device cpu] [--out DIR]

Prints every scored candidate, the Pareto front with energy savings vs
the INT32-PSUM baseline, which uniform baselines the heterogeneous front
members beat on energy, and the calibrate -> export -> CUDA-kernel round
trips of the front's best-accuracy and best PSUM-quantized policies.  The
full report lands in ``<out>/<arch>__pareto.json``.  It runs on the card
unless ``--device cpu``; there the round trips run the torch oracle alone
and prove no kernel parity, so the exit gate (which needs it) fails.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCH_NAMES, canonical_arch

from .candidates import SearchSpace
from .driver import SearchBudget, run_search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help=f"architecture id; one of {ARCH_NAMES} "
                         "(module-style spellings accepted)")
    ap.add_argument("--budget-smoke", action="store_true",
                    help="CI budget: 2 iterations, tiny eval shapes")
    ap.add_argument("--iterations", type=int, default=None,
                    help="mutation rounds (overrides the budget default)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="energy-side sequence length")
    ap.add_argument("--stage", default=None, choices=("prefill", "decode"),
                    help="energy-side stage")
    ap.add_argument("--dataflow", default=None, choices=("IS", "WS"),
                    help="energy-side dataflow")
    ap.add_argument("--gs", type=int, nargs="+", default=None,
                    help="gs choices of the search space")
    ap.add_argument("--n-p", type=int, nargs="+", default=None,
                    help="n_p choices of the search space")
    ap.add_argument("--include-presets", action="store_true",
                    help="score repro_torch.quant.policy_presets on the "
                         "same Pareto plot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the accuracy proxy and the round trips run "
                         "(default: the GPU; 'cpu' runs the oracle alone)")
    ap.add_argument("--out", default="experiments/search")
    args = ap.parse_args(argv)

    arch = canonical_arch(args.arch)
    budget = SearchBudget.smoke() if args.budget_smoke else SearchBudget()
    overrides = {k: v for k, v in (
        ("iterations", args.iterations), ("seq_len", args.seq_len),
        ("stage", args.stage), ("dataflow", args.dataflow),
        ("seed", args.seed if args.seed else None)) if v is not None}
    if overrides:
        budget = dataclasses.replace(budget, **overrides)
    space = SearchSpace()
    if args.gs or args.n_p:
        space = SearchSpace(
            gs_choices=tuple(args.gs) if args.gs else space.gs_choices,
            n_p_choices=tuple(args.n_p) if args.n_p else space.n_p_choices)

    extra = None
    if args.include_presets:
        from .evaluate import policy_sweep
        extra = dict(policy_sweep("all"))
    result = run_search(arch, budget, space, extra_policies=extra,
                        device=args.device)
    rep = result.report()

    print(f"\n[search] Pareto front for {arch} "
          f"({rep['n_evaluated']} candidates, {rep['elapsed_s']}s, "
          f"{rep['device']}):")
    for p in result.front:
        het = "het " if p.candidate.heterogeneous else "uni "
        print(f"  {het} E={p.energy_j:.3e}J (save {p.energy_saving:+.1%}) "
              f"err={p.error:.4f}  {p.candidate.name}")
    print(f"[search] heterogeneous points on front: "
          f"{rep['n_heterogeneous_on_front']}")
    print(f"[search] uniform baselines beaten on energy: "
          f"{rep['baselines_energy_dominated']}")
    print(f"[search] roundtrip ok={rep['roundtrip']['ok']} "
          f"backends={rep['roundtrip']['backends']} "
          f"decode={rep['roundtrip'].get('decode')}")
    if rep["roundtrip_psum"]:
        print(f"[search] psum roundtrip ok={rep['roundtrip_psum']['ok']} "
              f"({rep['roundtrip_psum'].get('candidate', 'best-accuracy')})")
    if rep["roundtrip"]["ok"] is None:
        print("[search] no kernel ran on this device: the round trips' "
              "kernel parity is not proven")
    path = result.save(args.out)
    print(f"[search] report -> {path}")
    # Exit gate == the subsystem's acceptance bar: >= 2 non-dominated
    # heterogeneous policies, at least one uniform baseline strictly
    # beaten on energy, and the servability proofs (best-accuracy AND
    # best PSUM-quantized front member) pass with backend parity.
    ok = (rep["n_heterogeneous_on_front"] >= 2
          and len(rep["baselines_energy_dominated"]) >= 1
          and rep["roundtrip"]["ok"]
          and rep["roundtrip_psum"].get("ok", True))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
