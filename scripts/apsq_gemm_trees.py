#!/usr/bin/env python3
"""Time the APSQ GEMM wrapper of one or more checkouts on one GPU.

    python3 scripts/apsq_gemm_trees.py OTHER/src src src OTHER/src

Each argument is the ``src`` directory of a checkout.  Its
``repro_torch`` runs in a process of its own, in the order given, so
two trees are compared inside one call in turns (parent, change,
change, parent).  Every tree gets the shapes of ``chip_smoke.py``'s
kernels phase (TinyLlama-1.1B's projections at ``APSQ_M`` rows,
mix2_ffn4's n_p and gs) through that script's own helpers
(``apsq_case``, ``apsq_rec``): device ms of calls captured in a CUDA
graph, weights rotating past the 50 MB L2, each result bit-exact against
the tree's own plain version.  Prints one JSON line per tree and writes
them all to ``chiprun_out/apsq_gemm_trees.json``; exits non-zero if a
tree fails or disagrees.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_tree(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.apsq_matmul import ops, ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, errors = [], []
    for m in cs.APSQ_M:
        for k, n in cs.APSQ_KN:
            x, ws, exps, gs = cs.apsq_case(torch, ref, gen, dev, m, k, n)
            rec = cs.apsq_rec(torch, ops, ref, x, ws, exps, gs, errors)
            rows.append({"M": m, "K": k, "N": n, "n_p": exps.shape[0],
                         "gs": gs, **rec})
            del ws
    return {"src": src, "card": cs.card_line(), "rows": rows,
            "errors": errors}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    runs, ok = [], True
    for src in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", src], capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{src}: rc {proc.returncode}\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            ok = False
            continue
        run = json.loads(lines[-1])
        ok = ok and not run["errors"]
        runs.append(run)
        print(json.dumps({"src": src, "errors": run["errors"], "ms": {
            f"M={r['M']} K={r['K']} N={r['N']}": r["ms"]
            for r in run["rows"]}}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "apsq_gemm_trees.json"),
              "w") as f:
        json.dump(runs, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
