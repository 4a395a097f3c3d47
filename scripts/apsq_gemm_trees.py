#!/usr/bin/env python3
"""Time the APSQ GEMM wrappers of one or more checkouts on one GPU.

    python3 scripts/apsq_gemm_trees.py OTHER/src src src OTHER/src
    python3 scripts/apsq_gemm_trees.py --kernels experts OTHER/src src ...

Each argument is the ``src`` directory of a checkout.  Its
``repro_torch`` runs in a process of its own, in the order given, so
two trees are compared inside one call in turns (parent, change,
change, parent).  ``--kernels`` picks ``dense`` (the generic and m=1
APSQ GEMMs), ``experts`` (the fused APSQ and W8A8 expert GEMMs) or
``all`` (the default).  Every tree gets the shapes of ``chip_smoke.py``'s
kernels phase through that script's own helpers: TinyLlama-1.1B's
projections at ``APSQ_M`` rows under mix2_ffn4 (``apsq_case``,
``apsq_rec``), and OLMoE-1B-7B's expert banks (E=64, K/N 2048/1024 and
1024/2048, M in ``EXPERT_M``, every expert live, and the 8-slot decode
routing of ``routed_codes``).  Device ms of calls captured in a CUDA
graph (weights past the 50 MB L2), each result bit-exact against
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
EXPERT_M = (1, 2, 3, 16, "routed")


def expert_rows(torch, cs, ops, ref, dev, errors: list) -> list:
    """Both expert wrappers of the tree at OLMoE's shapes (n_p=8 gs=4,
    exponents [E, n_p, N]): device ms and the bound over the live
    experts' weight bytes."""
    gen = torch.Generator(device=dev).manual_seed(2)
    E, n_p, gs, rows = 64, 8, 4, []
    for k, n in ((2048, 1024), (1024, 2048)):
        w = torch.randint(-128, 128, (E, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        exps = torch.randint(0, 14, (E, n_p, n), generator=gen, device=dev,
                             dtype=torch.int32)
        for m in EXPERT_M:
            x = (cs.routed_codes(torch, gen, dev, E, k) if m == "routed" else
                 torch.randint(-128, 128, (E, m, k), generator=gen,
                               device=dev, dtype=torch.int8))
            live = int((x != 0).flatten(1).any(1).sum())
            row = {"M": m, "K": k, "N": n, "live_experts": live}
            for name, call, plain, extra in (
                    ("apsq_expert_matmul",
                     lambda i: ops.apsq_expert_matmul_int8(x, w, exps,
                                                           gs=gs),
                     lambda: ref.apsq_expert_matmul_ref(x, w, exps, gs=gs),
                     exps.numel() * 4),
                    ("baseline_expert_matmul",
                     lambda i: ops.baseline_expert_matmul_int8(x, w),
                     lambda: ref.baseline_expert_matmul_ref(x, w), 0)):
                if not torch.equal(call(0), plain()):
                    errors.append(f"{name} M={m} K={k} N={n} disagrees")
                ms, _ = cs.both_ms(torch, call, 1)
                b_ms, _ = cs.bound(live * k * n + E * x.shape[1] * (k + 4 * n)
                                   + extra, 2.0 * live * x.shape[1] * k * n,
                                   cs.INT8_OPS_PER_S)
                row[name] = {"ms": ms, "bound_ms": b_ms}
            rows.append(row)
        del w
    return rows


def one_tree(src: str, kernels: str) -> dict:
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
    for m in cs.APSQ_M if kernels in ("dense", "all") else ():
        for k, n in cs.APSQ_KN:
            x, ws, exps, gs = cs.apsq_case(torch, ref, gen, dev, m, k, n)
            rec = cs.apsq_rec(torch, ops, ref, x, ws, exps, gs, errors)
            rows.append({"M": m, "K": k, "N": n, "n_p": exps.shape[0],
                         "gs": gs, **rec})
            del ws
    experts = (expert_rows(torch, cs, ops, ref, dev, errors)
               if kernels in ("experts", "all") else [])
    return {"src": src, "card": cs.card_line(), "rows": rows,
            "experts": experts, "errors": errors}


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--one":
        print(json.dumps(one_tree(args[1], args[2])), flush=True)
        return 0
    kernels = "all"
    if args[:1] == ["--kernels"]:
        kernels, args = args[1], args[2:]
    if not args or kernels not in ("dense", "experts", "all"):
        raise SystemExit(__doc__)
    runs, ok = [], True
    for src in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", src, kernels], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{src}: rc {proc.returncode}\n{proc.stderr[-3000:]}",
                  file=sys.stderr)
            ok = False
            continue
        run = json.loads(lines[-1])
        ok = ok and not run["errors"]
        runs.append(run)
        ms = {f"M={r['M']} K={r['K']} N={r['N']}": r["ms"]
              for r in run["rows"]}
        for r in run["experts"]:
            for name in ("apsq_expert_matmul", "baseline_expert_matmul"):
                ms[f"{name} M={r['M']} K={r['K']} N={r['N']}"] = \
                    r[name]["ms"]
        print(json.dumps({"src": src, "errors": run["errors"], "ms": ms}),
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "apsq_gemm_trees.json"),
              "w") as f:
        json.dump(runs, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
