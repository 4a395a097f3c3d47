#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,serve --profile   # where time goes

Phases (each exits non-zero on failure):

  build      compile the CUDA kernels from the sources in this checkout
             (one nvcc per source, started together).
  kernels    hold each kernel against its plain PyTorch version on the
             card at TinyLlama-1.1B's and OLMoE-1B-7B's shapes: the APSQ
             GEMMs (generic, m=1) bit-exact at M in {1, 8, 16}, K in
             {2048, 5632}, N in {256, 2048, 5632} with per-column
             exponents; the W8A8 baseline bit-exact there and at M in
             {17, 32, 33} (beside torch._int_mm), at ragged shapes and
             with extreme codes at K=5632; the fused expert GEMMs (APSQ
             and W8A8) bit-exact at E=64, M in {1, 2, 3, 16}, (K, N) in
             {(2048, 1024), (1024, 2048)}, exponents [E, n_p] and
             [E, n_p, N]; INT8-KV attention (hd=64, Hq=32, Hkv=4 and
             hd=128, Hq=Hkv=16; decode and prefill-chunk forms, the
             serving shapes, decode over 1024 and 4096 positions, a chunk
             whose first rows see nothing) within rtol 2e-5 / atol 2e-6,
             the bound the JAX package holds its own kernel to.  The
             W8A8 and attention kernels must also repeat their output
             bit for bit.  Times each kernel (device time: calls captured
             in a CUDA graph, replay timed with CUDA events; ``eager_ms``
             adds the wrapper's host dispatch; weights rotate through
             more copies than the 50 MB L2 holds), its plain version and,
             where one exists, a single PyTorch call computing the same
             function.  At the two 8-slot chunk shapes the attention
             kernel is also timed with one and with two query rows per
             warp (``rows_per_warp_ms``), the choice its plan makes.
  reference  the tinyllama-smoke model, calibrated and exported on the
             CPU, served on the card and on the CPU: last-chunk logits
             agree within rtol/atol 1e-3 (float ops round differently on
             the two devices; the integer GEMMs are exact on both).
  serve      the main path at full TinyLlama-1.1B width (22 layers, random
             weights from a seed, bf16): init_lm -> calibrate_model ->
             PagedServingEngine.from_exported (mix2_ffn4 policy) -> run
             16 requests (prompts 5-60, 16-32 new tokens, one with EOS);
             a max_batch=1 engine on two of them must give the same greedy
             tokens; logits finite.
  w8a8       a full-width 2-layer model under the ffn_only policy, so the
             W8A8 baseline kernel serves the attention projections.
  moe_reference  the olmoe-smoke model, calibrated and exported on the
             CPU: card vs CPU last-chunk logits within rtol/atol 1e-3;
             one deployed MoE layer on the card makes no host round trip
             (torch.cuda.set_sync_debug_mode("error")).
  moe_serve  the MoE path at full OLMoE-1B-7B width and depth (16 layers,
             64 experts top-8, random bf16 weights from a seed): init_lm
             -> calibrate_model -> export_quantized -> PagedServingEngine
             (mix2_ffn4, 8 slots, page 16, chunk 16, horizon 8) -> run 16
             requests; logits finite.  On 4 of the requests, engines on
             the card with the same params, requests and max_batch: the
             CUDA GEMM kernels (plain attention) give the ``oracle``
             engine's greedy tokens, a ``cuda`` engine gives its own
             tokens again, and the ``cuda`` engine's agreement with the
             ``oracle`` engine is reported (its attention kernel differs
             from the plain version in the last float bits).  MoE
             capacity comes from the whole batch (idle slots included),
             so batched tokens are not held to single-stream here.
  moe_w8a8   OLMoE at full width cut to 2 layers under the uniform W8A8
             preset, so the W8A8 expert kernel serves the experts.

The main path runs in four configurations, each its own path: ``serve``
(mix2_ffn4: every layer APSQ), ``w8a8`` (ffn_only: W8A8 attention
projections), ``moe_serve`` (OLMoE, mix2_ffn4) and ``moe_w8a8`` (OLMoE,
W8A8).  Launch counts are zeroed just before each and read just after;
every kernel of each path must have launched.  The line before the
last holds the per-kernel record: ``launches`` is the count of the path
named in ``path``, ``launches_by_path`` each path's own count (never a
sum).  The last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
PHASES = ("build", "kernels", "reference", "serve", "w8a8", "moe_reference",
          "moe_serve", "moe_w8a8")
NO_BATCHED_INT8_MM = ("none: PyTorch has no single call for a batched "
                      "INT8 GEMM (torch._int_mm is 2-D and needs M > 16)")

# kernel -> (source, TPU kernel it replaces, the path whose zeroed run
# gives its "launches": serve = mix2_ffn4 at 22 layers, w8a8 = ffn_only,
# moe_serve = OLMoE mix2_ffn4 at 16 layers, moe_w8a8 = OLMoE W8A8)
SOURCES = {
    "apsq_matmul": ("src/repro_torch/kernels/apsq_matmul/csrc/apsq_matmul.cu",
                    "src/repro/kernels/apsq_matmul/kernel.py:214", "serve"),
    "apsq_matmul_m1": ("src/repro_torch/kernels/apsq_matmul/csrc/"
                       "apsq_matmul.cu",
                       "src/repro/kernels/apsq_matmul/kernel.py:294",
                       "serve"),
    "baseline_matmul": ("src/repro_torch/kernels/apsq_matmul/csrc/"
                        "apsq_matmul.cu",
                        "src/repro/kernels/apsq_matmul/kernel.py:509",
                        "w8a8"),
    "int8_kv_attention": ("src/repro_torch/kernels/int8_kv_attention/csrc/"
                          "int8_kv_attention.cu",
                          "src/repro/kernels/int8_kv_attention/kernel.py:93",
                          "serve"),
    "apsq_expert_matmul": ("src/repro_torch/kernels/apsq_matmul/csrc/"
                           "apsq_matmul.cu",
                           "src/repro/kernels/apsq_matmul/kernel.py:419",
                           "moe_serve"),
    "baseline_expert_matmul": ("src/repro_torch/kernels/apsq_matmul/csrc/"
                               "apsq_matmul.cu",
                               "src/repro/kernels/apsq_matmul/kernel.py:472",
                               "moe_w8a8"),
}
# kernels each path must launch
PATH_KERNELS = {
    "serve": ("apsq_matmul", "apsq_matmul_m1", "int8_kv_attention"),
    "w8a8": ("apsq_matmul", "apsq_matmul_m1", "baseline_matmul",
             "int8_kv_attention"),
    "moe_serve": ("apsq_matmul", "apsq_expert_matmul", "int8_kv_attention"),
    "moe_w8a8": ("baseline_matmul", "baseline_expert_matmul",
                 "int8_kv_attention"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        lines = out.stdout.strip().splitlines()
        return lines[0].strip() if lines else f"nvidia-smi: {out.stderr}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def timed_ms(torch, fn, n_inputs: int, iters: int = 30,
             warmup: int = 3) -> float:
    """Mean ms per eager call of ``fn(i)`` between CUDA events (host
    dispatch included: a small kernel's wrapper can dominate)."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i % n_inputs)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, n_inputs: int, iters: int = 30) -> float:
    """Mean device ms per call of ``fn(i)``: the calls are captured in a
    CUDA graph and the replay is timed, so host dispatch drops out."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(0)                       # warm the allocator on the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for i in range(iters):
                fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / iters


def both_ms(torch, fn, n_inputs: int, iters: int = 30):
    """(device ms, eager ms) of ``fn``; device ms is None if the calls
    cannot be captured in a graph."""
    eager = timed_ms(torch, fn, n_inputs, iters=iters)
    try:
        return device_ms(torch, fn, n_inputs, iters=iters), eager
    except RuntimeError as e:
        print(f"chip_smoke: graph timing failed: {e}", file=sys.stderr)
        return None, eager


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def baseline_rec(torch, ops, ref, x, ws, errors: list, *,
                 timed: bool = True) -> dict:
    """The W8A8 kernel on x @ ws[0]: bit-exact against its plain version
    and against a second call; with ``timed``, device and eager ms over
    the rotating weight copies ``ws`` beside the plain version and
    torch._int_mm (which refuses M <= 16)."""
    m, k = x.shape
    n = ws[0].shape[1]
    got = ops.baseline_matmul_int8(x, ws[0])
    again = ops.baseline_matmul_int8(x, ws[0])
    want = ref.baseline_matmul_ref(x, ws[0])
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    repeat = bool(torch.equal(got, again))
    if err or not repeat:
        errors.append(f"W8A8 M={m} K={k} N={n}: max|err|={err}, repeat "
                      f"equal={repeat}")
    rec = {"max_abs_err": err, "repeat_equal": repeat,
           "plan": list(ops.baseline_plan(m, n, k))}
    if not timed:
        return rec
    rec["ms"], rec["eager_ms"] = both_ms(
        torch, lambda i: ops.baseline_matmul_int8(x, ws[i]), len(ws))
    rec["plain_ms"], _ = both_ms(torch, lambda i: ref.baseline_matmul_ref(
        x, ws[i]), len(ws), iters=5)
    rec["bound_ms"], rec["bound_by"] = bound(
        m * k + k * n + m * n * 4, 2.0 * m * k * n, INT8_OPS_PER_S)
    rec["library"] = "torch._int_mm"
    try:   # one PyTorch call for the same int8 x int8 -> int32 GEMM
        got_l = torch._int_mm(x, ws[0])
        rec["library_max_abs_err"] = int(
            (got_l.long() - want.long()).abs().max())
        rec["library_ms"] = device_ms(
            torch, lambda i: torch._int_mm(x, ws[i]), len(ws))
    except (RuntimeError, TypeError) as e:
        rec.update(library_ms=None, library_error=str(e).splitlines()[0])
    return rec


def baseline_row(torch, ops, ref, gen, dev, m, k, n, errors: list, *,
                 timed: bool = True) -> dict:
    """``baseline_rec`` on fresh random codes at [m, k] @ [k, n]."""
    # weight copies rotate so the timed reads miss the 50 MB L2
    copies = max(1, math.ceil(120e6 / (k * n))) if timed else 1
    ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                        dtype=torch.int8) for _ in range(copies)]
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    return {"M": m, "K": k, "N": n, "baseline_matmul": baseline_rec(
        torch, ops, ref, x, ws, errors, timed=timed)}


def gemm_checks(torch, records: dict) -> list:
    from repro_torch.kernels.apsq_matmul import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errors, rows = [], []
    shapes = [(2048, 256), (2048, 2048), (2048, 5632), (5632, 2048)]
    for m in (1, 8, 16):
        for k, n in shapes:
            n_p, gs = (4, 2) if n != 5632 and k == 2048 else (8, 4)
            # weight copies rotate so the timed reads miss the 50 MB L2
            copies = max(1, math.ceil(120e6 / (k * n)))
            ws = [torch.randint(-128, 128, (k, n), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(copies)]
            x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            base = ref.choose_exps(x, ws[0], n_p=n_p, gs=gs)
            exps = (base[:, None] + torch.arange(n, device=dev)[None] % 3
                    ).to(torch.int32).contiguous()
            got = ops.apsq_matmul_int8(x, ws[0], exps, gs=gs)
            want = ref.apsq_matmul_ref(x, ws[0], exps, n_p=n_p, gs=gs)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            name = "apsq_matmul_m1" if m == 1 else "apsq_matmul"
            if err:
                errors.append(f"GEMM M={m} K={k} N={n}: apsq max|err|={err}")
            t_k, e_k = both_ms(torch, lambda i: ops.apsq_matmul_int8(
                x, ws[i], exps, gs=gs), copies)
            t_p, _ = both_ms(torch, lambda i: ref.apsq_matmul_ref(
                x, ws[i], exps, n_p=n_p, gs=gs), copies, iters=5)
            b_ms, b_by = bound(m * k + k * n + m * n * 4 + n_p * n * 4,
                               2.0 * m * k * n, INT8_OPS_PER_S)
            row = {"M": m, "K": k, "N": n, "n_p": n_p, "gs": gs,
                   name: {"ms": t_k, "eager_ms": e_k, "plain_ms": t_p,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err},
                   "baseline_matmul": baseline_rec(torch, ops, ref, x, ws,
                                                   errors)}
            rows.append(row)
            # the record of each kernel is its main-path decode shape
            if (m, k, n) in ((8, 2048, 5632), (1, 5632, 2048)):
                records[name] = dict(row[name], library_ms=None,
                                     shape=f"M={m} K={k} N={n} n_p={n_p} "
                                           f"gs={gs}")
            if (m, k, n) == (8, 2048, 2048):
                records["baseline_matmul"] = dict(
                    row["baseline_matmul"], shape=f"M={m} K={k} N={n}")
            del ws
    # torch._int_mm refuses M <= 16, so the baseline's library yardstick
    # starts at M = 17; the kernel, its plain version and _int_mm run on
    # the same inputs (M = 32 is the smallest multiple of 8 it takes)
    for m in (17, 32, 33):
        for k, n in ((2048, 2048), (2048, 5632), (5632, 2048)):
            row = baseline_row(torch, ops, ref, gen, dev, m, k, n, errors)
            rows.append(row)
            if (m, k, n) == (32, 2048, 2048):
                records["baseline_matmul"]["at_library_shape"] = dict(
                    row["baseline_matmul"], shape=f"M={m} K={k} N={n}")
    # ragged shapes, and extreme codes at K=5632 (|sum| up to 9.2e7)
    for m, k, n in ((1, 45, 16), (8, 45, 16), (33, 45, 16),
                    (17, 1100, 300)):
        rows.append(baseline_row(torch, ops, ref, gen, dev, m, k, n, errors,
                                 timed=False))
    for m in (8, 33):
        for xv, wv in ((-128, -128), (127, 127), (-128, 127)):
            x = torch.full((m, 5632), xv, dtype=torch.int8, device=dev)
            w = torch.full((5632, 2048), wv, dtype=torch.int8, device=dev)
            got = ops.baseline_matmul_int8(x, w)
            want = ref.baseline_matmul_ref(x, w)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or int(got[0, 0]) != 5632 * xv * wv:
                errors.append(f"W8A8 extreme codes {xv} x {wv} M={m}: "
                              f"{int(got[0, 0])} vs {5632 * xv * wv}")
            rows.append({"M": m, "K": 5632, "N": 2048,
                         "codes": [xv, wv], "baseline_matmul": {
                             "max_abs_err": int((got.long() - want.long())
                                                .abs().max())}})
    return rows, errors


def expert_checks(torch, records: dict) -> list:
    """The fused expert GEMMs at OLMoE's shapes (E=64 experts; M is the
    capacity: 2 at 8-slot decode, 3 at a 16-token prefill chunk)."""
    from repro_torch.kernels.apsq_matmul import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    E, n_p, gs = 64, 8, 4                      # mix2_ffn4 on the experts
    errors, rows = [], []
    for k, n in ((2048, 1024), (1024, 2048)):
        # one bank is 134 MB, past the 50 MB L2: no copies need rotating
        w = torch.randint(-128, 128, (E, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        for m in (1, 2, 3, 16):
            x = torch.randint(-128, 128, (E, m, k), generator=gen,
                              device=dev, dtype=torch.int8)
            want_b = ref.baseline_expert_matmul_ref(x, w)
            got_b = ops.baseline_expert_matmul_int8(x, w)
            torch.cuda.synchronize()
            err_b = int((got_b.long() - want_b.long()).abs().max())
            del want_b, got_b
            t_kb, e_kb = both_ms(torch, lambda i: ops.
                                 baseline_expert_matmul_int8(x, w), 1)
            t_pb, _ = both_ms(torch, lambda i: ref.
                              baseline_expert_matmul_ref(x, w), 1, iters=5)
            byts = E * k * n + E * m * k + 4 * E * m * n
            bb_ms, bb_by = bound(byts, 2.0 * E * m * k * n, INT8_OPS_PER_S)
            row = {"E": E, "M": m, "K": k, "N": n, "n_p": n_p, "gs": gs,
                   "baseline_expert_matmul": {
                       "ms": t_kb, "eager_ms": e_kb, "plain_ms": t_pb,
                       "bound_ms": bb_ms, "bound_by": bb_by,
                       "max_abs_err": err_b, "library_ms": None,
                       "library": NO_BATCHED_INT8_MM}}
            if err_b:
                errors.append(f"expert baseline E={E} M={m} K={k} N={n}: "
                              f"max|err|={err_b}")
            for layout in ("vec", "cols"):
                shape = (E, n_p) if layout == "vec" else (E, n_p, n)
                exps = torch.randint(0, 14, shape, generator=gen,
                                     device=dev, dtype=torch.int32)
                got = ops.apsq_expert_matmul_int8(x, w, exps, gs=gs)
                want = ref.apsq_expert_matmul_ref(x, w, exps, gs=gs)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                del got, want
                if err:
                    errors.append(f"expert APSQ E={E} M={m} K={k} N={n} "
                                  f"exps {layout}: max|err|={err}")
                t_k, e_k = both_ms(torch, lambda i: ops.
                                   apsq_expert_matmul_int8(x, w, exps,
                                                           gs=gs), 1)
                t_p, _ = both_ms(torch, lambda i: ref.apsq_expert_matmul_ref(
                    x, w, exps, gs=gs), 1, iters=5)
                b_ms, b_by = bound(byts + exps.numel() * 4,
                                   2.0 * E * m * k * n, INT8_OPS_PER_S)
                row[f"apsq_expert_matmul_{layout}"] = {
                    "ms": t_k, "eager_ms": e_k, "plain_ms": t_p,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                    "library_ms": None, "library": NO_BATCHED_INT8_MM}
            rows.append(row)
            # the record of each kernel is its main-path decode shape:
            # per-column exponents (per-channel weights), 8 slots -> M=2
            if (m, k, n) == (2, 2048, 1024):
                shape_s = f"E={E} M={m} K={k} N={n}"
                records["apsq_expert_matmul"] = dict(
                    row["apsq_expert_matmul_cols"],
                    shape=f"{shape_s} n_p={n_p} gs={gs} exps [E,n_p,N]")
                records["baseline_expert_matmul"] = dict(
                    row["baseline_expert_matmul"], shape=shape_s)
        del w
    return rows, errors


def rows_per_warp_ms(torch, ops, args, want, errors: list) -> dict:
    """Device ms of the attention kernel on ``args`` with one and with two
    query rows per warp, S unsplit, whatever its plan picks; each result
    is held to ``want`` as the planned one is."""
    B, S = args[1].shape[:2]
    C, Hq, Hkv = args[0].shape[1], args[0].shape[2], args[1].shape[2]
    planned, out = ops.attention_plan, {}
    for rw in (1, 2):
        ops.attention_plan = lambda *_, rw=rw: ops.AttentionPlan(
            rw, math.ceil(C * (Hq // Hkv) / (ops.WARPS * rw)), 1,
            math.ceil(S / ops.TILE_S) * ops.TILE_S)
        try:
            got = ops.int8_kv_attention(*args)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=2e-5, atol=2e-6):
                errors.append(f"attention B={B} C={C} hd={args[0].shape[3]} "
                              f"at {rw} rows per warp disagrees")
            out[rw], _ = both_ms(torch, lambda i: ops.int8_kv_attention(
                *args), 1)
        finally:
            ops.attention_plan = planned
    return out


def attention_checks(torch, records: dict, pages_per_slot: int) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.int8_kv_attention import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    S_serve = pages_per_slot * 16
    errors, rows = [], []
    # (Hq, Hkv, hd): TinyLlama-1.1B, OLMoE-1B-7B.  The serving shapes
    # (8-slot decode, 16-token chunks at B=1 and 8), decode over long
    # caches at B=1 (S split across blocks), and a chunk at length 5,
    # whose first rows see no position (the reference averages V there)
    cases = [(heads, label, B, C, S, fixed)
             for heads in ((32, 4, 64), (16, 16, 128))
             for label, B, C, S, fixed in (
                 ("decode", 8, 0, S_serve, None),
                 ("chunk", 1, 16, S_serve, None),
                 ("chunk", 8, 16, S_serve, None),
                 ("decode", 1, 0, 1024, None), ("decode", 1, 0, 4096, None),
                 ("chunk", 1, 16, S_serve, 5))]
    for (Hq, Hkv, hd), label, B, C, S, fixed in cases:
        qshape = (B, Hq, hd) if C == 0 else (B, C, Hq, hd)
        q = torch.randn(qshape, generator=gen, device=dev)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev) * 2
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
        kc, ke = ref.quantize_kv_po2(k)
        vc, ve = ref.quantize_kv_po2(v)
        lo = max(C, 1)
        length = (torch.full((B,), fixed, dtype=torch.int32, device=dev)
                  if fixed else
                  torch.randint(lo, S + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32))
        got = ops.int8_kv_attention(q, kc, vc, ke, ve, length)
        again = ops.int8_kv_attention(q, kc, vc, ke, ve, length)
        want = ref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-6))
        repeat = bool(torch.equal(got, again))
        if not ok or not repeat:
            errors.append(f"attention {label} B={B} C={C} S={S} hd={hd}: "
                          f"max|err|={err}, repeat equal={repeat}")
        t_k, e_k = both_ms(torch, lambda i: ops.int8_kv_attention(
            q, kc, vc, ke, ve, length), 1)
        t_p, _ = both_ms(torch, lambda i: ref.int8_kv_attention_ref(
            q, kc, vc, ke, ve, length), 1, iters=10)
        # yardstick: SDPA on the dequantized cache (float inputs)
        q4 = (q[:, None] if C == 0 else q).transpose(1, 2)        # B,Hq,C,hd
        kd = ref.dequantize_kv_po2(kc, ke).transpose(1, 2)
        vd = ref.dequantize_kv_po2(vc, ve).transpose(1, 2)
        Cq = q4.shape[2]
        lim = (length[:, None] - Cq + 1
               + torch.arange(Cq, device=dev)[None])              # B, C
        mask = (torch.arange(S, device=dev)[None, None] < lim[..., None])
        mask = mask[:, None]                                       # B,1,C,S
        errors_lib = None
        try:
            t_lib = device_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, enable_gqa=True), 1)
        except (RuntimeError, TypeError) as e:
            t_lib = None
            errors_lib = str(e).splitlines()[0]
        # the function reads only the K/V positions some row can see:
        # up to the largest limit of each batch row (= its length); a row
        # that sees none averages V over all S
        rows_valid = lim.clamp(min=0, max=S).sum().item() * Hq
        blind = (lim <= 0)
        pos_k = lim.max(dim=1).values.clamp(min=0, max=S)
        pos_v = torch.where(blind.any(dim=1), S, pos_k)
        byts = (q.numel() * 4 * 2 + (pos_k + pos_v).sum().item() * Hkv * hd
                + 2 * B * Hkv * 4 + B * 4)
        b_ms, b_by = bound(byts, 4.0 * rows_valid * hd
                           + 2.0 * blind.sum().item() * Hq * S * hd,
                           F32_OPS_PER_S)
        row = {"form": label, "B": B, "C": max(C, 1), "S": S, "Hq": Hq,
               "Hkv": Hkv, "hd": hd, "length": fixed, "ms": t_k,
               "eager_ms": e_k, "plain_ms": t_p,
               "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err, "repeat_equal": repeat,
               "plan": list(ops.attention_plan(B, max(C, 1), Hq, Hkv, S)),
               "library": "sdpa on the dequantized cache"}
        if errors_lib:
            row["library_error"] = errors_lib
        if label == "chunk" and B == 8:
            row["rows_per_warp_ms"] = rows_per_warp_ms(
                torch, ops, (q, kc, vc, ke, ve, length), want, errors)
        rows.append(row)
        if label == "decode" and S == S_serve:
            rec = {k_: row[k_] for k_ in ("ms", "eager_ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
            rec["shape"] = f"decode B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd}"
            if hd == 64:
                records["int8_kv_attention"] = rec
            else:
                records["int8_kv_attention"][f"at_hd{hd}"] = rec
    return rows, errors


# ---------------------------------------------------------------------------
# Phases driving the port
# ---------------------------------------------------------------------------

def make_requests(np, rng, n, vocab, lo_p, hi_p, lo_n, hi_n, Request):
    return [Request(uid=i,
                    tokens=rng.integers(0, vocab, size=int(
                        rng.integers(lo_p, hi_p + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(lo_n, hi_n + 1)))
            for i in range(n)]


def top2_margin(torch, params, cfg, tokens, device) -> float:
    """Top-2 logit margin of the next token after ``tokens`` (prefill in
    one-token steps over a fresh single-slot paged cache)."""
    from repro_torch.models import forward_paged_chunk, init_paged_decode_state
    n = len(tokens)
    st = init_paged_decode_state(cfg, 1, page_size=16, n_pages=n // 16 + 2,
                                 device=device)
    table = torch.arange(1, n // 16 + 2, dtype=torch.int32,
                         device=device)[None]
    for t in range(n):
        lg, st = forward_paged_chunk(
            params, cfg, st, torch.tensor([[int(tokens[t])]], device=device),
            torch.tensor([t], dtype=torch.int32, device=device), table)
    top = torch.topk(lg[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_reference(torch, np, smoke_config):
    """Smoke config: the card's logits against the CPU's."""
    from repro_torch.checkpoint import to_device
    from repro_torch.models import forward_paged_chunk, init_lm, \
        init_paged_decode_state
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    cfg = smoke_config().with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(0)
    params = init_lm(cfg, seed=3, device="cpu")
    deploy, _ = export_quantized(calibrate_model(
        params, cfg, {"tokens": rng.integers(0, cfg.vocab, (2, 16))}))
    toks = rng.integers(0, cfg.vocab, 13)
    out = {}
    for dev in ("cpu", "cuda"):
        d = to_device(deploy, dev)
        st = init_paged_decode_state(cfg, 1, page_size=4, n_pages=8,
                                     device=dev)
        table = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
        done = 0
        for c in (8, 4, 1):
            lg, st = forward_paged_chunk(
                d, cfg, st, torch.tensor(toks[done:done + c][None],
                                         device=dev),
                torch.tensor([done], dtype=torch.int32, device=dev), table)
            done += c
        out[dev] = lg.float().cpu()
    err = float((out["cpu"] - out["cuda"]).abs().max())
    ok = bool(torch.allclose(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3))
    info = {"config": cfg.name, "max_abs_err": err,
            "logits_shape": list(out["cuda"].shape),
            "finite": bool(torch.isfinite(out["cuda"]).all())}
    if cfg.mlp == "moe":
        info["moe_host_syncs"] = moe_sync_check(torch, to_device(
            deploy["units"]["u0"]["0"]["ffn"], "cuda"), cfg)
        ok = ok and info["moe_host_syncs"] == "none"
    return info, ok


def moe_sync_check(torch, ffn, cfg) -> str:
    """One deployed MoE layer on the card (router, top-k, dispatch, the
    expert kernels, combine) under sync_debug_mode "error": any host
    round trip raises.  Returns "none" or the error."""
    from repro_torch.models import moe_ffn
    x = torch.randn((8, 1, cfg.d_model), device="cuda")
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, backend="cuda")
    moe_ffn(ffn, x, **kw)                        # warm up the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_ffn(ffn, x, **kw)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return "none"


def profile_summary(prof, wall_s: float) -> dict:
    """Device time by kernel name over the profiled window, and the share
    of the window the device was busy (sum of kernel times / wall)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue              # host-side ops: their kernels appear apart
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    return {"device_busy_s": total_us / 1e6,
            "device_busy_share": total_us / 1e6 / wall_s,
            "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:15]]}


def serve_all(torch, _build, dev, eng, reqs, profile: bool,
              info: dict) -> list:
    """Run ``reqs`` to the end on ``eng``; with ``profile``, trace the
    third heartbeat (device activity only: cheap).  Records the serve
    time, the launch counts and the engine's counters in ``info``."""
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        for r in reqs:
            eng.add_request(r)
        done, beat = [], 0
        while eng.sched.waiting or any(s is not None
                                       for s in eng.sched.slots):
            if beat == 2:
                sync(torch, dev)
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                tw = time.perf_counter()
            done.extend(eng.step())
            if beat == 2:
                sync(torch, dev)
                window = time.perf_counter() - tw
                prof.__exit__(None, None, None)
                info["profile"] = profile_summary(prof, window)
                info["profile"]["window_s"] = window
                info["profile"]["window"] = "engine heartbeat 2"
            beat += 1
    else:
        done = eng.run(reqs)
    sync(torch, dev)
    info["serve_s"] = time.perf_counter() - t0
    info["profiled"] = profile      # a traced run is slower
    info["launches"] = dict(_build.launch_counts)
    n_tok = sum(len(r.out) for r in done)
    info.update(requests=len(done), generated_tokens=n_tok,
                tokens_per_s=n_tok / info["serve_s"],
                decode_dispatches=eng.decode_dispatches,
                prefill_dispatches=eng.prefill_dispatches,
                horizon_hist=eng.horizon_hist,
                preempted=eng.sched.stats.preempted,
                peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                             if dev.type == "cuda" else None))
    return done


def missing_launches(path: str, launches: dict) -> list:
    return [f"kernel {k} never launched on the {path} path"
            for k in PATH_KERNELS[path] if launches.get(k, 0) == 0]


def phase_serve(torch, np, _build, cfg, dev, profile: bool = False):
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(12)
    info = {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 64))})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    reqs = make_requests(np, rng, 16, cfg.vocab, 5, 60, 16, 32, Request)
    pages = math.ceil((60 + 32) / 16)
    kw = dict(page_size=16, prefill_chunk=16, decode_horizon=8,
              max_pages_per_slot=pages)
    # single-stream reference for requests 0 and 1 (request 0 probes EOS)
    t0 = time.perf_counter()
    solo = PagedServingEngine.from_exported(params, cfg, max_batch=1,
                                            n_pages=pages + 1, **kw)
    info["export_s"] = time.perf_counter() - t0
    single = {}
    for r in reqs[:2]:
        probe = Request(uid=r.uid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens)
        solo.run([probe])
        single[r.uid] = probe.out
    out0 = single[0]
    step = next(i for i in range(1, len(out0)) if out0[i] not in out0[:i])
    reqs[0].eos_token = out0[step]
    eng = PagedServingEngine(solo.params, cfg, max_batch=8,
                             n_pages=8 * pages + 1, **kw)
    done = serve_all(torch, _build, dev, eng, reqs, profile, info)
    outs = {r.uid: r.out for r in done}
    n_tok = info["generated_tokens"]
    problems = []
    if len(done) != 16:
        problems.append(f"{len(done)} of 16 requests finished")
    if outs.get(0) != out0[:step + 1]:
        problems.append(f"EOS stream: {outs.get(0)} vs expected "
                        f"{out0[:step + 1]}")
    if outs.get(1) != single[1]:
        a, b = outs.get(1, []), single[1]
        i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 min(len(a), len(b)))
        margin = top2_margin(torch, eng.params, cfg,
                             list(reqs[1].tokens) + b[:i], dev)
        problems.append(f"batched != single-stream for request 1 at step "
                        f"{i}: {a[i:i + 1]} vs {b[i:i + 1]}, single-stream "
                        f"top-2 logit margin {margin}")
    from repro_torch.models import forward_paged_chunk, init_paged_decode_state
    st = init_paged_decode_state(cfg, 1, page_size=16, n_pages=3, device=dev)
    lg, _ = forward_paged_chunk(
        eng.params, cfg, st, torch.tensor(reqs[2].tokens[None][:, :16],
                                          device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([[1, 2]], dtype=torch.int32, device=dev))
    info["logits_finite"] = bool(torch.isfinite(lg).all())
    if not info["logits_finite"] or list(lg.shape) != [1, 1, cfg.vocab]:
        problems.append(f"logits {list(lg.shape)} finite="
                        f"{info['logits_finite']}")
    problems += missing_launches("serve", info["launches"])
    return info, problems


def phase_w8a8(torch, np, _build, cfg, dev):
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.scaled(n_layers=2).with_quant(policy_presets()["ffn_only"])
    rng = np.random.default_rng(13)
    _build.reset_launch_counts()
    params = init_lm(cfg, seed=1, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    eng = PagedServingEngine.from_exported(
        params, cfg, max_batch=4, n_pages=4 * 4 + 1, page_size=16,
        prefill_chunk=16, decode_horizon=4, max_pages_per_slot=4)
    done = eng.run(reqs)
    sync(torch, dev)
    info = {"launches": dict(_build.launch_counts), "requests": len(done),
            "generated_tokens": sum(len(r.out) for r in done)}
    problems = missing_launches("w8a8", info["launches"])
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    return info, problems


def first_divergence(a: dict, b: dict):
    """(uid, step) of the first token where two runs differ, or None."""
    for uid in sorted(set(a) | set(b)):
        x, y = a.get(uid, []), b.get(uid, [])
        for i in range(max(len(x), len(y))):
            if i >= len(x) or i >= len(y) or x[i] != y[i]:
                return uid, i
    return None


def phase_moe_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full OLMoE-1B-7B: init -> calibrate -> export -> serve 16
    requests on 8 slots; then a cuda engine and an oracle engine on the
    card serve 4 of them with the same params and max_batch."""
    from repro_torch.models import forward_paged_chunk, init_lm, \
        init_paged_decode_state
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(21)
    info = {}
    _build.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 64))})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    del params                          # the float expert banks go
    banks = [r for r in report.values() if "n_experts" in r]
    info["expert_banks"] = {
        "count": sum(r["count"] for r in banks),
        "int8_gb": sum(r["int8_bytes"] * r["count"] for r in banks) / 1e9}
    reqs = make_requests(np, rng, 16, cfg.vocab, 5, 48, 8, 16, Request)
    pages = math.ceil((48 + 16) / 16)
    kw = dict(max_batch=8, n_pages=8 * pages + 1, page_size=16,
              prefill_chunk=16, decode_horizon=8, max_pages_per_slot=pages)
    eng = PagedServingEngine(deploy, cfg, **kw)
    done = serve_all(torch, _build, dev, eng, reqs, profile, info)
    problems = missing_launches("moe_serve", info["launches"])
    if len(done) != 16:
        problems.append(f"{len(done)} of 16 requests finished")
    st = init_paged_decode_state(cfg, 1, page_size=16, n_pages=3, device=dev)
    lg, _ = forward_paged_chunk(
        deploy, cfg, st, torch.tensor(reqs[2].tokens[None][:, :16],
                                      device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([[1, 2]], dtype=torch.int32, device=dev))
    info["logits_finite"] = bool(torch.isfinite(lg).all())
    if not info["logits_finite"] or list(lg.shape) != [1, 1, cfg.vocab]:
        problems.append(f"logits {list(lg.shape)} finite="
                        f"{info['logits_finite']}")
    # Engines on the card, 4 requests, 8 slots, same params.  Held to
    # equal greedy tokens: the CUDA GEMM kernels with the plain attention
    # against the oracle (the integer kernels are exact, so every float
    # op downstream is the same), and the cuda engine against a second
    # run of itself (deterministic).  The cuda engine against the oracle
    # is reported: its attention kernel agrees with the plain version
    # only within rtol 2e-5, and under bf16 rounding, a top-8 routing
    # near a tie and greedy argmax that can change a token.
    sub = {}
    for name, backend in (("cuda", "cuda"), ("cuda_again", "cuda"),
                          ("cuda_gemms", gemm_kernels_plain_attention()),
                          ("oracle", "oracle")):
        t0 = time.perf_counter()
        e = PagedServingEngine(deploy, cfg, backend=backend, **kw)
        outs = e.run([Request(uid=r.uid, tokens=r.tokens,
                              max_new_tokens=r.max_new_tokens)
                      for r in reqs[:4]])
        sync(torch, dev)
        sub[name] = {r.uid: r.out for r in outs}
        info[f"sub_{name}_s"] = time.perf_counter() - t0
    info["sub_tokens"] = sum(len(o) for o in sub["oracle"].values())
    for name, ref_name, held in (("cuda_gemms", "oracle", True),
                                 ("cuda_again", "cuda", True),
                                 ("cuda", "oracle", False)):
        a, b = sub[name], sub[ref_name]
        div = first_divergence(a, b)
        key = f"{name}_vs_{ref_name}"
        info[key] = {"equal": div is None, "equal_tokens": sum(
            x == y for u in b for x, y in zip(a.get(u, []), b[u]))}
        if div is not None:
            uid, i = div
            info[key]["first_divergence"] = {
                "request": uid, "step": i, name: a[uid][i:i + 1],
                ref_name: b[uid][i:i + 1]}
            if held:
                problems.append(f"{name} engine != {ref_name} engine: "
                                f"{info[key]['first_divergence']}")
    # how far the cuda and oracle backends' logits lie apart on the same
    # single-slot forward, beside the oracle's top-2 margin: each
    # request's prompt, and the prefix where the engines diverged
    prefixes = {f"prompt {r.uid}": list(r.tokens) for r in reqs[:4]}
    div = info["cuda_vs_oracle"].get("first_divergence")
    if div:
        r = reqs[div["request"]]
        prefixes["divergence"] = (list(r.tokens)
                                  + sub["oracle"][r.uid][:div["step"]])
    info["cuda_vs_oracle_logits"] = {
        k: logit_gap(torch, deploy, cfg, toks, dev)
        for k, toks in prefixes.items()}
    return info, problems


def logit_gap(torch, params, cfg, tokens, dev) -> dict:
    """Next-token logits after ``tokens`` (one slot, 16-token chunks)
    from the cuda and the oracle backend: max |difference|, the
    oracle's top-2 margin, and whether the argmax agrees."""
    from repro_torch.models import forward_paged_chunk, \
        init_paged_decode_state
    n = len(tokens)
    pages = n // 16 + 1
    out = {}
    for backend in ("cuda", "oracle"):
        st = init_paged_decode_state(cfg, 1, page_size=16, n_pages=pages + 1,
                                     device=dev)
        table = torch.arange(1, pages + 1, dtype=torch.int32,
                             device=dev)[None]
        for s0 in range(0, n, 16):
            lg, st = forward_paged_chunk(
                params, cfg, st,
                torch.tensor([tokens[s0:s0 + 16]], device=dev),
                torch.tensor([s0], dtype=torch.int32, device=dev), table,
                backend=backend)
        out[backend] = lg[0, -1].float()
    top = torch.topk(out["oracle"], 2).values
    return {"max_abs_diff": float((out["cuda"] - out["oracle"]).abs().max()),
            "oracle_top2_margin": float(top[0] - top[1]),
            "argmax_equal": bool(out["cuda"].argmax() == out["oracle"].argmax())}


def gemm_kernels_plain_attention():
    """A backend with the CUDA GEMM kernels and the plain attention."""
    from repro_torch.exec import CudaBackend, get_backend

    class CudaGemms(CudaBackend):
        name = "cuda_gemms"

        def kv_attention(self, *args):
            return get_backend("oracle").kv_attention(*args)

    return CudaGemms()


def phase_moe_w8a8(torch, np, _build, cfg, dev):
    """OLMoE at full width, 2 layers, uniform W8A8: every projection on
    the INT32-accumulator kernels, the experts on the fused one."""
    from repro_torch.core import QuantConfig
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.scaled(n_layers=2).with_quant(QuantConfig.w8a8())
    rng = np.random.default_rng(22)
    _build.reset_launch_counts()
    params = init_lm(cfg, seed=1, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    eng = PagedServingEngine.from_exported(
        params, cfg, max_batch=4, n_pages=4 * 4 + 1, page_size=16,
        prefill_chunk=16, decode_horizon=4, max_pages_per_slot=4)
    done = eng.run(reqs)
    sync(torch, dev)
    info = {"launches": dict(_build.launch_counts), "requests": len(done),
            "generated_tokens": sum(len(r.out) for r in done)}
    problems = missing_launches("moe_w8a8", info["launches"])
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    return info, problems


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="trace one heartbeat of the serve and moe_serve "
                         "phases' batched engines with torch.profiler")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            fail(f"unknown phase {p!r}")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing package: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    from repro_torch.configs import olmoe_1b_7b, tinyllama_1_1b
    from repro_torch.kernels import _build
    cuda = torch.device("cuda")

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 head: full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    detail = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    records: dict = {}
    launches: dict = {}     # path -> its own zeroed run's counts
    t_all = time.perf_counter()
    for phase in ["build"] + [p for p in phases if p != "build"]:
        t0 = time.perf_counter()
        problems, info = [], {}
        if phase == "build":
            info = {"built": _build.build_all()}
            info["ptxas"] = {k: [ln for ln in v.splitlines()
                                 if "registers" in ln or "spill" in ln]
                             for k, v in _build.build_log.items()}
        elif phase == "kernels":
            g_rows, g_err = gemm_checks(torch, records)
            x_rows, x_err = expert_checks(torch, records)
            a_rows, a_err = attention_checks(torch, records,
                                             pages_per_slot=6)
            info = {"gemm": g_rows, "expert_gemm": x_rows,
                    "attention": a_rows}
            problems = g_err + x_err + a_err
        elif phase in ("reference", "moe_reference"):
            arch = olmoe_1b_7b if phase == "moe_reference" \
                else tinyllama_1_1b
            info, ok = phase_reference(torch, np, arch.smoke_config)
            if not ok or not info["finite"]:
                problems.append(f"card vs CPU logits: {info}")
        elif phase == "serve":
            info, problems = phase_serve(torch, np, _build,
                                         tinyllama_1_1b.CONFIG, cuda,
                                         profile=args.profile)
        elif phase == "w8a8":
            info, problems = phase_w8a8(torch, np, _build,
                                        tinyllama_1_1b.CONFIG, cuda)
        elif phase == "moe_serve":
            info, problems = phase_moe_serve(torch, np, _build,
                                             olmoe_1b_7b.CONFIG, cuda,
                                             profile=args.profile)
        elif phase == "moe_w8a8":
            info, problems = phase_moe_w8a8(torch, np, _build,
                                            olmoe_1b_7b.CONFIG, cuda)
        if "launches" in info:
            launches[phase] = info["launches"]
        dt = time.perf_counter() - t0
        detail[phase] = info
        short = {k: v for k, v in info.items()
                 if k not in ("gemm", "expert_gemm", "attention", "ptxas",
                              "profile")}
        emit({"phase": phase, "ok": not problems, "seconds": round(dt, 3),
              "card": card, **short})
        if problems:
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                      "w") as f:
                json.dump(detail, f, indent=1, default=str)
            fail(f"phase {phase}: " + "; ".join(problems))
    detail["seconds"] = time.perf_counter() - t_all
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    if "kernels" in phases:
        kernels = []
        for name, (source, replaces, path) in SOURCES.items():
            r = records.get(name, {})
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches.get(path, {}).get(name),
                "path": path,
                "launches_by_path": {p: c.get(name)
                                     for p, c in launches.items()},
                "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                "eager_ms": r.get("eager_ms"),
                "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                "bound_by": r.get("bound_by"),
                "library_ms": r.get("library_ms"),
                "shape": r.get("shape"),
                **{k: v for k, v in r.items()
                   if k.startswith("at_") or k == "library"}})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
