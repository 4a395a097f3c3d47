#!/usr/bin/env python3
"""What the fixed row blocks of the recurrent paged path buy and cost on
one GPU, at full-width RWKV6-3B (bf16).

    python3 scripts/rwkv_row_blocks.py [--layers 32] [--reps 20] [--steps 16]

A model with recurrent layers runs its float GEMMs and norms in blocks
of ``common.ROW_BLOCK`` rows on the paged serving path
(``common.row_blocks``, turned on by ``forward_paged_chunk``).  This
script measures:

1. per op, which row counts change a row's result: each float op of the
   path on random inputs X [16, K] (seed 0; heavy-tailed, N(0, 1) times
   exp(N(0, 1.5)), as activations are), op(X[:m]) against op(X)[:m]
   bit for bit for m = 1..16, plain and through ``rows_apply``;
2. the model, init (seed 0) -> calibrate (2 x 32 tokens) -> export
   (mix2_ffn4), then ``forward_paged_chunk`` in five modes, in this
   order: ``on`` (as served), ``off`` (``row_blocks`` replaced by a
   no-op), ``norms_only`` (float GEMMs unblocked), ``gemms_only``
   (norms unblocked), ``on_again``.  Per mode: the host wall time per
   call (median of ``--reps``) of a decode step at batch 8 and of a
   16-token prefill chunk at batch 1; and 8 requests, each prefilled
   alone (16 tokens), decoded ``--steps`` steps at batch 8 and each
   alone on the same tokens: the (step, request) pairs whose logits
   differ bit for bit.

Prints one JSON object and writes it to
``chiprun_out/rwkv_row_blocks.json``.  Needs a GPU; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def op_rows(torch, dev) -> dict:
    """{op: {"plain": [m that differ], "blocked": [...]}} at the model's
    widths (d 2560, 40 heads of 64, LoRA ranks 64 and 5 x 64, vocab
    65536), bf16 operands as served (the group norm in float32)."""
    from repro_torch.models.common import _norm, rows_apply
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        scale = torch.exp(torch.randn(shape, generator=g, device=dev) * 1.5)
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    ln = {"scale": torch.rand(2560, generator=g, device=dev).to(bf) + 0.5,
          "bias": torch.randn(2560, generator=g, device=dev).to(bf)}

    def group_norm(y):                  # rwkv_time_mix's, over 40 heads
        y = y.reshape(y.shape[0], 40, 64)
        mu = y.mean(dim=-1, keepdim=True)
        var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
        return ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(y.shape[0], -1)

    def gemm(k, n):
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(bf)
        return k, lambda x: x @ w

    ops = {"layernorm 2560": (2560, lambda x: _norm(ln, x, "layernorm",
                                                    1e-6)),
           "group norm 40x64 (f32)": (2560, group_norm),
           "mix_w1 2560x320": gemm(2560, 320),
           "mix_w2 64x2560": gemm(64, 2560),
           "decay_w1 2560x64": gemm(2560, 64),
           "decay_w2 64x2560": gemm(64, 2560),
           "cm wr 2560x2560": gemm(2560, 2560),
           "head 2560x65536": gemm(2560, 65536),
           "sigmoid 2560": (2560, torch.sigmoid),
           "tanh 320": (320, torch.tanh)}
    out = {}
    for name, (k, fn) in ops.items():
        x = rand(16, k, dtype=torch.float32 if "f32" in name else bf)
        rec = {}
        for label, f in (("plain", fn),
                         ("blocked", lambda a, fn=fn: rows_apply(fn, a))):
            full = f(x)
            rec[label] = [m for m in range(1, 17)
                          if not torch.equal(f(x[:m]), full[:m])]
        out[name] = rec
    return out


def model_rows(torch, np, dev, layers: int, reps: int, steps: int) -> dict:
    import repro_torch.models.common as common
    import repro_torch.models.model as model_mod
    import repro_torch.models.rwkv as rwkv_mod
    from repro_torch.configs import rwkv6_3b
    from repro_torch.models import forward_paged_chunk, init_lm, \
        init_paged_decode_state, tree_map
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    cfg = rwkv6_3b.CONFIG.with_quant(policy_presets()["mix2_ffn4"])
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    rng = np.random.default_rng(0)
    params = init_lm(cfg, seed=0, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    deploy, _ = export_quantized(params)
    del params
    torch.cuda.empty_cache()

    def call(B, C, tokens, st=None):
        """(logits [B, 1, V], state) of one chunk; a fresh state when
        ``st`` is None (no attention layer: pos and pages unused)."""
        if st is None:
            st = init_paged_decode_state(cfg, B, page_size=16, n_pages=1,
                                         device=dev)
        tok = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
        pos = torch.zeros(B, dtype=torch.int32, device=dev)
        table = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        with torch.no_grad():
            return forward_paged_chunk(deploy, cfg, st, tok, pos, table)

    def batch_vs_alone(prompts) -> list:
        """[(step, request)] whose batched logits differ from alone."""
        alone = [call(1, 16, p[None]) for p in prompts]
        batched = tree_map(lambda _, *xs: torch.cat(xs),
                           *[st for _, st in alone])
        tok = [int(lg[0, -1].argmax()) for lg, _ in alone]
        states = [st for _, st in alone]
        differ = []
        for t in range(steps):
            lg_b, batched = call(8, 1, [[x] for x in tok], batched)
            for i in range(8):
                lg, states[i] = call(1, 1, [[tok[i]]], states[i])
                if not torch.equal(lg_b[i], lg[0]):
                    differ.append((t, i))
                tok[i] = int(lg[0, -1].argmax())
        return differ

    def wall_ms(B, C, tokens):
        for _ in range(2):
            call(B, C, tokens)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(B, C, tokens)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    dec = rng.integers(0, cfg.vocab, size=(8, 1))
    pre = rng.integers(0, cfg.vocab, size=(1, 16))
    prompts = rng.integers(0, cfg.vocab, size=(8, 16))
    def plain_matmul(x, w):
        return x @ w.to(x.dtype)

    def plain_norm(p, x, kind="rmsnorm", eps=1e-6):
        return common._norm(p, x, kind, eps)

    modes = {"on": {},
             "off": {(model_mod, "row_blocks"):
                     lambda on=True: contextlib.nullcontext()},
             "norms_only": {(common, "matmul"): plain_matmul,
                            (rwkv_mod, "matmul"): plain_matmul},
             "gemms_only": {(model_mod, "apply_norm"): plain_norm},
             "on_again": {}}
    out = {"layers": cfg.n_layers}
    for label, patches in modes.items():
        saved = {k: getattr(*k) for k in patches}
        for (mod, name), fn in patches.items():
            setattr(mod, name, fn)
        try:
            out[label] = {
                "decode_b8_ms": wall_ms(8, 1, dec),
                "prefill_c16_ms": wall_ms(1, 16, pre),
                "batch_differs_at": batch_vs_alone(prompts)}
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    rec = {"card": card, "ops": op_rows(torch, dev),
           "model": model_rows(torch, np, dev, args.layers, args.reps,
                               args.steps)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rwkv_row_blocks.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
