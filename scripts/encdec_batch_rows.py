#!/usr/bin/env python3
"""Which float op makes a request's values depend on the batch it rides
in, on the encoder-decoder path at full-width SeamlessM4T-v2-large
(bf16) on one GPU.

    python3 scripts/encdec_batch_rows.py [--layers 24] [--steps 12] [--reps 5]

The integer GEMMs are exact whatever the row count; the float ops are
not held to that by cuBLAS or PyTorch.  This script measures:

1. per op, at the model's widths on random inputs (seed 0;
   heavy-tailed, N(0, 1) times exp(N(0, 1.5)), as activations are): for
   a batch of 8 requests, op(X[:b]) against op(X)[:b] bit for bit for
   b = 1..8, plain and (for the row-wise ops) through ``rows_apply``.
   The ops: LayerNorm over a decode step's rows (one per request) and
   over the encoder's (256 per request), the float head, and attention
   (scores, softmax, values: ``attention._attend``) of a decode step
   over its cache and over the encoder output, and of the encoder;
2. the model (``--layers`` encoder and decoder layers), init (seed 0)
   -> calibrate (2 x 16 tokens, 2 x 256 frames) -> export (enc_heavy),
   then 8 requests of 256 frames: ``encode`` at B = 8 against each
   request encoded alone (bit for bit), and ``--steps`` teacher-forced
   ``decode_step(enc_out=)`` steps at B = 8 against each request alone
   on the same tokens: the (step, request) pairs whose logits differ.
   In four modes: ``off`` (no row blocks), ``on`` (norms and float
   GEMMs in ``common.row_blocks``, encode and decode; the decode step
   as served), ``norms_only`` and ``head_only``; with the host wall
   time of a decode step at B = 8 (median of ``--reps``);
3. ``chip_smoke.py``'s ``seamless_serve`` workload as served (its seeds:
   init seed 0, data from ``default_rng(71)``; 24 + 24 layers; 8
   requests of 256 frames and 4 prompt tokens, 32 greedy tokens each):
   the batched loop's tokens, then requests 0-2 alone, teacher-forced
   on them; at each request's first step whose logits differ, the first
   op (in call order: norms, attention blocks, MLPs, the head; with its
   layer) whose output row differs, and the top-2 logit margin there.

Prints one JSON object and writes it to
``chiprun_out/encdec_batch_rows.json``.  Needs a GPU; imports no JAX.
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

FRAMES = 256


def op_rows(torch, dev) -> dict:
    """{op: {"plain": [b that differ], "blocked": [...]}}: d 1024, 16
    heads of 64, vocab 256206, a 36-slot cache, 256 frames."""
    from repro_torch.models.attention import _attend
    from repro_torch.models.common import _norm, rows_apply
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape):
        scale = torch.exp(torch.randn(shape, generator=g, device=dev) * 1.5)
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    ln = {"scale": torch.rand(1024, generator=g, device=dev).to(bf) + 0.5,
          "bias": torch.randn(1024, generator=g, device=dev).to(bf)}
    head = (torch.randn((1024, 256206), generator=g, device=dev)
            / 32.0).to(bf)

    def norm(x):
        return _norm(ln, x, "layernorm", 1e-6)

    def attend(sq, sk):
        k, v = rand(8, sk, 16, 64), rand(8, sk, 16, 64)
        return lambda q: _attend(q, k[:q.shape[0]], v[:q.shape[0]], None,
                                 None), (8, sq, 16, 64)

    # name -> (fn over a batch, input shape, row-wise: blockable)
    ops = {"layernorm decode [B, 1024]": (norm, (8, 1024), True),
           "layernorm encoder [B*256, 1024]": (norm, (8, FRAMES, 1024),
                                               True),
           "head [B, 1024] @ [1024, 256206]": (lambda x: x @ head,
                                               (8, 1024), True),
           "attention decode over 36 cache slots": (*attend(1, 36), False),
           "attention decode over 256 frames": (*attend(1, FRAMES), False),
           "attention encoder 256 x 256": (*attend(FRAMES, FRAMES), False)}
    out = {}
    for name, (fn, shape, rowwise) in ops.items():
        x = rand(*shape)
        rec = {}
        variants = [("plain", fn)]
        if rowwise:
            variants.append(("blocked",
                             lambda a, fn=fn: rows_apply(fn, a)))
        for label, f in variants:
            full = f(x)
            rec[label] = [b for b in range(1, 9)
                          if not torch.equal(f(x[:b]), full[:b])]
        out[name] = rec
    return out


def model_rows(torch, np, dev, layers: int, steps: int, reps: int) -> dict:
    import repro_torch.models.common as common
    import repro_torch.models.model as model_mod
    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.models import (decode_step, encode, init_decode_state,
                                    init_lm)
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    cfg = seamless_m4t_large_v2.CONFIG.with_quant(
        policy_presets()["enc_heavy"])
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers, n_enc_layers=layers)
    rng = np.random.default_rng(0)
    params = init_lm(cfg, seed=0, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 16)),
        "enc_embeds": rng.standard_normal((2, FRAMES, cfg.d_model),
                                          dtype=np.float32)})
    deploy, _ = export_quantized(params)
    del params
    torch.cuda.empty_cache()
    frames = torch.from_numpy(rng.standard_normal(
        (8, FRAMES, cfg.d_model), dtype=np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           size=(8, steps))).to(dev)
    blocks = common.row_blocks

    def run(b0, b1):
        """(enc_out, [logits per step]) of requests b0..b1-1 together."""
        with torch.no_grad(), model_mod.row_blocks(True):
            enc = encode(deploy, cfg, frames[b0:b1])
        st = init_decode_state(cfg, b1 - b0, steps, device=dev)
        lgs = []
        with torch.no_grad():
            for t in range(steps):
                lg, st = decode_step(deploy, cfg, st, tokens[b0:b1, t:t + 1],
                                     t, enc_out=enc)
                lgs.append(lg)
        return enc, lgs

    def differs() -> dict:
        enc8, lg8 = run(0, 8)
        enc_rows, steps_at = [], []
        for i in range(8):
            enc1, lg1 = run(i, i + 1)
            if not torch.equal(enc8[i], enc1[0]):
                enc_rows.append(i)
            steps_at += [(t, i) for t in range(steps)
                         if not torch.equal(lg8[t][i], lg1[t][0])]
        return {"encode_differs_for": enc_rows, "decode_differs_at": steps_at}

    def step_ms() -> float:
        enc = run(0, 8)[0]
        st = init_decode_state(cfg, 8, reps + 2, device=dev)
        ts = []
        with torch.no_grad():
            for t in range(reps + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, st = decode_step(deploy, cfg, st, tokens[:, :1], t,
                                    enc_out=enc)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts[2:])

    def plain_matmul(x, w):
        return x @ w.to(x.dtype)

    def plain_norm(p, x, kind="rmsnorm", eps=1e-6):
        return common._norm(p, x, kind, eps)

    forced_on = lambda on=True: blocks(True)             # noqa: E731
    forced_off = lambda on=True: contextlib.nullcontext()  # noqa: E731
    modes = {"off": {(model_mod, "row_blocks"): forced_off},
             "on": {(model_mod, "row_blocks"): forced_on},
             "norms_only": {(model_mod, "row_blocks"): forced_on,
                            (common, "matmul"): plain_matmul},
             "head_only": {(model_mod, "row_blocks"): forced_on,
                           (model_mod, "apply_norm"): plain_norm}}
    out = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "steps": steps}
    for label, patches in modes.items():
        saved = {k: getattr(*k) for k in patches}
        for (mod, name), fn in patches.items():
            setattr(mod, name, fn)
        try:
            out[label] = {**differs(), "decode_b8_ms": step_ms()}
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
    return out


def first_differing_op(torch, np, dev) -> dict:
    """Measurement 3 (module docstring)."""
    import repro_torch.models.model as model_mod
    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.models import (decode_step, encode, init_decode_state,
                                    init_lm)
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    cfg = seamless_m4t_large_v2.CONFIG.with_quant(
        policy_presets()["enc_heavy"])
    rng = np.random.default_rng(71)
    params = calibrate_model(init_lm(cfg, seed=0, device=dev), cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 16)),
        "enc_embeds": rng.standard_normal((4, FRAMES, cfg.d_model),
                                          dtype=np.float32)})
    deploy, _ = export_quantized(params)
    del params
    torch.cuda.empty_cache()
    frames = torch.from_numpy(rng.standard_normal(
        (8, FRAMES, cfg.d_model), dtype=np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            size=(8, 4))).to(dev)
    n_steps = 4 + 32 - 1
    names = ("apply_norm", "attention_block", "apply_mlp",
             "logits_from_hidden")
    saved = {n: getattr(model_mod, n) for n in names}
    log: list = []

    def traced(name):
        def fn(*a, **k):
            out = saved[name](*a, **k)
            log.append((name, (out[0] if isinstance(out, tuple)
                               else out).detach().clone()))
            return out
        return fn

    def run(b0, b1, forced=None):
        """Greedy (or ``forced`` [B, n_steps] tokens) from requests
        b0..b1-1: (tokens fed, [logits per step], [op log per step])."""
        with torch.no_grad():
            enc = encode(deploy, cfg, frames[b0:b1])
            st = init_decode_state(cfg, b1 - b0, n_steps + 1, device=dev)
            cur, fed, lgs, logs = prompts[b0:b1, :1], [], [], []
            for t in range(n_steps):
                if forced is not None:
                    cur = forced[:, t:t + 1]
                fed.append(cur)
                log.clear()
                lg, st = decode_step(deploy, cfg, st, cur, t, enc_out=enc)
                lgs.append(lg)
                logs.append(list(log))
                cur = (prompts[b0:b1, t + 1:t + 2] if t < 3
                       else lg[:, -1].argmax(-1)[:, None])
        return torch.cat(fed, 1), lgs, logs

    for n in names:
        setattr(model_mod, n, traced(n))
    try:
        fed, lg8, log8 = run(0, 8)
        out = {}
        for i in range(3):
            _, lg1, log1 = run(i, i + 1, forced=fed[i:i + 1])
            t = next((t for t in range(n_steps)
                      if not torch.equal(lg8[t][i], lg1[t][0])), None)
            rec = {"first_step": t}
            if t is not None:
                count: dict = {}
                for (name, a), (_, b) in zip(log8[t], log1[t]):
                    count[name] = count.get(name, 0) + 1
                    if not torch.equal(a[i], b[0]):
                        rec.update(op=name, call=count[name],
                                   max_abs=float((a[i].float() - b[0].float())
                                                 .abs().max()))
                        break
                top = torch.topk(lg8[t][i, -1].float(), 2).values
                rec["margin"] = float(top[0] - top[1])
            out[f"request_{i}"] = rec
        return out
    finally:
        for n, fn in saved.items():
            setattr(model_mod, n, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
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
           "model": model_rows(torch, np, dev, args.layers, args.steps,
                               args.reps),
           "served": first_differing_op(torch, np, dev)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "encdec_batch_rows.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
