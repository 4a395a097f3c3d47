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
             GEMMs (generic, m=1) bit-exact and bit-identical on repeat
             at M in {1, 2, 4, 8, 16, 32}, K in {2048, 5632}, N in
             {256, 2048, 5632} with per-column exponents, each row with
             its plan, at the two record shapes the device time of each
             of the call's two kernels (``stages_ms``) and at M=1 both
             partial bodies (``m1_body_ms``); the W8A8 baseline
             bit-exact at M in {1, 8, 16} and at M in
             {17, 32, 33} (beside torch._int_mm), at ragged shapes and
             with extreme codes at K=5632; the fused expert GEMMs (APSQ
             and W8A8) bit-exact and bit-identical on repeat at E=64, M
             in {1, 2, 3, 16}, (K, N) in {(2048, 1024), (1024, 2048)},
             exponents [E, n_p] and [E, n_p, N], and at 8-slot decode
             routing (``routed``: 8 tokens' seeded top-8 choices through
             the MoE dispatch at capacity 2, the experts no token chose
             all zero; its bound counts the live experts' weights); the
             APSQ one at Qwen3-MoE's banks (E=128, (K, N) in {(4096,
             1536), (1536, 4096)}) at M=2 and at 4-slot decode routing
             (4 tokens' top-8 at capacity 1);
             INT8-KV attention (hd=64, Hq=32, Hkv=4 and
             hd=128, Hq=Hkv=16; decode and prefill-chunk forms, the
             serving shapes, decode over 1024 and 4096 positions, a chunk
             whose first rows see nothing) within rtol 2e-5 / atol 2e-6,
             the bound the JAX package holds its own kernel to.  The
             APSQ, W8A8 and attention kernels must also repeat their
             output bit for bit.  Times each kernel (device time: calls
             captured in a CUDA graph, replay timed with CUDA events;
             ``eager_ms`` adds the wrapper's host dispatch; weights
             rotate through more copies than the 50 MB L2 holds), its
             plain version and, where one exists, a single PyTorch call
             computing the same function.  At the two 8-slot chunk
             shapes the attention kernel is also timed with one and with
             two query rows per warp (``rows_per_warp_ms``), the choice
             its plan makes.
  reference  the tinyllama-smoke model, calibrated and exported on the
             CPU, served on the card and on the CPU: last-chunk logits
             agree within rtol/atol 1e-3 (float ops round differently on
             the two devices; the integer GEMMs are exact on both).
  serve      the main path at full TinyLlama-1.1B width (22 layers, random
             weights from a seed, bf16): init_lm -> calibrate_model ->
             export_quantized (mix2_ffn4 policy) -> PagedServingEngine
             -> run 16 requests (prompts 5-60, 16-32 new tokens, one with
             EOS); a max_batch=1 engine on two of them must give the same
             greedy tokens; logits finite.
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
  load       a JAX export read from disk without JAX: the committed
             fixture ``tests/fixtures/jax_export_starcoder2_smoke``
             (starcoder2-smoke, tied head, stacked units, mix2_ffn4,
             written by the JAX package's checkpoint.save) restored by
             ``repro_torch.checkpoint.restore``.  The port's ``oracle``
             engine on the CPU gives the greedy tokens the JAX oracle
             engine recorded in its manifest; every deployed GEMM of the
             tree on the card (APSQ, and the tied head's W8A8) is
             bit-exact against its plain version; a ``cuda`` engine gives
             the recorded tokens (the smallest top-2 logit margin along
             them is reported); last-chunk logits card vs CPU within
             rtol/atol 1e-3.
  sc2_serve  full-width StarCoder2-15B (40 layers, d=6144, 48/4 heads at
             hd=128, GELU d_ff=24576, LayerNorm, vocab 49152, random bf16
             weights from a seed; the allocator's cache is emptied
             first): init_lm -> calibrate_model ->
             export_quantized -> del the float params ->
             PagedServingEngine (mix2_ffn4, 8 slots, page 16, chunk 16,
             horizon 8) -> run 8 requests (prompts 5-48, 8-16 new
             tokens, one with an EOS at a step >= 1); a max_batch=1
             engine on two of them gives the same greedy tokens; logits
             finite.  Records each stage's seconds and the peak memory.
  dense_2l   ChatGLM3-6B (RoPE on half the head, GQA group 16) and
             DeepSeek-7B (MHA, float head at vocab 102400) at full width
             cut to 2 layers (mix2_ffn4): 4 requests on 4 slots, and a
             max_batch=1 engine on one of them gives the same tokens.
  train      quantization-aware training of full-width TinyLlama-1.1B
             (22 layers, random bf16 weights from a seed) under APSQ
             gs=2 n_p=8 on every projection (the launcher's ``--quant
             apsq --gs 2 --np 8``), TF32 off: init_lm -> calibrate_model
             -> Trainer.fit for 10 steps (SyntheticCorpus, seq 256, batch
             8 in 2 microbatches, per-unit remat, AdamW at lr 3e-4 with
             the launcher's warmup and cosine) -> checkpoint at the last
             step -> restore: every leaf bit-equal -> 2 steps resumed from
             the checkpoint (``Trainer.fit``) bit-equal to 2 steps in
             memory -> snap_params_po2 / export_quantized of the restored
             params: the snapped fake-quant forward and the integer
             forward on the CUDA kernels agree within 1e-4 with the same
             greedy tokens on a batch of 2 x 256 -> PagedServingEngine
             serves 4 requests, and a max_batch=1 engine gives request
             0's tokens.  Losses and grad norms finite, the mean of the
             last 3 losses at least 0.5 below the first.  Records the
             median step time, training tokens/s, peak memory and the
             loss trajectory; ``--profile`` traces one more step.
  moe_train  the ``train`` phase's flow on full-width OLMoE-1B-7B (d=2048,
             64 experts top-8, vocab 50304, bf16) cut to 4 of 16 layers
             (device memory: float32 accumulators and the old and new
             AdamW moments of 1.88 B parameters peak at 52 GB), the
             router float: Trainer.fit 10 steps (cap 160 per
             microbatch) -> save -> restore (bit-equal) -> 2 resumed
             steps == 2 in memory (bit-equal) -> export: snapped fake
             quant vs the integer path within 1e-4, equal greedy tokens
             -> 4 requests served, then the ``moe_serve`` engine checks
             (``moe_engine_checks``).
  qwen3_2l   Qwen3-MoE-235B-A22B at full width (d=4096, 64/4 heads at
             hd=128: an attention wider than the model, 128 experts
             top-8, expert d_ff 1536, vocab 151936, bf16) cut to 2 of 94
             layers, mix2_ffn4: init -> calibrate -> export -> every
             deployed GEMM (the expert banks too) bit-exact against its
             plain version -> 4 requests on 4 slots -> the ``moe_serve``
             engine checks.
  rwkv_serve full-width RWKV6-3B (32 layers, d=2560, 40 heads of 64,
             channel mix d_ff 8960, LayerNorm, vocab 65536, bf16, random
             weights from seed 0; no attention layer): init_lm ->
             calibrate_model (4 x 64 tokens, the chunked WKV) ->
             export_quantized (mix2_ffn4: the time mix's wr/wk/wv/wg/wo
             and the channel mix's wk/wv on the APSQ kernels; the LoRAs
             and the channel mix's gate stay float) -> del the float
             params -> PagedServingEngine (8 slots, page 16, chunk 16,
             horizon 8) -> 8 requests (prompts 5-60, 16-32 new tokens,
             one with an EOS at a step >= 1).  Checks: a max_batch=1
             engine gives the same tokens on two requests; the second of
             them, served on the slot the first left, equals itself on a
             fresh engine; ``cuda`` and ``oracle`` engines on the card
             give identical tokens on 2 requests; logits finite; the
             chunked WKV within 5e-6 (relative) of the scan at 40 x 64
             heads over 64 tokens.  Then QAT at full width cut to 2 of
             32 layers (APSQ gs=2 n_p=8, seq 256 x batch 4 in 2
             microbatches, the chunked WKV's backward): 2 steps with
             finite losses, the first repeated from the same state bit
             for bit.  Records tokens/s, peak memory, calibrate_s,
             export_s and the launch counts.
  rg_serve   full-width RecurrentGemma-2B (26 layers: 8 units of
             rglru, rglru, local and 2 remainder rglru; d=2560, 10 query
             heads and 1 KV head at hd 256, GELU d_ff 7680, d_rnn 2560,
             vocab 256000, window 2048, bf16, random weights from seed
             0) on the dense ServingEngine (float KV rings; the paged
             engine refuses local attention): init_lm -> calibrate_model
             -> export_quantized (mix2_ffn4) -> del the float params ->
             8 slots, cache_len 256, horizon 8 -> 8 requests (prompts
             16-64, 16-32 new tokens; per-token prefill, as the
             reference's).  Checks: every deployed GEMM bit for bit
             against its plain version; finite logits; 3 requests served
             alone give the batched tokens; ``cuda`` and ``oracle``
             engines give identical tokens on 3 requests, and sampled at
             T = 0.8 one seed repeats and horizon 8 equals horizon 1 on
             2 (prompts cut to 8 tokens, 8 new ones); no
             ``int8_kv_attention`` launch.  Then the same
             widths cut to one unit (3 layers): a 2064-token prompt and
             16 new tokens at cache_len 2112 (the 2048-slot ring wraps),
             horizon 8 == horizon 1, and the agreement with ``forward``'s
             greedy tokens reported with top-2 margins.  Records tokens/s
             with prefill and decode seconds apart, peak memory,
             calibrate_s, export_s and the launch counts.
  seamless_serve  full-width SeamlessM4T-v2-large (24 encoder and 24
             decoder layers, d=1024, 16/16 heads at hd 64, GELU d_ff
             8192, LayerNorm, vocab 256206, bf16, random weights from
             seed 0; the audio frontend a stub: frame embeddings) under
             enc_heavy (encoder APSQ gs=1 n_p=8, the rest gs=4 n_p=4):
             init_lm -> calibrate_model (tokens and frames) ->
             export_quantized -> del the float params -> 8 requests of
             256 frames and a 4-token prompt each: ``encode`` at B = 8
             (kernel 1 at M = 2048), then a greedy loop of
             ``decode_step(enc_out=)`` to 32 tokens each (kernel 1 at
             M = 8, and at M = 2048 for the cross-attention's K/V at
             every step).  Checks: every deployed GEMM bit for bit at
             M = 1, 3, 8, 16 and three at M = 2048; 3 requests alone at
             B = 1 give the batched tokens (kernel 4 there); ``encode``
             on ``cuda`` == ``oracle`` bit for bit and both decode the
             same tokens on 3 requests; finite logits.  Reports
             teacher-forced ``forward(enc_embeds=)``'s agreement with
             the decoded tokens, encode_s, decode_s, tokens/s, peak
             memory and the launch counts.
  vlm_2l     InternVL2-26B's LM at full width (d=6144, 48/8 heads at hd
             128, SwiGLU d_ff 16384, vocab 92553, 256 image tokens
             through the float frontend_proj stub) cut to 2 of 48
             layers, mix2_ffn4: calibrate with patch embeddings, export,
             every deployed GEMM bit-exact, ``forward(embeds=)`` on
             ``cuda`` == ``oracle`` bit for bit with the image prefix
             moving the text logits, then the paged engine serves 4 text
             requests, batched == single-stream.
  search     the per-layer (gs, n_p) policy search and the APSQ energy
             model (``repro_torch.search``): the search's CLI in-process
             on the card (``--arch tinyllama-1.1b --budget-smoke
             --include-presets``, report under chiprun_out/search):
             energy scored on full TinyLlama-1.1B, the accuracy proxy on
             tinyllama-smoke, about 20 candidates, the Pareto front and
             both round trips (calibrate -> export -> GEMM parity oracle
             vs cuda and greedy decode on a dense engine per backend);
             its exit code must be 0.  Then full-width TinyLlama-1.1B
             (22 layers, d=2048, bf16, random weights from seed 0) under
             uniform W8A8 and under the front's best PSUM-quantized
             member: ``energy_report``, ``accuracy_proxy`` on a 2 x 32
             batch, ``roundtrip_report`` (GEMM parity bit-equal at M = 4,
             ``oracle`` == ``cuda`` greedy tokens) and
             ``backend_parity_report`` (M = 8, bit-equal).  The whole
             phase is the path's zeroed run: kernels 1, 2 and 4 must
             launch.  Records seconds and peak memory.
  dryrun     the one-device dry run (``repro_torch.launch.dryrun``) of
             full-width TinyLlama-1.1B: train_4k, prefill_32k and
             decode_32k counted on meta tensors (one line each: FLOPs,
             bytes, dominant term, bound_s at the H100's rates, peak
             bytes, whether it fits 80 GB); a real prefill step on the
             card at B=1, S=2048 whose counted FLOPs must equal the dry
             run's at that shape exactly, with max_memory_allocated
             (less what was allocated before the step's params were
             made) against the predicted peak and the step's time against
             bound_s (share of the roofline); ``--backend-parity`` under
             apsq (kernel 1) and w8a8 (kernel 2), bit-equal, the
             corrected roofline read from ``cuda_us``; the search's
             round trip of seamless-smoke (``encode`` +
             ``decode_step(enc_out=)``, enc_heavy) with equal ``oracle``
             and ``cuda`` tokens.  The phase is the path's zeroed run:
             kernels 1, 2 and 4 must launch.
  tp_serve   tensor- and expert-parallel serving (``repro_torch.dist``):
             four ranks spawned on the one card over gloo (NCCL refuses
             two ranks on one GPU), meshes (2, 2) and (1, 4).  Each rank
             restores the whole export from disk on the CPU and keeps its
             slices; each run is held to one rank's engine on the same
             export: equal greedy tokens, and the ranks' KV pools and
             exponents gathered over heads equal to one rank's, array
             for array.  Runs: full-width TinyLlama-1.1B (22 layers,
             mix2_ffn4; the ``serve`` phase's export when both run, kept
             on disk under ``_tp_export/``), 8 requests x 16 new tokens
             at D=2 on the int8 wire (data replica 0) and the fp32 wire
             (replica 1) at once; its first 2 layers at D=4 (one KV head
             a rank); 2 layers under PSQ gs = n_p = 8 (K-shards through
             the W8A8 expert kernel) and under W8A8 (K-shards, int32
             all-reduce) at D=2; full-width OLMoE-1B-7B (16 layers, the
             ``moe_serve`` phase's export when both run) expert-parallel
             at D=2, the CUDA GEMMs with the plain attention as
             ``moe_serve`` holds it.  A decode step of every dense run
             moves exactly the bytes ``wire_report`` prices.  Records
             the transport, per-rank peak memory, launches per kernel
             and rank (all six must launch), the bytes copied through
             the host (none) and ``wire_report``'s int8 and fp32 bytes
             per decode step.  The ranks time-slice one card: their
             seconds are no speed.

The main path runs in nineteen configurations, each its own path:
``serve`` (mix2_ffn4: every layer APSQ), ``w8a8`` (ffn_only: W8A8
attention projections), ``moe_serve`` (OLMoE, mix2_ffn4), ``moe_w8a8``
(OLMoE, W8A8), ``load`` (the restored JAX export), ``sc2_serve``,
``dense_2l``'s two models, ``train`` and ``moe_train`` (their export ->
serve tails; the training step itself is plain PyTorch and reaches no
kernel), ``qwen3_2l``, ``rwkv_serve``, ``rg_serve``,
``seamless_serve`` (its batched run; its single-stream runs are
``seamless_serve/single``), ``vlm_2l``, ``search`` (the search's
CLI and the full-width round trips), ``dryrun`` (the backend parity
probes and the encoder-decoder round trip) and ``tp_serve`` (every
rank's runs, summed).  Launch
counts are zeroed just before each and read just after; every kernel of
each path must have launched.  The line before the
last holds the per-kernel record: ``launches`` is the count of the path
named in ``path``, ``launches_by_path`` each path's own count (never a
sum).  Each serving phase records ``tokens_sha256``, a digest of its
batched engine's greedy tokens, so two trees can be compared on the
same seed.  The last line is ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import hashlib
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
          "moe_serve", "moe_w8a8", "load", "sc2_serve", "dense_2l", "train",
          "moe_train", "qwen3_2l", "rwkv_serve", "rg_serve", "seamless_serve",
          "vlm_2l", "search", "dryrun", "tp_serve")
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "jax_export_starcoder2_smoke")
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
    "load": ("apsq_matmul", "baseline_matmul", "int8_kv_attention"),
    "sc2_serve": ("apsq_matmul", "apsq_matmul_m1", "int8_kv_attention"),
    "dense_2l/chatglm3-6b": ("apsq_matmul", "apsq_matmul_m1",
                             "int8_kv_attention"),
    "dense_2l/deepseek-7b": ("apsq_matmul", "apsq_matmul_m1",
                             "int8_kv_attention"),
    "train": ("apsq_matmul", "apsq_matmul_m1", "int8_kv_attention"),
    "moe_train": ("apsq_matmul", "apsq_expert_matmul", "int8_kv_attention"),
    "qwen3_2l": ("apsq_matmul", "apsq_expert_matmul", "int8_kv_attention"),
    "rwkv_serve": ("apsq_matmul", "apsq_matmul_m1"),
    "rg_serve": ("apsq_matmul", "apsq_matmul_m1"),
    "seamless_serve": ("apsq_matmul",),
    "seamless_serve/single": ("apsq_matmul", "apsq_matmul_m1"),
    "vlm_2l": ("apsq_matmul", "apsq_matmul_m1", "int8_kv_attention"),
    "search": ("apsq_matmul", "apsq_matmul_m1", "baseline_matmul"),
    "dryrun": ("apsq_matmul", "apsq_matmul_m1", "baseline_matmul"),
    "tp_serve": tuple(SOURCES),
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
    """Device ms per call of ``fn(i)``: the calls are captured in a CUDA
    graph, so host dispatch drops out; the median of 5 replays, each
    timed alone."""
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
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return sorted(times)[2]


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


APSQ_M = (1, 2, 4, 8, 16, 32)   # decode slots, prefill chunks, 32-row blocks
APSQ_KN = ((2048, 256), (2048, 2048), (2048, 5632), (5632, 2048))


def apsq_case(torch, ref, gen, dev, m, k, n, n_p=None, gs=None):
    """Random codes at a TinyLlama projection [m, k] @ [k, n] under
    mix2_ffn4 (attention n_p=4 gs=2, FFN n_p=8 gs=4; or the ``n_p`` and
    ``gs`` given), with per-column exponents; weight copies rotate so the
    timed reads miss the 50 MB L2.  Returns x, the weight copies, exps
    and gs."""
    if n_p is None:
        n_p, gs = (4, 2) if n != 5632 and k == 2048 else (8, 4)
    copies = max(1, math.ceil(120e6 / (k * n)))
    ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                        dtype=torch.int8) for _ in range(copies)]
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    base = ref.choose_exps(x, ws[0], n_p=n_p, gs=gs)
    exps = (base[:, None] + torch.arange(n, device=dev)[None] % 3
            ).to(torch.int32).contiguous()
    return x, ws, exps, gs


def apsq_rec(torch, ops, ref, x, ws, exps, gs, errors: list) -> dict:
    """The APSQ kernel on x @ ws[0]: bit-exact against its plain version
    and against a second call; device and eager ms over the rotating
    weight copies ``ws`` beside the plain version, and the bound."""
    m, k = x.shape
    n, n_p = ws[0].shape[1], exps.shape[0]
    got = ops.apsq_matmul_int8(x, ws[0], exps, gs=gs)
    again = ops.apsq_matmul_int8(x, ws[0], exps, gs=gs)
    want = ref.apsq_matmul_ref(x, ws[0], exps, n_p=n_p, gs=gs)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    repeat = bool(torch.equal(got, again))
    if err or not repeat:
        errors.append(f"GEMM M={m} K={k} N={n}: apsq max|err|={err}, "
                      f"repeat equal={repeat}")
    t_k, e_k = both_ms(torch, lambda i: ops.apsq_matmul_int8(
        x, ws[i], exps, gs=gs), len(ws))
    t_p, _ = both_ms(torch, lambda i: ref.apsq_matmul_ref(
        x, ws[i], exps, n_p=n_p, gs=gs), len(ws), iters=5)
    b_ms, b_by = bound(m * k + k * n + m * n * 4 + n_p * n * 4,
                       2.0 * m * k * n, INT8_OPS_PER_S)
    return {"ms": t_k, "eager_ms": e_k, "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "repeat_equal": repeat}


def stages_ms(torch, fn, n_inputs: int, iters: int = 20) -> dict:
    """Device ms per call of each kernel that ``fn(i)`` launches (the
    APSQ call's partial and epilogue kernels), from torch.profiler."""
    from torch.profiler import ProfilerActivity
    fn(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    return {r["name"]: r["device_ms"] / iters
            for r in profile_summary(prof, 1.0)["top"]}


def m1_body_ms(torch, ops, ref, x, ws, exps, gs, errors: list) -> dict:
    """Device ms of the M == 1 kernel with each partial body (the
    one-row dp4a body, bm 1, and the tensor-core body, bm 16), whatever
    its plan picks; each result is held bit-exact as the planned one."""
    planned, out = ops.apsq_plan, {}
    want = ref.apsq_matmul_ref(x, ws[0], exps, n_p=exps.shape[0], gs=gs)
    for bm, label in ((1, "dp4a"), (16, "mma")):
        ops.apsq_plan = lambda *a, bm=bm: planned(*a)._replace(bm=bm)
        try:
            got = ops.apsq_matmul_int8(x, ws[0], exps, gs=gs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                errors.append(f"apsq M=1 {label} body disagrees")
            out[label], _ = both_ms(torch, lambda i: ops.apsq_matmul_int8(
                x, ws[i], exps, gs=gs), len(ws))
        finally:
            ops.apsq_plan = planned
    return out


def gemm_checks(torch, records: dict) -> list:
    from repro_torch.kernels.apsq_matmul import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errors, rows = [], []
    for m in APSQ_M:
        for k, n in APSQ_KN:
            x, ws, exps, gs = apsq_case(torch, ref, gen, dev, m, k, n)
            n_p = exps.shape[0]
            name = "apsq_matmul_m1" if m == 1 else "apsq_matmul"
            rec = apsq_rec(torch, ops, ref, x, ws, exps, gs, errors)
            rec["plan"] = list(ops.apsq_plan(m, n, k, n_p))
            row = {"M": m, "K": k, "N": n, "n_p": n_p, "gs": gs, name: rec}
            if m in (1, 8, 16):
                row["baseline_matmul"] = baseline_rec(torch, ops, ref, x, ws,
                                                      errors)
            rows.append(row)
            # the record of each kernel is its main-path decode shape
            if (m, k, n) in ((8, 2048, 5632), (1, 5632, 2048)):
                call = lambda i: ops.apsq_matmul_int8(x, ws[i], exps, gs=gs)
                rec["stages_ms"] = stages_ms(torch, call, len(ws))
                if m == 1:
                    rec["m1_body_ms"] = m1_body_ms(torch, ops, ref, x, ws,
                                                   exps, gs, errors)
                records[name] = dict(rec, library_ms=None,
                                     shape=f"M={m} K={k} N={n} n_p={n_p} "
                                           f"gs={gs}")
            if (m, k, n) == (8, 2048, 2048):
                records["baseline_matmul"] = dict(
                    row["baseline_matmul"], shape=f"M={m} K={k} N={n}")
            del ws
    # StarCoder2-15B's FFN bodies under mix2_ffn4 (n_p=8 gs=4), about
    # 150 MB of weights each: decode at 8 slots, and the wo at M=1
    for m, k, n, label in ((8, 6144, 24576, "ffn_wi"),
                           (8, 24576, 6144, "ffn_wo"),
                           (1, 24576, 6144, "ffn_wo")):
        x, ws, exps, gs = apsq_case(torch, ref, gen, dev, m, k, n)
        n_p = exps.shape[0]
        name = "apsq_matmul_m1" if m == 1 else "apsq_matmul"
        rec = apsq_rec(torch, ops, ref, x, ws, exps, gs, errors)
        rec["share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else None
        rec["plan"] = list(ops.apsq_plan(m, n, k, n_p))
        rows.append({"M": m, "K": k, "N": n, "n_p": n_p, "gs": gs,
                     "model": f"starcoder2-15b {label}", name: rec})
        records[name][f"at_sc2_{label}_m{m}"] = dict(
            rec, shape=f"M={m} K={k} N={n} n_p={n_p} gs={gs}")
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
    rows += encoder_rows(torch, ops, ref, dev, records, errors)
    return rows, errors


# SeamlessM4T-v2-large's encoder GEMMs under enc_heavy: M = 8 requests x
# 256 frames; the FFN at gs=1 n_p=8 (the encoder's rule), the
# cross-attention's K/V projection at gs=4 n_p=4 (every other layer's)
ENCODER_ROWS = ((2048, 1024, 8192, 8, 1, "enc_ffn_wi"),
                (2048, 8192, 1024, 8, 1, "enc_ffn_wo"),
                (2048, 1024, 1024, 4, 4, "xattn_wk"))


def encoder_rows(torch, ops, ref, dev, records: dict, errors: list) -> list:
    """``apsq_matmul`` at the encoder's M = 2048 (``ENCODER_ROWS``):
    bit-exact, device and eager ms beside the plain version, its bound
    and share, each of its two kernels' ms, the bytes of its int32
    scratch ``part`` ([n_p * splits, M, N]) and ``torch._int_mm`` at the
    same shape (the W8A8 product: a yardstick, not the same function)."""
    gen = torch.Generator(device=dev).manual_seed(2048)
    rows = []
    for m, k, n, n_p, gs, label in ENCODER_ROWS:
        x, ws, exps, gs = apsq_case(torch, ref, gen, dev, m, k, n, n_p, gs)
        rec = apsq_rec(torch, ops, ref, x, ws, exps, gs, errors)
        plan = ops.apsq_plan(m, n, k, n_p)
        rec.update(
            share=rec["bound_ms"] / rec["ms"] if rec["ms"] else None,
            plan=list(plan), part_bytes=n_p * plan.splits * m * n * 4,
            stages_ms=stages_ms(torch, lambda i: ops.apsq_matmul_int8(
                x, ws[i], exps, gs=gs), len(ws)),
            library="torch._int_mm (W8A8: not the same function)",
            library_ms=device_ms(torch, lambda i: torch._int_mm(x, ws[i]),
                                 len(ws)),
            shape=f"M={m} K={k} N={n} n_p={n_p} gs={gs}")
        rows.append({"M": m, "K": k, "N": n, "n_p": n_p, "gs": gs,
                     "model": f"seamless-m4t-large-v2 {label}",
                     "apsq_matmul": rec})
        records["apsq_matmul"][f"at_{label}_m{m}"] = rec
        del ws
    return rows


def expert_rec(torch, ops, ref, x, w, exps, gs, errors: list,
               label: str) -> dict:
    """One expert kernel on x @ w (APSQ where ``exps`` is given, else
    W8A8): bit-exact against its plain version and against a second
    call, device and eager ms beside the plain version's, and the bound
    over the weight bytes of the experts that have a nonzero activation
    row (``live_experts``: the kernel reads no other weights)."""
    E, m, k = x.shape
    n = w.shape[2]
    if exps is None:
        call = lambda i: ops.baseline_expert_matmul_int8(x, w)
        plain = lambda i: ref.baseline_expert_matmul_ref(x, w)
    else:
        call = lambda i: ops.apsq_expert_matmul_int8(x, w, exps, gs=gs)
        plain = lambda i: ref.apsq_expert_matmul_ref(x, w, exps, gs=gs)
    got, again, want = call(0), call(0), plain(0)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    repeat = bool(torch.equal(got, again))
    del got, again, want
    if err or not repeat:
        errors.append(f"{label}: max|err|={err}, repeat equal={repeat}")
    live = int((x != 0).flatten(1).any(1).sum())
    t_k, e_k = both_ms(torch, call, 1)
    t_p, _ = both_ms(torch, plain, 1, iters=5)
    byts = live * k * n + E * m * k + 4 * E * m * n
    if exps is not None:
        byts += exps.numel() * 4
    b_ms, b_by = bound(byts, 2.0 * live * m * k * n, INT8_OPS_PER_S)
    return {"ms": t_k, "eager_ms": e_k, "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": b_by, "bound_over": f"weights of {live} live "
            f"experts of {E}", "live_experts": live, "max_abs_err": err,
            "repeat_equal": repeat, "library_ms": None,
            "library": NO_BATCHED_INT8_MM,
            "plan": list(ops.expert_plan(E, m, n, k, exps.shape[1]
                                         if exps is not None else 1))}


EXPERT_PLANS = ((64, 4), (128, 4))    # (columns per block, stages)


def expert_plans_ms(torch, ops, ref, x, w, exps, gs, errors: list) -> dict:
    """Device ms of both expert kernels at each (columns per block,
    stages) the plan can pick, whatever ``ops.expert_plan`` picks here;
    each result is held bit-exact as the planned one is."""
    planned, out = ops.expert_plan, {}
    want = ref.apsq_expert_matmul_ref(x, w, exps, gs=gs)
    want_b = ref.baseline_expert_matmul_ref(x, w)
    for bn, stages in EXPERT_PLANS:
        ops.expert_plan = lambda *a, bn=bn, stages=stages: planned(
            *a)._replace(bn=bn, stages=stages)
        try:
            apsq = lambda i: ops.apsq_expert_matmul_int8(x, w, exps, gs=gs)
            base = lambda i: ops.baseline_expert_matmul_int8(x, w)
            ok = torch.equal(apsq(0), want) and torch.equal(base(0), want_b)
            if not ok:
                errors.append(f"expert kernels disagree at bn={bn} "
                              f"stages={stages}")
            out[f"bn={bn} stages={stages}"] = {
                "apsq": both_ms(torch, apsq, 1)[0],
                "baseline": both_ms(torch, base, 1)[0]}
        finally:
            ops.expert_plan = planned
    return out


def routed_codes(torch, gen, dev, E, k, *, tokens=8, top_k=8, cap=2):
    """Activation codes [E, cap, k] as OLMoE's dispatch leaves them at
    8-slot decode: ``tokens`` tokens' seeded top-``top_k`` choices through
    ``models.moe._dispatch`` at capacity ``cap``, random codes in the
    rows where an entry landed and zeros elsewhere."""
    from repro_torch.models.moe import _dispatch
    g = torch.Generator().manual_seed(17)
    topi = torch.stack([torch.randperm(E, generator=g)[:top_k]
                        for _ in range(tokens)]).to(dev)
    order, slot, keep = _dispatch(topi, E, cap)
    codes = torch.randint(-128, 128, (tokens, k), generator=gen, device=dev,
                          dtype=torch.int8)
    buf = torch.zeros((E * cap + 1, k), dtype=torch.int8, device=dev)
    buf[slot] = torch.where(keep[:, None], codes[order // top_k], 0)
    return buf[:-1].reshape(E, cap, k)


def expert_checks(torch, records: dict) -> list:
    """The fused expert GEMMs at OLMoE's shapes (E=64 experts; M is the
    capacity: 2 at 8-slot decode, 3 at a 16-token prefill chunk), every
    expert live, and at 8-slot decode routing (``routed``: the experts no
    token chose have zero rows); the APSQ one at Qwen3-MoE's (E=128)."""
    from repro_torch.kernels.apsq_matmul import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    E, n_p, gs = 64, 8, 4                      # mix2_ffn4 on the experts
    errors, rows = [], []
    for k, n in ((2048, 1024), (1024, 2048)):
        # one bank is 134 MB, past the 50 MB L2: no copies need rotating
        w = torch.randint(-128, 128, (E, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        for m in (1, 2, 3, 16, "routed"):
            if m == "routed":
                if (k, n) != (2048, 1024):
                    continue
                x = routed_codes(torch, gen, dev, E, k)
            else:
                x = torch.randint(-128, 128, (E, m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
            shape_s = f"E={E} M={x.shape[1]} K={k} N={n}"
            row = {"E": E, "M": m, "K": k, "N": n, "n_p": n_p, "gs": gs,
                   "baseline_expert_matmul": expert_rec(
                       torch, ops, ref, x, w, None, 1, errors,
                       f"expert baseline {shape_s}")}
            for layout in ("vec", "cols"):
                shape = (E, n_p) if layout == "vec" else (E, n_p, n)
                exps = torch.randint(0, 14, shape, generator=gen,
                                     device=dev, dtype=torch.int32)
                row[f"apsq_expert_matmul_{layout}"] = expert_rec(
                    torch, ops, ref, x, w, exps, gs, errors,
                    f"expert APSQ {shape_s} exps {layout}")
            rows.append(row)
            # the record of each kernel is its main-path decode shape:
            # per-column exponents (per-channel weights), 8 slots -> M=2
            if (m, k, n) == (2, 2048, 1024):
                records["apsq_expert_matmul"] = dict(
                    row["apsq_expert_matmul_cols"],
                    shape=f"{shape_s} n_p={n_p} gs={gs} exps [E,n_p,N]",
                    plans_ms=expert_plans_ms(torch, ops, ref, x, w, exps,
                                             gs, errors))
                records["baseline_expert_matmul"] = dict(
                    row["baseline_expert_matmul"], shape=shape_s)
            if m == "routed":
                for name, key in (("apsq_expert_matmul",
                                   "apsq_expert_matmul_cols"),
                                  ("baseline_expert_matmul",
                                   "baseline_expert_matmul")):
                    records[name]["at_routed"] = dict(
                        row[key], shape=f"{shape_s}, 8 tokens' top-8 "
                        f"choices at capacity 2")
        del w
    # Qwen3-MoE's banks (E=128; wi/wg [4096, 1536], wo [1536, 4096]; an
    # 805 MB bank) at M=2, and at 4-slot decode routing (4 tokens' top-8
    # choices at capacity 1: the bound counts the live experts only)
    E = 128
    for k, n in ((4096, 1536), (1536, 4096)):
        w = torch.randint(-128, 128, (E, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        for m in (2, "routed"):
            if m == "routed":
                x = routed_codes(torch, gen, dev, E, k, tokens=4, cap=1)
            else:
                x = torch.randint(-128, 128, (E, m, k), generator=gen,
                                  device=dev, dtype=torch.int8)
            exps = torch.randint(0, 14, (E, n_p, n), generator=gen,
                                 device=dev, dtype=torch.int32)
            shape_s = f"E={E} M={x.shape[1]} K={k} N={n}"
            rec = expert_rec(torch, ops, ref, x, w, exps, gs, errors,
                             f"expert APSQ {shape_s} exps cols")
            rows.append({"E": E, "M": m, "K": k, "N": n, "n_p": n_p,
                         "gs": gs, "model": "qwen3-moe-235b-a22b",
                         "apsq_expert_matmul_cols": rec})
            tag = "routed" if m == "routed" else f"m{m}"
            records["apsq_expert_matmul"][f"at_qwen3_k{k}_n{n}_{tag}"] = \
                dict(rec, shape=f"{shape_s} n_p={n_p} gs={gs} exps "
                     f"[E,n_p,N]" + (", 4 tokens' top-8 choices at "
                                     "capacity 1" if m == "routed" else ""))
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


def top2_margins(torch, params, cfg, prompt, out, dev,
                 chunk: int = 1) -> list:
    """Top-2 logit margin of the next token at the end of ``prompt`` and
    after each token of ``out`` (teacher-forced): len(out) + 1 margins.
    One slot over a fresh paged cache; the prompt goes in ``chunk``-token
    pieces, ``out`` one token at a time."""
    from repro_torch.models import forward_paged_chunk, \
        init_paged_decode_state
    toks = [int(t) for t in prompt] + [int(t) for t in out]
    pages = len(toks) // 4 + 2
    st = init_paged_decode_state(cfg, 1, page_size=4, n_pages=pages + 1,
                                 device=dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    pieces = [chunk] * (len(prompt) // chunk) + (
        [len(prompt) % chunk] if len(prompt) % chunk else []) + [1] * len(out)
    margins, done = [], 0
    for c in pieces:
        lg, st = forward_paged_chunk(
            params, cfg, st, torch.tensor([toks[done:done + c]], device=dev),
            torch.tensor([done], dtype=torch.int32, device=dev), table)
        done += c
        if done >= len(prompt):
            top = torch.topk(lg[0, -1].float(), 2).values
            margins.append(float(top[0] - top[1]))
    return margins


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


def tokens_digest(done) -> str:
    """sha256 of finished requests' greedy tokens, by request id."""
    return hashlib.sha256(json.dumps(
        sorted((r.uid, r.out) for r in done)).encode()).hexdigest()


def serve_all(torch, _build, dev, eng, reqs, profile: bool,
              info: dict) -> list:
    """Run ``reqs`` to the end on ``eng``, the path's zeroed run: the
    launch counts are set to 0 here and read at the end.  With
    ``profile``, trace the third heartbeat (device activity only:
    cheap).  Records the serve time, the launch counts and the engine's
    counters in ``info``."""
    _build.reset_launch_counts()
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
    info["tokens_sha256"] = tokens_digest(done)
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


def batched_vs_single(torch, deploy, cfg, reqs, outs, single, step,
                      dev) -> list:
    """Problems where the batched engine's tokens ``outs`` leave the
    single-stream ones: request 0 must stop at its EOS (step ``step``),
    request 1 must match (a mismatch reports the single stream's top-2
    logit margin there)."""
    problems = []
    if outs.get(0) != single[0][:step + 1]:
        problems.append(f"EOS stream: {outs.get(0)} vs expected "
                        f"{single[0][:step + 1]}")
    if outs.get(1) != single[1]:
        a, b = outs.get(1, []), single[1]
        i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 min(len(a), len(b)))
        margin = top2_margins(torch, deploy, cfg,
                              list(reqs[1].tokens) + b[:i], [], dev)[0]
        problems.append(f"batched != single-stream for request 1 at step "
                        f"{i}: {a[i:i + 1]} vs {b[i:i + 1]}, single-stream "
                        f"top-2 logit margin {margin}")
    return problems


def logits_check(torch, deploy, cfg, tokens, dev, info: dict) -> list:
    """One 16-token chunk of ``tokens`` on a fresh slot: the last row's
    logits must be finite and of shape [1, 1, vocab]."""
    from repro_torch.models import forward_paged_chunk, \
        init_paged_decode_state
    st = init_paged_decode_state(cfg, 1, page_size=16, n_pages=3, device=dev)
    lg, _ = forward_paged_chunk(
        deploy, cfg, st, torch.tensor(tokens[None][:, :16], device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([[1, 2]], dtype=torch.int32, device=dev))
    info["logits_finite"] = bool(torch.isfinite(lg).all())
    if not info["logits_finite"] or list(lg.shape) != [1, 1, cfg.vocab]:
        return [f"logits {list(lg.shape)} finite={info['logits_finite']}"]
    return []


def phase_serve(torch, np, _build, cfg, dev, profile: bool = False):
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(12)
    info = {}
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
    t0 = time.perf_counter()
    deploy, _ = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    info["kept_export_s"] = keep_export("serve", cfg, deploy)
    # single-stream reference for requests 0 and 1 (request 0 probes EOS)
    single, step = single_stream_check(torch, deploy, cfg, reqs[:2], kw,
                                       dev, probe_eos=True)
    eng = PagedServingEngine(deploy, cfg, max_batch=8,
                             n_pages=8 * pages + 1, **kw)
    done = serve_all(torch, _build, dev, eng, reqs, profile, info)
    problems = []
    if len(done) != 16:
        problems.append(f"{len(done)} of 16 requests finished")
    problems += batched_vs_single(torch, deploy, cfg, reqs,
                                  {r.uid: r.out for r in done}, single, step,
                                  dev)
    problems += logits_check(torch, deploy, cfg, reqs[2].tokens, dev, info)
    problems += missing_launches("serve", info["launches"])
    return info, problems


def phase_w8a8(torch, np, _build, cfg, dev):
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.scaled(n_layers=2).with_quant(policy_presets()["ffn_only"])
    rng = np.random.default_rng(13)
    params = init_lm(cfg, seed=1, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    eng = PagedServingEngine.from_exported(
        params, cfg, max_batch=4, n_pages=4 * 4 + 1, page_size=16,
        prefill_chunk=16, decode_horizon=4, max_pages_per_slot=4)
    _build.reset_launch_counts()        # the path's zeroed run
    done = eng.run(reqs)
    sync(torch, dev)
    info = {"launches": dict(_build.launch_counts), "requests": len(done),
            "generated_tokens": sum(len(r.out) for r in done),
            "tokens_sha256": tokens_digest(done)}
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


def moe_engine_checks(torch, deploy, cfg, reqs, kw, dev, info) -> list:
    """Engines on the card serving ``reqs`` with the same params and
    engine settings ``kw``.  Held to equal greedy tokens: the CUDA GEMM
    kernels with the plain attention against the oracle (the integer
    kernels are exact, so every float op downstream is the same), and
    the cuda engine against a second run of itself (deterministic).  The
    cuda engine against the oracle is reported: its attention kernel
    agrees with the plain version only within rtol 2e-5, and under bf16
    rounding, a top-8 routing near a tie and greedy argmax that can
    change a token.  Returns the problems; records in ``info``."""
    from repro_torch.serving import PagedServingEngine, Request
    problems, sub = [], {}
    for name, backend in (("cuda", "cuda"), ("cuda_again", "cuda"),
                          ("cuda_gemms", gemm_kernels_plain_attention()),
                          ("oracle", "oracle")):
        t0 = time.perf_counter()
        e = PagedServingEngine(deploy, cfg, backend=backend, **kw)
        outs = e.run([Request(uid=r.uid, tokens=r.tokens,
                              max_new_tokens=r.max_new_tokens)
                      for r in reqs])
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
    prefixes = {f"prompt {r.uid}": list(r.tokens) for r in reqs}
    div = info["cuda_vs_oracle"].get("first_divergence")
    if div:
        r = next(r for r in reqs if r.uid == div["request"])
        prefixes["divergence"] = (list(r.tokens)
                                  + sub["oracle"][r.uid][:div["step"]])
    info["cuda_vs_oracle_logits"] = {
        k: logit_gap(torch, deploy, cfg, toks, dev)
        for k, toks in prefixes.items()}
    return problems


def phase_moe_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full OLMoE-1B-7B: init -> calibrate -> export -> serve 16
    requests on 8 slots; then a cuda engine and an oracle engine on the
    card serve 4 of them with the same params and max_batch."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(21)
    info = {}
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
    info["kept_export_s"] = keep_export("moe_serve", cfg, deploy)
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
    problems += logits_check(torch, deploy, cfg, reqs[2].tokens, dev, info)
    problems += moe_engine_checks(torch, deploy, cfg, reqs[:4], kw, dev,
                                  info)
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
    params = init_lm(cfg, seed=1, device=dev)
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    eng = PagedServingEngine.from_exported(
        params, cfg, max_batch=4, n_pages=4 * 4 + 1, page_size=16,
        prefill_chunk=16, decode_horizon=4, max_pages_per_slot=4)
    _build.reset_launch_counts()        # the path's zeroed run
    done = eng.run(reqs)
    sync(torch, dev)
    info = {"launches": dict(_build.launch_counts), "requests": len(done),
            "generated_tokens": sum(len(r.out) for r in done),
            "tokens_sha256": tokens_digest(done)}
    problems = missing_launches("moe_w8a8", info["launches"])
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    return info, problems


def release(torch) -> None:
    """Free what the last phase left on the card and restart the peak
    count, so the next phase's peak memory is its own
    (``max_memory_allocated`` does not count the allocator's cache, which
    stays for the next phase)."""
    import gc
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def deployed_gemm_checks(torch, tree, errors: list,
                         ms=(1, 3, 8, 16)) -> int:
    """Every deployed GEMM of ``tree`` (on the card) on random activation
    codes at each M of ``ms`` (by default 1, the ``__dp4a`` body of a
    dense APSQ GEMM, 3, 8 and 16; an expert bank: M rows for each
    expert), at the layer's own K, N, n_p and gs, against its plain
    version on the same codes, bit for bit; returns how many layers were
    held."""
    from repro_torch.core import DeployedQuantState, psum_group_size
    from repro_torch.kernels.apsq_matmul import ops, ref
    gen = None
    n = 0

    def walk(node, path):
        nonlocal n, gen
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
            return
        if not isinstance(node, DeployedQuantState):
            return
        n += 1
        w = node.w_codes
        bank = w.dim() == 3
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(4)
        for m in ms:
            x = torch.randint(-128, 128, w.shape[:-2] + (m, w.shape[-2]),
                              generator=gen, device=w.device,
                              dtype=torch.int8)
            if node.psum_exps is None and bank:
                got = ops.baseline_expert_matmul_int8(x, w)
                want = ref.baseline_expert_matmul_ref(x, w)
            elif node.psum_exps is None:
                got = ops.baseline_matmul_int8(x, w)
                want = ref.baseline_matmul_ref(x, w)
            else:
                n_p = int(node.psum_exps.shape[1 if bank else 0])
                gs = psum_group_size(node.spec, n_p)
                if bank:
                    got = ops.apsq_expert_matmul_int8(x, w, node.psum_exps,
                                                      gs=gs)
                    want = ref.apsq_expert_matmul_ref(x, w, node.psum_exps,
                                                      gs=gs)
                else:
                    got = ops.apsq_matmul_int8(x, w, node.psum_exps, gs=gs)
                    want = ref.apsq_matmul_ref(x, w, node.psum_exps,
                                               n_p=n_p, gs=gs)
            if not torch.equal(got, want):
                errors.append(f"deployed {path} at M={m}: max|err|="
                              f"{int((got.long() - want.long()).abs().max())}")

    walk(tree, "")
    torch.cuda.synchronize()
    return n


def phase_load(torch, np, _build, dev):
    """The committed JAX export, restored without JAX and served."""
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_smoke
    from repro_torch.models import forward_paged_chunk, \
        init_paged_decode_state
    from repro_torch.serving import PagedServingEngine, Request
    problems = []
    t0 = time.perf_counter()
    tree_cpu, manifest = restore(FIXTURE, device="cpu")
    tree, _ = restore(FIXTURE)                  # device=None: the card
    info = {"restore_s": time.perf_counter() - t0,
            "leaves": len(manifest["leaves"])}
    extra = manifest["extra"]
    cfg = get_smoke(extra["arch"]).scaled(
        tie_embeddings=extra["tie_embeddings"])
    kw = {k: v for k, v in extra["engine"].items() if k != "backend"}
    want = {r["uid"]: r["out"] for r in extra["requests"]}

    def run(params, backend):
        done = PagedServingEngine(params, cfg, backend=backend, **kw).run([
            Request(uid=r["uid"], tokens=np.array(r["tokens"], np.int32),
                    max_new_tokens=r["max_new_tokens"])
            for r in extra["requests"]])
        return {r.uid: r.out for r in done}, tokens_digest(done)

    # (a) the port's oracle engine on the CPU
    cpu_out, _ = run(tree_cpu, "oracle")
    info["cpu_oracle_equals_jax"] = cpu_out == want
    if cpu_out != want:
        problems.append(f"CPU oracle engine {cpu_out} != JAX {want}")
    # (b) every deployed GEMM on the card against its plain version
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, tree,
                                                       problems)
    # (c) the cuda engine, the path's zeroed run
    _build.reset_launch_counts()
    cuda_out, info["tokens_sha256"] = run(tree, "cuda")
    sync(torch, dev)
    info["launches"] = dict(_build.launch_counts)
    info["cuda_equals_jax"] = cuda_out == want
    if cuda_out != want:
        problems.append(f"cuda engine {cuda_out} != JAX {want}: first "
                        f"divergence {first_divergence(cuda_out, want)}")
    info["min_top2_margin"] = min(
        m for r in extra["requests"]
        for m in top2_margins(torch, tree, cfg, r["tokens"], r["out"], dev,
                              kw["prefill_chunk"])[:-1])
    # (d) last-chunk logits of the longest prompt, card vs CPU
    toks = max((r["tokens"] for r in extra["requests"]), key=len)
    chunks = [kw["prefill_chunk"]] * (len(toks) // kw["prefill_chunk"])
    if len(toks) % kw["prefill_chunk"]:
        chunks.append(len(toks) % kw["prefill_chunk"])
    out = {}
    for d, params in (("cpu", tree_cpu), ("cuda", tree)):
        st = init_paged_decode_state(cfg, 1, page_size=kw["page_size"],
                                     n_pages=16, device=d)
        table = torch.arange(1, 16, dtype=torch.int32, device=d)[None]
        done = 0
        for c in chunks:
            lg, st = forward_paged_chunk(
                params, cfg, st, torch.tensor([toks[done:done + c]],
                                              device=d),
                torch.tensor([done], dtype=torch.int32, device=d), table)
            done += c
        out[d] = lg.float().cpu()
    info["logits_max_abs_err"] = float((out["cpu"] - out["cuda"]).abs().max())
    if not torch.allclose(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3):
        problems.append(f"card vs CPU logits differ by "
                        f"{info['logits_max_abs_err']}")
    problems += missing_launches("load", info["launches"])
    return info, problems


def single_stream_check(torch, deploy, cfg, reqs, kw, dev, probe_eos: bool):
    """Serve ``reqs`` one at a time on a max_batch=1 engine; with
    ``probe_eos`` the first request gets as EOS a token it first emits
    at a step >= 1.  Returns {uid: tokens} and the EOS step (or None)."""
    from repro_torch.serving import PagedServingEngine, Request
    solo = PagedServingEngine(deploy, cfg, max_batch=1,
                              n_pages=kw["max_pages_per_slot"] + 1, **kw)
    single = {}
    for r in reqs:
        probe = Request(uid=r.uid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens)
        solo.run([probe])
        single[r.uid] = probe.out
    step = None
    if probe_eos:
        out0 = single[reqs[0].uid]
        step = next(i for i in range(1, len(out0)) if out0[i] not in out0[:i])
        reqs[0].eos_token = out0[step]
    sync(torch, dev)
    return single, step


def phase_sc2_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full StarCoder2-15B: init -> calibrate -> export -> serve 8
    requests on 8 slots, the float params dropped after export."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(31)
    info = {}
    torch.cuda.empty_cache()        # 15 B parameters: the card to itself
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 64))})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params                      # the bf16 weights go; the codes stay
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    reqs = make_requests(np, rng, 8, cfg.vocab, 5, 48, 8, 16, Request)
    pages = math.ceil((48 + 16) / 16)
    kw = dict(page_size=16, prefill_chunk=16, decode_horizon=8,
              max_pages_per_slot=pages)
    t0 = time.perf_counter()
    single, step = single_stream_check(torch, deploy, cfg, reqs[:2], kw,
                                       dev, probe_eos=True)
    info["single_stream_s"] = time.perf_counter() - t0
    eng = PagedServingEngine(deploy, cfg, max_batch=8,
                             n_pages=8 * pages + 1, **kw)
    done = serve_all(torch, _build, dev, eng, reqs, profile, info)
    info["peak_mem_gb"] = max(info["peak_mem_gb"], info["peak_mem_export_gb"])
    problems = []
    if len(done) != 8:
        problems.append(f"{len(done)} of 8 requests finished")
    problems += batched_vs_single(torch, deploy, cfg, reqs,
                                  {r.uid: r.out for r in done}, single, step,
                                  dev)
    problems += logits_check(torch, deploy, cfg, reqs[2].tokens, dev, info)
    problems += missing_launches("sc2_serve", info["launches"])
    return info, problems


def iter_tensors(tree):
    import dataclasses
    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from iter_tensors(getattr(tree, f.name))
    elif hasattr(tree, "numel"):
        yield tree


def phase_dense_2l(torch, np, _build, configs, dev):
    """ChatGLM3-6B and DeepSeek-7B at full width, 2 layers, mix2_ffn4:
    4 requests on 4 slots, batched == single-stream for one of them.
    Each model is its own path (launch counts zeroed per model)."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    info, problems, paths = {}, [], {}
    for seed, full in enumerate(configs):
        cfg = full.scaled(n_layers=2).with_quant(
            policy_presets()["mix2_ffn4"])
        rng = np.random.default_rng(40 + seed)
        params = init_lm(cfg, seed=seed, device=dev)
        params = calibrate_model(params, cfg, {
            "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
        deploy, _ = export_quantized(params)
        del params
        reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
        kw = dict(page_size=16, prefill_chunk=16, decode_horizon=4,
                  max_pages_per_slot=4)
        single, _ = single_stream_check(torch, deploy, cfg, reqs[:1], kw,
                                        dev, probe_eos=False)
        _build.reset_launch_counts()    # the path's zeroed run
        done = PagedServingEngine(deploy, cfg, max_batch=4,
                                  n_pages=4 * 4 + 1, **kw).run(reqs)
        sync(torch, dev)
        path = f"dense_2l/{full.name}"
        paths[path] = dict(_build.launch_counts)
        outs = {r.uid: r.out for r in done}
        info[full.name] = {
            "requests": len(done), "tokens_sha256": tokens_digest(done),
            "generated_tokens": sum(len(r.out) for r in done),
            "batched_equals_single": outs.get(0) == single[0],
            "launches": paths[path]}
        if len(done) != 4:
            problems.append(f"{full.name}: {len(done)} of 4 requests")
        if outs.get(0) != single[0]:
            problems.append(f"{full.name}: batched {outs.get(0)} != "
                            f"single-stream {single[0]}")
        problems += missing_launches(path, paths[path])
        del deploy
        release(torch)
    info["paths"] = paths
    return info, problems


def phase_qwen3_2l(torch, np, _build, cfg, dev):
    """Qwen3-MoE-235B-A22B at full width (d=4096, 64/4 heads at hd=128:
    an attention wider than the model, 128 experts top-8, expert d_ff
    1536, vocab 151936), cut to 2 of 94 layers, mix2_ffn4: init ->
    calibrate -> export -> every deployed GEMM bit-exact against its
    plain version -> 4 requests on 4 slots (the path's zeroed run) ->
    the ``moe_serve`` engine checks."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.scaled(n_layers=2).with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(61)
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32))})
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["calibrate_export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    info["clamped_exps"] = sum(r["clamped_exps"] for r in report.values())
    banks = [k for k, r in report.items() if "n_experts" in r]
    info["expert_banks"] = len(banks)
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, deploy,
                                                       problems)
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    kw = dict(max_batch=4, n_pages=4 * 4 + 1, page_size=16,
              prefill_chunk=16, decode_horizon=4, max_pages_per_slot=4)
    done = serve_all(torch, _build, dev, PagedServingEngine(deploy, cfg,
                                                            **kw),
                     reqs, False, info)
    info["peak_mem_gb"] = max(info["peak_mem_gb"] or 0.0,
                              info["peak_mem_export_gb"])
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    problems += logits_check(torch, deploy, cfg, reqs[0].tokens, dev, info)
    problems += moe_engine_checks(torch, deploy, cfg, reqs, kw, dev, info)
    problems += missing_launches("qwen3_2l", info["launches"])
    return info, problems


TRAIN_CKPT = os.path.join(ROOT, "_train_ckpt")    # git-ignored, removed
MOE_TRAIN_LAYERS = 4


def tree_bits_equal(torch, a, b) -> list:
    """Paths where two trees' leaves differ in shape, dtype or any bit."""
    from repro_torch.models import tree_leaves
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    if la.keys() != lb.keys():
        return [f"leaf sets differ: {sorted(set(la) ^ set(lb))[:4]}"]
    bad = []
    for path, x in la.items():
        y = lb[path]
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append("/".join(path))
            continue
        ix = x.view(torch.int16) if x.element_size() == 2 else x
        iy = y.view(torch.int16) if y.element_size() == 2 else y
        if not torch.equal(ix, iy):
            bad.append("/".join(path))
    return bad


def phase_train(torch, np, _build, cfg, dev, steps: int = 10,
                profile: bool = False, path: str = "train"):
    """Full-width QAT: init -> calibrate -> Trainer.fit (APSQ gs=2 n_p=8,
    seq 256, batch 8, 2 microbatches) -> save -> restore (bit-equal) ->
    2 steps resumed from the checkpoint == 2 steps in memory (bit-equal)
    -> snap_params_po2 / export_quantized: the snapped fake-quant forward
    and the integer forward on the card agree (1e-4, same greedy tokens)
    -> PagedServingEngine serves 4 requests; a dense model: a
    max_batch=1 engine gives request 0's tokens; a MoE model: the
    ``moe_serve`` engine checks (``moe_engine_checks``)."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint import restore, to_device
    from repro_torch.core import QuantConfig
    from repro_torch.data import DataConfig, SyntheticCorpus, \
        device_put_batch
    from repro_torch.models import forward, init_lm
    from repro_torch.optim import OptimConfig
    from repro_torch.quant import calibrate_model, export_quantized, \
        snap_params_po2
    from repro_torch.serving import PagedServingEngine, Request
    from repro_torch.train import TrainConfig, Trainer, make_train_step
    problems = []
    info = {"allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32],
            "config": cfg.name, "layers": cfg.n_layers}
    if any(info["allow_tf32"]):
        problems.append(f"TF32 is on {info['allow_tf32']}: the fake-quant "
                        "GEMM needs exact float32 tile sums")
    cfg = cfg.with_quant(QuantConfig.apsq(gs=2, n_p=8))
    data = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8)
    corpus = SyntheticCorpus(data)
    # the launcher's schedule at --lr 3e-4
    ocfg = OptimConfig(lr=3e-4, total_steps=steps,
                       warmup_steps=max(steps // 20, 5))
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    tcfg = TrainConfig(microbatches=2, steps=steps, save_every=steps,
                       log_every=5, ckpt_dir=TRAIN_CKPT)
    params = init_lm(cfg, seed=0, device=dev)
    params = calibrate_model(params, cfg,
                             {"tokens": corpus.batch_at(10**6)["tokens"]})
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, ocfg, tcfg, device=dev)
    t0 = time.perf_counter()
    params, opt = trainer.fit(data, params=params,
                              log=lambda m: print(m, flush=True))
    info["fit_s"] = time.perf_counter() - t0     # checkpoint write included
    info["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log = trainer.metrics_log
    losses = [m["loss"] for m in log]
    dts = sorted(m["dt"] for m in log)
    info["steps"] = steps
    info["losses"] = losses
    info["grad_norms"] = [m["grad_norm"] for m in log]
    info["step_ms_median"] = 1e3 * dts[len(dts) // 2]
    info["step_ms_first"] = 1e3 * log[0]["dt"]
    info["train_tokens_per_s"] = (data.global_batch * data.seq_len
                                  / (info["step_ms_median"] / 1e3))
    if not all(math.isfinite(v) for v in losses + info["grad_norms"]):
        problems.append("a loss or grad-norm is not finite")
    info["loss_drop"] = losses[0] - sum(losses[-3:]) / 3
    if not info["loss_drop"] >= 0.5:
        problems.append(f"mean of the last 3 losses is not 0.5 below the "
                        f"first: {losses}")
    step_fn = make_train_step(cfg, ocfg, tcfg)
    if profile:     # one more step, traced (device activity), discarded
        from torch.profiler import ProfilerActivity
        batch = device_put_batch(corpus.batch_at(steps), dev)
        sync(torch, dev)
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        tw = time.perf_counter()
        step_fn(params, opt, batch)
        sync(torch, dev)
        window = time.perf_counter() - tw
        prof.__exit__(None, None, None)
        info["profile"] = profile_summary(prof, window)
        info["profile"].update(window_s=window, window="one train step")

    t0 = time.perf_counter()
    state, manifest = restore(TRAIN_CKPT, device=dev)
    info["restore_s"] = time.perf_counter() - t0
    info["ckpt_leaves"] = len(manifest["leaves"])
    info["ckpt_gb"] = sum(os.path.getsize(os.path.join(dirpath, f))
                          for dirpath, _, files in os.walk(TRAIN_CKPT)
                          for f in files) / 1e9
    bad = tree_bits_equal(torch, state, {"params": params, "opt": opt})
    info["restored_bit_equal"] = not bad
    if bad:
        problems.append(f"restored tree differs at {bad[:4]}")
    trained = state["params"]
    del state
    for s in (steps, steps + 1):
        params, opt, _ = step_fn(params, opt,
                                 device_put_batch(corpus.batch_at(s), dev))
    # held in host memory while the resumed run holds its own state
    continuous = to_device({"params": params, "opt": opt}, "cpu")
    del params, opt
    release(torch)
    resumed = Trainer(cfg, ocfg, dataclasses.replace(tcfg, save_every=0),
                      device=dev)
    p_res, o_res = resumed.fit(data, steps=steps + 2, log=lambda m: None)
    bad = tree_bits_equal(torch, continuous, to_device(
        {"params": p_res, "opt": o_res}, "cpu"))
    info["resume_bit_equal"] = not bad
    if bad:
        problems.append(f"2 steps resumed from the checkpoint differ from "
                        f"2 steps in memory at {bad[:4]}")
    del continuous, p_res, o_res
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    release(torch)

    # the trained model (from its checkpoint), exported and served
    deploy, report = export_quantized(trained)
    info["clamped_exps"] = sum(r["clamped_exps"] for r in report.values())
    tokens = torch.as_tensor(corpus.batch_at(10**6 + 1)["tokens"][:2],
                             device=dev)
    with torch.no_grad():
        fake = forward(snap_params_po2(trained), cfg, tokens).float()
        integer = forward(deploy, cfg, tokens).float()
    del trained
    info["logit_gap"] = float((fake - integer).abs().max())
    info["greedy_equal"] = bool(torch.equal(fake.argmax(-1),
                                            integer.argmax(-1)))
    if not info["logit_gap"] <= 1e-4 or not info["greedy_equal"]:
        problems.append(f"snapped fake quant vs integer path: max |gap| "
                        f"{info['logit_gap']}, greedy equal "
                        f"{info['greedy_equal']}")
    del fake, integer
    rng = np.random.default_rng(51)
    reqs = make_requests(np, rng, 4, cfg.vocab, 5, 48, 8, 16, Request)
    kw = dict(page_size=16, prefill_chunk=16, decode_horizon=8,
              max_pages_per_slot=4)
    moe = cfg.mlp == "moe"
    if not moe:
        single, _ = single_stream_check(torch, deploy, cfg, reqs[:1], kw,
                                        dev, probe_eos=False)
    eng = PagedServingEngine(deploy, cfg, max_batch=4, n_pages=4 * 4 + 1,
                             **kw)
    done = serve_all(torch, _build, dev, eng, reqs, False, info)
    info["peak_mem_gb"] = max(info["train_peak_mem_gb"],
                              info["peak_mem_gb"] or 0.0)
    outs = {r.uid: r.out for r in done}
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    if moe:     # MoE capacity comes from the whole call: no single stream
        problems += moe_engine_checks(torch, deploy, cfg, reqs, dict(
            kw, max_batch=4, n_pages=4 * 4 + 1), dev, info)
    elif outs.get(0) != single[0]:
        problems.append(f"batched {outs.get(0)} != single-stream "
                        f"{single[0]}")
    problems += missing_launches(path, info["launches"])
    return info, problems


RWKV_TRAIN_LAYERS = 2


def wkv_check(torch, cfg, dev, info: dict) -> list:
    """The chunked WKV against the per-token scan on the card at the
    model's full head width (H x hd, 4 sequences of 64 tokens from a
    random state, ``log_w`` over its clip range [-2, -1e-4], chunk
    ``cfg.wkv_chunk``): relative error (max |diff| / max |scan|) of the
    outputs and final states within 5e-6, the CPU tests' bound."""
    from repro_torch.models.rwkv import _wkv_chunked, _wkv_scan
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (4, 64, cfg.n_heads, cfg.hd)
    r, k, v = (torch.randn(shape, generator=g, device=dev)
               for _ in range(3))
    log_w = torch.clamp(-torch.exp(torch.rand(shape, generator=g,
                                              device=dev) * 10.5 - 9),
                        -2.0, -1e-4)
    u = torch.randn((cfg.n_heads, cfg.hd), generator=g, device=dev) * 0.5
    s0 = torch.randn((4, cfg.n_heads, cfg.hd, cfg.hd), generator=g,
                     device=dev)
    with torch.no_grad():
        yc, sc = _wkv_chunked(r, k, v, log_w, u, s0, chunk=cfg.wkv_chunk)
        ys, ss = _wkv_scan(r, k, v, log_w, u, s0)
    info["wkv_chunked_vs_scan_rel"] = [
        float((a - b).abs().max() / b.abs().max())
        for a, b in ((yc, ys), (sc, ss))]
    if not max(info["wkv_chunked_vs_scan_rel"]) <= 5e-6:
        return [f"chunked WKV vs scan: {info['wkv_chunked_vs_scan_rel']}"]
    return []


def engines_equal(torch, deploy, cfg, reqs, kw, dev, info) -> list:
    """A ``cuda`` engine and an ``oracle`` engine on the card serve
    ``reqs`` with the same params and settings: the tokens must be
    identical (the path has no attention, and the integer GEMM kernels
    are exact, so every float op is the same in both)."""
    from repro_torch.serving import PagedServingEngine, Request
    sub = {}
    for backend in ("cuda", "oracle"):
        t0 = time.perf_counter()
        e = PagedServingEngine(deploy, cfg, backend=backend, **kw)
        sub[backend] = {r.uid: r.out for r in e.run([
            Request(uid=r.uid, tokens=r.tokens,
                    max_new_tokens=r.max_new_tokens) for r in reqs])}
        sync(torch, dev)
        info[f"sub_{backend}_s"] = time.perf_counter() - t0
    div = first_divergence(sub["cuda"], sub["oracle"])
    info["cuda_vs_oracle"] = {"equal": div is None, "tokens": sum(
        len(o) for o in sub["oracle"].values())}
    if div is not None:
        return [f"cuda engine != oracle engine at (request, step) {div}"]
    return []


def rwkv_train_tail(torch, cfg, dev, info: dict) -> list:
    """QAT of the model at full width cut to ``RWKV_TRAIN_LAYERS``
    layers (APSQ gs=2 n_p=8, seq 256 x batch 4 in 2 microbatches, the
    chunked WKV and its backward): 2 steps with finite losses, and the
    first step taken again from the same state gives the same loss and
    params, bit for bit."""
    from repro_torch.core import QuantConfig
    from repro_torch.data import DataConfig, SyntheticCorpus, \
        device_put_batch
    from repro_torch.models import init_lm
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.quant import calibrate_model
    from repro_torch.train import TrainConfig, make_train_step
    cfg = cfg.scaled(n_layers=RWKV_TRAIN_LAYERS).with_quant(
        QuantConfig.apsq(gs=2, n_p=8))
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=256,
                                        global_batch=4))
    # the launcher's schedule at --lr 3e-4 (warmup max(steps // 20, 5))
    ocfg = OptimConfig(lr=3e-4, total_steps=2, warmup_steps=5)
    release(torch)
    params = init_lm(cfg, seed=0, device=dev)
    params = calibrate_model(params, cfg,
                             {"tokens": corpus.batch_at(10**6)["tokens"]})
    opt = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, TrainConfig(microbatches=2))
    batches = [device_put_batch(corpus.batch_at(s), dev) for s in (0, 1)]
    t0 = time.perf_counter()
    p1, o1, m1 = step_fn(params, opt, batches[0])
    p2, _, m2 = step_fn(p1, o1, batches[1])
    sync(torch, dev)
    info["train_2_steps_s"] = time.perf_counter() - t0
    info["train_losses"] = [float(m1["loss"]), float(m2["loss"])]
    info["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    problems = []
    if not all(math.isfinite(v) for v in info["train_losses"]):
        problems.append(f"train losses {info['train_losses']}")
    again, _, m1b = step_fn(params, opt, batches[0])
    bad = tree_bits_equal(torch, again, p1)
    info["train_step_repeats"] = not bad and float(m1b["loss"]) == float(
        m1["loss"])
    if not info["train_step_repeats"]:
        problems.append(f"the train step from one state differs on repeat "
                        f"at {bad[:4]}")
    return problems


def phase_rwkv_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full-width RWKV6-3B (32 layers, d=2560, 40 heads of 64, d_ff 8960,
    vocab 65536, bf16, random weights from seed 0): init -> calibrate
    (4 x 64 tokens: the chunked WKV) -> export (mix2_ffn4) -> del the
    float params -> 8 requests on 8 slots (page 16, chunk 16, horizon 8;
    the path's zeroed run).  Checks: every deployed GEMM (kernels 1 and 4
    at K=N=2560 n_p=4 gs=2, 2560x8960 and 8960x2560 at n_p=8 gs=4) bit
    for bit against its plain version, batched == single-stream for two
    requests (one with an EOS at step >= 1), a request served on the slot
    another left gives its tokens from a fresh engine, the ``cuda`` and
    ``oracle`` engines give identical tokens on 2 requests, finite
    logits, the chunked WKV within 5e-6 of the scan at full head width,
    then the QAT tail (``rwkv_train_tail``)."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(41)
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 64))})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    info["clamped_exps"] = sum(r["clamped_exps"] for r in report.values())
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, deploy,
                                                       problems)
    problems += wkv_check(torch, cfg, dev, info)
    reqs = make_requests(np, rng, 8, cfg.vocab, 5, 60, 16, 32, Request)
    pages = math.ceil((60 + 32) / 16)
    kw = dict(page_size=16, prefill_chunk=16, decode_horizon=8,
              max_pages_per_slot=pages)
    t0 = time.perf_counter()
    single, step = single_stream_check(torch, deploy, cfg, reqs[:2], kw,
                                       dev, probe_eos=True)
    # request 1 above ran on the slot request 0 left: again on a fresh one
    fresh, _ = single_stream_check(torch, deploy, cfg, reqs[1:2], kw, dev,
                                   probe_eos=False)
    info["single_stream_s"] = time.perf_counter() - t0
    info["reused_slot_equal"] = fresh[1] == single[1]
    if not info["reused_slot_equal"]:
        problems.append(f"request 1 on a reused slot {single[1]} != on a "
                        f"fresh engine {fresh[1]}")
    eng = PagedServingEngine(deploy, cfg, max_batch=8,
                             n_pages=8 * pages + 1, **kw)
    done = serve_all(torch, _build, dev, eng, reqs, profile, info)
    info["peak_mem_gb"] = max(info["peak_mem_gb"] or 0.0,
                              info["peak_mem_export_gb"])
    if len(done) != 8:
        problems.append(f"{len(done)} of 8 requests finished")
    problems += batched_vs_single(torch, deploy, cfg, reqs,
                                  {r.uid: r.out for r in done}, single, step,
                                  dev)
    problems += logits_check(torch, deploy, cfg, reqs[2].tokens, dev, info)
    problems += missing_launches("rwkv_serve", info["launches"])
    problems += engines_equal(torch, deploy, cfg, reqs[2:4], dict(
        kw, max_batch=2, n_pages=2 * pages + 1), dev, info)
    del deploy
    problems += rwkv_train_tail(torch, cfg, dev, info)
    return info, problems


RG_WINDOW_LAYERS = 3      # one (rglru, rglru, local) unit


def dense_engine_run(torch, eng, reqs, dev, profile: bool = False,
                     info: dict | None = None) -> dict:
    """Run fresh copies of ``reqs`` to the end on a dense ``ServingEngine``;
    returns {uid: tokens}.  With ``profile``, trace its third heartbeat
    (admission + one decode macro-step) into ``info["profile"]``."""
    from repro_torch.serving import Request
    pending = [Request(uid=r.uid, tokens=r.tokens,
                       max_new_tokens=r.max_new_tokens,
                       eos_token=r.eos_token) for r in reqs]
    done, beat = [], 0
    while pending or any(s is not None for s in eng.slots):
        if profile and beat == 2:
            from torch.profiler import ProfilerActivity
            sync(torch, dev)
            prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            tw = time.perf_counter()
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        done.extend(eng.step())
        if profile and beat == 2:
            sync(torch, dev)
            window = time.perf_counter() - tw
            prof.__exit__(None, None, None)
            info["profile"] = profile_summary(prof, window)
            info["profile"].update(window_s=window,
                                   window="engine heartbeat 2")
        beat += 1
    sync(torch, dev)
    return {r.uid: r.out for r in done}


def dense_logits_check(torch, deploy, cfg, tokens, dev, info: dict) -> list:
    """``decode_step`` over 16 tokens of ``tokens`` from a fresh dense
    state: the logits of every step finite, of shape [1, 1, vocab]."""
    from repro_torch.models import decode_step, init_decode_state
    st = init_decode_state(cfg, 1, 64, device=dev)
    finite, shape = True, None
    for t in range(16):
        lg, st = decode_step(deploy, cfg, st,
                             torch.tensor([[int(tokens[t])]], device=dev),
                             torch.tensor([t], dtype=torch.int32,
                                          device=dev))
        finite = finite and bool(torch.isfinite(lg).all())
        shape = list(lg.shape)
    info["logits_finite"] = finite
    if not finite or shape != [1, 1, cfg.vocab]:
        return [f"logits {shape} finite={finite}"]
    return []


def rg_window_check(torch, np, cfg, dev, info: dict) -> list:
    """RecurrentGemma's widths cut to one unit (rglru, rglru, local): one
    request of 2064 prompt tokens and 16 new ones at cache_len 2112, so
    the 2048-slot ring wraps and the window masks.  The prompt prefills
    once; a second engine at horizon 1 takes a copy of the prefilled
    slot.  Gate: horizon 8 gives horizon 1's tokens.  Reported: agreement
    of those tokens with ``forward``'s greedy tokens over the same
    sequence (teacher-forced), with the top-2 logit margin where they
    differ (bf16), and the times."""
    from repro_torch.models import forward, init_lm, tree_map
    from repro_torch.quant import calibrate_model, export_quantized
    from repro_torch.serving import Request, ServingEngine
    t_all = time.perf_counter()
    cfg = cfg.scaled(n_layers=RG_WINDOW_LAYERS)
    rng = np.random.default_rng(53)
    params = calibrate_model(init_lm(cfg, seed=1, device=dev), cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 64))})
    deploy, _ = export_quantized(params)
    del params
    prompt = rng.integers(0, cfg.vocab, size=2064).astype(np.int32)
    engines = {h: ServingEngine(deploy, cfg, max_batch=1, cache_len=2112,
                                decode_horizon=h) for h in (8, 1)}
    t0 = time.perf_counter()
    engines[8].add_request(Request(uid=0, tokens=prompt, max_new_tokens=16))
    sync(torch, dev)
    info["window_prefill_s"] = time.perf_counter() - t0
    twin = engines[1]
    twin.state = tree_map(lambda _, t: t.clone(), engines[8].state)
    twin.pos = engines[8].pos.copy()
    twin.slots = [Request(uid=0, tokens=prompt, max_new_tokens=16,
                          out=list(engines[8].slots[0].out))]
    outs = {}
    for h in (8, 1):
        t0 = time.perf_counter()
        outs[h] = dense_engine_run(torch, engines[h], [], dev)[0]
        info[f"window_h{h}_s"] = time.perf_counter() - t0
    seq = torch.tensor([[int(t) for t in prompt] + outs[8][:-1]],
                       device=dev)
    with torch.no_grad():
        lg = forward(deploy, cfg, seq)[0, len(prompt) - 1:].float()
    ref = [int(t) for t in lg.argmax(-1)]
    top = torch.topk(lg, 2, dim=-1).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    info["window"] = {
        "layers": cfg.n_layers, "prompt": len(prompt), "new": 16,
        "cache_len": 2112, "ring": cfg.local_window,
        "h8_equals_h1": outs[8] == outs[1],
        "forward_agrees": sum(a == b for a, b in zip(outs[8], ref)),
        "forward_differs_at": [
            {"step": i, "engine": a, "forward": b, "margin": margins[i]}
            for i, (a, b) in enumerate(zip(outs[8], ref)) if a != b],
        "seconds": time.perf_counter() - t_all}
    if outs[8] != outs[1]:
        return [f"window: horizon 8 {outs[8]} != horizon 1 {outs[1]}"]
    return []


def phase_rg_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full-width RecurrentGemma-2B (26 layers: 8 units of rglru, rglru,
    local and 2 remainder rglru; d=2560, 10 query heads and 1 KV head at
    hd 256, GELU d_ff 7680, d_rnn 2560, vocab 256000, window 2048, bf16,
    random weights from seed 0): init -> calibrate (4 x 64 tokens) ->
    export (mix2_ffn4: RG-LRU wx/wy/wo and attention on APSQ gs=2 n_p=4,
    the MLP on gs=4 n_p=8; the gates and the head stay float) -> del the
    float params -> the dense ``ServingEngine`` (8 slots, cache_len 256,
    horizon 8) -> 8 requests (prompts 16-64, 16-32 new tokens; the
    path's zeroed run).  Checks: every deployed GEMM bit for bit against
    its plain version; finite logits; the 3 requests with the shortest
    prompts served alone give the batched tokens; with their prompts cut
    to 8 tokens and 8 new ones, the ``cuda`` engine gives the ``oracle``
    engine's tokens, and sampled at T = 0.8 (the next 2 shortest, cut
    alike) one seed gives the same tokens twice and at horizons 8 and 1,
    and other tokens than greedy decoding of those requests; the path
    launches
    ``apsq_matmul`` and ``apsq_matmul_m1`` and no ``int8_kv_attention``;
    then the window check at one unit (``rg_window_check``)."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import Request, ServingEngine
    cfg = cfg.with_quant(policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(51)
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 64))})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, deploy,
                                                       problems)
    reqs = make_requests(np, rng, 8, cfg.vocab, 16, 64, 16, 32, Request)
    problems += dense_logits_check(torch, deploy, cfg, reqs[0].tokens, dev,
                                   info)
    kw = dict(cache_len=256, decode_horizon=8)
    eng = ServingEngine(deploy, cfg, max_batch=8, **kw)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    batched = dense_engine_run(torch, eng, reqs, dev, profile, info)
    info["serve_s"] = time.perf_counter() - t0
    info["launches"] = dict(_build.launch_counts)
    n_tok = sum(len(o) for o in batched.values())
    info.update(
        requests=len(batched), generated_tokens=n_tok,
        tokens_per_s=n_tok / info["serve_s"], profiled=profile,
        tokens_sha256=hashlib.sha256(json.dumps(
            sorted(batched.items())).encode()).hexdigest(),
        prefill_tokens=eng.prefill_tokens, prefill_s=eng.prefill_seconds,
        decode_s=eng.decode_seconds,
        decode_dispatches=eng.decode_dispatches,
        decode_device_steps=eng.decode_device_steps,
        horizon_hist=eng.horizon_hist,
        peak_mem_gb=max(torch.cuda.max_memory_allocated() / 1e9,
                        info["peak_mem_export_gb"]))
    if len(batched) != 8:
        problems.append(f"{len(batched)} of 8 requests finished")
    problems += missing_launches("rg_serve", info["launches"])
    if info["launches"].get("int8_kv_attention", 0):
        problems.append("int8_kv_attention launched on the dense engine's "
                        "path")
    # the checks take the requests with the shortest prompts: every step
    # of the per-token prefill runs the whole model
    short = sorted(reqs, key=lambda r: len(r.tokens))
    t0 = time.perf_counter()
    single = {r.uid: dense_engine_run(torch, ServingEngine(
        deploy, cfg, max_batch=1, **kw), [r], dev)[r.uid]
        for r in short[:3]}
    info["single_stream_s"] = time.perf_counter() - t0
    div = first_divergence(single, {u: batched[u] for u in single})
    info["batched_equals_single"] = div is None
    if div is not None:
        problems.append(f"batched != single-stream at (request, step) {div}")
    # the engine and sampling checks cut those prompts to 8 tokens and
    # the outputs to 8: the oracle engine takes ~0.9 s a step
    cut = [Request(uid=r.uid, tokens=r.tokens[:8], max_new_tokens=8)
           for r in short[:5]]
    sub = {}
    for backend in ("cuda", "oracle"):
        t0 = time.perf_counter()
        sub[backend] = dense_engine_run(torch, ServingEngine(
            deploy, cfg, max_batch=3, backend=backend, **kw), cut[:3], dev)
        info[f"sub_{backend}_s"] = time.perf_counter() - t0
    div = first_divergence(sub["cuda"], sub["oracle"])
    info["cuda_vs_oracle"] = {"equal": div is None, "tokens": sum(
        len(o) for o in sub["oracle"].values())}
    if div is not None:
        problems.append(f"cuda engine != oracle engine at (request, step) "
                        f"{div}")
    sampled, t0 = {}, time.perf_counter()
    for run, h, greedy in (("a", 8, False), ("b", 8, False),
                           ("h1", 1, False), ("greedy", 8, True)):
        sampled[run] = dense_engine_run(torch, ServingEngine(
            deploy, cfg, max_batch=2, cache_len=256, decode_horizon=h,
            greedy=greedy, temperature=0.8, seed=5), cut[3:5], dev)
    info["sampled"] = {
        "repeats": sampled["a"] == sampled["b"],
        "h8_equals_h1": sampled["a"] == sampled["h1"],
        "differs_from_greedy": sampled["a"] != sampled["greedy"],
        "seconds": time.perf_counter() - t0}
    if not (info["sampled"]["repeats"] and info["sampled"]["h8_equals_h1"]
            and info["sampled"]["differs_from_greedy"]):
        problems.append(f"sampling: {info['sampled']}")
    del deploy, eng
    release(torch)
    problems += rg_window_check(torch, np, cfg, dev, info)
    return info, problems


SEAMLESS_FRAMES = 256        # frame embeddings per request (encoder S)
SEAMLESS_PROMPT = 4          # decoder prompt tokens per request
SEAMLESS_NEW = 32            # tokens each request emits


def encdec_greedy(torch, deploy, cfg, frames, prompts, n_new: int, dev,
                  backend="auto", profile: bool = False,
                  info: dict | None = None):
    """``encode`` the frames [B, S_enc, d], then the greedy loop of
    ``decode_step(enc_out=)`` over a fresh dense state: the prompt
    tokens [B, P] one at a time, then each step's argmax, ``n_new``
    tokens per request (the last prompt step gives the first).  With
    ``profile``, trace 8 decode steps at the loop's middle into
    ``info["profile"]``.  Returns (tokens [B][n_new], enc_out, encode_s,
    decode_s, every step's logits finite)."""
    from repro_torch.models import decode_step, encode, init_decode_state
    B, P = prompts.shape
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = encode(deploy, cfg, frames, backend=backend)
    sync(torch, dev)
    encode_s = time.perf_counter() - t0
    st = init_decode_state(cfg, B, P + n_new, device=dev)
    cur, out = prompts[:, :1], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    window = range(P + 7, P + 15) if profile else ()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(P + n_new - 1):
            if window and t == window[0]:
                from torch.profiler import ProfilerActivity
                sync(torch, dev)
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                tw = time.perf_counter()
            lg, st = decode_step(deploy, cfg, st, cur, t, enc_out=enc,
                                 backend=backend)
            nxt = lg[:, -1].argmax(-1)
            finite &= torch.isfinite(lg).all()
            if t >= P - 1:
                out.append(nxt)
            cur = prompts[:, t + 1:t + 2] if t + 1 < P else nxt[:, None]
            if window and t == window[-1]:
                sync(torch, dev)
                wall = time.perf_counter() - tw
                prof.__exit__(None, None, None)
                info["profile"] = profile_summary(prof, wall)
                info["profile"].update(
                    window_s=wall, window=f"8 decode steps at {B} slots")
    sync(torch, dev)
    decode_s = time.perf_counter() - t0
    return (torch.stack(out, 1).tolist(), enc, encode_s, decode_s,
            bool(finite))


def forward_agreement(torch, deploy, cfg, frames, prompts, toks, dev):
    """Teacher-forced ``forward(enc_embeds=)`` over each request's prompt
    and its decoded tokens: how many of its argmaxes equal the decode
    loop's tokens, and the top-2 margin where they differ (the two paths
    round bf16 attention differently)."""
    from repro_torch.models import forward
    P, agree, differ = prompts.shape[1], 0, []
    for i, out in enumerate(toks):
        seq = torch.cat([prompts[i:i + 1], torch.tensor(
            [out[:-1]], dtype=prompts.dtype, device=dev)], 1)
        with torch.no_grad():
            lg = forward(deploy, cfg, seq,
                         enc_embeds=frames[i:i + 1])[0, P - 1:].float()
        top = torch.topk(lg, 2, dim=-1).values
        ref = lg.argmax(-1).tolist()
        for j, (a, b) in enumerate(zip(out, ref)):
            if a == b:
                agree += 1
            else:
                differ.append({"request": i, "step": j, "decode": a,
                               "forward": b,
                               "margin": float(top[j, 0] - top[j, 1])})
    return {"agree": agree, "of": sum(len(o) for o in toks),
            "differ": differ}


def phase_seamless_serve(torch, np, _build, cfg, dev, profile: bool = False):
    """Full-width SeamlessM4T-v2-large (24 encoder and 24 decoder layers,
    d=1024, 16/16 heads at hd 64, GELU d_ff 8192, LayerNorm, vocab
    256206, bf16, random weights from seed 0; the audio frontend a stub:
    frame embeddings): init -> calibrate (4 x 16 tokens, 4 x 256 frames)
    -> export (``enc_heavy``: the encoder APSQ gs=1 n_p=8, the decoder's
    self- and cross-attention and FFN gs=4 n_p=4; the head float) -> del
    the float params -> 8 requests, each its own 256 frames and a
    4-token prompt: ``encode`` at B = 8, then 32 greedy tokens each
    through ``decode_step(enc_out=)`` (the cross-attention's K/V
    recomputed from ``enc_out`` at every step, as the reference does;
    the path's zeroed run).  Checks: every deployed GEMM bit for bit
    against its plain version at M = 1, 3, 8, 16, and one encoder ``wi``
    and ``wo`` and one ``xattn.wk`` at M = 2048; finite logits; 3
    requests encoded and decoded alone at B = 1 give the batched tokens
    (their own zeroed run, ``seamless_serve/single``); ``encode`` on the
    ``cuda`` backend equals ``oracle`` bit for bit, and on 3 requests
    with 8 new tokens the two backends decode the same tokens; no
    ``int8_kv_attention`` launch.  Reported: teacher-forced
    ``forward(enc_embeds=)``'s agreement with the decoded tokens."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    cfg = cfg.with_quant(policy_presets()["enc_heavy"])
    rng = np.random.default_rng(71)
    info, problems = {"config": cfg.name, "layers": cfg.n_layers,
                      "enc_layers": cfg.n_enc_layers}, []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(4, 16)),
        "enc_embeds": rng.standard_normal(
            (4, SEAMLESS_FRAMES, cfg.d_model), dtype=np.float32)})
    sync(torch, dev)
    info["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, deploy,
                                                       problems)
    enc0, dec0 = deploy["encoder"]["units"]["u0"]["0"], deploy["units"][
        "u0"]["0"]
    deployed_gemm_checks(torch, {
        "encoder.unit.0.ffn.wi": enc0["ffn"]["wi"],
        "encoder.unit.0.ffn.wo": enc0["ffn"]["wo"],
        "unit.0.xattn.wk": dec0["xattn"]["wk"]}, problems,
        ms=(8 * SEAMLESS_FRAMES,))
    frames = torch.from_numpy(rng.standard_normal(
        (8, SEAMLESS_FRAMES, cfg.d_model), dtype=np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(8, SEAMLESS_PROMPT))).to(dev)
    _build.reset_launch_counts()
    toks, enc, info["encode_s"], info["decode_s"], finite = encdec_greedy(
        torch, deploy, cfg, frames, prompts, SEAMLESS_NEW, dev,
        profile=profile, info=info)
    info["launches"] = dict(_build.launch_counts)
    n_tok = sum(len(o) for o in toks)
    info.update(
        requests=len(toks), generated_tokens=n_tok,
        serve_s=info["encode_s"] + info["decode_s"],
        decode_step_ms=info["decode_s"] * 1e3 / (
            SEAMLESS_PROMPT + SEAMLESS_NEW - 1),
        logits_finite=finite, profiled=profile,
        tokens_sha256=hashlib.sha256(json.dumps(
            sorted(enumerate(toks))).encode()).hexdigest(),
        peak_mem_gb=max(torch.cuda.max_memory_allocated() / 1e9,
                        info["peak_mem_export_gb"]))
    info["tokens_per_s"] = n_tok / info["serve_s"]
    if not finite:
        problems.append("non-finite decode logits")
    problems += missing_launches("seamless_serve", info["launches"])
    if info["launches"].get("int8_kv_attention", 0):
        problems.append("int8_kv_attention launched on the enc-dec path")
    # batched == single-stream: 3 requests, each encoded and decoded alone
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    single = [encdec_greedy(torch, deploy, cfg, frames[i:i + 1],
                            prompts[i:i + 1], SEAMLESS_NEW, dev)[0][0]
              for i in range(3)]
    info["single_stream_s"] = time.perf_counter() - t0
    info["paths"] = {"seamless_serve/single": dict(_build.launch_counts)}
    problems += missing_launches("seamless_serve/single",
                                 info["paths"]["seamless_serve/single"])
    div = first_divergence(dict(enumerate(single)),
                           {i: toks[i] for i in range(3)})
    info["batched_equals_single"] = div is None
    if div is not None:
        problems.append(f"batched != single-stream at (request, step) {div}")
    # cuda == oracle: the encoder at B = 8, and 3 requests x 8 tokens
    t0 = time.perf_counter()
    with torch.no_grad():
        from repro_torch.models import encode
        enc_oracle = encode(deploy, cfg, frames, backend="oracle")
    sub = {b: encdec_greedy(torch, deploy, cfg, frames[:3], prompts[:3], 8,
                            dev, backend=b)[0] for b in ("cuda", "oracle")}
    info["cuda_vs_oracle"] = {
        "encode_equal": bool(torch.equal(enc, enc_oracle)),
        "tokens_equal": sub["cuda"] == sub["oracle"],
        "tokens": sum(len(o) for o in sub["oracle"]),
        "seconds": time.perf_counter() - t0}
    if not info["cuda_vs_oracle"]["encode_equal"]:
        problems.append("encode on cuda != oracle")
    if not info["cuda_vs_oracle"]["tokens_equal"]:
        problems.append(f"decode cuda {sub['cuda']} != oracle "
                        f"{sub['oracle']}")
    del enc, enc_oracle
    t0 = time.perf_counter()
    agreement = forward_agreement(torch, deploy, cfg, frames, prompts, toks,
                                  dev)
    info.update(forward_agreement=agreement,
                forward_agrees=f"{agreement['agree']} of {agreement['of']}",
                forward_s=time.perf_counter() - t0)
    return info, problems


VLM_LAYERS = 2


def phase_vlm_2l(torch, np, _build, cfg, dev):
    """InternVL2-26B's LM at full width (d=6144, 48/8 heads at hd 128,
    SwiGLU d_ff 16384, vocab 92553, 256 image tokens; the InternViT a
    stub: patch embeddings through the float ``frontend_proj``) cut to 2
    of 48 layers, mix2_ffn4: init -> calibrate (2 x 32 tokens behind 2 x
    256 patch embeddings) -> export -> every deployed GEMM bit for bit
    against its plain version -> ``forward(embeds=)`` on 2 x (256 + 16)
    positions: ``cuda`` equals ``oracle`` bit for bit, finite, and the
    image prefix changes the text logits -> the paged engine serves 4
    text requests on 4 slots (the path's zeroed run), each request's
    tokens equal to it served alone."""
    from repro_torch.models import forward, init_lm
    from repro_torch.quant import calibrate_model, export_quantized, \
        policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    cfg = cfg.scaled(n_layers=VLM_LAYERS).with_quant(
        policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(81)
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync(torch, dev)
    info["init_s"] = time.perf_counter() - t0
    info["params_gb"] = sum(t.numel() * t.element_size() for t in
                            iter_tensors(params)) / 1e9
    n_img = cfg.n_frontend_tokens
    t0 = time.perf_counter()
    params = calibrate_model(params, cfg, {
        "tokens": rng.integers(0, cfg.vocab, size=(2, 32)),
        "embeds": rng.standard_normal((2, n_img, cfg.d_model),
                                      dtype=np.float32)})
    deploy, report = export_quantized(params)
    sync(torch, dev)
    info["calibrate_export_s"] = time.perf_counter() - t0
    info["peak_mem_export_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    release(torch)
    info["int8_gb"] = sum(r["int8_bytes"] * r["count"]
                          for r in report.values()) / 1e9
    info["deployed_gemms_held"] = deployed_gemm_checks(torch, deploy,
                                                       problems)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 16))).to(dev)
    emb = torch.from_numpy(rng.standard_normal(
        (2, n_img, cfg.d_model), dtype=np.float32)).to(dev)
    with torch.no_grad():
        lg = {b: forward(deploy, cfg, tok, embeds=emb, backend=b)
              for b in ("cuda", "oracle")}
        text = forward(deploy, cfg, tok)
    info["forward"] = {
        "shape": list(lg["cuda"].shape),
        "cuda_equals_oracle": bool(torch.equal(lg["cuda"], lg["oracle"])),
        "finite": bool(torch.isfinite(lg["cuda"]).all()),
        "prefix_moves_text_logits": float(
            (lg["cuda"][:, n_img:].float() - text.float()).abs().max())}
    if not (info["forward"]["cuda_equals_oracle"]
            and info["forward"]["finite"]
            and info["forward"]["prefix_moves_text_logits"] > 0
            and info["forward"]["shape"] == [2, n_img + 16, cfg.vocab]):
        problems.append(f"forward(embeds=): {info['forward']}")
    del lg, text
    reqs = make_requests(np, rng, 4, cfg.vocab, 3, 40, 8, 16, Request)
    kw = dict(page_size=16, prefill_chunk=16, decode_horizon=4,
              max_pages_per_slot=4)
    single, _ = single_stream_check(torch, deploy, cfg, reqs, kw, dev,
                                    probe_eos=False)
    done = serve_all(torch, _build, dev, PagedServingEngine(
        deploy, cfg, max_batch=4, n_pages=4 * 4 + 1, **kw), reqs, False,
        info)
    info["peak_mem_gb"] = max(info["peak_mem_gb"] or 0.0,
                              info["peak_mem_export_gb"])
    div = first_divergence(single, {r.uid: r.out for r in done})
    info["batched_equals_single"] = div is None
    if len(done) != 4:
        problems.append(f"{len(done)} of 4 requests finished")
    if div is not None:
        problems.append(f"batched != single-stream at (request, step) {div}")
    problems += logits_check(torch, deploy, cfg, reqs[0].tokens, dev, info)
    problems += missing_launches("vlm_2l", info["launches"])
    return info, problems


SEARCH_OUT = os.path.join(ROOT, "chiprun_out", "search")


def report_candidate(point: dict):
    """The search candidate behind one point of the CLI's JSON report: a
    preset by its label, a generated candidate from its per-class
    choice labels (``w8a8``, ``apsq(gs=G,np=N)``, ``psq(np=N)``)."""
    import re
    from repro_torch.search import Candidate, FixedCandidate, policy_sweep
    if point["origin"] == "preset":
        return FixedCandidate(name=point["name"], fixed_policy=dict(
            policy_sweep("all"))[point["name"]])

    def choice(label):
        nums = tuple(int(v) for v in re.findall(r"=(\d+)", label))
        return {"w8a8": ("w8a8",), "apsq": ("apsq",) + nums,
                "psq": ("psq", 0) + nums}[label.split("(")[0]]

    return Candidate(name=point["name"], origin=point["origin"],
                     assignment=tuple((pat, choice(lbl)) for pat, lbl
                                      in point["assignment"].items()))


def phase_search(torch, np, _build, cfg, dev):
    """The search's CLI on the card, then full-width TinyLlama-1.1B under
    uniform W8A8 and the front's best PSUM-quantized member: energy,
    accuracy proxy, round trip and backend parity; one zeroed run."""
    import contextlib
    import io
    from repro_torch.core import QuantConfig
    from repro_torch.quant import QuantPolicy
    from repro_torch.search import (accuracy_proxy, backend_parity_report,
                                    energy_report, layer_classes,
                                    make_eval_batch, model_inventory,
                                    oracle_logits, roundtrip_report)
    from repro_torch.search.cli import main as search_cli
    from repro_torch.search.driver import has_psum
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    torch.cuda.empty_cache()
    os.makedirs(SEARCH_OUT, exist_ok=True)
    _build.reset_launch_counts()        # the path's zeroed run
    t_all = t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = search_cli(["--arch", "tinyllama-1.1b", "--budget-smoke",
                         "--include-presets", "--out", SEARCH_OUT])
    info["cli_s"] = time.perf_counter() - t0
    with open(os.path.join(SEARCH_OUT, "cli.log"), "w") as f:
        f.write(log.getvalue())
    with open(os.path.join(SEARCH_OUT, "tinyllama-1.1b__pareto.json")) as f:
        rep = json.load(f)
    info["cli_rc"] = rc
    info["n_evaluated"] = rep["n_evaluated"]
    info["front"] = [{k: p[k] for k in ("name", "origin", "heterogeneous",
                                        "energy_j", "energy_saving", "error",
                                        "top1_agreement", "kl")}
                     for p in rep["front"]]
    info["n_heterogeneous_on_front"] = rep["n_heterogeneous_on_front"]
    info["baselines_energy_dominated"] = rep["baselines_energy_dominated"]
    info["roundtrip"] = rep["roundtrip"]
    info["roundtrip_psum"] = rep["roundtrip_psum"]
    if rc != 0:
        problems.append(f"search CLI exit code {rc}: front "
                        f"{info['n_heterogeneous_on_front']} heterogeneous, "
                        f"baselines beaten {rep['baselines_energy_dominated']}"
                        f", roundtrip {rep['roundtrip'].get('ok')}, psum "
                        f"{rep['roundtrip_psum'].get('ok')}")
    classes = layer_classes(model_inventory(cfg, 4096))
    psum_front = [p for p in rep["front"]
                  if has_psum(report_candidate(p), classes)]
    if not psum_front:
        problems.append("no PSUM-quantized policy on the front")
        return info, problems
    best_psum = min(psum_front, key=lambda p: p["error"])
    policies = {"w8a8": QuantPolicy.uniform(QuantConfig.w8a8()),
                "psum": report_candidate(best_psum).policy()}
    info["psum_policy"] = best_psum["name"]
    t0 = time.perf_counter()
    batch = make_eval_batch(cfg, 2, 32, device=dev)
    ref = oracle_logits(cfg, batch, device=dev)
    info["full_width"] = {}
    for label, policy in policies.items():
        r = {"energy": energy_report(cfg, policy)}
        r["accuracy"] = accuracy_proxy(cfg, policy, batch, ref, device=dev)
        rt = roundtrip_report(cfg, policy, batch, device=dev)
        r["roundtrip"] = rt
        r["backend_parity"] = backend_parity_report(cfg.with_quant(policy),
                                                    device=dev)
        info["full_width"][label] = r
        gp = rt.get("gemm_parity", {})
        if not (gp.get("bit_equal") is True
                and rt["decode"]["oracle"] == rt["decode"]["cuda"]
                and rt["ok"] is True):
            problems.append(f"full-width {label} round trip: {rt}")
        if r["backend_parity"].get("bit_equal") is not True:
            problems.append(f"full-width {label} backend parity: "
                            f"{r['backend_parity']}")
        if label == "psum" and not gp.get("psum"):
            problems.append("the PSUM policy's GEMM parity ran no PSUM layer")
        if not all(math.isfinite(v) for v in r["accuracy"].values()):
            problems.append(f"full-width {label} accuracy: {r['accuracy']}")
    sync(torch, dev)
    info["launches"] = dict(_build.launch_counts)
    info["full_width_s"] = time.perf_counter() - t0
    info["seconds"] = time.perf_counter() - t_all
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    problems += missing_launches("search", info["launches"])
    return info, problems


DRYRUN_STEP = (1, 2048)      # the real prefill step: batch, sequence


def phase_dryrun(torch, np, _build, cfg, dev):
    """The one-device dry run (``repro_torch.launch.dryrun``) of
    full-width TinyLlama-1.1B: every cell counted on meta tensors; a real
    prefill step at B=1, S=2048 on the card held to the count at its
    shape (FLOPs exactly; peak memory and time reported); the
    ``--backend-parity`` probe on kernels 1 (apsq) and 2 (w8a8) with the
    roofline corrected from ``cuda_us``; the search's encoder-decoder
    round trip on seamless-smoke.  One zeroed run."""
    from repro_torch.configs import cells_for, get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    from repro_torch.quant import policy_presets
    from repro_torch.search import make_eval_batch, roundtrip_report
    arch = "tinyllama-1.1b"
    info, problems = {"config": cfg.name, "layers": cfg.n_layers}, []
    keys = ("flops", "bytes", "dominant", "bound_s", "peak_bytes", "fits",
            "count_s", "depth")
    torch.cuda.empty_cache()
    _build.reset_launch_counts()        # the path's zeroed run
    t_all = time.perf_counter()
    info["cells"] = {}
    for name in cells_for(arch):
        r = dryrun.run_cell(arch, name, device=dev, verbose=False)
        if not r["ok"]:
            problems.append(f"dry run {name}: {r.get('error')}")
            continue
        info["cells"][name] = {k: r[k] for k in keys}
        print(json.dumps({"dryrun_cell": name, **info["cells"][name]}),
              flush=True)

    # a real step at a shape that fits, against its count
    B, S = DRYRUN_STEP
    shape = ShapeCell("prefill_2k", S, B, "prefill")
    r = dryrun.run_cell(arch, "prefill_32k", shape=shape, device=dev,
                        verbose=False)
    if not r["ok"]:
        problems.append(f"dry run at B={B} S={S}: {r.get('error')}")
        return info, problems
    sync(torch, dev)
    before = torch.cuda.memory_allocated()    # what earlier phases left
    step = dryrun.build_cell(cfg, shape, device=dev)
    fn = step.parts[0][1]
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync(torch, dev)
    peak = torch.cuda.max_memory_allocated() - before
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[2]
    counted = dryrun.count_step(step)
    del step, fn
    real = {"shape": [B, S], "flops": counted["flops"],
            "bytes": counted["bytes"], "predicted_flops": r["flops"],
            "flops_equal": counted["flops"] == r["flops"],
            "allocated_before": before,
            "max_memory_allocated": peak + before,
            "predicted_peak_bytes": r["peak_bytes"],
            "memory_ratio": peak / r["peak_bytes"],    # the step's own
            "step_s": step_s, "bound_s": r["bound_s"],
            "dominant": r["dominant"],
            "share_of_roofline": r["bound_s"] / step_s,
            "depth": r["depth"]}
    info["real_step"] = real
    print(json.dumps({"dryrun_real_step": real}), flush=True)
    if not real["flops_equal"]:
        problems.append(f"real step FLOPs {counted['flops']} != counted "
                        f"{r['flops']}")
    if not 0.75 <= real["memory_ratio"] <= 1.33:
        info["memory_finding"] = ("max_memory_allocated / predicted peak "
                                  "outside 0.75-1.33: see PERF.md")

    # kernel 1 (apsq) and kernel 2 (w8a8) under --backend-parity
    info["backend_parity"] = {}
    for quant in ("apsq", "w8a8"):
        r = dryrun.run_cell(arch, "decode_32k", quant=quant,
                            backend_parity=True, device=dev, verbose=False)
        bp, br = r.get("backend_parity", {}), r.get("backend_roofline", {})
        info["backend_parity"][quant] = {
            "ok": r["ok"], "parity": bp, "backend_roofline": br}
        if not (r["ok"] and bp.get("bit_equal") is True
                and br.get("probe_backend") == "cuda"
                and br.get("probe_measured_us") == round(bp["cuda_us"], 1)):
            problems.append(f"--backend-parity {quant}: {r.get('error')} "
                            f"{bp} {br}")

    # the search's round trip of an encoder-decoder
    scfg = get_smoke("seamless-m4t-large-v2")
    batch = make_eval_batch(scfg, 2, 32, device=dev)
    rt = roundtrip_report(scfg, policy_presets()["enc_heavy"], batch,
                          device=dev)
    info["encdec_roundtrip"] = rt
    if not (rt["ok"] is True and rt["decode"]["oracle"] == rt["decode"][
            "cuda"]):
        problems.append(f"seamless-smoke round trip: {rt}")
    sync(torch, dev)
    info["launches"] = dict(_build.launch_counts)
    info["seconds"] = time.perf_counter() - t_all
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    problems += missing_launches("dryrun", info["launches"])
    return info, problems


# ---------------------------------------------------------------------------
# Phase: tensor- and expert-parallel serving, ranks sharing the card
# ---------------------------------------------------------------------------

TP_EXPORTS = os.path.join(ROOT, "_tp_export")   # git-ignored, removed after
KEEP_EXPORTS: set = set()   # exports serve/moe_serve save for tp_serve
TP_WORLD = 4
TP_CUT = 2                  # layers of the D=4, PSQ and W8A8 runs


def keep_export(name: str, cfg, deploy):
    """Save an export for the tp_serve phase (when it will run), so its
    ranks restore it from disk as a deployment would; the seconds it
    took, or None."""
    if name not in KEEP_EXPORTS:
        return None
    from repro_torch.checkpoint import save
    t0 = time.perf_counter()
    save(os.path.join(TP_EXPORTS, name), 0, deploy, extra={"arch": cfg.name})
    return time.perf_counter() - t0


def cut_units(tree: dict, n: int) -> dict:
    """The tree of the first ``n`` layers (one layer a unit)."""
    return {**tree, "units": {f"u{i}": tree["units"][f"u{i}"]
                              for i in range(n)}}


def tp_rank(rank: int, world: int, init: str, job_path: str,
            out_dir: str) -> None:
    """One rank of the tp_serve phase, a spawned process on the one card:
    every run of the job on its mesh, each export restored from disk on
    the CPU and cut to this rank's slices (``shard_deployed``)."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore
    from repro_torch.dist import tp
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import decode_step_paged
    from repro_torch.serving import PagedServingEngine, Request

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    job = torch.load(job_path, weights_only=False)
    meshes = {2: make_smoke_mesh((world // 2, 2), device=job["device"]),
              world: make_smoke_mesh((1, world), device=job["device"])}
    out = {"mesh": {d: {"transport": m.backend, "shared_device":
                        m.shared_device, "shape": m.shape,
                        "device": str(m.device)} for d, m in meshes.items()}}
    restored = {}
    for run in job["runs"]:
        mesh = meshes[run["d"]]
        wires = [w for w, replica in run["wires"]
                 if replica is None or replica == mesh.coords["data"]]
        if not wires:
            continue
        if run["export"] not in restored:
            restored[run["export"]] = restore(run["export"], device="cpu")[0]
        deploy = restored[run["export"]]
        if run["layers"]:
            deploy = cut_units(deploy, run["layers"])
        cfg = run["cfg"]
        backend = tp_backend(run, mesh.device)
        for wire in wires:
            eng = PagedServingEngine(deploy, cfg, backend=backend, mesh=mesh,
                                     wire=wire, **run["kw"])
            sync(torch, mesh.device)
            _build.reset_launch_counts()
            mesh.wire_bytes.clear()
            t0 = time.perf_counter()
            done = eng.run([Request(uid=u, tokens=t, max_new_tokens=n)
                            for u, t, n in run["reqs"]])
            sync(torch, mesh.device)
            rec = {"serve_s": time.perf_counter() - t0,
                   "tokens": {r.uid: r.out for r in done},
                   "launches": dict(_build.launch_counts),
                   "wire_bytes": dict(mesh.wire_bytes)}
            state = tp.gather_paged_state(eng.state, cfg, mesh)
            if mesh.coords["model"] == 0:
                rec["state"] = tree_cpu(state)
            # one decode step at the engine's B rows moves what
            # wire_report prices at m = B (the dense runs)
            b = run["kw"]["max_batch"]
            mesh.wire_bytes.clear()
            with torch.no_grad():
                decode_step_paged(
                    eng.params, cfg, eng.state,
                    torch.zeros((b, 1), dtype=torch.int32, device=mesh.device),
                    torch.zeros(b, dtype=torch.int32, device=mesh.device),
                    torch.ones((b, 1), dtype=torch.int32, device=mesh.device),
                    backend=eng.backend)
            rec["step_wire_bytes"] = sum(mesh.wire_bytes.values())
            rec["wire_report"] = {
                f"m{m}": tp.wire_report(eng.shard_plan, m=m)["total"]
                for m in (1, b)}
            rec["axes"] = sorted({f"{p.kind}:{p.axis}:{p.mode}"
                                  for p in eng.shard_plan.values()})
            out[(run["name"], wire)] = rec
            del eng, state
    if mesh.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def tp_backend(run: dict, dev):
    """A run's inner backend: the CUDA GEMMs with the plain attention
    (OLMoE, as moe_serve holds it), else ``auto`` (on the CPU, where this
    phase is rehearsed, ``auto`` is the plain versions)."""
    if run["plain_attention"] and dev.type == "cuda":
        return gemm_kernels_plain_attention()
    return "auto"


def tree_cpu(tree):
    from repro_torch.models.model import tree_map
    return tree_map(lambda _, a: a.cpu(), tree)


def tp_export(torch, np, name: str, cfg, dev, calib_rows: int = 4):
    """Path of ``name``'s export on disk: the one serve/moe_serve kept,
    else made here (init from seed 0, calibrate, export, save)."""
    from repro_torch.models import init_lm
    from repro_torch.quant import calibrate_model, export_quantized
    path = os.path.join(TP_EXPORTS, name)
    if not os.path.isdir(path):
        params = init_lm(cfg, seed=0, device=dev)
        params = calibrate_model(params, cfg, {
            "tokens": np.random.default_rng(31).integers(
                0, cfg.vocab, size=(calib_rows, 64))})
        deploy, _ = export_quantized(params)
        del params
        KEEP_EXPORTS.add(name)
        keep_export(name, cfg, deploy)
        del deploy
    return path


def phase_tp_serve(torch, np, _build, configs, dev):
    """Tensor- and expert-parallel serving over ``torch.distributed``:
    ranks spawned on the one card (gloo: NCCL refuses two ranks on one
    GPU), each restoring the whole export from disk and keeping its
    slices, held to one rank's engine on the same export: equal greedy
    tokens, and the ranks' pools and exponents gathered over heads
    equal to one rank's, array for array."""
    import shutil

    import torch.multiprocessing as mp
    from repro_torch.checkpoint import restore
    from repro_torch.core import QuantConfig
    from repro_torch.quant import policy_presets
    from repro_torch.serving import PagedServingEngine, Request
    tiny, olmoe = configs
    mix = policy_presets()["mix2_ffn4"]
    rng = np.random.default_rng(41)
    t_phase = time.perf_counter()
    dense = tiny.with_quant(mix)
    cut = tiny.scaled(n_layers=TP_CUT)
    moe = olmoe.with_quant(mix)
    exports = {"serve": tp_export(torch, np, "serve", dense, dev),
               "moe_serve": tp_export(torch, np, "moe_serve", moe, dev)}
    for name, quant in (("psq", QuantConfig.apsq(gs=8, n_p=8)),
                        ("w8a8", QuantConfig.w8a8())):
        exports[name] = tp_export(torch, np, f"tp_{name}",
                                  cut.with_quant(quant), dev, calib_rows=2)
    t_exports = time.perf_counter() - t_phase

    def reqs(n, lo_p, hi_p, new):
        return [(r.uid, r.tokens, r.max_new_tokens) for r in make_requests(
            np, rng, n, tiny.vocab, lo_p, hi_p, new, new, Request)]

    dense_kw = dict(max_batch=8, page_size=16, prefill_chunk=16,
                    decode_horizon=8, max_pages_per_slot=5, n_pages=41)
    dense_reqs = reqs(8, 5, 60, 16)
    cut_reqs = reqs(4, 5, 40, 8)
    cut_kw = dict(dense_kw, max_batch=4, n_pages=21)
    # wires: (wire, data replica of the (2, 2) mesh that serves it, or
    # None: every rank, D=4); the two replicas serve at the same time
    runs = [
        dict(name="tinyllama_2l_d4", d=TP_WORLD, export=exports["serve"],
             layers=TP_CUT, cfg=dense.scaled(n_layers=TP_CUT),
             wires=(("int8", None),), kw=cut_kw, reqs=cut_reqs,
             plain_attention=False),
        dict(name="tinyllama_22l_d2", d=2, export=exports["serve"],
             layers=0, cfg=dense, wires=(("int8", 0), ("fp32", 1)),
             kw=dense_kw, reqs=dense_reqs, plain_attention=False),
        dict(name="psq_2l_d2", d=2, export=exports["psq"], layers=0,
             cfg=cut.with_quant(QuantConfig.apsq(gs=8, n_p=8)),
             wires=(("int8", 0), ("fp32", 1)), kw=cut_kw, reqs=cut_reqs,
             plain_attention=False),
        dict(name="w8a8_2l_d2", d=2, export=exports["w8a8"], layers=0,
             cfg=cut.with_quant(QuantConfig.w8a8()), wires=(("int8", 1),),
             kw=cut_kw, reqs=cut_reqs, plain_attention=False),
        dict(name="olmoe_16l_d2", d=2, export=exports["moe_serve"],
             layers=0, cfg=moe, wires=(("int8", 0),),
             kw=dict(dense_kw, max_batch=4, n_pages=21),
             reqs=[(u, t % olmoe.vocab, n) for u, t, n in cut_reqs],
             plain_attention=True),
    ]
    tmp = os.path.join(TP_EXPORTS, "world")
    os.makedirs(tmp, exist_ok=True)
    job_path = os.path.join(tmp, "job.pt")
    torch.save({"runs": runs,
                "device": None if dev.type == "cuda" else str(dev)}, job_path)
    info = {"world": TP_WORLD, "exports_s": t_exports,
            "cut": f"D=4, PSQ and W8A8 runs: {TP_CUT} of 22 layers "
                   "(phase time)"}
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        tp_rank, args=(TP_WORLD, "file://" + os.path.join(tmp, "rdv"),
                       job_path, tmp), nprocs=TP_WORLD, join=False,
        start_method="spawn")
    # one rank's engines on the same exports, while the ranks serve
    one = {}
    try:
        for run in runs:
            deploy = restore(run["export"], device=dev)[0]
            if run["layers"]:
                deploy = cut_units(deploy, run["layers"])
            eng = PagedServingEngine(deploy, run["cfg"],
                                     backend=tp_backend(run, dev), **run["kw"])
            done = eng.run([Request(uid=u, tokens=t, max_new_tokens=n)
                            for u, t, n in run["reqs"]])
            one[run["name"]] = ({r.uid: r.out for r in done},
                                tree_cpu(eng.state))
            del eng, deploy
    finally:
        while not ctx.join():
            pass
    info["world_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(TP_WORLD)]
    shutil.rmtree(TP_EXPORTS)
    KEEP_EXPORTS.clear()

    from repro_torch.models.model import tree_leaves
    problems = []
    m = ranks[0]["mesh"]
    info["transport"] = m[2]["transport"]
    info["ranks_share_one_card"] = m[2]["shared_device"]
    if m[2]["transport"] != "gloo" or (dev.type == "cuda"
                                       and not m[2]["shared_device"]):
        problems.append(f"mesh: {m}")
    info["peak_mem_gb_by_rank"] = [r.get("peak_mem_gb") for r in ranks]
    launches = {k: 0 for k in SOURCES}
    info["runs"], info["wire"] = {}, {}
    for run in runs:
        want_tokens, want_state = one[run["name"]]
        for wire, _ in run["wires"]:
            key = (run["name"], wire)
            recs = [r[key] for r in ranks if key in r]
            rec = {"ranks": len(recs), "serve_s": [r["serve_s"] for r in recs],
                   "tokens_equal": all(r["tokens"] == want_tokens
                                       for r in recs),
                   "wire_bytes": recs[0]["wire_bytes"],
                   "step_wire_bytes": recs[0]["step_wire_bytes"],
                   "wire_report": recs[0]["wire_report"],
                   "axes": recs[0]["axes"],
                   "launches_by_rank": [r["launches"] for r in recs]}
            got = dict(tree_leaves(next(r["state"] for r in recs
                                        if "state" in r)))
            want = dict(tree_leaves(want_state))
            rec["state_equal"] = (got.keys() == want.keys() and all(
                torch.equal(got[k], want[k]) for k in want))
            if len(recs) != run["d"] or not rec["tokens_equal"] \
                    or not rec["state_equal"]:
                problems.append(f"{key}: {len(recs)} ranks, tokens equal "
                                f"{rec['tokens_equal']}, state equal "
                                f"{rec['state_equal']}")
            b = run["kw"]["max_batch"]
            if run["name"] != "olmoe_16l_d2" and (
                    rec["step_wire_bytes"]
                    != rec["wire_report"][f"m{b}"][wire]):
                problems.append(f"{key}: a decode step moved "
                                f"{rec['step_wire_bytes']} bytes, "
                                f"wire_report prices {rec['wire_report']}")
            for r in recs:
                for k, c in r["launches"].items():
                    launches[k] += c
            info["runs"][f"{run['name']}/{wire}"] = rec
            info["wire"][f"{run['name']}/{wire}"] = {
                "decode_step_measured": rec["step_wire_bytes"],
                **rec["wire_report"]}
    info["launches"] = launches
    info["host_copied_bytes"] = 0   # gloo takes the CUDA tensors as they are
    info["seconds"] = time.perf_counter() - t_phase
    problems += missing_launches("tp_serve", launches)
    return info, problems


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="trace one heartbeat of the serve, moe_serve, "
                         "sc2_serve, rwkv_serve and rg_serve phases' "
                         "batched engines, 8 decode steps of "
                         "seamless_serve's batched loop, "
                         "and one train "
                         "step of the train and moe_train phases, with "
                         "torch.profiler")
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
    from repro_torch.configs import (chatglm3_6b, deepseek_7b, internvl2_26b,
                                     olmoe_1b_7b, qwen3_moe_235b_a22b,
                                     recurrentgemma_2b, rwkv6_3b,
                                     seamless_m4t_large_v2, starcoder2_15b,
                                     tinyllama_1_1b)
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
    if "tp_serve" in phases:
        KEEP_EXPORTS.update(("serve", "moe_serve"))
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
        elif phase == "load":
            info, problems = phase_load(torch, np, _build, cuda)
        elif phase == "sc2_serve":
            info, problems = phase_sc2_serve(torch, np, _build,
                                             starcoder2_15b.CONFIG, cuda,
                                             profile=args.profile)
        elif phase == "dense_2l":
            info, problems = phase_dense_2l(
                torch, np, _build, (chatglm3_6b.CONFIG, deepseek_7b.CONFIG),
                cuda)
        elif phase == "train":
            info, problems = phase_train(torch, np, _build,
                                         tinyllama_1_1b.CONFIG, cuda,
                                         profile=args.profile)
        elif phase == "moe_train":
            # 4 of 16 layers: bf16 weights, float32 accumulators and the
            # old and new AdamW moments peak at 52 GB there; 8 would not
            # fit one card
            info, problems = phase_train(
                torch, np, _build,
                olmoe_1b_7b.CONFIG.scaled(n_layers=MOE_TRAIN_LAYERS), cuda,
                profile=args.profile, path="moe_train")
            info["cut"] = (f"{MOE_TRAIN_LAYERS} of 16 layers (device "
                           "memory)")
        elif phase == "qwen3_2l":
            info, problems = phase_qwen3_2l(torch, np, _build,
                                            qwen3_moe_235b_a22b.CONFIG, cuda)
        elif phase == "rwkv_serve":
            info, problems = phase_rwkv_serve(torch, np, _build,
                                              rwkv6_3b.CONFIG, cuda,
                                              profile=args.profile)
        elif phase == "rg_serve":
            info, problems = phase_rg_serve(torch, np, _build,
                                            recurrentgemma_2b.CONFIG, cuda,
                                            profile=args.profile)
        elif phase == "seamless_serve":
            info, problems = phase_seamless_serve(
                torch, np, _build, seamless_m4t_large_v2.CONFIG, cuda,
                profile=args.profile)
        elif phase == "vlm_2l":
            info, problems = phase_vlm_2l(torch, np, _build,
                                          internvl2_26b.CONFIG, cuda)
            info["cut"] = f"{VLM_LAYERS} of 48 layers (phase time)"
        elif phase == "search":
            info, problems = phase_search(torch, np, _build,
                                          tinyllama_1_1b.CONFIG, cuda)
        elif phase == "dryrun":
            info, problems = phase_dryrun(torch, np, _build,
                                          tinyllama_1_1b.CONFIG, cuda)
        elif phase == "tp_serve":
            info, problems = phase_tp_serve(
                torch, np, _build,
                (tinyllama_1_1b.CONFIG, olmoe_1b_7b.CONFIG), cuda)
        if "launches" in info:
            launches[phase] = info["launches"]
        launches.update(info.pop("paths", {}))
        release(torch)
        dt = time.perf_counter() - t0
        detail[phase] = info
        short = {k: v for k, v in info.items()
                 if k not in ("gemm", "expert_gemm", "attention", "ptxas",
                              "profile", "grad_norms", "forward_agreement",
                              "runs")}
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
                   if k.startswith("at_") or k in (
                       "library", "plan", "stages_ms", "m1_body_ms",
                       "plans_ms", "live_experts", "bound_over")}})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
