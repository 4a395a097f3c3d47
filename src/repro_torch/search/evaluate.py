"""Policy evaluation: energy (analytical) x accuracy (fake-quant proxy)
(port of ``repro/search/evaluate.py``).

Shared by ``repro_torch.search.driver`` (the co-exploration loop) and
``repro_torch.search.cli`` — one implementation of "what does this
policy cost and how wrong is it" for every surface.

Two axes, both cheap enough to run per candidate:

  * ``energy_report``  — the paper's analytical accelerator model (eqs
    1-6) over the architecture's *full-size* GEMM inventory, with each
    layer's (gs, psum_bits, n_p) resolved from the policy
    (``inventory.energy_specs``) — heterogeneous per-layer energy, scored
    against the INT32-PSUM baseline.  Pure Python: the same numbers as
    the JAX package's, to the last bit.
  * ``accuracy_proxy`` — fake-quant forward error vs the float oracle on
    a calibration batch, at the arch's *smoke-scale* sibling (same
    family, small).  Calibration is the capture-based ``calibrate_model``
    (the same taps QAT uses), so PSUM scales are data-driven, not
    generic — exactly the error the deployed integer path inherits.

``roundtrip_report`` proves a searched policy is *servable*: calibrate ->
``export_quantized`` -> execute through the CUDA kernels vs the torch
oracle (GEMM-level bit parity on an exported layer + greedy decode parity
through the dense ``ServingEngine``, or for an encoder-decoder through
``encode`` + ``decode_step(enc_out=)``).  On the CPU only the ``oracle``
leg can run: the report names the backends that ran and claims no
parity it did not run (``bit_equal``, ``serving_parity`` and ``ok`` are
None there).

Every entry point that makes tensors takes ``device=`` (``None``: the
card, ``resolve_device``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.energy import AcceleratorConfig, model_energy
from repro_torch.models.config import ModelConfig

from .inventory import energy_specs, model_inventory


def _parity_backends(device) -> tuple:
    """The backends a parity check runs on ``device``: the torch oracle
    and, on the card, the CUDA kernels (the CPU has none)."""
    return ("oracle", "cuda") if device.type == "cuda" else ("oracle",)


def _cpu_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


# ---------------------------------------------------------------------------
# Policy description + backend parity
# ---------------------------------------------------------------------------

def describe_policy(quant) -> list:
    """Human-readable rule list for a QuantPolicy (JSON-report friendly)."""
    def one(cfg):
        if cfg is None:
            return "float"
        if not cfg.enabled:
            return "disabled"
        if cfg.psum.mode == "none":
            return f"w{cfg.w_bits}a{cfg.a_bits}"
        return (f"{cfg.psum.mode}(gs={cfg.psum.gs},n_p={cfg.psum.n_p},"
                f"bits={cfg.psum.bits})")

    rules = [[r.pattern, one(r.config)]
             for r in getattr(quant, "rules", ())]
    rules.append(["<default>", one(getattr(quant, "default", quant))])
    return rules


def policy_sweep(arg: str) -> list:
    """Resolve a ``--quant-policy`` argument to ``[(label, policy)]``:
    ``arg`` is a preset name from ``repro_torch.quant.policy_presets`` or
    ``'all'`` for the whole registry."""
    from repro_torch.quant import policy_presets

    presets = policy_presets()
    names = sorted(presets) if arg == "all" else [arg]
    try:
        return [(f"policy_{n}", presets[n]) for n in names]
    except KeyError:
        raise KeyError(f"unknown --quant-policy {arg!r}; "
                       f"known: {sorted(presets)} or 'all'") from None


def _parity_fields(times: dict, bit_equal) -> dict:
    return {"backends": list(times), "bit_equal": bit_equal,
            **{f"{name}_us": round(t, 1) for name, t in times.items()}}


def backend_parity_report(cfg: ModelConfig, m: int = 8, *,
                          device=None) -> dict:
    """Oracle-vs-cuda execution check at the arch's GEMM shape.

    Exports one calibrated [k, k] linear (k = min(d_model, 512)) under
    the cfg's policy and runs it through
    ``repro_torch.exec.backend_parity_check`` at M = ``m``: parity, and
    each backend's time side by side: ``<backend>_us`` is the integer
    GEMM alone (the kernel's device time on the card,
    ``_int_gemm_us``), ``<backend>_gemm_us`` the whole deployed GEMM,
    eager, on the host's clock (quantize, launch, rescale, dispatch).  The policy is probed at representative
    layer names, preferring a PSUM-quantized resolution (a sweep like
    ``ffn_only`` is checked on the APSQ path it exists to measure)."""
    from repro_torch.core import calibrate_dense, quant_params_init
    from repro_torch.exec import backend_parity_check
    from repro_torch.quant.export import export_quantized
    from repro_torch.quant.policy import resolve_quant

    device = resolve_device(device)
    probe, resolved = None, None
    for name in ("unit.0.mix.wq", "unit.0.ffn.wi", "rem.0.mix.wq",
                 "encoder.unit.0.mix.wq", "head"):
        r = resolve_quant(cfg.policy, name)
        if r is None:
            continue
        if resolved is None or (resolved.psum.mode == "none"
                                and r.psum.mode != "none"):
            probe, resolved = name, r
        if resolved.psum.mode != "none":
            break
    if resolved is None:
        return {"skipped": "no quantized layers under this policy"}
    k = min(cfg.d_model, 512)  # representative reduction dim
    gen = _cpu_generator(0)
    x = torch.randn((m, k), generator=gen).to(device)
    w = (torch.randn((k, k), generator=gen) * 0.05).to(device)
    qp = calibrate_dense(quant_params_init(w, resolved, name=probe), x, w)
    dep, _ = export_quantized({"lin": {"w": w, "qp": qp}})
    dq = dep["lin"]["qp"]
    _, gemm_us, bit_equal = backend_parity_check(
        dq, x, backends=_parity_backends(device))
    return {"layer": probe, "shape": [m, k, k],
            "mode": resolved.psum.mode, "gs": resolved.psum.gs,
            "n_p": resolved.psum.n_p, "backends": list(gemm_us),
            "bit_equal": bit_equal,
            **{f"{name}_us": round(_int_gemm_us(dq, x, name), 2)
               for name in gemm_us},
            **{f"{name}_gemm_us": round(t, 1)
               for name, t in gemm_us.items()}}


_TIMED_LAUNCHES = 50


def _int_gemm_us(dq, x: torch.Tensor, backend: str) -> float:
    """Microseconds of one call of ``backend``'s integer GEMM alone (the
    kernel on ``cuda``), on the codes of ``x``: without the quantize and
    rescale around it, and without the host's dispatch.  On the card,
    ``_TIMED_LAUNCHES`` calls are captured in one CUDA graph and a replay
    is timed by CUDA events (the median of three); on the CPU, the host
    clock over as many calls."""
    launches = _TIMED_LAUNCHES
    from repro_torch.core import QuantConfig, psum_group_size
    from repro_torch.exec import get_backend, quantize_activations
    be = get_backend(backend)
    spec = dq.spec or QuantConfig.w8a8()
    xc = quantize_activations(x, dq.ax_exp, spec.a_bits)
    gs = 1 if dq.psum_exps is None else psum_group_size(
        spec, int(dq.psum_exps.shape[0]))

    def run():
        be.int_gemm(xc, dq.w_codes, dq.psum_exps, gs=gs)

    run()
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(launches):
            run()
        return (time.perf_counter() - t0) / launches * 1e6
    main = torch.cuda.current_stream(x.device)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        run()                        # the side stream's allocator warmed
        with torch.cuda.graph(graph, stream=side):
            for _ in range(launches):
                run()
    main.wait_stream(side)
    graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(main)
        graph.replay()
        b.record(main)
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / launches)
    return sorted(times)[1]


# ---------------------------------------------------------------------------
# Energy axis
# ---------------------------------------------------------------------------

def energy_report(cfg: ModelConfig, policy, *, seq_len: int = 4096,
                  stage: str = "prefill", dataflow: str = "WS",
                  acc: AcceleratorConfig | None = None,
                  inventory: list | None = None) -> dict:
    """Heterogeneous per-layer energy of ``policy`` on ``cfg``'s GEMMs.

    Returns total/psum energy under the policy, the INT32-PSUM baseline,
    and the fractional saving — the energy coordinate of one search point.
    Pass ``inventory`` to reuse a precomputed walk across candidates.
    """
    if acc is None:
        acc = (AcceleratorConfig.llm_decode() if stage == "decode"
               else AcceleratorConfig())
    if inventory is None:
        inventory = model_inventory(cfg, seq_len, stage)
    shapes = [e.shape for e in inventory]
    base = model_energy(shapes, acc, dataflow, psum_bits=32)
    e = model_energy(energy_specs(inventory, policy, acc), acc, dataflow)
    return {
        "energy_j": e["total"], "psum_j": e["psum"],
        "baseline_j": base["total"],
        "saving": 1.0 - e["total"] / base["total"],
        "dataflow": dataflow, "seq_len": seq_len, "stage": stage,
    }


# ---------------------------------------------------------------------------
# Accuracy axis (fake-quant forward vs the float oracle)
# ---------------------------------------------------------------------------

def make_eval_batch(cfg: ModelConfig, batch: int = 2, seq: int = 32,
                    seed: int = 0, *, device=None) -> dict:
    """Calibration/eval batch for the accuracy proxy: tokens (and an
    enc-dec's frame or a vision stub's patch embeddings at 0.1 scale)
    drawn from one CPU ``torch.Generator`` seeded with ``seed``, then
    moved to ``device``, so the batch is the same on every device."""
    device = resolve_device(device)
    gen = _cpu_generator(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                   generator=gen)}
    if cfg.encdec:
        out["enc_embeds"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=gen) * 0.1
    if cfg.frontend == "vision":
        out["embeds"] = torch.randn(
            (batch, cfg.n_frontend_tokens, cfg.d_model), generator=gen) * 0.1
    return {k: v.to(device) for k, v in out.items()}


def _forward(params, cfg: ModelConfig, batch: dict, device):
    from repro_torch.models.model import forward

    def get(key):
        v = batch.get(key)
        return None if v is None else torch.as_tensor(v, device=device)

    return forward(params, cfg, get("tokens").long(), embeds=get("embeds"),
                   enc_embeds=get("enc_embeds"))


@torch.no_grad()
def oracle_logits(cfg: ModelConfig, batch: dict, seed: int = 0, *,
                  device=None) -> torch.Tensor:
    """Logits of the *unquantized* model at the shared init."""
    from repro_torch.models.model import init_lm

    device = resolve_device(device)
    cfg_f = cfg.with_quant(None) if cfg.policy is not None else cfg
    params = init_lm(cfg_f, seed=seed, device=device)
    return _forward(params, cfg_f, batch, device)


@torch.no_grad()
def accuracy_proxy(cfg: ModelConfig, policy, batch: dict, ref_logits=None,
                   seed: int = 0, *, device=None) -> dict:
    """Calibrated fake-quant forward error vs the float oracle.

    Init under the policy shares the float weights with the oracle (the
    quantizer state is derived from the weights, not the generator), so
    the error is purely the policy's quantization noise.  Returns the
    scalar ``error`` (relative L1 on logits) plus top-1 agreement and KL,
    all on float32 logits — the accuracy coordinate of one search point.
    """
    from repro_torch.models.model import init_lm
    from repro_torch.quant.qat import calibrate_model

    device = resolve_device(device)
    cfg_q = cfg.with_quant(policy)
    params = init_lm(cfg_q, seed=seed, device=device)
    params = calibrate_model(params, cfg_q, batch)
    logits = _forward(params, cfg_q, batch, device)
    del params
    if ref_logits is None:
        ref_logits = oracle_logits(cfg, batch, seed, device=device)
    lf = ref_logits.to(device=device, dtype=torch.float32)
    lq = logits.float()
    rel = float(torch.mean(torch.abs(lq - lf))
                / torch.clamp(torch.mean(torch.abs(lf)), min=1e-12))
    top1 = float(torch.mean((torch.argmax(lq, -1) == torch.argmax(lf, -1))
                            .float()))
    pf = torch.softmax(lf, -1)
    kl = float(torch.mean(torch.sum(
        pf * (torch.log_softmax(lf, -1) - torch.log_softmax(lq, -1)), -1)))
    return {"error": rel, "top1_agreement": top1, "kl": kl}


# ---------------------------------------------------------------------------
# Round trip: searched policy -> calibrate -> export -> kernel serving
# ---------------------------------------------------------------------------

def _find_deployed(tree, require_psum: bool):
    """The first deployed 2-D linear of ``tree`` (with PSUM exponents
    when ``require_psum``), in the tree's order."""
    from repro_torch.core import DeployedQuantState

    if isinstance(tree, DeployedQuantState):
        ok = tree.w_codes.dim() == 2 and (
            tree.psum_exps is not None or not require_psum)
        return tree if ok else None
    if isinstance(tree, dict):
        for v in tree.values():
            hit = _find_deployed(v, require_psum)
            if hit is not None:
                return hit
    return None


def _encdec_greedy(deploy, cfg: ModelConfig, frames: torch.Tensor,
                   prompt: torch.Tensor, n_new: int, backend: str,
                   device) -> list:
    """Greedy tokens of an encoder-decoder (the engines serve
    decoder-only models): ``encode`` the frames [1, S_enc, d], then
    ``decode_step(enc_out=)`` over a fresh dense state, the prompt [1, P]
    a token at a time, then each step's argmax, ``n_new`` tokens (the
    last prompt step gives the first), as the engines count them."""
    from repro_torch.models.model import (decode_step, encode,
                                          init_decode_state)
    enc = encode(deploy, cfg, frames, backend=backend)
    P = prompt.shape[1]
    state = init_decode_state(cfg, 1, P + n_new, device=device)
    cur, out = prompt[:, :1], []
    for t in range(P + n_new - 1):
        logits, state = decode_step(deploy, cfg, state, cur, t, enc_out=enc,
                                    backend=backend)
        nxt = logits[:, -1].argmax(-1)
        if t >= P - 1:
            out.append(int(nxt[0]))
        cur = prompt[:, t + 1:t + 2] if t + 1 < P else nxt[:, None]
    return out


@torch.no_grad()
def roundtrip_report(cfg: ModelConfig, policy, batch: dict, seed: int = 0,
                     max_new_tokens: int = 6, *, device=None) -> dict:
    """Prove a searched policy is servable on the integer path.

    calibrate -> ``export_quantized`` -> (a) GEMM-level oracle-vs-cuda
    bit parity on an exported layer at M = 4 (a PSUM-quantized one where
    the policy has one: the APSQ kernel path), (b) greedy decode parity
    through a dense ``ServingEngine`` (max_batch 1, cache 64) pinned to
    each backend; an encoder-decoder, which the engines refuse, decodes
    the batch's first frames and prompt through ``encode`` +
    ``decode_step(enc_out=)`` (``_encdec_greedy``) on each backend.
    ``backends`` names what ran; on the CPU that is the oracle alone,
    and ``bit_equal``, ``serving_parity`` and ``ok`` are None (not run)
    rather than a claim.
    """
    from repro_torch.exec import backend_parity_check
    from repro_torch.models.model import init_lm
    from repro_torch.quant.export import export_quantized
    from repro_torch.quant.qat import calibrate_model
    from repro_torch.serving import Request, ServingEngine

    device = resolve_device(device)
    backends = _parity_backends(device)
    cfg_q = cfg.with_quant(policy)
    params = init_lm(cfg_q, seed=seed, device=device)
    params = calibrate_model(params, cfg_q, batch)
    deploy, export_rep = export_quantized(params)
    del params

    report: dict = {"n_exported_layers": len(export_rep),
                    "backends": list(backends)}
    dq = _find_deployed(deploy, True) or _find_deployed(deploy, False)
    if dq is not None:
        k = int(dq.w_codes.shape[0])
        x = torch.randn((4, k), generator=_cpu_generator(seed + 1)).to(device)
        _, times, bit_equal = backend_parity_check(dq, x, backends=backends)
        report["gemm_parity"] = {
            "layer": dq.name,
            "psum": dq.psum_exps is not None,
            **_parity_fields(times, bit_equal)}

    prompt = np.asarray(batch["tokens"][0, :8].cpu()).astype(np.int64)
    decodes = {}
    for backend in backends:
        if cfg_q.encdec:
            decodes[backend] = _encdec_greedy(
                deploy, cfg_q, batch["enc_embeds"][:1].to(device),
                torch.as_tensor(prompt, device=device)[None],
                max_new_tokens, backend, device)
            continue
        eng = ServingEngine(deploy, cfg_q, max_batch=1, cache_len=64,
                            backend=backend)
        done = eng.run([Request(uid=0, tokens=prompt,
                                max_new_tokens=max_new_tokens)])
        decodes[backend] = [int(t) for t in done[0].out]
    report["decode"] = decodes
    if len(backends) < 2:
        report["serving_parity"] = None
        report["ok"] = None
        return report
    report["serving_parity"] = decodes["oracle"] == decodes["cuda"]
    report["ok"] = bool(report["serving_parity"]
                        and report.get("gemm_parity", {}).get("bit_equal",
                                                             True))
    return report
