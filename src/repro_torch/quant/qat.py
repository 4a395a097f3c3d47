"""QAT integration: capture-based calibration, distillation, named
policies (port of ``repro/quant/qat.py``).

``distill_loss`` is the QAT-with-teacher objective (KL(teacher ||
student) on logits mixed with cross entropy), ``make_distill_loss_fn``
its ``(params, batch) -> loss`` with the teacher's forward under
``torch.no_grad``, and ``quant_variants`` the named uniform policies of
the gs sweep (``SweepResult`` one point of it).  Training itself
differentiates through the same fake-quant forward
(``repro_torch.train``); calibration is forward only.

``calibrate_model`` runs the model one unit at a time with fake-quant
linears.  ``quant_dense`` appends a ``TapRecord`` per linear to the
capture list; each captured ``QuantState`` is refined by
``calibrate_dense`` (activation scale + running-accumulation PSUM
scales).  Two passes per unit: the second re-captures with the first
pass's scales, so a linear downstream of another quantized linear in the
same unit (the MLP's ``wo``) sees calibrated inputs.  Each unit is then
re-applied with its calibrated scales before the next unit is captured,
and the remainder layers (``rem.<i>``) follow the units one at a time.
An encoder-decoder's encoder goes first, unit by unit the same way over
``batch["enc_embeds"]``; its final-norm output is the ``enc_out`` that
the decoder's cross-attentions read while they are captured.  A vision
stub's ``batch["embeds"]`` are projected and prepended to the tokens
(``embed_inputs``).  A tied head gets its ``embed.qp_head`` last (policy
name ``"head"``), calibrated on the final-norm hidden states over
``tied_head_weight(table)``.
"""
from __future__ import annotations

import dataclasses

import torch

import torch.nn.functional as F

from repro_torch.core import (QuantConfig, QuantState, calibrate_dense,
                              quant_params_init, tied_head_weight)
from .policy import QuantPolicy, resolve_quant


def _replace_quant_states(tree, calibrated: dict):
    """Swap every ``QuantState`` whose name is in ``calibrated``."""
    if isinstance(tree, QuantState):
        return calibrated.get(tree.name, tree)
    if isinstance(tree, dict):
        return {k: _replace_quant_states(v, calibrated)
                for k, v in tree.items()}
    return tree


def _calibrate_from_taps(taps, sample_tokens: int) -> dict:
    out = {}
    for rec in taps:
        if rec.name in out:
            continue
        out[rec.name] = calibrate_dense(rec.qp, rec.x[:sample_tokens], rec.w)
    return out


def _calibrate_block(apply_fn, block_params, sample_tokens: int,
                     passes: int = 2):
    """Capture -> calibrate ``passes`` times over one block."""
    new_params = block_params
    for _ in range(passes):
        taps: list = []
        apply_fn(new_params, taps)
        calibrated = _calibrate_from_taps(taps, sample_tokens)
        new_params = _replace_quant_states(new_params, calibrated)
    return new_params


def _calibrate_units(units, x, cfg, sample_tokens: int, *, enc_out,
                     causal: bool):
    """Each unit of ``units`` captured and calibrated on ``x``, then
    re-applied with its calibrated scales to give the next unit's input;
    returns (new units, output)."""
    from repro_torch.models.model import apply_unit   # lazy: models import us
    new_units = {}
    for i in range(len(units)):
        key = f"u{i}"
        new_units[key] = _calibrate_block(
            lambda pp, tap, _x=x: apply_unit(pp, _x, cfg=cfg, pos=0,
                                             enc_out=enc_out, causal=causal,
                                             tap=tap),
            units[key], sample_tokens)
        x, _ = apply_unit(new_units[key], x, cfg=cfg, pos=0, enc_out=enc_out,
                          causal=causal)
    return new_units, x


@torch.no_grad()
def calibrate_model(params, cfg, batch: dict,
                    sample_tokens: int = 512):
    """Refine every quantized linear's (ax, ap) from one forward pass.

    Pure: returns a new params tree.  ``batch["tokens"]`` [B, S] int,
    ``batch["enc_embeds"]`` [B, S_enc, d] (needed by an encoder-decoder)
    and ``batch["embeds"]`` [B, n_img, d] (a vision stub's, optional):
    numpy or tensors on any device; they move to the params' device.
    """
    # lazy: models import quant.policy
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import apply_layer, embed_inputs
    device = params["embed"]["table"].device

    def get(key):
        v = batch.get(key)
        return None if v is None else torch.as_tensor(v, device=device)

    new_params = dict(params)
    enc_out = None
    if cfg.encdec:
        if batch.get("enc_embeds") is None:
            raise ValueError(f"{cfg.name}: encoder-decoder calibration needs "
                             "enc_embeds")
        enc = params["encoder"]
        new_enc_units, xe = _calibrate_units(
            enc["units"], get("enc_embeds").to(cfg.torch_dtype), cfg,
            sample_tokens, enc_out=None, causal=False)
        new_params["encoder"] = {**enc, "units": new_enc_units}
        enc_out = apply_norm(enc["final_norm"], xe, cfg.norm)
    x = embed_inputs(params, cfg, get("tokens").long(), get("embeds"))
    new_params["units"], x = _calibrate_units(
        params["units"], x, cfg, sample_tokens, enc_out=enc_out, causal=True)
    if cfg.n_rem:
        new_rem = {}
        for i in range(cfg.n_rem):
            kind = cfg.block_pattern[i]
            new_rem[str(i)] = _calibrate_block(
                lambda pp, tap, _x=x, _k=kind: apply_layer(
                    pp, _x, cfg=cfg, kind=_k, pos=0, enc_out=enc_out,
                    tap=tap),
                params["rem"][str(i)], sample_tokens)
            x, _ = apply_layer(new_rem[str(i)], x, cfg=cfg, kind=kind, pos=0,
                               enc_out=enc_out)
        new_params["rem"] = new_rem
    resolved = (resolve_quant(cfg.policy, "head") if cfg.tie_embeddings
                else None)
    if resolved is not None:
        w2d = tied_head_weight(params["embed"]["table"])
        xh = apply_norm(params["final_norm"], x, cfg.norm)
        qp0 = params["embed"].get("qp_head")
        if not isinstance(qp0, QuantState):
            qp0 = quant_params_init(w2d, resolved, name="head")
        qp = calibrate_dense(
            qp0, xh.reshape(-1, xh.shape[-1])[:sample_tokens], w2d)
        new_params["embed"] = {**params["embed"], "qp_head": qp}
    return new_params


def policy_presets() -> dict:
    """Named heterogeneous per-layer policies (the JAX package's
    ``policy_presets``)."""
    apsq = QuantConfig.apsq
    return {
        # attention projections tight (small gs), FFN loose (bigger gs)
        "mix2_ffn4": QuantPolicy.of(
            ("*.mix.*", apsq(gs=2, n_p=4)),
            ("*.ffn.*", apsq(gs=4, n_p=8)),
            default=QuantConfig.w8a8()),
        # PSUM-quantize only the FFN (attention stays plain W8A8)
        "ffn_only": QuantPolicy.of(
            ("*.ffn.*", apsq(gs=2, n_p=8)),
            default=QuantConfig.w8a8()),
        # aggressive everywhere incl. remainder layers, fine K tiling
        "aggressive": QuantPolicy.of(
            ("rem.*", apsq(gs=1, n_p=16)),
            ("*", apsq(gs=2, n_p=16))),
        # encoder quantized harder than decoder (encdec archs)
        "enc_heavy": QuantPolicy.of(
            ("encoder.*", apsq(gs=1, n_p=8)),
            ("*", apsq(gs=4, n_p=4))),
    }


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, alpha: float = 0.5,
                 temperature: float = 2.0) -> torch.Tensor:
    """alpha * KL(teacher || student) * T^2 + (1 - alpha) * CE(labels)."""
    from repro_torch.models.model import lm_loss   # lazy: models import us
    t = temperature
    sl = F.log_softmax(student_logits.float() / t, dim=-1)
    tl = F.softmax(teacher_logits.float() / t, dim=-1)
    kl = torch.sum(tl * (torch.log(torch.clamp(tl, min=1e-20)) - sl), dim=-1)
    ce = lm_loss(student_logits, labels)
    return alpha * kl.mean() * (t * t) + (1 - alpha) * ce


def make_distill_loss_fn(cfg_student, cfg_teacher, teacher_params,
                         alpha: float = 0.5, temperature: float = 2.0):
    """(student_params, batch) -> loss against a frozen full-precision
    teacher's logits (computed without autograd); a batch's ``embeds``
    and ``enc_embeds`` reach both forwards."""
    from repro_torch.models.model import forward

    def loss_fn(params, batch):
        kw = dict(embeds=batch.get("embeds"),
                  enc_embeds=batch.get("enc_embeds"))
        s_logits = forward(params, cfg_student, batch["tokens"], **kw)
        with torch.no_grad():
            t_logits = forward(teacher_params, cfg_teacher, batch["tokens"],
                               **kw)
        return distill_loss(s_logits, t_logits, batch["labels"], alpha,
                            temperature)
    return loss_fn


@dataclasses.dataclass
class SweepResult:
    """One point of the gs sweep (Table I): the policy's gs and mode, and
    its final training and evaluation losses."""
    gs: int
    mode: str
    final_loss: float
    eval_loss: float


def quant_variants(gs_values=(1, 2, 3, 4), n_p: int = 8) -> dict:
    """Named uniform policies: W8A8 baseline, APSQ at each gs, and PSQ."""
    out = {"baseline_w8a8": QuantPolicy.uniform(QuantConfig.w8a8())}
    for gs in gs_values:
        out[f"apsq_gs{gs}"] = QuantPolicy.uniform(
            QuantConfig.apsq(gs=gs, n_p=n_p))
    out["psq"] = QuantPolicy.uniform(QuantConfig.psq(n_p=n_p))
    return out
