"""QAT integration: capture-based calibration, distillation, named
policies (port of ``repro/quant/qat.py``, dense branch).

``distill_loss`` is the QAT-with-teacher objective (KL(teacher ||
student) on logits mixed with cross entropy), ``make_distill_loss_fn``
its ``(params, batch) -> loss`` with the teacher's forward under
``torch.no_grad``, and ``quant_variants`` the named uniform policies of
the gs sweep.  Training itself differentiates through the same
fake-quant forward (``repro_torch.train``); calibration is forward only.

``calibrate_model`` runs the model one unit at a time with fake-quant
linears.  ``quant_dense`` appends a ``TapRecord`` per linear to the
capture list; each captured ``QuantState`` is refined by
``calibrate_dense`` (activation scale + running-accumulation PSUM
scales).  Two passes per unit: the second re-captures with the first
pass's scales, so a linear downstream of another quantized linear in the
same unit (the MLP's ``wo``) sees calibrated inputs.  Each unit is then
re-applied with its calibrated scales before the next unit is captured,
and the remainder layers (``rem.<i>``) follow the units one at a time.
A tied head gets its ``embed.qp_head`` last (policy name ``"head"``),
calibrated on the final-norm hidden states over
``tied_head_weight(table)``.
"""
from __future__ import annotations

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


@torch.no_grad()
def calibrate_model(params, cfg, batch: dict,
                    sample_tokens: int = 512):
    """Refine every quantized linear's (ax, ap) from one forward pass.

    Pure: returns a new params tree.  ``batch["tokens"]`` [B, S] int
    (numpy or a tensor) on any device; it moves to the params' device.
    """
    # lazy: models import quant.policy
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import (apply_layer, apply_unit,
                                          embed_inputs)
    device = params["embed"]["table"].device
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    new_params = dict(params)
    x = embed_inputs(params, cfg, tokens)
    new_units = {}
    for i in range(len(params["units"])):
        key = f"u{i}"
        new_unit = _calibrate_block(
            lambda pp, tap, _x=x: apply_unit(pp, _x, cfg=cfg, pos=0,
                                             tap=tap),
            params["units"][key], sample_tokens)
        x, _ = apply_unit(new_unit, x, cfg=cfg, pos=0)
        new_units[key] = new_unit
    new_params["units"] = new_units
    if cfg.n_rem:
        new_rem = {}
        for i in range(cfg.n_rem):
            kind = cfg.block_pattern[i]
            new_rem[str(i)] = _calibrate_block(
                lambda pp, tap, _x=x, _k=kind: apply_layer(
                    pp, _x, cfg=cfg, kind=_k, pos=0, tap=tap),
                params["rem"][str(i)], sample_tokens)
            x, _ = apply_layer(new_rem[str(i)], x, cfg=cfg, kind=kind, pos=0)
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
    """Named heterogeneous per-layer policies (the dense ones of the JAX
    package's ``policy_presets``)."""
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
    teacher's logits (computed without autograd)."""
    from repro_torch.models.model import forward

    def loss_fn(params, batch):
        s_logits = forward(params, cfg_student, batch["tokens"])
        with torch.no_grad():
            t_logits = forward(teacher_params, cfg_teacher, batch["tokens"])
        return distill_loss(s_logits, t_logits, batch["labels"], alpha,
                            temperature)
    return loss_fn


def quant_variants(gs_values=(1, 2, 3, 4), n_p: int = 8) -> dict:
    """Named uniform policies: W8A8 baseline, APSQ at each gs, and PSQ."""
    out = {"baseline_w8a8": QuantPolicy.uniform(QuantConfig.w8a8())}
    for gs in gs_values:
        out[f"apsq_gs{gs}"] = QuantPolicy.uniform(
            QuantConfig.apsq(gs=gs, n_p=n_p))
    out["psq"] = QuantPolicy.uniform(QuantConfig.psq(n_p=n_p))
    return out
