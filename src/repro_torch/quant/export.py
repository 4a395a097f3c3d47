"""Integer deployment export (port of ``export_quantized`` in
``repro/quant/export.py``, plain linears).

Every ``{"w": ..., "qp": QuantState}`` subtree becomes ``{"qp":
DeployedQuantState}`` (the float weight is dropped):

  * weight codes at the per-channel scale ``2^floor(log2 aw)``;
  * activation exponent ``floor(log2 ax)``;
  * PSUM shift exponents ``e_i = floor(ap_i) - ax_exp - aw_exp`` in
    product-scale units, clamped to >= 0 (the shifter cannot
    left-shift-quantize).

``floor(log2 .)`` of ``aw`` and ``ax`` is the exact
``core.po2.floor_log2``, not a float ``log2``.  ``ap`` is already a float
log2 (``core.layers.calibrate_dense``), so ``floor(ap)`` can differ from
the exact exponent where the PSUM magnitude lies at or next to a power of
two (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import (DeployedQuantState, QuantState, effective_n_p,
                              floor_log2, po2_quantize_codes)


def _export_one(w: torch.Tensor, qp: QuantState):
    """One [K, *out] weight + state -> (DeployedQuantState, n_clamped)."""
    spec = qp.spec
    k = w.shape[0]
    w2d = w.reshape(k, -1).float()
    aw_exp = floor_log2(torch.clamp(qp.aw.float(), min=1e-30))
    w_codes = po2_quantize_codes(w2d, aw_exp, bits=spec.w_bits)
    ax_exp = floor_log2(torch.clamp(qp.ax.float(), min=1e-30))
    psum_exps = None
    n_clamped = 0
    if qp.ap is not None:
        ap_exp = torch.floor(qp.ap.float()).to(torch.int32)
        if aw_exp.dim():  # per-channel weights -> per-(tile, column) shifts
            psum_exps = ap_exp[:, None] - ax_exp - aw_exp[None, :]
        else:
            psum_exps = ap_exp - ax_exp - aw_exp
        n_clamped = int((psum_exps < 0).sum())
        psum_exps = torch.clamp(psum_exps, min=0)
    return DeployedQuantState(
        w_codes=w_codes, ax_exp=ax_exp, aw_exp=aw_exp, psum_exps=psum_exps,
        spec=spec, name=qp.name, out_dims=tuple(w.shape[1:])), n_clamped


@torch.no_grad()
def export_quantized(params, policy=None):
    """Export every quantized linear to the integer deployment format.

    ``policy`` optionally overrides each layer's spec (same n_p).
    Returns ``(deploy_params, report)``; report maps layer name to
    {k, n, n_p, gs, mode, int8_bytes, clamped_exps, count}.
    """
    report: dict = {}

    def apply_policy(qp: QuantState, k: int) -> QuantState:
        if policy is None:
            return qp
        override = policy.resolve(qp.name)
        if override is None or not override.enabled:
            return qp
        if override.psum.mode != "none":
            if qp.ap is None:
                raise ValueError(
                    f"{qp.name}: export policy requests psum mode "
                    f"{override.psum.mode!r} but the layer was calibrated "
                    "without PSUM scales")
            n_p = qp.ap.shape[-1]
            eff = effective_n_p(k, override.psum.n_p)
            if eff != n_p:
                raise ValueError(f"{qp.name}: export policy n_p="
                                 f"{override.psum.n_p} (effective {eff} "
                                 f"for K={k}) != calibrated n_p={n_p}")
            override = dataclasses.replace(
                override, psum=dataclasses.replace(override.psum, n_p=eff))
        return dataclasses.replace(qp, spec=override)

    def export_linear(w, qp: QuantState):
        qp = apply_policy(qp, int(w.shape[0]))
        dq, n_clamped = _export_one(w, qp)
        prev = report.get(qp.name)
        spec = qp.spec
        report[qp.name] = {
            "k": int(dq.w_codes.shape[-2]), "n": int(dq.w_codes.shape[-1]),
            "mode": spec.psum.mode, "gs": spec.psum.gs,
            "n_p": spec.psum.n_p, "int8_bytes": int(dq.w_codes.numel()),
            "clamped_exps": n_clamped + (prev["clamped_exps"] if prev else 0),
            "count": 1 + (prev["count"] if prev else 0),
        }
        return {"qp": dq}

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if "w" in tree and isinstance(tree.get("qp"), QuantState):
            return export_linear(tree["w"], tree["qp"])
        return {k: walk(v) for k, v in tree.items()}

    return walk(params), report
