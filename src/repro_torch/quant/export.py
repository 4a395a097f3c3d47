"""Integer deployment export (port of ``export_quantized`` and
``snap_params_po2`` in ``repro/quant/export.py``: plain linears and MoE
expert banks).

Every ``{"w": ..., "qp": QuantState}`` subtree becomes ``{"qp":
DeployedQuantState}`` (the float weight is dropped), and every MoE
expert bank ``{"wi": [E, K, N], "qp_wi": QuantState}`` becomes
``{"qp_wi": DeployedQuantState}`` with a leading expert axis on each
data leaf: per-expert codes, and the exponents of the one shared state
repeated per expert (as the JAX package's ``vmap`` over experts does).
A tied head's ``{"table", "qp_head": QuantState}`` keeps its float table
(the input lookup) beside a deployed ``qp_head`` with the codes of
``tied_head_weight(table)``.  The walk reaches every subtree: an
encoder's units (``encoder.unit.<j>``) and the decoder's cross-attention
(``xattn``) export like any linear, while a float linear without a
state (the head, a vision stub's ``frontend_proj``) stays as it is.

  * weight codes at the per-channel scale ``2^floor(log2 aw)``;
  * activation exponent ``floor(log2 ax)``;
  * PSUM shift exponents ``e_i = floor(ap_i) - ax_exp - aw_exp`` in
    product-scale units, clamped to >= 0 (the shifter cannot
    left-shift-quantize).

``snap_params_po2`` is the fake-quant reference of the export: the same
tree with every ``QuantState``'s ``ax``/``aw`` snapped to
``2^floor(log2 .)``, the scales whose exponents the export takes.

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
                              floor_log2, po2_quantize_codes, pow2,
                              tied_head_weight)


def _exponents(qp: QuantState):
    """(ax_exp, aw_exp, psum_exps, n_clamped) of one quantizer state."""
    aw_exp = floor_log2(torch.clamp(qp.aw.float(), min=1e-30))
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
    return ax_exp, aw_exp, psum_exps, n_clamped


def _export_one(w: torch.Tensor, qp: QuantState):
    """One [K, *out] weight + state -> (DeployedQuantState, n_clamped)."""
    ax_exp, aw_exp, psum_exps, n_clamped = _exponents(qp)
    w_codes = po2_quantize_codes(w.reshape(w.shape[0], -1).float(), aw_exp,
                                 bits=qp.spec.w_bits)
    return DeployedQuantState(
        w_codes=w_codes, ax_exp=ax_exp, aw_exp=aw_exp, psum_exps=psum_exps,
        spec=qp.spec, name=qp.name, out_dims=tuple(w.shape[1:])), n_clamped


def _export_experts(w: torch.Tensor, qp: QuantState):
    """Expert bank [E, K, N] + its shared state -> (stacked
    DeployedQuantState, n_clamped summed over experts): expert e's leaves
    are exactly ``_export_one(w[e], qp)``'s."""
    n_exp = w.shape[0]
    ax_exp, aw_exp, psum_exps, n_clamped = _exponents(qp)
    w_codes = po2_quantize_codes(w.reshape(n_exp, w.shape[1], -1).float(),
                                 aw_exp, bits=qp.spec.w_bits)

    def per_expert(t):
        return t.expand(n_exp, *t.shape).contiguous()

    return DeployedQuantState(
        w_codes=w_codes, ax_exp=per_expert(ax_exp),
        aw_exp=per_expert(aw_exp),
        psum_exps=None if psum_exps is None else per_expert(psum_exps),
        spec=qp.spec, name=qp.name,
        out_dims=tuple(w.shape[2:])), n_clamped * n_exp


@torch.no_grad()
def export_quantized(params, policy=None):
    """Export every quantized linear to the integer deployment format.

    ``policy`` optionally overrides each layer's spec (same n_p).
    Returns ``(deploy_params, report)``; report maps layer name to
    {k, n, n_p, gs, mode, int8_bytes, clamped_exps, count}, plus
    ``n_experts`` for an expert bank and ``tied_head`` for a tied head.
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

    def record(dq, spec, n_clamped, name, **extra):
        prev = report.get(name)
        report[name] = {
            "k": int(dq.w_codes.shape[-2]), "n": int(dq.w_codes.shape[-1]),
            "mode": spec.psum.mode, "gs": spec.psum.gs,
            "n_p": spec.psum.n_p, "int8_bytes": int(dq.w_codes.numel()),
            "clamped_exps": n_clamped + (prev["clamped_exps"] if prev else 0),
            "count": 1 + (prev["count"] if prev else 0), **extra,
        }

    def export_linear(w, qp: QuantState):
        qp = apply_policy(qp, int(w.shape[0]))
        dq, n_clamped = _export_one(w, qp)
        record(dq, qp.spec, n_clamped, qp.name)
        return {"qp": dq}

    def export_experts(w, qp: QuantState):
        qp = apply_policy(qp, int(w.shape[-2]))
        dq, n_clamped = _export_experts(w, qp)
        record(dq, qp.spec, n_clamped, qp.name, n_experts=int(w.shape[0]))
        return dq

    def export_head(table, qp: QuantState):
        w = tied_head_weight(table)
        qp = apply_policy(qp, int(w.shape[0]))
        dq, n_clamped = _export_one(w, qp)
        record(dq, qp.spec, n_clamped, qp.name, tied_head=True)
        return dq

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if "w" in tree and isinstance(tree.get("qp"), QuantState):
            return export_linear(tree["w"], tree["qp"])
        if "table" in tree and isinstance(tree.get("qp_head"), QuantState):
            out = {k: walk(v) for k, v in tree.items() if k != "qp_head"}
            out["qp_head"] = export_head(tree["table"], tree["qp_head"])
            return out
        # expert banks: [E, K, N] floats beside a shared QuantState
        banks = [k[3:] for k, v in tree.items()
                 if k.startswith("qp_") and isinstance(v, QuantState)
                 and isinstance(tree.get(k[3:]), torch.Tensor)
                 and tree[k[3:]].dim() == 3]
        return {k: (export_experts(tree[k[3:]], v)
                    if k.startswith("qp_") and k[3:] in banks else walk(v))
                for k, v in tree.items() if k not in banks}

    return walk(params), report


def _snap_one(qp: QuantState) -> QuantState:
    """Snap ax/aw to the exported PO2 grid (fake-quant reference view)."""
    aw = pow2(floor_log2(torch.clamp(qp.aw.float(), min=1e-30)))
    ax = pow2(floor_log2(torch.clamp(qp.ax.float(), min=1e-30)))
    return dataclasses.replace(qp, aw=aw, ax=ax)


@torch.no_grad()
def snap_params_po2(params):
    """Fake-quant reference matching the export: same tree, with every
    ``QuantState``'s ax/aw snapped to ``2^floor(log2 .)``.  Running the
    model on this tree reproduces the deployed integer path."""
    def walk(tree):
        if isinstance(tree, QuantState):
            return _snap_one(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree
    return walk(params)
