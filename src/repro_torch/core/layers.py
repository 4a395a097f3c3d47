"""Quantized linear layers (port of ``repro/core/layers.py``).

``QuantState`` is one linear's quantizer state (LSQ scales ``aw``/``ax``
and PO2 log2 PSUM scales ``ap``) with its resolved ``QuantConfig`` and
stable layer name; ``DeployedQuantState`` is its integer deployment view
(INT8 weight codes + PO2 shift exponents) produced by
``repro_torch.quant.export_quantized``.  Both hold torch tensors.

``quant_dense`` runs a linear three ways, chosen by the state it is
given: plain float, W8A8 (+ PSQ/APSQ) fake quant for calibration and
quantization-aware training, or the integer deployment path through
``repro_torch.exec.execute_gemm``.  Fake quant is differentiable in
``x``, ``w`` and the state's ``aw`` (per-channel or scalar), ``ax`` and
``ap``: the trainer makes those three trainable leaves, while ``spec``
and ``name`` stay static (as in the JAX pytree).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .apsq import apsq_matmul
from .quantizers import (init_alpha_from, lsq_gradient_scale, lsq_quantize,
                         qrange)

PSUM_MODES = ("none", "psq", "apsq")


@dataclasses.dataclass(frozen=True)
class PsumQuantConfig:
    """PSUM handling for the simulated IS/WS accelerator."""

    mode: str = "none"  # none | psq | apsq
    gs: int = 2         # group size (Algorithm 1); psq == apsq with gs>=n_p
    n_p: int = 8        # #PSUM tiles along K (= ceil(C_i/P_ci))
    bits: int = 8

    def __post_init__(self):
        if self.mode not in PSUM_MODES:
            raise ValueError(f"psum mode must be one of {PSUM_MODES}")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """W8A8 fake-quant + optional PSUM quantization."""

    enabled: bool = False
    w_bits: int = 8
    a_bits: int = 8
    per_channel_w: bool = True
    psum: PsumQuantConfig = dataclasses.field(default_factory=PsumQuantConfig)

    @staticmethod
    def w8a8() -> "QuantConfig":
        return QuantConfig(enabled=True)

    @staticmethod
    def apsq(gs: int = 2, n_p: int = 8) -> "QuantConfig":
        return QuantConfig(enabled=True,
                           psum=PsumQuantConfig("apsq", gs=gs, n_p=n_p))

    @staticmethod
    def psq(n_p: int = 8) -> "QuantConfig":
        return QuantConfig(enabled=True, psum=PsumQuantConfig("psq", n_p=n_p))


def psum_group_size(spec: QuantConfig, n_p: int) -> int:
    """The PSUM group size ``gs`` a layer with ``n_p`` PSUM tiles runs at,
    in fake quant and on the integer path alike: all ``n_p`` tiles under
    ``psq``, else the spec's ``gs``."""
    return n_p if spec.psum.mode == "psq" else spec.psum.gs


def effective_n_p(k: int, requested: int) -> int:
    """Largest divisor of K that is <= requested (K-tiling must be exact)."""
    n = max(1, min(requested, k))
    while k % n:
        n -= 1
    return n


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Quantizer state of one linear: ``aw`` (LSQ weight scale, [N] or
    scalar), ``ax`` (LSQ activation scale, scalar), ``ap`` (log2 PSUM
    scales [n_p], None without PSUM quantization), the resolved ``spec``
    and the stable layer ``name``.  Reads like a mapping of its data
    fields (``qp["ap"]``, ``"ap" in qp``, ``get``, ``as_dict``), as the
    JAX package's does; ``from_dict`` builds one from such a dict."""

    aw: torch.Tensor
    ax: torch.Tensor
    ap: torch.Tensor | None = None
    spec: QuantConfig | None = None
    name: str = ""

    _FIELDS = ("aw", "ax", "ap")

    def __getitem__(self, key):
        if key in self._FIELDS:
            v = getattr(self, key)
            if v is None:
                raise KeyError(key)
            return v
        raise KeyError(key)

    def __contains__(self, key):
        return key in self._FIELDS and getattr(self, key) is not None

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def as_dict(self) -> dict:
        d = {"aw": self.aw, "ax": self.ax}
        if self.ap is not None:
            d["ap"] = self.ap
        return d

    @staticmethod
    def from_dict(d: dict, spec: QuantConfig | None = None,
                  name: str = "") -> "QuantState":
        return QuantState(aw=d["aw"], ax=d["ax"], ap=d.get("ap"),
                          spec=spec, name=name)


@dataclasses.dataclass(frozen=True)
class DeployedQuantState:
    """Integer deployment view of one linear: ``w_codes`` (INT8 [K, N]),
    ``ax_exp`` (int32 scalar), ``aw_exp`` (int32 [N] or scalar),
    ``psum_exps`` (int32 [n_p] or [n_p, N]; None for plain W8A8), the
    ``spec``, ``name`` and ``out_dims`` (trailing weight dims)."""

    w_codes: torch.Tensor
    ax_exp: torch.Tensor
    aw_exp: torch.Tensor
    psum_exps: torch.Tensor | None = None
    spec: QuantConfig | None = None
    name: str = ""
    out_dims: tuple = ()


@dataclasses.dataclass
class TapRecord:
    """One captured linear invocation (calibration capture)."""

    name: str
    x: torch.Tensor    # [tokens, K] activations as seen by the linear
    w: torch.Tensor    # [K, N] flattened weight
    qp: QuantState


def quant_params_init(w: torch.Tensor, cfg: QuantConfig,
                      name: str = "") -> QuantState:
    """Quantizer state for one linear with (flattened) weight [K, N]."""
    k = w.shape[0]
    w2d = w.reshape(k, -1).float()
    if cfg.per_channel_w:
        _, qp = qrange(cfg.w_bits, True)
        aw = 2.0 * w2d.abs().mean(dim=0) / math.sqrt(qp) + 1e-12
    else:
        aw = init_alpha_from(w2d, cfg.w_bits)
    ap = None
    spec = cfg
    if cfg.psum.mode != "none":
        n_p = effective_n_p(k, cfg.psum.n_p)
        spec = dataclasses.replace(
            cfg, psum=dataclasses.replace(cfg.psum, n_p=n_p))
        # generic start; calibrate_dense refines it from data
        ap = torch.full((n_p,), 4.0, dtype=torch.float32, device=w.device)
    return QuantState(aw=aw, ax=torch.ones((), device=w.device), ap=ap,
                      spec=spec, name=name)


def calibrate_dense(qp: QuantState, x: torch.Tensor,
                    w: torch.Tensor) -> QuantState:
    """Refine activation and PSUM scales from a calibration batch.

    PSUM scales come from the running accumulation (cumsum over tiles),
    the quantity APSQ actually quantizes."""
    spec = qp.spec
    k = w.shape[0]
    n = w.numel() // k
    w2d = w.reshape(k, n).float()
    x2d = x.reshape(-1, k).float()
    ax = init_alpha_from(x2d, spec.a_bits)
    ap = qp.ap
    if ap is not None:
        n_p = ap.shape[-1]
        kt = k // n_p
        tiles = torch.einsum("bpk,pkn->pbn", x2d.reshape(-1, n_p, kt),
                             w2d.reshape(n_p, kt, n))
        running = torch.cumsum(tiles, dim=0)
        _, qpmax = qrange(spec.psum.bits, True)
        mags = 2.0 * running.abs().mean(dim=(1, 2)) / math.sqrt(qpmax)
        # ap stays a float log2, as in the reference, because fake quant
        # uses it unrounded; export floors it (``quant/export.py``), the
        # one PO2 exponent the port still takes from a float log2
        # (ROADMAP queue 3)
        ap = torch.log2(torch.clamp(mags, min=1e-6))
    return dataclasses.replace(qp, ax=ax, ap=ap)


def quant_dense(x: torch.Tensor, w: torch.Tensor | None, qp, *,
                tap: list | None = None, backend=None) -> torch.Tensor:
    """``x @ w`` as the state ``qp`` says.

    ``DeployedQuantState``: the integer path (``w`` ignored).
    ``QuantState``: W8A8 fake quant, plus PSQ/APSQ on the PSUMs, with
    the straight-through gradients of ``core.quantizers``; appends a
    ``TapRecord`` to ``tap`` when given.  None: plain float GEMM.
    x: [..., K]; w: [K, N], or a MoE bank [E, K, N] against x [E, C, K]
    with one state shared by every expert (``models.moe``, which taps
    its experts itself).  Returns [..., N] in x.dtype.

    A bank is JAX's ``jax.vmap`` of this function over the experts: each
    quantizer's LSQ gradient scale ``g = 1/sqrt(numel * Qp)`` counts one
    expert's tensor (``x [C, K]``, ``w [K, N]``, a PSUM tile ``[C, N]``),
    and the shared scales' gradients sum over the experts.  One call
    over the bank with ``g`` taken per expert gives exactly that.
    """
    if isinstance(qp, DeployedQuantState):
        return deployed_dense(x, qp, backend=backend)
    spec = qp.spec if isinstance(qp, QuantState) else None
    if spec is None or not spec.enabled:
        return x @ w.to(x.dtype)
    k = w.shape[-2]
    if tap is not None:
        tap.append(TapRecord(qp.name, x.reshape(-1, k), w, qp))
    gx = gw = None                            # 2-D: from each tensor
    if w.dim() == 3:        # a bank: one expert's sizes (``apsq_matmul``
        n_exp = w.shape[0]  # takes its PSUM tiles' so too)
        gx = lsq_gradient_scale(x.numel() // n_exp, qrange(spec.a_bits)[1])
        gw = lsq_gradient_scale(w.numel() // n_exp, qrange(spec.w_bits)[1])
    xq = lsq_quantize(x.float(), qp.ax, bits=spec.a_bits, g=gx)
    wq = lsq_quantize(w.float(), qp.aw, bits=spec.w_bits, g=gw)
    if spec.psum.mode == "none":
        y = xq @ wq
    else:
        n_p = qp.ap.shape[0]
        y = apsq_matmul(xq, wq, qp.ap, n_p=n_p, gs=psum_group_size(spec, n_p),
                        bits=spec.psum.bits)
    return y.to(x.dtype)


def tied_head_weight(table: torch.Tensor) -> torch.Tensor:
    """The tied-embedding logits weight: table [V, ...D] -> [D, V] fp32.

    The one definition that head calibration (``quant.qat``), integer
    export (``quant.export``) and the fake-quant forward
    (``models.model.logits_from_hidden``) share, so the calibrated
    scales and the codes belong to the GEMM that runs."""
    return table.reshape(table.shape[0], -1).T.float()


def deployed_dense(x: torch.Tensor, dq: DeployedQuantState, *,
                   backend=None) -> torch.Tensor:
    """Integer GEMM on exported codes through ``repro_torch.exec``."""
    from repro_torch.exec import execute_gemm  # lazy: exec imports kernels
    return execute_gemm(dq, x, backend=backend)
