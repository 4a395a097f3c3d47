"""Quantizers with straight-through gradients (port of
``repro/core/quantizers.py``).

  * ``round_ste`` / ``floor_ste`` / ``round_half_up_ste`` — rounding with
    an identity (straight-through) gradient;
  * ``grad_scale`` — forward identity, gradient times ``scale`` (the LSQ
    trick), and ``lsq_gradient_scale`` its ``g = 1/sqrt(numel * Qp)``;
  * ``lsq_quantize`` — LSQ fake quantization ``alpha * round(clip(x /
    alpha))`` (round half to even, as ``jnp.round``);
  * ``po2_scale`` / ``po2_quantize`` — fake quantization at the learned
    power-of-two scale ``2^floor(log2_alpha)`` with round-half-up, the
    RAE shifter's rounding (the PSUM quantizer);
  * ``po2_quantize_codes`` — INT8 codes at ``2^exp`` (deployment view);
  * ``QuantSpec`` — the static description of one quantizer.

Forward values are exact: an STE returns the rounded value itself and
``grad_scale`` returns its input (JAX's ``x*s + stop_gradient(x*(1-s))``
can be one ulp off ``x``), and ``po2_scale`` builds ``2^floor`` from its
IEEE bits (``po2.pow2``).  Gradients are JAX's autodiff of the same
expressions: ``clip`` is ``minimum(maximum(x, lo), hi)`` as ``jnp.clip``
is, so a value exactly on a bound passes half its gradient (``torch.clamp``
would pass all of it), and ``po2_scale``'s gradient is ``ln2 * 2^floor``,
the derivative of ``exp2`` straight through the floor.  Where autograd
records nothing (``torch.no_grad``, or no input needs a gradient) each
function computes its forward value alone.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .po2 import pow2

LN2 = math.log(2.0)


def qrange(bits: int, signed: bool = True) -> tuple[int, int]:
    """(Qn, Qp) clip bounds for a ``bits``-wide integer grid."""
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _ste(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` forward, identity gradient to ``x``."""
    if not _recording(x):
        return value
    return value.detach() + (x - x.detach())


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even with identity (straight-through) gradient."""
    return _ste(x, torch.round(x))


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    """Floor with identity gradient (power-of-two exponents)."""
    return _ste(x, torch.floor(x))


def round_half_up_ste(x: torch.Tensor) -> torch.Tensor:
    """Round-half-up (toward +inf) with identity gradient: the rounding of
    the RAE's shift-based PSUM quantizer, ``(v + 2^(e-1)) >> e`` ==
    ``floor(v / 2^e + 0.5)``."""
    return _ste(x, torch.floor(x + 0.5))


def grad_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Forward identity; gradient multiplied by ``scale`` (LSQ trick)."""
    if not _recording(x):
        return x
    return x.detach() + (x - x.detach()) * scale


def lsq_gradient_scale(numel: int, qp: int) -> float:
    """LSQ paper's per-quantizer gradient scale g = 1/sqrt(numel * Qp)."""
    return 1.0 / math.sqrt(max(int(numel) * int(qp), 1))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: values in [lo, hi]; the gradient is 1 inside, 1/2 on
    a bound and 0 outside (``minimum(maximum(x, lo), hi)``'s)."""
    if not _recording(x):
        return torch.clamp(x, lo, hi)
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def lsq_quantize(x: torch.Tensor, alpha, bits: int = 8, signed: bool = True,
                 g: float | None = None) -> torch.Tensor:
    """LSQ fake quantization: ``alpha * round(clip(x / alpha, Qn, Qp))``.

    ``alpha`` is scalar (per-tensor) or broadcastable (per-channel); ``g``
    is the LSQ gradient scale, by default from ``x.numel()``.  Gradients
    to ``x`` pass inside the clip range; ``alpha`` collects the rounding
    residual inside and the saturation value outside (LSQ eq. 3)."""
    qn, qp = qrange(bits, signed)
    if g is None:
        g = lsq_gradient_scale(x.numel(), qp)
    if isinstance(alpha, torch.Tensor):
        alpha = grad_scale(alpha, g)
    return round_ste(clip(x / alpha, qn, qp)) * alpha


def po2_scale(log2_alpha: torch.Tensor) -> torch.Tensor:
    """The power-of-two scale ``2^floor(log2_alpha)`` (exact), with the
    gradient ``ln2 * 2^floor(log2_alpha)`` straight through the floor."""
    alpha = pow2(torch.floor(log2_alpha.detach()))
    if not _recording(log2_alpha):
        return alpha
    return alpha + (log2_alpha - log2_alpha.detach()) * (alpha * LN2)


def po2_quantize(x: torch.Tensor, log2_alpha, bits: int = 8,
                 signed: bool = True, g: float | None = None) -> torch.Tensor:
    """Fake quantization at the scale ``2^floor(log2_alpha)`` with
    round-half-up (the PSUM quantizer; matches the integer shifter bit for
    bit on the PO2 grid).  ``g`` as in ``lsq_quantize``."""
    qn, qp = qrange(bits, signed)
    if g is None:
        g = lsq_gradient_scale(x.numel(), qp)
    la = torch.as_tensor(log2_alpha, dtype=torch.float32, device=x.device)
    alpha = po2_scale(grad_scale(la, g))
    return round_half_up_ste(clip(x / alpha, qn, qp)) * alpha


def po2_quantize_codes(x: torch.Tensor, exp: torch.Tensor,
                       bits: int = 8) -> torch.Tensor:
    """INT8 codes of ``x`` at the scale ``2^exp`` (round half to even).

    The JAX function takes a float ``log2_alpha`` and floors it; the port
    takes the integer exponent itself, computed exactly by
    ``po2.floor_log2`` at the call site (``quant.export``)."""
    qn, qp = qrange(bits, True)
    alpha = pow2(exp).to(x.device)
    return torch.clamp(torch.round(x / alpha), qn, qp).to(torch.int8)


def init_alpha_from(x: torch.Tensor, bits: int = 8,
                    signed: bool = True) -> torch.Tensor:
    """LSQ initialization: alpha = 2 * mean(|x|) / sqrt(Qp)."""
    _, qp = qrange(bits, signed)
    return 2.0 * x.abs().mean() / math.sqrt(float(qp)) + 1e-12


def init_log2_alpha_from(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """PO2 variant of LSQ init (log2 domain)."""
    return torch.log2(init_alpha_from(x, bits))


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer (used by configs & model surgery)."""

    bits: int = 8
    signed: bool = True
    po2: bool = False  # power-of-two scale (PSUM quantizers)

    @property
    def qn(self) -> int:
        return qrange(self.bits, self.signed)[0]

    @property
    def qp(self) -> int:
        return qrange(self.bits, self.signed)[1]
