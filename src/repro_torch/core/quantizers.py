"""Quantizers, forward only (port of ``repro/core/quantizers.py``).

The port serves and calibrates; it does not train yet, so there are no
straight-through estimators here: each function is the forward value of
its JAX counterpart.

  * ``lsq_quantize``  — LSQ fake quantization ``alpha * round(clip(x/alpha))``
    (round half to even, as ``jnp.round``);
  * ``po2_quantize``  — fake quantization at the power-of-two scale
    ``2^floor(log2_alpha)`` with round-half-up, the RAE shifter's rounding;
  * ``po2_quantize_codes`` — INT8 codes at ``2^exp`` (deployment view).
"""
from __future__ import annotations

import math

import torch

from .po2 import pow2


def qrange(bits: int, signed: bool = True) -> tuple[int, int]:
    """(Qn, Qp) clip bounds for a ``bits``-wide integer grid."""
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def lsq_quantize(x: torch.Tensor, alpha, bits: int = 8,
                 signed: bool = True) -> torch.Tensor:
    """LSQ fake quantization: ``alpha * round(clip(x / alpha, Qn, Qp))``.
    ``alpha`` is scalar (per-tensor) or broadcastable (per-channel)."""
    qn, qp = qrange(bits, signed)
    return torch.round(torch.clamp(x / alpha, qn, qp)) * alpha


def po2_quantize(x: torch.Tensor, log2_alpha, bits: int = 8,
                 signed: bool = True) -> torch.Tensor:
    """Fake quantization at the scale ``2^floor(log2_alpha)`` with
    round-half-up (the PSUM quantizer; matches the integer shifter)."""
    qn, qp = qrange(bits, signed)
    alpha = pow2(torch.floor(torch.as_tensor(log2_alpha)).to(torch.int32))
    alpha = alpha.to(x.device)
    return torch.floor(torch.clamp(x / alpha, qn, qp) + 0.5) * alpha


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
