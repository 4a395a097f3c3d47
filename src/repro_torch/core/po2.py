"""Exact power-of-two exponents and scales.

The reference takes every PO2 exponent as ``ceil`` or ``floor`` of a
float ``log2`` (``serving/paged_cache.py:po2_exponent``,
``kernels/int8_kv_attention/ref.py:quantize_kv_po2``,
``quant/export.py:_export_one``, ``core/quantizers.py:
po2_quantize_codes``, ``kernels/apsq_matmul/ref.py:choose_exps``).
A float ``log2`` is not exact at exact powers of two on every backend
(XLA's CPU ``log2`` returns ``n + 1ulp`` at some ``2^n``), and two
implementations of it disagree there, so the port never calls one: it
applies the same float pre-division as the reference and reads the
exponent off ``torch.frexp``, which is exact and gives the same bits on
the CPU and on the card.

``y = m * 2^e`` with ``m`` in [0.5, 1):

  * ``floor(log2 y) = e - 1``
  * ``ceil(log2 y)  = e - 1`` if ``m == 0.5`` (``y`` is a power of two),
    else ``e``.

``pow2`` builds ``2^e`` from its IEEE bits, so scales are exact too
(float ``exp2`` of an integer is not exact on every backend either).
"""
from __future__ import annotations

import torch


def ceil_log2(y: torch.Tensor) -> torch.Tensor:
    """Exact ``ceil(log2(y))`` for positive finite float ``y`` -> int32."""
    m, e = torch.frexp(y.float())
    return torch.where(m == 0.5, e - 1, e).to(torch.int32)


def floor_log2(y: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(y))`` for positive finite float ``y`` -> int32."""
    _, e = torch.frexp(y.float())
    return (e - 1).to(torch.int32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for integer ``e`` (clamped to normal range)."""
    e = torch.as_tensor(e).to(torch.int32).clamp(-126, 127)
    return ((e + 127) << 23).view(torch.float32)
