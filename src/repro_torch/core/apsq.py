"""APSQ fake-quant accumulation and GEMM (port of ``repro/core/apsq.py``).

Semantics of Algorithm 1 (0-based, group starts S = {0, gs, 2gs, ...}):

  AP*_0 = Q_0(T_p0)
  group start i>0 : AP*_i = Q_i( sum_{j=i-gs}^{i-1} deq(AP*_j) + T_pi )
  tail j (< n_p-1): AP*_j = Q_j(T_pj)
  final tile n_p-1: deq(AP*_{n_p-1}) if it starts a group, else
                    deq(Q_{n_p-1}( sum_{l=i_last}^{n_p-2} deq(AP*_l)
                                   + T_p{n_p-1} ))

  * ``apsq_accumulate_reference`` — the unrolled transcription (oracle);
  * ``apsq_accumulate`` — the JAX scan form: one full group at a time
    (APSQ on the group's start tile, PSQ on its tails, the tails' sum
    folded into the carry), then the possibly partial last group;
  * ``psq_accumulate`` — every tile quantized alone (== gs >= n_p);
  * ``apsq_matmul`` — ``x @ w`` with the tiles made on the fly in the
    scan form's order, so its float additions happen in JAX's order.

Every PSUM quantizer is ``po2_quantize`` with its own LSQ gradient scale
``g`` from its tile's size, so autograd through these loops gives the
gradients of JAX's autodiff of its scan (per-tile ``_fq``, the tails'
sum, the peeled last group).  ``apsq_matmul`` on a MoE bank (tiles
``[E, C, N]``, E experts' tiles) takes ``g`` from one expert's tile
``[C, N]``, as JAX does under its vmap over the experts
(``core.layers.quant_dense``).  Outputs are dequantized fake-quant
floats; the integer path is ``repro_torch.kernels.apsq_matmul``.
"""
from __future__ import annotations

import math

import torch

from .quantizers import lsq_gradient_scale, po2_quantize, qrange


def _fq(x, log2_alpha, bits, g=None):
    """PSUM fake quantizer: PO2-scale LSQ (``g``: its gradient scale,
    by default from ``x``'s size)."""
    return po2_quantize(x, log2_alpha, bits=bits, signed=True, g=g)


def _check_gs(gs: int):
    if gs < 1:
        raise ValueError(f"gs must be >= 1, got {gs}")


def apsq_accumulate_reference(tiles: torch.Tensor, log2_alphas: torch.Tensor,
                              gs: int, bits: int = 8) -> torch.Tensor:
    """Direct transcription of Algorithm 1.

    tiles [n_p, ...] PSUM tiles, log2_alphas [n_p], gs >= 1; returns the
    dequantized output tile, shape ``tiles.shape[1:]``."""
    n_p = tiles.shape[0]
    _check_gs(gs)
    stored = [None] * n_p
    for i in range(0, n_p, gs):                      # group starts
        prev = 0.0
        for j in range(max(0, i - gs), i):
            prev = prev + stored[j]
        stored[i] = _fq(prev + tiles[i], log2_alphas[i], bits)   # APSQ
        if i == n_p - 1:
            return stored[i]
        for j in range(i + 1, min(i + gs, n_p)):
            if j < n_p - 1:
                stored[j] = _fq(tiles[j], log2_alphas[j], bits)  # PSQ
            else:
                acc = tiles[j]
                for l in range(i, n_p - 1):
                    acc = acc + stored[l]
                return _fq(acc, log2_alphas[j], bits)            # final
    raise AssertionError("unreachable")


def _accumulate(tile, log2_alphas, n_p: int, gs: int, bits: int, carry, g):
    """Algorithm 1 in the scan form over ``tile(i)`` (the i-th PSUM
    tile), starting from the zero ``carry``."""
    n_groups = -(-n_p // gs)
    last_start = (n_groups - 1) * gs
    for g0 in range(0, last_start, gs):          # full groups (the scan)
        ap_start = _fq(carry + tile(g0), log2_alphas[g0], bits, g)
        if gs > 1:
            tails = torch.stack([_fq(tile(j), log2_alphas[j], bits, g)
                                 for j in range(g0 + 1, g0 + gs)])
            carry = ap_start + tails.sum(dim=0)
        else:
            carry = ap_start
    i = last_start                               # the peeled last group
    ap_start = _fq(carry + tile(i), log2_alphas[i], bits, g)
    if i == n_p - 1:
        return ap_start
    acc = ap_start
    for j in range(i + 1, n_p - 1):
        acc = acc + _fq(tile(j), log2_alphas[j], bits, g)
    return _fq(acc + tile(n_p - 1), log2_alphas[n_p - 1], bits, g)


def apsq_accumulate(tiles: torch.Tensor, log2_alphas: torch.Tensor, gs: int,
                    bits: int = 8) -> torch.Tensor:
    """Scan-form Algorithm 1 over materialized tiles [n_p, ...];
    numerically identical to the reference."""
    _check_gs(gs)
    return _accumulate(lambda i: tiles[i], log2_alphas, tiles.shape[0], gs,
                       bits, torch.zeros_like(tiles[0]), None)


def psq_accumulate(tiles: torch.Tensor, log2_alphas: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """Plain PSUM quantization: every tile quantized alone, summed once at
    the end (== Algorithm 1 with gs >= n_p)."""
    return apsq_accumulate(tiles, log2_alphas, gs=tiles.shape[0], bits=bits)


def apsq_matmul(x: torch.Tensor, w: torch.Tensor, log2_alphas: torch.Tensor,
                *, n_p: int, gs: int, bits: int = 8) -> torch.Tensor:
    """``x @ w`` with APSQ-quantized PSUM accumulation (fake quant, f32).

    x: [..., K] (fake-quantized activations), w: [K, N] (fake-quantized
    weights; or a MoE bank [E, K, N] against x [E, C, K]), log2_alphas:
    [n_p].  K must be divisible by n_p.  Every PSUM quantizer's LSQ
    gradient scale counts one tile, ``x.shape[:-1] + (N,)``; on a bank,
    one expert's, ``x.shape[1:-1] + (N,)``.  On the card the tile products
    must be full float32 (``torch.backends.cuda.matmul.allow_tf32``
    False, PyTorch's default): PSUM rounding depends on exact tile sums.
    """
    K = x.shape[-1]
    if K % n_p:
        raise ValueError(f"K={K} not divisible by n_p={n_p}")
    if tuple(log2_alphas.shape) != (n_p,):
        raise ValueError(f"log2_alphas must be [n_p]={n_p}, "
                         f"got {tuple(log2_alphas.shape)}")
    _check_gs(gs)
    g = None                                    # from each tile's size
    if w.dim() == 3:                            # a bank: one expert's tile
        g = lsq_gradient_scale(math.prod(x.shape[1:-1]) * w.shape[-1],
                               qrange(bits, True)[1])
    if n_p == 1:
        return _fq(x @ w, log2_alphas[0], bits, g)
    kt = K // n_p

    def tile(i):
        return x[..., i * kt:(i + 1) * kt] @ w[..., i * kt:(i + 1) * kt, :]

    carry = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=torch.float32,
                        device=x.device)
    return _accumulate(tile, log2_alphas, n_p, gs, bits, carry, g)
