"""APSQ fake-quant GEMM, forward only (port of ``repro/core/apsq.py``).

``apsq_matmul`` follows the JAX fused formulation step for step — one
full group at a time (APSQ on the group's start tile, PSQ on its tails,
the tails' sum folded into the carry), then the possibly partial last
group — so its float additions happen in the same order.  Semantics of
Algorithm 1 (0-based, group starts S = {0, gs, 2gs, ...}):

  AP*_0 = Q_0(T_p0)
  group start i>0 : AP*_i = Q_i( sum_{j=i-gs}^{i-1} deq(AP*_j) + T_pi )
  tail j (< n_p-1): AP*_j = Q_j(T_pj)
  final tile n_p-1: deq(AP*_{n_p-1}) if it starts a group, else
                    deq(Q_{n_p-1}( sum_{l=i_last}^{n_p-2} deq(AP*_l)
                                   + T_p{n_p-1} ))
"""
from __future__ import annotations

import torch

from .quantizers import po2_quantize


def _fq(x, log2_alpha, bits):
    return po2_quantize(x, log2_alpha, bits=bits, signed=True)


def apsq_matmul(x: torch.Tensor, w: torch.Tensor, log2_alphas: torch.Tensor,
                *, n_p: int, gs: int, bits: int = 8) -> torch.Tensor:
    """``x @ w`` with APSQ-quantized PSUM accumulation (fake quant, f32).

    x: [..., K] (fake-quantized activations), w: [K, N] (fake-quantized
    weights; or a MoE bank [E, K, N] against x [E, C, K]), log2_alphas:
    [n_p].  K must be divisible by n_p.
    """
    K = x.shape[-1]
    if K % n_p:
        raise ValueError(f"K={K} not divisible by n_p={n_p}")
    if tuple(log2_alphas.shape) != (n_p,):
        raise ValueError(f"log2_alphas must be [n_p]={n_p}, "
                         f"got {tuple(log2_alphas.shape)}")
    if n_p == 1:
        return _fq(x @ w, log2_alphas[0], bits)
    kt = K // n_p
    n_groups = -(-n_p // gs)
    last_start = (n_groups - 1) * gs

    def tile(i):
        return x[..., i * kt:(i + 1) * kt] @ w[..., i * kt:(i + 1) * kt, :]

    carry = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=torch.float32,
                        device=x.device)
    for g0 in range(0, last_start, gs):          # full groups
        ap_start = _fq(carry + tile(g0), log2_alphas[g0], bits)
        if gs > 1:
            tails = torch.stack([_fq(tile(j), log2_alphas[j], bits)
                                 for j in range(g0 + 1, g0 + gs)])
            carry = ap_start + tails.sum(dim=0)
        else:
            carry = ap_start
    i = last_start
    ap_start = _fq(carry + tile(i), log2_alphas[i], bits)
    if i == n_p - 1:
        return ap_start
    acc = ap_start
    for j in range(i + 1, n_p - 1):
        acc = acc + _fq(tile(j), log2_alphas[j], bits)
    return _fq(acc + tile(n_p - 1), log2_alphas[n_p - 1], bits)
