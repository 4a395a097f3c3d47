"""Torch oracle for INT8-KV attention with power-of-two scales.

Port of ``repro/kernels/int8_kv_attention/ref.py``.  Codes are int8,
scales ``2^e`` per (batch, kv-head), exponents int32:

    out[b, h*G+g] = softmax_s( q . (k_codes[b,s,h] * 2^ke[b,h]) / sqrt(d) )
                    . (v_codes[b,s,h] * 2^ve[b,h])

Masked scores are ``NEG_INF = -1e30``, not ``-inf``: the CUDA kernel's
online softmax relies on ``exp(-1e30 - -1e30) = 1`` being washed out by
the first real score, where ``-inf`` would give NaN.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.po2 import ceil_log2, pow2

NEG_INF = -1e30


def quantize_kv_po2(x: torch.Tensor):
    """[B, S, H, hd] float -> (int8 codes, int32 exponents [B, H]) at the
    smallest power of two whose 127-code range covers each (b, h)."""
    amax = x.float().abs().amax(dim=(1, 3))
    exp = ceil_log2(amax.clamp(min=1e-30) / 127.0)
    scale = pow2(exp)[:, None, :, None]
    codes = torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)
    return codes, exp


def dequantize_kv_po2(codes: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    return codes.float() * pow2(exp)[:, None, :, None]


def int8_kv_attention_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          v_codes: torch.Tensor, k_exp: torch.Tensor,
                          v_exp: torch.Tensor, length) -> torch.Tensor:
    """Attention over the INT8 cache.

    Decode form (3-D q [B, Hq, hd]): one query row per batch over the
    first ``length`` positions.  Chunk form (4-D q [B, C, Hq, hd]): C
    causal rows whose LAST row sits at position ``length - 1`` — row
    ``t`` sees positions ``< length - C + 1 + t``.  Output in q's dtype.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, C, Hq, hd = q.shape
    S, Hkv = k_codes.shape[1], k_codes.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    k = dequantize_kv_po2(k_codes, k_exp)
    v = dequantize_kv_po2(v_codes, v_exp)
    qf = q.reshape(B, C, Hkv, G, hd).float()
    s = torch.einsum("bchgd,bshd->bchgs", qf, k) * scale
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    limit = length - C + 1 + torch.arange(C, device=q.device)[None]  # [B, C]
    valid = torch.arange(S, device=q.device)[None, None] < limit[..., None]
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bchgs,bshd->bchgd", p, v)
    out = out.reshape(B, C, Hq, hd).to(q.dtype)
    return out[:, 0] if squeeze else out
