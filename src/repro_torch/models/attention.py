"""GQA attention block (port of ``repro/models/attention.py``, two modes).

  * ``cache is None``: full-sequence causal attention, used by
    calibration.  A plain softmax over the masked scores; the JAX
    package's chunked online-softmax form is a TPU memory layout of the
    same function, not a kernel.
  * ``cache = {"k_pages", "v_pages", "k_exp", "v_exp"}``: decode (S=1) or
    a prefill chunk (S>1) against the paged INT8 KV cache
    (``repro_torch.serving.paged_cache``), ``pos`` a per-slot [B] vector
    of the chunk's first position and ``page_table`` [B, n_max].
"""
from __future__ import annotations

import math

import torch

from .common import Params, apply_rope, dense, init_linear

NEG_INF = -1e30


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype, *, device, quant=None,
                   name: str = "") -> Params:
    kw = dict(device=device, quant=quant)
    return {
        "wq": init_linear(gen, (d_model, n_heads * head_dim), dtype,
                          name=f"{name}.wq", **kw),
        "wk": init_linear(gen, (d_model, n_kv_heads * head_dim), dtype,
                          name=f"{name}.wk", **kw),
        "wv": init_linear(gen, (d_model, n_kv_heads * head_dim), dtype,
                          name=f"{name}.wv", **kw),
        "wo": init_linear(gen, (n_heads * head_dim, d_model), dtype,
                          name=f"{name}.wo", **kw),
    }


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0) -> torch.Tensor:
    """q [B, S, Hq, hd], k/v [B, S, Hkv, hd] -> [B, S, Hq, hd] in v.dtype;
    GQA groups query heads as ``reshape(B, S, Hkv, G, hd)``."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, Hkv, G, hd),
                     k).float() * (1.0 / math.sqrt(hd))
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, S, Hq, hd).to(v.dtype)


def attention_block(p: Params, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int,
                    rope_fraction: float = 1.0, rope_theta: float = 10000.0,
                    cache: Params | None = None, pos=0,
                    tap: list | None = None, backend=None, page_table=None):
    """Projections + RoPE + attention; returns (out, new_cache)."""
    B, S, _ = x.shape
    q = dense(p["wq"], x, tap=tap, backend=backend).reshape(
        B, S, n_heads, head_dim)
    k = dense(p["wk"], x, tap=tap, backend=backend).reshape(
        B, S, n_kv_heads, head_dim)
    v = dense(p["wv"], x, tap=tap, backend=backend).reshape(
        B, S, n_kv_heads, head_dim)
    paged = cache is not None and "k_pages" in cache
    if paged:  # per-slot positions: [B, S]
        qpos = (torch.as_tensor(pos, device=x.device).to(torch.int32)
                .reshape(-1, 1) + torch.arange(S, device=x.device))
    else:
        qpos = pos + torch.arange(S, device=x.device)
    q = apply_rope(q, qpos, fraction=rope_fraction, theta=rope_theta)
    k = apply_rope(k, qpos, fraction=rope_fraction, theta=rope_theta)

    if paged:
        from repro_torch.serving.paged_cache import (
            paged_prefill_chunk_update_and_attend, paged_update_and_attend)
        if S == 1:
            out, new_cache = paged_update_and_attend(
                cache, q[:, 0], k, v, pos, page_table, backend=backend)
            out = out[:, None]
        else:
            out, new_cache = paged_prefill_chunk_update_and_attend(
                cache, q, k, v, pos, page_table, backend=backend)
    elif cache is None:
        out = causal_attention(q, k, v, q_offset=int(pos))
        new_cache = {"k": k, "v": v}
    else:
        raise NotImplementedError("the dense float KV cache is not ported "
                                  "yet; serve through the paged cache")
    out = dense(p["wo"], out.reshape(B, S, n_heads * head_dim), tap=tap,
                backend=backend)
    return out, new_cache
