"""GQA attention block (port of ``repro/models/attention.py``, three modes).

  * ``cache is None``: full-sequence attention, used by calibration,
    training and the encoder.  A plain softmax over the masked scores
    (``causal_attention``; ``full_attention`` when ``causal`` is False,
    the encoder's); a ``local`` layer's sliding window goes
    through ``local_attention``, the same masked softmax per query chunk
    over the keys that chunk can see, so nothing of size [S, S] is made.
    Cross-attention (``xkv``, the encoder's output) takes K and V from
    ``xkv``, attends without a mask and applies no RoPE.
    The JAX package's chunked online-softmax form and its windowed
    gather are TPU memory layouts of the same functions, not kernels.
  * ``cache = {"k", "v"}``: single-token decode against the dense float
    KV cache of the dense ``ServingEngine`` (``update_kv_cache`` then
    ``decode_attention``; a ``local`` layer's cache is a ring buffer of
    ``min(window, cache_len)`` slots), ``pos`` a scalar or a per-slot [B]
    vector of the token's position.
  * ``cache = {"k_pages", "v_pages", "k_exp", "v_exp"}``: decode (S=1) or
    a prefill chunk (S>1) against the paged INT8 KV cache
    (``repro_torch.serving.paged_cache``), ``pos`` a per-slot [B] vector
    of the chunk's first position and ``page_table`` [B, n_max]; full
    attention only, as in the reference.

A ``softcap`` c bounds the scaled float32 scores as ``c * tanh(s / c)``
before the mask, in every mode that takes one.
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


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """q [B, Sq, Hq, hd] against k/v [B, Sk, Hkv, hd] where ``mask``
    ([Sq, Sk], or [B, 1, 1, Sq, Sk]; None: every key) is True -> [B, Sq,
    Hq, hd] in v.dtype; GQA groups query heads as ``reshape(B, Sq, Hkv,
    G, hd)``."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, hd),
                     k).float() * (1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, hd).to(v.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0, window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """The reference's ``multi_head_attention`` (causal): q [B, S, Hq, hd],
    k/v [B, Skv, Hkv, hd] -> [B, S, Hq, hd], the keys at positions 0.. and
    the queries at ``q_offset``..; ``window`` keeps the keys less than
    ``window`` positions back."""
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return _attend(q, k, v, mask, softcap)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   softcap: float | None = None) -> torch.Tensor:
    """The reference's ``multi_head_attention(causal=False)``: every query
    of q [B, Sq, Hq, hd] sees every key of k/v [B, Skv, Hkv, hd] (the
    encoder's self-attention, cross-attention), one [Sq, Skv] score
    block per head as in ``causal_attention``."""
    return _attend(q, k, v, None, softcap)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, softcap: float | None = None,
                    chunk_q: int = 512) -> torch.Tensor:
    """Sliding-window causal attention over a full sequence: query i sees
    keys i - window + 1 .. i.  Queries go in chunks of ``chunk_q``, each
    against the ``window + chunk_q - 1`` keys it can see, so the scores
    never exceed [chunk_q, window + chunk_q].  (The reference's
    ``q_offset`` shifts queries and keys alike and cancels.)"""
    S = q.shape[1]
    outs = []
    for c0 in range(0, S, chunk_q):
        c1 = min(c0 + chunk_q, S)
        k0 = max(0, c0 - window + 1)
        diff = (torch.arange(c0, c1, device=q.device)[:, None]
                - torch.arange(k0, c1, device=q.device)[None, :])
        mask = (diff >= 0) & (diff < window)
        outs.append(_attend(q[:, c0:c1], k[:, k0:c1], v[:, k0:c1], mask,
                            softcap))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _slot_positions(pos, batch: int, device) -> torch.Tensor:
    """A scalar or per-slot position as an int64 [batch] vector."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(
        -1).expand(batch)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, window: int | None = None,
                     ring: bool = False,
                     softcap: float | None = None) -> torch.Tensor:
    """q [B, 1, Hq, hd] against caches [B, Skv, Hkv, hd]; ``pos`` (a scalar
    or [B]) is the position of the current token, already written.
    ``ring``: slot s of the cache holds logical position ``pos - ((pos -
    s) mod Skv)`` (negative: never written)."""
    B, Skv = q.shape[0], k_cache.shape[1]
    pos = _slot_positions(pos, B, q.device)[:, None]
    slots = torch.arange(Skv, device=q.device)[None, :]
    if ring:
        logical = pos - torch.remainder(pos - slots, Skv)
        valid = logical >= 0
    else:
        logical = slots
        valid = slots <= pos
    if window is not None:
        valid &= (pos - logical) < window
    return _attend(q, k_cache, v_cache, valid[:, None, None, None, :],
                   softcap)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, pos, *,
                    ring: bool = False):
    """Write k/v_new [B, S, Hkv, hd] at position ``pos`` (a scalar or [B];
    ``ring``: at ``pos mod Skv``); returns new caches.  As the reference's
    ``dynamic_update_slice``, a start past ``Skv - S`` is clamped to it."""
    B, Skv = k_cache.shape[:2]
    S = k_new.shape[1]
    idx = _slot_positions(pos, B, k_cache.device)
    if ring:
        idx = torch.remainder(idx, Skv)
    start = torch.clamp(idx, 0, Skv - S)
    rows = (start[:, None]
            + torch.arange(S, device=k_cache.device)[None, :])
    slot = torch.arange(B, device=k_cache.device)[:, None].expand(B, S)
    return (k_cache.index_put((slot, rows), k_new.to(k_cache.dtype)),
            v_cache.index_put((slot, rows), v_new.to(v_cache.dtype)))


def attention_block(p: Params, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int,
                    rope_fraction: float = 1.0, rope_theta: float = 10000.0,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    cache: Params | None = None, pos=0,
                    xkv: torch.Tensor | None = None, use_rope: bool = True,
                    tap: list | None = None, backend=None, page_table=None):
    """Projections + RoPE + attention; returns (out, new_cache).

    ``xkv`` [B, Skv, d] (cross-attention, full sequence only): K and V
    are projected from it, every query sees every key, and no RoPE is
    applied (the encoder's output carries no positions).  ``causal``
    False (the encoder) attends without the causal mask."""
    B, S, _ = x.shape
    src = x if xkv is None else xkv
    q = dense(p["wq"], x, tap=tap, backend=backend).reshape(
        B, S, n_heads, head_dim)
    k = dense(p["wk"], src, tap=tap, backend=backend).reshape(
        B, src.shape[1], n_kv_heads, head_dim)
    v = dense(p["wv"], src, tap=tap, backend=backend).reshape(
        B, src.shape[1], n_kv_heads, head_dim)
    if use_rope and xkv is None:
        if cache is not None:  # per-slot positions: [B, S] (or [1, S])
            qpos = (torch.as_tensor(pos, device=x.device).to(torch.int32)
                    .reshape(-1, 1) + torch.arange(S, device=x.device))
        else:
            qpos = pos + torch.arange(S, device=x.device)
        q = apply_rope(q, qpos, fraction=rope_fraction, theta=rope_theta)
        k = apply_rope(k, qpos, fraction=rope_fraction, theta=rope_theta)

    if cache is not None and "k_pages" in cache:
        if window is not None or softcap is not None:
            raise NotImplementedError(
                "paged INT8 KV decode serves full attention only (no "
                "sliding window / softcap)")
        from repro_torch.serving.paged_cache import (
            paged_prefill_chunk_update_and_attend, paged_update_and_attend)
        if S == 1:
            out, new_cache = paged_update_and_attend(
                cache, q[:, 0], k, v, pos, page_table, backend=backend)
            out = out[:, None]
        else:
            out, new_cache = paged_prefill_chunk_update_and_attend(
                cache, q, k, v, pos, page_table, backend=backend)
    elif cache is not None:  # decode against the dense float cache
        if S != 1:
            raise ValueError(f"the dense KV cache decodes one token per "
                             f"call, got {S}")
        ring = window is not None
        kc, vc = update_kv_cache(cache["k"], cache["v"], k, v, pos,
                                 ring=ring)
        out = decode_attention(q, kc, vc, pos, window=window, ring=ring,
                               softcap=softcap)
        new_cache = {"k": kc, "v": vc}
    else:
        if xkv is None and window is not None:
            out = local_attention(q, k, v, window=window, softcap=softcap)
        elif xkv is not None or not causal:
            out = full_attention(q, k, v, softcap=softcap)
        else:
            out = causal_attention(q, k, v, q_offset=int(pos),
                                   softcap=softcap)
        new_cache = {"k": k, "v": v}
    out = dense(p["wo"], out.reshape(B, S, n_heads * head_dim), tap=tap,
                backend=backend)
    return out, new_cache
