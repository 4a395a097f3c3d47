"""Paged INT8 KV cache (port of ``repro/serving/paged_cache.py``).

One attention layer's cache is a pool of fixed-size pages shared by all
request slots,

    k_pages / v_pages : int8  [n_pages, page_size, Hkv, hd]
    k_exp  / v_exp    : int32 [max_slots, Hkv]

and a host-side page table ([max_slots, pages_per_slot] physical ids)
maps each slot's positions onto pool pages.  Page 0 is the null page:
unallocated entries point at it, writes to it are junk and reads of it
are masked by the valid length.

Scales are powers of two per (slot, kv-head).  The running exponent only
grows; growing it requantizes a slot's codes with an integer
round-half-up right shift (``_shift_codes``), never a float pass, so a
slot's cache depends only on its own tokens.  Exponents come from the
exact helper ``repro_torch.core.po2.ceil_log2``.  Fresh slots start at
``EXP_FLOOR = -24``; KV codes clip to +-127.

The functions are pure, as in the JAX package: they return new pools.
The prefill chunk's stable/replay choice is a host-side branch.
"""
from __future__ import annotations

import torch

from repro_torch.core.po2 import ceil_log2, pow2
from repro_torch.kernels.apsq_matmul.ref import shift_left, shift_right

NULL_PAGE = 0
EXP_FLOOR = -24


def page_span(start: int, end: int, page_size: int) -> range:
    """Page-aligned start positions of every page holding [start, end)."""
    return range(start - start % page_size, end, page_size)


def po2_exponent(x: torch.Tensor) -> torch.Tensor:
    """Smallest PO2 exponent whose 127-code range covers ``x``:
    [B, S, Hkv, hd] -> int32 [B, Hkv]."""
    amax = x.float().abs().amax(dim=(1, 3))
    return ceil_log2(torch.clamp(amax, min=1e-30) / 127.0)


def quantize_at(x: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """Float [B, S, Hkv, hd] -> int8 codes at the scale 2^exp[B, Hkv]."""
    scale = pow2(exp)[:, None, :, None]
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _shift_codes(codes: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Requantize int8 codes [B, n, P, Hkv, hd] to a coarser scale:
    round-half-up ``>> shift`` ([B, Hkv], >= 0), integer only."""
    sh = shift[:, None, None, :, None].to(torch.int32)
    c = codes.to(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=codes.device)
    half = torch.where(sh > 0, shift_left(one, (sh - 1).clamp(min=0)),
                       torch.zeros_like(sh))
    return torch.clamp(shift_right(c + half, sh), -127, 127).to(torch.int8)


def _bump_token(gathered: torch.Tensor, exp: torch.Tensor,
                x_new: torch.Tensor, pos: torch.Tensor):
    """One token of the running-exponent recurrence on a gathered view
    [B, n_max, P, Hkv, hd]: bump the exponent to cover ``x_new``
    [B, 1, Hkv, hd], requantize old codes by shift, write the new codes
    at ``pos`` [B]."""
    page_size = gathered.shape[2]
    b_idx = torch.arange(x_new.shape[0], device=x_new.device)
    new_exp = torch.maximum(exp, po2_exponent(x_new))
    gathered = _shift_codes(gathered, new_exp - exp)
    codes = quantize_at(x_new, new_exp)
    pos = pos.long()
    gathered[b_idx, pos // page_size, pos % page_size] = codes[:, 0]
    return gathered, new_exp


def _scatter_pages(pages, page_table, gathered):
    """Write each slot's gathered view [B, n_max, P, Hkv, hd] back to its
    pages.  Table rows repeat the null page (an idle slot's row is all
    null pages), so indices collide.  Every colliding entry writes the
    data of the LAST such entry in row-major order -- what a sequential
    scatter leaves, as on the CPU -- so the pool does not depend on the
    order a parallel scatter applies duplicates.  It matters for MoE:
    idle slots attend over the null page and their routing takes expert
    capacity from live tokens."""
    idx = page_table.long().reshape(-1)
    order = torch.arange(idx.numel(), device=idx.device)
    last = torch.where(idx[:, None] == idx[None, :], order[None, :],
                       -1).amax(dim=1)
    src = gathered.reshape(idx.numel(), *gathered.shape[2:])[last]
    return pages.index_put((idx,), src)


def _update_pool(pages, exp, x_new, pos, page_table):
    """Write one token per slot; returns (pages', exp', gathered view)."""
    gathered, new_exp = _bump_token(pages[page_table.long()], exp, x_new, pos)
    pages = _scatter_pages(pages, page_table, gathered)
    return pages, new_exp, gathered


def _update_pool_chunk(pages, exp, x_new, pos, page_table):
    """Write a [B, C] chunk by replaying the per-token bump recurrence
    (round-half-up shifts do not compose).  Returns (pages', exp',
    gathered, exps_seq [C, B, Hkv])."""
    g, e = pages[page_table.long()], exp
    seq = []
    for t in range(x_new.shape[1]):
        g, e = _bump_token(g, e, x_new[:, t:t + 1], pos + t)
        seq.append(e)
    pages = _scatter_pages(pages, page_table, g)
    return pages, e, g, torch.stack(seq)


def paged_update_and_attend(cache: dict, q, k_new, v_new, pos, page_table,
                            *, backend=None):
    """One decode step: write then attend.  q [B, Hq, hd]; k_new/v_new
    [B, 1, Hkv, hd] (roped); pos [B] (position written).  On a mesh the
    backend keeps this rank's heads of the new rows (its pools hold only
    those) and gathers every head's output at the end."""
    from repro_torch.exec import execute_kv_attention, get_backend
    backend = get_backend(backend)
    n_heads = q.shape[-2]
    q, k_new, v_new = backend.local_heads(q, k_new, v_new)
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32)
    k_pages, k_exp, gk = _update_pool(cache["k_pages"], cache["k_exp"],
                                      k_new, pos, page_table)
    v_pages, v_exp, gv = _update_pool(cache["v_pages"], cache["v_exp"],
                                      v_new, pos, page_table)
    b, n_max, page_size = gk.shape[:3]
    k_seq = gk.reshape(b, n_max * page_size, *gk.shape[3:])
    v_seq = gv.reshape(b, n_max * page_size, *gv.shape[3:])
    out = execute_kv_attention(q, k_seq, v_seq, k_exp, v_exp, pos + 1,
                               backend=backend)
    return backend.gather_heads(out, n_heads), {
        "k_pages": k_pages, "v_pages": v_pages, "k_exp": k_exp,
        "v_exp": v_exp}


def paged_prefill_chunk_update_and_attend(cache: dict, q, k_new, v_new, pos,
                                          page_table, *, backend=None):
    """One prefill chunk, bit-identical to C decode steps.

    q [B, C, Hq, hd]; k_new/v_new [B, C, Hkv, hd]; pos [B] = the chunk's
    first position.  Stable regime (the exponents after the chunk's first
    token already cover the chunk): one chunked attention call.  Replay
    regime (a later token bumped an exponent, so earlier rows saw finer
    codes): replay the per-row snapshots from the pre-chunk pools.  On a
    mesh each rank takes the regime of its own heads (the two give the
    same values) and the heads are gathered once, after either.
    """
    from repro_torch.exec import execute_kv_attention, get_backend
    backend = get_backend(backend)
    n_heads = q.shape[-2]
    q, k_new, v_new = backend.local_heads(q, k_new, v_new)
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32)
    chunk = q.shape[1]
    page_size = cache["k_pages"].shape[1]
    gk0 = cache["k_pages"][page_table.long()]
    gv0 = cache["v_pages"][page_table.long()]
    k_pages, k_exp, gk, k_exps = _update_pool_chunk(
        cache["k_pages"], cache["k_exp"], k_new, pos, page_table)
    v_pages, v_exp, gv, v_exps = _update_pool_chunk(
        cache["v_pages"], cache["v_exp"], v_new, pos, page_table)
    b, n_max = gk.shape[:2]
    seq = n_max * page_size
    stable = bool(torch.equal(k_exps[0], k_exp)
                  and torch.equal(v_exps[0], v_exp))
    if stable:
        out = execute_kv_attention(
            q, gk.reshape(b, seq, *gk.shape[3:]),
            gv.reshape(b, seq, *gv.shape[3:]), k_exp, v_exp, pos + chunk,
            backend=backend)
    else:
        cgk, cke, cgv, cve = gk0, cache["k_exp"], gv0, cache["v_exp"]
        outs = []
        for t in range(chunk):
            cgk, cke = _bump_token(cgk, cke, k_new[:, t:t + 1], pos + t)
            cgv, cve = _bump_token(cgv, cve, v_new[:, t:t + 1], pos + t)
            outs.append(execute_kv_attention(
                q[:, t], cgk.reshape(b, seq, *cgk.shape[3:]),
                cgv.reshape(b, seq, *cgv.shape[3:]), cke, cve, pos + t + 1,
                backend=backend))
        out = torch.stack(outs, dim=1)
    return backend.gather_heads(out, n_heads), {
        "k_pages": k_pages, "v_pages": v_pages, "k_exp": k_exp,
        "v_exp": v_exp}
