"""Wrapper of the INT8-KV attention kernel (port of
``kernels/int8_kv_attention/ops.py``).

A tensor on the CPU goes to the plain version (``ref``); a CUDA tensor
goes to the kernel in ``csrc/int8_kv_attention.cu`` or raises.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .._build import NUM_SMS
from . import ref

# compiled instances: the tests, smoke configs, TinyLlama, OLMoE
HEAD_DIMS = (8, 16, 64, 128)

TILE_S = 32          # cache positions per tile of the kernel
WARPS = 4            # warps per block of the kernel
MIN_SPLIT_TILES = 4  # shortest split: a shorter walk costs less than the
                     # merge kernel a split brings
MAX_BLOCKS = 4 * NUM_SMS   # beyond this, two rows per warp instead of one


class AttentionPlan(NamedTuple):
    """How the kernel cuts one call: ``rows_per_warp`` query rows per
    warp (``WARPS`` warps per block), ``row_blocks`` blocks over the C*G
    rows of a kv-head, and S cut into ``n_split`` splits of ``split_len``
    positions (the last one shorter where S is not a multiple)."""
    rows_per_warp: int
    row_blocks: int
    n_split: int
    split_len: int


@functools.lru_cache(maxsize=256)
def attention_plan(B: int, C: int, Hq: int, Hkv: int,
                   S: int) -> AttentionPlan:
    """The kernel's grid for q [B, C, Hq, hd] over a cache of S positions,
    a pure function of the shapes (so a call repeats its result bit for
    bit).  One query row per warp, two where the blocks would pass
    ``MAX_BLOCKS``.  S is split (flash-decoding) only where rows, heads
    and batch give fewer blocks than the card has SMs and S holds at
    least two splits of ``MIN_SPLIT_TILES`` tiles; then into splits of
    that length, or longer ones where ``MAX_BLOCKS`` is reached first."""
    rows = C * (Hq // Hkv)
    for rw in (1, 2):
        row_blocks = math.ceil(rows / (WARPS * rw))
        if row_blocks * Hkv * B <= MAX_BLOCKS:
            break
    base = row_blocks * Hkv * B
    tiles = max(1, math.ceil(S / TILE_S))
    if base >= NUM_SMS or tiles < 2 * MIN_SPLIT_TILES:
        return AttentionPlan(rw, row_blocks, 1, tiles * TILE_S)
    per = max(MIN_SPLIT_TILES, tiles // math.ceil(MAX_BLOCKS / base))
    return AttentionPlan(rw, row_blocks, math.ceil(tiles / per),
                         per * TILE_S)


def int8_kv_attention(q: torch.Tensor, k_codes: torch.Tensor,
                      v_codes: torch.Tensor, k_exp: torch.Tensor,
                      v_exp: torch.Tensor, length) -> torch.Tensor:
    """Attention over an INT8 cache, matching q's rank (3-D decode row,
    4-D causal prefill chunk ending at ``length - 1``); output in q's
    dtype."""
    B, S, Hkv, hd = k_codes.shape
    length = torch.as_tensor(length, device=q.device).to(torch.int32)
    length = length.reshape(-1).expand(B).contiguous()
    if q.device.type == "cpu":
        return ref.int8_kv_attention_ref(q, k_codes, v_codes, k_exp, v_exp,
                                         length)
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError("KV codes must be int8")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    C, Hq = q4.shape[1], q4.shape[2]
    if (Hq % Hkv or q4.shape[0] != B or q4.shape[3] != hd
            or v_codes.shape != k_codes.shape
            or tuple(k_exp.shape) != (B, Hkv)
            or tuple(v_exp.shape) != (B, Hkv)):
        raise ValueError(f"q {tuple(q.shape)}, exps {tuple(k_exp.shape)} "
                         f"do not match cache {tuple(k_codes.shape)}")
    if not all(t.device == q.device for t in (k_codes, v_codes, k_exp,
                                                v_exp)):
        raise ValueError("attention operands on different devices")
    qf = q4.float().contiguous()
    out = torch.empty_like(qf)
    # the kernel copies codes 4 at a time: rows must start 4-byte aligned
    kc, vc = (t if t.is_contiguous() and t.data_ptr() % 4 == 0
              else t.clone(memory_format=torch.contiguous_format)
              for t in (k_codes, v_codes))
    # 16 at a time where every row starts 16-byte aligned
    vec16 = hd % 16 == 0 and kc.data_ptr() % 16 == 0 \
        and vc.data_ptr() % 16 == 0
    ke = k_exp.to(torch.int32).contiguous()
    ve = v_exp.to(torch.int32).contiguous()
    plan = attention_plan(B, C, Hq, Hkv, S)
    # split partials: acc [n_split, B*C*Hq, hd], then (m, l) per row
    part = (torch.empty(plan.n_split * B * C * Hq * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if plan.n_split > 1 else out)
    err = _build.entry("int8_kv_attention")(
        qf.data_ptr(), kc.data_ptr(), vc.data_ptr(), ke.data_ptr(),
        ve.data_ptr(), length.data_ptr(), out.data_ptr(), part.data_ptr(),
        B, C, Hq, S, Hkv, hd, 1.0 / math.sqrt(hd), plan.rows_per_warp,
        plan.n_split, plan.split_len, int(vec16),
        _build.stream_ptr(q.device))
    _build.check(err, "int8_kv_attention")
    out = out.to(q.dtype)
    return out[:, 0] if squeeze else out
