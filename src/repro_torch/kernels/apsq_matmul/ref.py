"""Torch integer oracle for the APSQ matmul kernels.

Port of ``repro/kernels/apsq_matmul/ref.py``: the true-integer semantics
of Algorithm 1 (paper §III) that the CUDA kernels in ``csrc/`` must
match bit for bit.

  * activations / weights are INT8 codes; each K-tile product
    accumulates exactly (int64 on the CPU; float64 on the card, where
    torch has no integer matmul — exact because every tile sum is below
    2^53) and wraps to int32 like the reference's int32 accumulator,
  * every stored PSUM is an INT8 code with a power-of-two scale ``2^e_i``
    (product-scale units): quantization is an arithmetic right shift
    with round-half-up, dequantization a left shift,
  * group starts apply APSQ, tails plain PSQ, the final tile is
    requantized once more and dequantized to INT32.

Shifts follow XLA's semantics, spelled out because C++ and CUDA leave
them undefined: a left shift by a count outside [0, 32) gives 0, an
arithmetic right shift by such a count fills with the sign bit, and
int32 adds and left shifts wrap.
"""
from __future__ import annotations

import torch

from repro_torch.core.po2 import ceil_log2

INT8_MIN, INT8_MAX = -128, 127


def _i32(e, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(e, device=like.device).to(torch.int32)


def shift_left(a: torch.Tensor, s) -> torch.Tensor:
    """int32 ``a << s``; counts outside [0, 32) give 0 (XLA ShiftLeft)."""
    s = _i32(s, a)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, a << s.clamp(0, 31), torch.zeros_like(a))


def shift_right(a: torch.Tensor, s) -> torch.Tensor:
    """int32 arithmetic ``a >> s``; counts outside [0, 32) fill with the
    sign bit (XLA ShiftRightArithmetic)."""
    s = _i32(s, a)
    ok = (s >= 0) & (s < 32)
    return a >> torch.where(ok, s, torch.full_like(s, 31))


def rshift_round(v: torch.Tensor, e) -> torch.Tensor:
    """Arithmetic right shift by ``e`` with round-half-up (RAE shifter):
    ``(v + 2^(e-1)) >> e`` for ``e > 0``, identity for ``e <= 0``."""
    v = v.to(torch.int32)
    e = _i32(e, v)
    one = torch.ones((), dtype=torch.int32, device=v.device)
    bias = torch.where(e > 0, shift_left(one, (e - 1).clamp(min=0)),
                       torch.zeros_like(e))
    return torch.where(e > 0, shift_right(v + bias, e), v)


def quantize_psum(v: torch.Tensor, e) -> torch.Tensor:
    """INT32 PSUM -> INT8 code at scale 2^e (shift + clip)."""
    return rshift_round(v, e).clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize_psum(code: torch.Tensor, e) -> torch.Tensor:
    """INT8 code at scale 2^e -> INT32 value in product-scale units."""
    return shift_left(code.to(torch.int32), e)


def pad_ragged_k(x_codes: torch.Tensor, w_codes: torch.Tensor, n_p: int):
    """Zero-pad K up to ``n_p * ceil(K / n_p)`` (remainder PSUM group);
    ``[..., M, K]`` / ``[..., K, N]``, leading (expert) dims kept."""
    k = x_codes.shape[-1]
    pad = (-k) % n_p
    if pad:
        x_codes = torch.nn.functional.pad(x_codes, (0, pad))
        w_codes = torch.nn.functional.pad(w_codes, (0, 0, 0, pad))
    return x_codes, w_codes


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 operands ``[..., K] @ [..., K, N]``,
    wrapped to int32."""
    if a.device.type == "cpu":
        out = torch.matmul(a.to(torch.int64), b.to(torch.int64))
    else:  # no integer matmul on the card; |sum| < 2^53 keeps f64 exact
        out = torch.matmul(a.to(torch.float64),
                           b.to(torch.float64)).to(torch.int64)
    return out.to(torch.int32)


def psum_tiles(x_codes: torch.Tensor, w_codes: torch.Tensor,
               n_p: int) -> torch.Tensor:
    """[n_p, ..., M, N] INT32 partial-sum tiles of ``x @ w`` split along
    K, for ``[..., M, K] @ [..., K, N]`` (one batched product per tile)."""
    x_codes, w_codes = pad_ragged_k(x_codes, w_codes, n_p)
    *lead, m, k = x_codes.shape
    n = w_codes.shape[-1]
    kt = k // n_p
    xt = x_codes.reshape(*lead, m, n_p, kt).movedim(-2, 0)  # [n_p,..,M,kt]
    wt = w_codes.reshape(*lead, n_p, kt, n).movedim(-3, 0)  # [n_p,..,kt,N]
    return int_matmul(xt, wt)


def _algorithm1(tiles: torch.Tensor, exp_at, n_p: int,
                gs: int) -> torch.Tensor:
    """Algorithm 1 over PSUM ``tiles`` [n_p, ...]; ``exp_at(i)`` is tile
    i's exponent, broadcastable against a tile.  Every op is elementwise,
    so a leading expert axis gives E independent recurrences."""
    assert gs >= 1
    stored: list = [None] * n_p
    for i in range(0, n_p, gs):  # group starts
        acc = tiles[i]
        for j in range(max(0, i - gs), i):  # previous group's stored codes
            acc = acc + dequantize_psum(stored[j], exp_at(j))
        code = quantize_psum(acc, exp_at(i))  # APSQ
        stored[i] = code
        if i == n_p - 1:
            return dequantize_psum(code, exp_at(i))
        for j in range(i + 1, min(i + gs, n_p)):
            if j < n_p - 1:
                stored[j] = quantize_psum(tiles[j], exp_at(j))  # PSQ tail
            else:  # final tile closes out mid-group
                acc = tiles[j]
                for l in range(i, n_p - 1):
                    acc = acc + dequantize_psum(stored[l], exp_at(l))
                code = quantize_psum(acc, exp_at(j))
                return dequantize_psum(code, exp_at(j))
    raise AssertionError("unreachable")


def apsq_matmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                    exps: torch.Tensor, *, n_p: int, gs: int) -> torch.Tensor:
    """INT8 x INT8 GEMM with Algorithm-1 PSUM handling -> INT32 [M, N].

    ``exps``: [n_p] or [n_p, N] int32 shift exponents (product-scale
    units).  Returns ``AP*_{n_p-1} << e_{n_p-1}``.
    """
    exps = exps.to(torch.int32)
    return _algorithm1(psum_tiles(x_codes, w_codes, n_p),
                       lambda i: exps[i], n_p, gs)


def apsq_expert_matmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                           exps: torch.Tensor, *, gs: int) -> torch.Tensor:
    """Stacked expert bank: [E, M, K] @ [E, K, N] -> INT32 [E, M, N].

    ``exps``: [E, n_p] or [E, n_p, N].  Bit-identical to E calls of
    ``apsq_matmul_ref`` (the JAX oracle's unrolled form), computed with
    one batched product per PSUM tile instead of a loop over experts.
    """
    n_p = int(exps.shape[1])
    exps = exps.to(torch.int32)
    if exps.dim() == 2:
        exp_at = lambda i: exps[:, i, None, None]           # [E, 1, 1]
    else:
        exp_at = lambda i: exps[:, i, None, :]              # [E, 1, N]
    return _algorithm1(psum_tiles(x_codes, w_codes, n_p), exp_at, n_p, gs)


def baseline_matmul_ref(x_codes: torch.Tensor,
                        w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator W8A8 GEMM (the high-precision-PSUM baseline)."""
    return int_matmul(x_codes, w_codes)


def baseline_expert_matmul_ref(x_codes: torch.Tensor,
                               w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator expert GEMM: [E, M, K] @ [E, K, N] -> [E, M, N]."""
    return int_matmul(x_codes, w_codes)


def choose_exps(x_codes: torch.Tensor, w_codes: torch.Tensor, *, n_p: int,
                gs: int) -> torch.Tensor:
    """Per-tile exponents from running-PSUM magnitudes (calibration
    helper): the smallest shift whose INT8 range covers the running
    accumulation, clamped to >= 0."""
    tiles = psum_tiles(x_codes, w_codes, n_p)
    running = torch.cumsum(tiles.to(torch.int64), dim=0).to(torch.int32)
    mags = running.abs().amax(dim=(1, 2))
    exps = ceil_log2(mags.clamp(min=1).float() / INT8_MAX)
    return exps.clamp(min=0)
