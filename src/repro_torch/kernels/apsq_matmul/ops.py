"""Wrappers of the APSQ GEMM kernels (port of ``kernels/apsq_matmul/ops.py``).

A tensor on the CPU goes to the plain version (``ref``); a CUDA tensor
goes to the hand-written kernel in ``csrc/apsq_matmul.cu`` or raises.
There is no fallback between the two.  The wrapper zero-pads ragged
``K % n_p`` (``ref.pad_ragged_k``), checks types and shapes, allocates
the output, launches on the current stream and counts the launch.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .._build import NUM_SMS
from . import ref

# Largest number of live INT8 bank codes per output element the kernel
# keeps in registers (two packed 64-bit words).
MAX_BANKS = 16

W8_BN = 64           # columns per block of the W8A8 tensor-core kernel
W8_KS = 64           # K rows per warp slice of it
W8_WARPS = 4         # warps per block of it


class BaselinePlan(NamedTuple):
    """How the W8A8 kernel cuts [M, K] @ [K, N]: ``bm`` rows per block
    (16 or 32), K in ``splits`` ranges of ``k_split`` rows (a multiple of
    ``W8_WARPS * W8_KS``; the last range shorter where K is not a
    multiple)."""
    bm: int
    splits: int
    k_split: int


@functools.lru_cache(maxsize=256)
def baseline_plan(m: int, n: int, k: int) -> BaselinePlan:
    """A pure function of the shapes: K is split over blocks until about
    three blocks per SM are busy, in ranges of whole rounds of K slices
    (one slice per warp), so every warp of a block has work."""
    bm = 16 if m <= 16 else 32
    tiles = math.ceil(n / W8_BN) * math.ceil(m / bm)
    rnd = W8_WARPS * W8_KS                    # K rows per round of slices
    splits = max(1, int(3 * NUM_SMS / tiles + 0.5))
    k_split = max(1, math.ceil(k / splits / rnd)) * rnd
    return BaselinePlan(bm, max(1, math.ceil(k / k_split)), k_split)


def _check_operands(x_codes, w_codes, *, experts: bool = False):
    """int8 [M, K] @ [K, N], or [E, M, K] @ [E, K, N] for an expert bank,
    on one device."""
    if x_codes.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise TypeError("APSQ GEMM takes int8 codes, got "
                        f"{x_codes.dtype} and {w_codes.dtype}")
    nd = 3 if experts else 2
    if (x_codes.dim() != nd or w_codes.dim() != nd
            or x_codes.shape[:-2] != w_codes.shape[:-2]
            or x_codes.shape[-1] != w_codes.shape[-2]):
        form = "[E,M,K] @ [E,K,N]" if experts else "[M,K] @ [K,N]"
        raise ValueError(f"shapes {tuple(x_codes.shape)} @ "
                         f"{tuple(w_codes.shape)} do not form {form}")
    if x_codes.device != w_codes.device:
        raise ValueError("operands on different devices")


def apsq_matmul_int8(x_codes: torch.Tensor, w_codes: torch.Tensor,
                     exps: torch.Tensor, *, gs: int) -> torch.Tensor:
    """INT8 GEMM with Algorithm-1 PSUM handling -> INT32 [M, N].

    ``n_p`` is ``exps.shape[0]``; ``exps`` is [n_p] or [n_p, N].  M == 1
    takes the decode kernel (``apsq_matmul_m1``), any other M the
    generic one (``apsq_matmul``); both are bit-identical to ``ref``.
    """
    _check_operands(x_codes, w_codes)
    n_p = int(exps.shape[0])
    if x_codes.device.type == "cpu":
        return ref.apsq_matmul_ref(x_codes, w_codes, exps, n_p=n_p, gs=gs)
    m, n = x_codes.shape[0], w_codes.shape[1]
    if exps.dim() == 2 and tuple(exps.shape) != (n_p, n):
        raise ValueError(f"exps {tuple(exps.shape)} != [n_p, N]=({n_p}, {n})")
    gs_eff = min(int(gs), n_p)   # gs >= n_p is PSQ: one group over all tiles
    if gs_eff < 1 or gs_eff > MAX_BANKS:
        raise ValueError(f"gs={gs} (n_p={n_p}): the CUDA kernel keeps at "
                         f"most {MAX_BANKS} bank codes")
    x_codes, w_codes = ref.pad_ragged_k(x_codes, w_codes, n_p)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e = exps.to(device=x.device, dtype=torch.int32).contiguous()
    bk = x.shape[1] // n_p
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = _build.stream_ptr(x.device)
    if m == 1:
        err = _build.entry("apsq_matmul_m1")(
            x.data_ptr(), w.data_ptr(), e.data_ptr(), out.data_ptr(),
            n, n_p, bk, gs_eff, int(e.dim() == 2), stream)
        _build.check(err, "apsq_matmul_m1")
    else:
        err = _build.entry("apsq_matmul")(
            x.data_ptr(), w.data_ptr(), e.data_ptr(), out.data_ptr(),
            m, n, n_p, bk, gs_eff, int(e.dim() == 2), stream)
        _build.check(err, "apsq_matmul")
    return out


def apsq_expert_matmul_int8(x_codes: torch.Tensor, w_codes: torch.Tensor,
                            exps: torch.Tensor, *,
                            gs: int) -> torch.Tensor:
    """Stacked expert bank [E, M, K] @ [E, K, N] with Algorithm-1 PSUM
    handling -> INT32 [E, M, N], all experts in one launch.

    ``exps`` is [E, n_p] or [E, n_p, N]; bit-identical to
    ``ref.apsq_expert_matmul_ref`` (E calls of the 2-D oracle)."""
    _check_operands(x_codes, w_codes, experts=True)
    e_, m, _ = x_codes.shape
    n = w_codes.shape[2]
    if exps.dim() not in (2, 3) or exps.shape[0] != e_ or (
            exps.dim() == 3 and exps.shape[2] != n):
        raise ValueError(f"exps {tuple(exps.shape)} is not [E, n_p] or "
                         f"[E, n_p, N] for E={e_}, N={n}")
    if x_codes.device.type == "cpu":
        return ref.apsq_expert_matmul_ref(x_codes, w_codes, exps, gs=gs)
    n_p = int(exps.shape[1])
    gs_eff = min(int(gs), n_p)
    if gs_eff < 1 or gs_eff > MAX_BANKS:
        raise ValueError(f"gs={gs} (n_p={n_p}): the CUDA kernel keeps at "
                         f"most {MAX_BANKS} bank codes")
    x_codes, w_codes = ref.pad_ragged_k(x_codes, w_codes, n_p)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e = exps.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((e_, m, n), dtype=torch.int32, device=x.device)
    if e_ == 0 or m == 0 or n == 0:
        return out
    err = _build.entry("apsq_expert_matmul")(
        x.data_ptr(), w.data_ptr(), e.data_ptr(), out.data_ptr(), e_, m, n,
        n_p, x.shape[2] // n_p, gs_eff, int(e.dim() == 3),
        _build.stream_ptr(x.device))
    _build.check(err, "apsq_expert_matmul")
    return out


def baseline_expert_matmul_int8(x_codes: torch.Tensor,
                                w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator expert bank [E, M, K] @ [E, K, N] -> [E, M, N]
    in one launch (W8A8 expert layers)."""
    _check_operands(x_codes, w_codes, experts=True)
    if x_codes.device.type == "cpu":
        return ref.baseline_expert_matmul_ref(x_codes, w_codes)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e_, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((e_, m, n), dtype=torch.int32, device=x.device)
    if e_ == 0 or m == 0 or n == 0:
        return out
    err = _build.entry("baseline_expert_matmul")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e_, m, n, k,
        _build.stream_ptr(x.device))
    _build.check(err, "baseline_expert_matmul")
    return out


def baseline_matmul_int8(x_codes: torch.Tensor,
                         w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator W8A8 GEMM -> INT32 [M, N] (layers without PSUM
    exponents; the paper's INT32-PSUM baseline)."""
    _check_operands(x_codes, w_codes)
    if x_codes.device.type == "cpu":
        return ref.baseline_matmul_ref(x_codes, w_codes)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = baseline_plan(m, n, k)
    err = _build.entry("baseline_matmul")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, plan.bm,
        plan.splits, plan.k_split, _build.stream_ptr(x.device))
    _build.check(err, "baseline_matmul")
    return out
