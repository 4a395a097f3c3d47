"""Wrappers of the APSQ GEMM kernels (port of ``kernels/apsq_matmul/ops.py``).

A tensor on the CPU goes to the plain version (``ref``); a CUDA tensor
goes to the hand-written kernel in ``csrc/apsq_matmul.cu`` or raises.
There is no fallback between the two.  The wrapper zero-pads ragged
``K % n_p`` (``ref.pad_ragged_k``), checks types and shapes, allocates
the output, launches on the current stream and counts the launch.
``quantize_operands``, ``apsq_matmul_f32`` and ``calibrate_exps`` are
the float entry and the calibration helper of the JAX package's ops.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .._build import NUM_SMS
from . import ref

W8_BN = 64           # columns per block of the tensor-core kernels
W8_KS = 64           # K rows per warp slice of them
W8_WARPS = 4         # warps per block of them
M1_BM = 1            # the APSQ body at M == 1: 1 = one-row dp4a, 16 = mma

XS_BM = 16           # rows per block of the expert kernels: one m16 tile
EXPERT_STAGES = 4    # stages in their ring of weight tiles


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


class ApsqPlan(NamedTuple):
    """How the APSQ kernels cut [M, K] @ [K, N] into PSUM-tile partials:
    ``bm`` rows per block (16 or 32 on the tensor cores; 1 is the one-row
    body, M == 1 only), each tile's ``bk`` K rows in ``splits`` ranges
    of ``k_split`` rows (a multiple of ``W8_WARPS * W8_KS``; the last
    range shorter), never across a tile's end.  The partials go to a
    [n_p * splits, M, N] int32 scratch, one slot per block, and a second
    kernel (the epilogue) walks Algorithm 1 over them."""
    bm: int
    splits: int
    k_split: int


@functools.lru_cache(maxsize=256)
def apsq_plan(m: int, n: int, k: int, n_p: int) -> ApsqPlan:
    """A pure function of the shapes (``k`` before or after the ragged
    pad): as ``baseline_plan``, each PSUM tile is split until about
    three blocks per SM are busy, in whole rounds of K slices."""
    bm = M1_BM if m == 1 else (16 if m <= 16 else 32)
    bk = math.ceil(k / n_p)
    blocks = math.ceil(n / W8_BN) * math.ceil(m / bm) * n_p
    rnd = W8_WARPS * W8_KS
    splits = max(1, int(3 * NUM_SMS / blocks + 0.5))
    k_split = max(1, math.ceil(bk / splits / rnd)) * rnd
    return ApsqPlan(bm, max(1, math.ceil(bk / k_split)), k_split)


class ExpertPlan(NamedTuple):
    """How the expert kernels cut [E, M, K] @ [E, K, N]: a block owns
    ``bn`` columns (64 or 128: 32 per warp) x ``bm`` rows (16) of one
    expert and walks all of K, streaming the weights through a ring of
    ``stages`` shared stages of 64 K rows; a stage never crosses a PSUM
    tile's end, and a tile's last stage brings its exponents."""
    bn: int
    stages: int
    bm: int


@functools.lru_cache(maxsize=256)
def expert_plan(e: int, m: int, n: int, k: int, n_p: int) -> ExpertPlan:
    """A pure function of the shapes: 128 columns per block where that
    still gives two blocks per SM, else 64.  K and the PSUM tiles set only
    each block's walk, not the cut, since no block splits K."""
    wide = e * math.ceil(n / 128) * math.ceil(m / XS_BM)
    return ExpertPlan(128 if wide >= 2 * NUM_SMS else 64, EXPERT_STAGES,
                      XS_BM)


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
    Either is one launch count: the tile partials and the Algorithm-1
    epilogue are two kernels of one call (``apsq_plan``).
    """
    _check_operands(x_codes, w_codes)
    n_p = int(exps.shape[0])
    if x_codes.device.type == "cpu":
        return ref.apsq_matmul_ref(x_codes, w_codes, exps, n_p=n_p, gs=gs)
    _build.require_data("apsq_matmul", x_codes, w_codes)
    m, n = x_codes.shape[0], w_codes.shape[1]
    if exps.dim() == 2 and tuple(exps.shape) != (n_p, n):
        raise ValueError(f"exps {tuple(exps.shape)} != [n_p, N]=({n_p}, {n})")
    gs_eff = min(int(gs), n_p)   # gs >= n_p is PSQ: one group over all tiles
    if gs_eff < 1:
        raise ValueError(f"gs={gs} must be >= 1")
    x_codes, w_codes = ref.pad_ragged_k(x_codes, w_codes, n_p)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e = exps.to(device=x.device, dtype=torch.int32).contiguous()
    bk = x.shape[1] // n_p
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = apsq_plan(m, n, x.shape[1], n_p)
    # one int32 partial per (PSUM tile, K range) and output element
    part = torch.empty((n_p * plan.splits, m, n), dtype=torch.int32,
                       device=x.device)
    stream = _build.stream_ptr(x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), e.data_ptr(), part.data_ptr(),
            out.data_ptr())
    name = "apsq_matmul_m1" if m == 1 else "apsq_matmul"
    shape = (n,) if m == 1 else (m, n)
    err = _build.entry(name)(*ptrs, *shape, n_p, bk, gs_eff,
                             int(e.dim() == 2), *plan, stream)
    _build.check(err, name)
    return out


def apsq_expert_matmul_int8(x_codes: torch.Tensor, w_codes: torch.Tensor,
                            exps: torch.Tensor, *,
                            gs: int) -> torch.Tensor:
    """Stacked expert bank [E, M, K] @ [E, K, N] with Algorithm-1 PSUM
    handling -> INT32 [E, M, N], all experts in one launch.

    ``exps`` is [E, n_p] or [E, n_p, N]; bit-identical to
    ``ref.apsq_expert_matmul_ref`` (E calls of the 2-D oracle).  Any gs:
    the kernel keeps one running int32 per output element.  Experts whose
    rows are all zero read no weights (the kernel checks on the card)."""
    _check_operands(x_codes, w_codes, experts=True)
    e_, m, _ = x_codes.shape
    n = w_codes.shape[2]
    if exps.dim() not in (2, 3) or exps.shape[0] != e_ or (
            exps.dim() == 3 and exps.shape[2] != n):
        raise ValueError(f"exps {tuple(exps.shape)} is not [E, n_p] or "
                         f"[E, n_p, N] for E={e_}, N={n}")
    if x_codes.device.type == "cpu":
        return ref.apsq_expert_matmul_ref(x_codes, w_codes, exps, gs=gs)
    _build.require_data("apsq_expert_matmul", x_codes, w_codes)
    n_p = int(exps.shape[1])
    gs_eff = min(int(gs), n_p)   # gs >= n_p is PSQ: one group over all tiles
    if gs_eff < 1:
        raise ValueError(f"gs={gs} must be >= 1")
    x_codes, w_codes = ref.pad_ragged_k(x_codes, w_codes, n_p)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e = exps.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((e_, m, n), dtype=torch.int32, device=x.device)
    if e_ == 0 or m == 0 or n == 0:
        return out
    k = x.shape[2]
    err = _build.entry("apsq_expert_matmul")(
        x.data_ptr(), w.data_ptr(), e.data_ptr(), out.data_ptr(), e_, m, n,
        n_p, k // n_p, gs_eff, int(e.dim() == 3),
        *expert_plan(e_, m, n, k, n_p), _build.stream_ptr(x.device))
    _build.check(err, "apsq_expert_matmul")
    return out


def baseline_expert_matmul_int8(x_codes: torch.Tensor,
                                w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator expert bank [E, M, K] @ [E, K, N] -> [E, M, N]
    in one launch (W8A8 expert layers); the APSQ kernel's walk with one
    PSUM tile over all of K and no requantization."""
    _check_operands(x_codes, w_codes, experts=True)
    if x_codes.device.type == "cpu":
        return ref.baseline_expert_matmul_ref(x_codes, w_codes)
    _build.require_data("baseline_expert_matmul", x_codes, w_codes)
    x = x_codes.contiguous()
    w = w_codes.contiguous()
    e_, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((e_, m, n), dtype=torch.int32, device=x.device)
    if e_ == 0 or m == 0 or n == 0:
        return out
    err = _build.entry("baseline_expert_matmul")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e_, m, n, k,
        *expert_plan(e_, m, n, k, 1), _build.stream_ptr(x.device))
    _build.check(err, "baseline_expert_matmul")
    return out


def baseline_matmul_int8(x_codes: torch.Tensor,
                         w_codes: torch.Tensor) -> torch.Tensor:
    """INT32-accumulator W8A8 GEMM -> INT32 [M, N] (layers without PSUM
    exponents; the paper's INT32-PSUM baseline)."""
    _check_operands(x_codes, w_codes)
    if x_codes.device.type == "cpu":
        return ref.baseline_matmul_ref(x_codes, w_codes)
    _build.require_data("baseline_matmul", x_codes, w_codes)
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


def quantize_operands(x: torch.Tensor, w: torch.Tensor, *, ax, aw):
    """Float activations/weights -> INT8 codes with scales ``ax``
    (per-tensor) and ``aw`` (per-tensor or per-column [N]): round half to
    even, clipped to [-128, 127]."""
    ax = torch.as_tensor(ax, dtype=torch.float32, device=x.device)
    aw = torch.as_tensor(aw, dtype=torch.float32, device=w.device)
    xq = torch.clamp(torch.round(x / ax), -128, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w / aw), -128, 127).to(torch.int8)
    return xq, wq


def apsq_matmul_f32(x: torch.Tensor, w: torch.Tensor, exps: torch.Tensor, *,
                    gs: int, ax, aw) -> torch.Tensor:
    """Deployment-path float entry: quantize -> ``apsq_matmul_int8`` (the
    kernel on the card, its plain version on the CPU) -> rescale by the
    product scale ``ax * aw`` (``aw`` broadcasts per column)."""
    xq, wq = quantize_operands(x, w, ax=ax, aw=aw)
    y = apsq_matmul_int8(xq, wq, exps, gs=gs)
    return (y.float() * torch.as_tensor(ax, dtype=torch.float32,
                                        device=y.device)
            * torch.as_tensor(aw, dtype=torch.float32, device=y.device))


def calibrate_exps(x_codes: torch.Tensor, w_codes: torch.Tensor, *, n_p: int,
                   gs: int) -> torch.Tensor:
    """Exponent calibration from a sample batch (``ref.choose_exps``)."""
    return ref.choose_exps(x_codes, w_codes, n_p=n_p, gs=gs)
