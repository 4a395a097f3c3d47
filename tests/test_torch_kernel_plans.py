"""What the redesigned CUDA kernels decide and compute, checked on the CPU.

The kernels themselves run only on the card (``test_torch_cuda.py``).
Here, without a card:

* The wrappers' plans (``attention_plan``, ``baseline_plan``,
  ``apsq_plan``) are pure functions of the shapes that cover every cache
  position / K row exactly once and fill the card where the shapes allow
  (for attention: where S holds splits of ``MIN_SPLIT_TILES`` tiles, the
  shortest that pays for the merge).
* The split-S attention, emulated in plain torch the way the kernel cuts
  it (row blocks, splits, the walk that stops at a block's last limit,
  partial (m, l, acc) merged by log-sum-exp), matches
  ``int8_kv_attention_ref`` within rtol 2e-5 / atol 2e-6, the reference's
  own bound: rows whose limit is <= 0, splits no row sees, S not a
  multiple of the split.
* The byte tricks of the kernels, emulated byte for byte with the
  selectors read from the CUDA sources: the 4x4 ``__byte_perm``
  transpose of the W8A8 kernel equals ``np.transpose``, and the int8 ->
  float conversion of the attention kernel is exact for all 256 codes.
* The W8A8 kernel's whole dataflow (lane loads, transposes, the K
  permutation fed to ``mma.m16n8k32`` with PTX's fragment layouts, the
  column mapping, the in-block fold and split-K) emulated in numpy is
  bit-exact against an integer matmul, ragged M, N and K included.
* The APSQ kernels' dataflow (``ops.apsq_plan``'s tile-aligned K slots,
  the tensor-core and one-row partial bodies, the partials stored as
  int32, the Algorithm-1 epilogue with its running sum of dequantized
  codes and XLA shifts) emulated in numpy is bit-exact against the
  torch oracle and the JAX reference, over
  ``test_torch_kernels.GEMM_CASES`` and more (ragged K with bk = 12, 13,
  37, 138, gs 1-17, n_p = 1, gs = n_p, both exponent layouts,
  adversarial exponents, three K ranges per tile) and M in {1, 8, 16,
  17, 32, 128}; the APSQ plan covers every K row of every PSUM tile
  once, no slot crossing a tile's end.
* The expert kernels' dataflow (``ops.expert_plan``'s grid of column
  block x 16 rows x expert, the zero-block skip, the ring of 64-row
  stages that never crosses a PSUM tile's end, the warps' column split
  with its K permutation fed to ``mma.m16n8k32``, Algorithm 1's carry
  form in registers at each tile's end) emulated in numpy is bit-exact
  against the torch oracle and the JAX oracle backend's
  ``int_expert_gemm``, APSQ and W8A8: the serving shapes cut in E, M in
  {1, 2, 3, 9, 16, 17}, bk = 12, 37, 138, gs past 16, shift counts
  >= 32, experts whose rows are all zero or have one live row.  The
  plan is pure, covers every (expert, row, column) and every K row of
  every tile once, and its stages fit one block's shared memory.
* A zero code row gives 0 under both plain versions and the JAX oracle
  at every exponent in [-40, 40], both layouts: the fact the skip rests
  on.
* ``baseline_matmul_ref`` is bit-exact against JAX's at K=5632 with
  extreme codes.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec import get_backend as j_get_backend
from repro.kernels.apsq_matmul import ref as jref
from repro_torch.kernels.apsq_matmul import ops as gops
from repro_torch.kernels.apsq_matmul import ref as gref
from repro_torch.kernels.int8_kv_attention import ops as kops
from repro_torch.kernels.int8_kv_attention import ref as kref
from _hypothesis_compat import given, st
from test_torch_kernels import GEMM_CASES, _exps

KERNELS = Path(kops.__file__).resolve().parents[1]


def _selectors(src: str) -> dict:
    text = (KERNELS / src).read_text()
    return {name: int(val, 16) for name, val in re.findall(
        r"constexpr unsigned (\w+) = (0x[0-9a-fA-F]+)u;", text)}


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def splits(plan, seq_len):
    """(begin, end) of each split of the cache, as the kernel reads the
    attention plan (split z covers [z*split_len, (z+1)*split_len) & S)."""
    return [(i * plan.split_len, min(seq_len, (i + 1) * plan.split_len))
            for i in range(plan.n_split)]


def k_ranges(plan, k):
    """(begin, end) of each block's K range under a W8A8 plan."""
    return [(i * plan.k_split, min(k, (i + 1) * plan.k_split))
            for i in range(plan.splits)]


ATTN_SHAPES = [  # (B, C, Hq, Hkv, S)
    (1, 16, 32, 4, 96), (8, 16, 32, 4, 96), (8, 1, 32, 4, 96),
    (1, 16, 16, 16, 96), (8, 16, 16, 16, 96), (8, 1, 16, 16, 96),
    (1, 1, 32, 4, 1024), (1, 1, 32, 4, 4096), (1, 1, 16, 16, 4096),
    (1, 16, 32, 4, 4096), (1, 1, 16, 16, 1024), (2, 8, 8, 2, 100),
    (3, 1, 8, 2, 48), (1, 1, 4, 4, 7), (64, 16, 32, 4, 96),
]


@pytest.mark.parametrize("B,C,Hq,Hkv,S", ATTN_SHAPES)
def test_attention_plan_covers_every_position_once(B, C, Hq, Hkv, S):
    plan = kops.attention_plan(B, C, Hq, Hkv, S)
    assert plan == kops.attention_plan(B, C, Hq, Hkv, S)   # deterministic
    assert plan.rows_per_warp in (1, 2)
    rows = C * (Hq // Hkv)
    assert plan.row_blocks == math.ceil(rows /
                                        (kops.WARPS * plan.rows_per_warp))
    assert plan.split_len % kops.TILE_S == 0
    seen = np.zeros(S, np.int64)
    for lo, hi in splits(plan, S):
        assert lo < hi                                    # no empty split
        seen[lo:hi] += 1
    assert (seen == 1).all()
    base = plan.row_blocks * Hkv * B
    blocks = base * plan.n_split
    tiles = math.ceil(S / kops.TILE_S)
    if plan.rows_per_warp > 1:            # more rows only past MAX_BLOCKS
        assert math.ceil(rows / (kops.WARPS * plan.rows_per_warp // 2)) \
            * Hkv * B > kops.MAX_BLOCKS
    if plan.n_split > 1:                  # splits of at least 4 tiles
        assert plan.split_len >= kops.MIN_SPLIT_TILES * kops.TILE_S
    if base >= kops.NUM_SMS:
        assert plan.n_split == 1                          # no needless merge
    elif base * (tiles // kops.MIN_SPLIT_TILES) >= kops.NUM_SMS:
        assert blocks >= kops.NUM_SMS                     # one block per SM
    if tiles < 2 * kops.MIN_SPLIT_TILES:
        assert plan.n_split == 1        # too short to pay for the merge


GEMM_SHAPES = [  # (M, N, K)
    (1, 2048, 5632), (8, 2048, 2048), (16, 5632, 2048), (17, 2048, 2048),
    (32, 2048, 2048), (32, 5632, 2048), (32, 2048, 5632), (33, 16, 45),
    (64, 5632, 5632), (8, 16, 45), (3, 9, 37), (128, 2048, 2048),
    (8, 2048, 0),
]


@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
def test_baseline_plan_covers_every_k_row_once(M, N, K):
    plan = gops.baseline_plan(M, N, K)
    assert plan == gops.baseline_plan(M, N, K)
    assert plan.bm == (16 if M <= 16 else 32)
    assert plan.k_split % gops.W8_KS == 0 and plan.splits >= 1
    seen = np.zeros(K, np.int64)
    for lo, hi in k_ranges(plan, K):
        assert lo < hi or K == 0
        seen[lo:hi] += 1
    assert (seen == 1).all()
    tiles = math.ceil(N / gops.W8_BN) * math.ceil(M / plan.bm)
    rnd = gops.W8_WARPS * gops.W8_KS
    # whole rounds of K slices: every warp of a block has one
    assert plan.k_split % rnd == 0
    if tiles * (K // rnd) >= 3 * gops.NUM_SMS:
        assert tiles * plan.splits >= gops.NUM_SMS       # the card is full
    if tiles >= 3 * gops.NUM_SMS:
        assert plan.splits == 1


# ---------------------------------------------------------------------------
# Split-S attention, emulated
# ---------------------------------------------------------------------------

def split_attention_emulation(q, kc, vc, ke, ve, length, plan):
    """The kernel's cut of the work in plain float32 torch: per block
    (row block, kv-head, batch, split) the partial (m, l, acc) of its rows
    over its walk, then the log-sum-exp merge in split order.  A test
    helper, on no path."""
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    B, C, Hq, hd = q4.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    rows = C * G
    rb_rows = kops.WARPS * plan.rows_per_warp
    scale = 1.0 / math.sqrt(hd)
    neg = torch.tensor(kref.NEG_INF, dtype=torch.float32)
    pm = torch.full((plan.n_split, B, C, Hq), kref.NEG_INF)
    pl = torch.zeros((plan.n_split, B, C, Hq))
    pacc = torch.zeros((plan.n_split, B, C, Hq, hd))
    for b in range(B):
        first = int(length[b]) - C + 1
        for h in range(Hkv):
            sk = scale * 2.0 ** int(ke[b, h])
            vs = 2.0 ** int(ve[b, h])
            for rb in range(plan.row_blocks):
                r0 = rb * rb_rows
                nr = min(rb_rows, rows - r0)
                lim_lo = first + r0 // G
                lim_hi = first + (r0 + nr - 1) // G
                for sp, (lo, split_end) in enumerate(splits(plan, S)):
                    end = min(split_end, lim_hi) if lim_lo >= 1 \
                        else split_end
                    if end <= lo:
                        continue                  # m = -1e30, l = acc = 0
                    pos = torch.arange(lo, end)
                    kk = kc[b, lo:end, h].float()
                    vv = vc[b, lo:end, h].float()
                    for row in range(r0, r0 + nr):
                        t, head = row // G, h * G + row % G
                        sc = (kk @ q4[b, t, head].float()) * sk
                        sc = torch.where(pos < first + t, sc, neg)
                        m = sc.max()
                        p = torch.exp(sc - m)
                        pm[sp, b, t, head] = m
                        pl[sp, b, t, head] = p.sum()
                        pacc[sp, b, t, head] = (p @ vv) * vs
    mx = pm.max(dim=0).values
    wgt = torch.exp(pm - mx)
    out = (wgt[..., None] * pacc).sum(0) / (wgt * pl).sum(0).clamp(
        min=1e-30)[..., None]
    return out[:, 0] if squeeze else out


ATTN_EMU_CASES = [  # (B, C, S, Hq, Hkv, hd, lengths, n_split or None:
    #                   the plan's splits, or one per tile where it has one)
    (2, 0, 100, 4, 2, 16, [7, 100], None),      # S not a multiple of 32
    (2, 8, 64, 8, 2, 16, [3, 40], None),        # rows with limit <= 0
    (1, 16, 96, 8, 1, 8, [10], None),           # all rows of a block <= 0
    (1, 0, 1024, 2, 1, 8, [20], None),          # splits no row sees
    (1, 4, 1024, 4, 2, 16, [37], None),         # same, chunk form
    (3, 0, 48, 8, 2, 8, [1, 20, 48], None),
    (2, 4, 100, 4, 4, 16, [9, 100], 3),         # forced: 3 splits of 64
    (1, 8, 70, 4, 2, 8, [5], 2),                # forced, limit <= 0 rows
]


@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths,n_split", ATTN_EMU_CASES)
def test_split_s_merge_emulation_matches_reference(B, C, S, Hq, Hkv, hd,
                                                   lengths, n_split):
    rng = np.random.default_rng(B * 1000 + C * 100 + S + hd)
    qshape = (B, Hq, hd) if C == 0 else (B, C, Hq, hd)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(np.float32))
    kc, ke = kref.quantize_kv_po2(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, hd)).astype(np.float32) * 2))
    vc, ve = kref.quantize_kv_po2(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)))
    length = torch.tensor(lengths, dtype=torch.int32)
    plan = kops.attention_plan(B, max(C, 1), Hq, Hkv, S)
    if n_split is None and plan.n_split == 1:
        n_split = math.ceil(S / kops.TILE_S)     # one split per tile
    if n_split is not None:
        per = math.ceil(math.ceil(S / kops.TILE_S) / n_split)
        plan = plan._replace(n_split=n_split, split_len=per * kops.TILE_S)
        assert splits(plan, S)[-1][1] == S
    assert plan.n_split > 1
    got = split_attention_emulation(q, kc, vc, ke, ve, length, plan)
    want = kref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# Byte tricks, emulated with the kernels' own selectors
# ---------------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA ``__byte_perm``: byte n of the result is byte (s >> 4n) & 7 of
    the 8 bytes {x.b0..x.b3, y.b0..y.b3}."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        sel = np.uint64(((s >> (4 * n)) & 7) * 8)
        out |= ((src >> sel) & np.uint64(0xff)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def transpose4x4(r, sel):
    """The W8A8 kernel's transpose4x4 on words r[0..3] (rows)."""
    t0 = byte_perm(r[0], r[1], sel["PRMT_PAIR_LO"])
    t1 = byte_perm(r[0], r[1], sel["PRMT_PAIR_HI"])
    t2 = byte_perm(r[2], r[3], sel["PRMT_PAIR_LO"])
    t3 = byte_perm(r[2], r[3], sel["PRMT_PAIR_HI"])
    return [byte_perm(t0, t2, sel["PRMT_HALF_LO"]),
            byte_perm(t0, t2, sel["PRMT_HALF_HI"]),
            byte_perm(t1, t3, sel["PRMT_HALF_LO"]),
            byte_perm(t1, t3, sel["PRMT_HALF_HI"])]


def _words(b):
    """[..., 4] int8 bytes -> uint32 words (byte 0 lowest)."""
    return b.astype(np.uint8).view(np.uint32)[..., 0]


def _bytes(w):
    return np.asarray(w, np.uint32)[..., None].view(np.uint8).reshape(
        *np.shape(w), 4).view(np.int8)


@pytest.mark.parametrize("seed", range(4))
def test_byte_perm_transpose_equals_np_transpose(seed):
    sel = _selectors("apsq_matmul/csrc/apsq_matmul.cu")
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-128, 128, (1000, 4, 4)).astype(np.int8)
    if seed == 0:        # every byte value in every position
        blocks[:256] = np.arange(-128, 128, dtype=np.int8)[:, None, None]
        blocks[:256, 1] = np.roll(blocks[:256, 1], 1, axis=0)
        blocks[:256, 2, 3] = 0x7f
    rows = [_words(np.ascontiguousarray(blocks[:, i])) for i in range(4)]
    cols = transpose4x4(rows, sel)
    got = np.stack([_bytes(c) for c in cols], axis=1)
    np.testing.assert_array_equal(got, np.transpose(blocks, (0, 2, 1)))


def test_int8_to_float_conversion_exact_for_every_code():
    sel = _selectors("int8_kv_attention/csrc/int8_kv_attention.cu")
    codes = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    w = _words(codes) ^ np.uint32(0x80808080)
    for i in range(4):
        bits = byte_perm(w, np.uint32(0x4B000000), sel["I8F_SEL"] + i)
        f = bits.view(np.float32) - np.float32(8388736.0)
        np.testing.assert_array_equal(f, codes[:, i].astype(np.float32))


# ---------------------------------------------------------------------------
# The W8A8 kernel's dataflow, emulated
# ---------------------------------------------------------------------------

LANE = np.arange(32)
GRP, TIG = LANE // 4, LANE % 4


def _fragment_index():
    """PTX's m16n8k32 .s8 fragment layouts: (row, col) of every byte of A
    (4 registers), B (2) and every element of C (4), per lane."""
    a_rc = np.zeros((32, 4, 4, 2), np.int64)
    for r in range(4):
        for i in range(4):
            idx = 4 * r + i
            row = np.where((idx < 4) | ((8 <= idx) & (idx < 12)), GRP,
                           GRP + 8)
            col = TIG * 4 + (idx & 3) + (16 if idx >= 8 else 0)
            a_rc[:, r, i] = np.stack([row, col], -1)
    b_rc = np.zeros((32, 2, 4, 2), np.int64)
    for r in range(2):
        for i in range(4):
            idx = 4 * r + i
            k = TIG * 4 + (idx & 3) + (16 if idx >= 4 else 0)
            b_rc[:, r, i] = np.stack([k, GRP], -1)
    c_rc = np.zeros((32, 4, 2), np.int64)
    for i in range(4):
        c_rc[:, i] = np.stack([GRP + 8 * (i >= 2), TIG * 2 + (i & 1)], -1)
    return a_rc, b_rc, c_rc


A_RC, B_RC, C_RC = _fragment_index()


def mma_m16n8k32(acc, a_regs, b_regs):
    """acc [32, 4] int64 += A @ B, A and B assembled from the lanes'
    registers (a_regs [32, 4], b_regs [32, 2] uint32)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    A[A_RC[..., 0], A_RC[..., 1]] = _bytes(a_regs)
    B[B_RC[..., 0], B_RC[..., 1]] = _bytes(b_regs)
    D = A @ B
    return acc + D[C_RC[..., 0], C_RC[..., 1]]


def _masked(x, w, kb, ke, pad):
    """What the kernels' loads return inside K range [kb, ke): the
    operands, zeros outside the range and past M or N (``pad`` rows)."""
    M, K = x.shape
    N = w.shape[1]
    xz = np.zeros((M + pad, K + 64), np.int8)
    xz[:M, kb:ke] = x[:, kb:ke]
    wz = np.zeros((K + 64, N + 64), np.int8)
    wz[kb:ke, :N] = w[kb:ke]
    return xz, wz


def _lane_loads(xz, wz, kr, col, rows):
    """A lane's operands for one K slice: 16 weight rows x 8 columns as
    the low/high words of its uint2 loads, and for each activation row in
    ``rows`` ([32 lanes] each) its 16 K bytes as 4 words."""
    wr = [np.stack([wz[kr + i, col + j] for j in range(8)], -1)
          for i in range(16)]                        # [32 lanes, 8]
    wlo = [_words(r[:, :4].copy()) for r in wr]
    whi = [_words(r[:, 4:].copy()) for r in wr]
    xr = [_words(np.stack([xz[m, kr + j] for j in range(16)], -1)
                 .reshape(32, 4, 4)) for m in rows]
    return wlo, whi, xr


def emulate_mma_partial(xz, wz, m0, n0, kb, ke, bm, sel):
    """``mma_partial``, lane by lane (lanes vectorised): the block's int64
    tile [bm, 64] of its K range, on operands masked to it."""
    mt_n = bm // 16
    tile = np.zeros((bm, gops.W8_BN), np.int64)
    for warp in range(gops.W8_WARPS):
        acc = np.zeros((mt_n, 8, 32, 4), np.int64)
        for k0 in range(kb + warp * gops.W8_KS, ke,
                        gops.W8_WARPS * gops.W8_KS):
            kr = k0 + 16 * TIG                       # the lane's K rows
            rows = [m0 + 16 * mt + GRP + 8 * hh
                    for mt in range(mt_n) for hh in range(2)]
            wlo, whi, xr = _lane_loads(xz, wz, kr, n0 + 8 * GRP, rows)
            for s in range(2):
                b = []
                for hh in range(2):
                    i = 8 * s + 4 * hh
                    b.append(transpose4x4(wlo[i:i + 4], sel)
                             + transpose4x4(whi[i:i + 4], sel))
                for mt in range(mt_n):
                    lo, hi = xr[2 * mt], xr[2 * mt + 1]
                    a = np.stack([lo[:, 2 * s], hi[:, 2 * s],
                                  lo[:, 2 * s + 1], hi[:, 2 * s + 1]], -1)
                    for q in range(8):
                        acc[mt, q] = mma_m16n8k32(
                            acc[mt, q], a, np.stack([b[0][q], b[1][q]], -1))
        # the fold: accumulator c of n8 tile q sits at row g + 8*(c//2),
        # column 16t + 8*(c%2) + q
        for mt in range(mt_n):
            for q in range(8):
                for c in range(4):
                    np.add.at(tile, (16 * mt + GRP + 8 * (c // 2),
                                     16 * TIG + 8 * (c % 2) + q),
                              acc[mt, q, :, c])
    return tile


def dp4a(a, b, c):
    """CUDA ``__dp4a`` (signed): c + the 4 byte products of a and b."""
    return c + (_bytes(a).astype(np.int64) * _bytes(b)).sum(-1)


def emulate_dp4a_partial(xz, wz, n0, kb, ke, sel):
    """``apsq_partial_dp4a_kernel`` for one block: its [64] int64 sums of
    row 0 over its K range, lane by lane, then the shuffles over the 4
    lanes of a column group and the warps' sum."""
    red = np.zeros((gops.W8_WARPS, gops.W8_BN), np.int64)
    for warp in range(gops.W8_WARPS):
        acc = np.zeros((8, 32), np.int64)
        for k0 in range(kb + warp * gops.W8_KS, ke,
                        gops.W8_WARPS * gops.W8_KS):
            kr = k0 + 16 * TIG
            wlo, whi, (xr,) = _lane_loads(xz, wz, kr, n0 + 8 * GRP,
                                          [np.zeros(32, np.int64)])
            for hh in range(4):
                i = 4 * hh
                b = transpose4x4(wlo[i:i + 4], sel) + \
                    transpose4x4(whi[i:i + 4], sel)
                for q in range(8):
                    acc[q] = dp4a(b[q], xr[:, hh], acc[q])
        for q in range(8):                           # __shfl_xor 1, then 2
            acc[q] = acc[q] + acc[q][LANE ^ 1]
            acc[q] = acc[q] + acc[q][LANE ^ 2]
        for q in range(8):
            red[warp, 8 * GRP[TIG == 0] + q] = acc[q][TIG == 0]
    return red.sum(0)


def range_partials(x, w, ranges, bm):
    """The int64 [M, N] partial of each K range in ``ranges``, as the
    blocks of the tensor-core kernels (bm 16 or 32) or of the one-row
    body (bm 1) compute it."""
    sel = _selectors("apsq_matmul/csrc/apsq_matmul.cu")
    M = x.shape[0]
    N = w.shape[1]
    out = []
    for kb, ke in ranges:
        xz, wz = _masked(x, w, kb, ke, max(bm, 16) + 8)
        part = np.zeros((M, N), np.int64)
        for m0 in range(0, M, bm):
            for n0 in range(0, N, gops.W8_BN):
                cols = min(gops.W8_BN, N - n0)
                if bm == 1:
                    part[0, n0:n0 + cols] = emulate_dp4a_partial(
                        xz, wz, n0, kb, ke, sel)[:cols]
                    continue
                rows = min(bm, M - m0)
                part[m0:m0 + rows, n0:n0 + cols] = emulate_mma_partial(
                    xz, wz, m0, n0, kb, ke, bm, sel)[:rows, :cols]
        out.append(part)
    return out


def _wrap(v):
    """int64 -> int32 bits, mod 2^32."""
    return ((np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31)


def emulate_w8a8_kernel(x, w, plan):
    """w8a8_mma_kernel on int8 numpy operands: the blocks' partials over
    the plan's K ranges, added into the output; returns int32."""
    parts = range_partials(x, w, k_ranges(plan, x.shape[1]), plan.bm)
    return _wrap(sum(parts)).astype(np.int32)


@pytest.mark.parametrize("M,N,K", [
    (1, 16, 45), (8, 64, 256), (17, 72, 200), (33, 24, 300), (5, 9, 37),
    (16, 130, 64), (32, 64, 1100),
])
def test_w8a8_kernel_dataflow_emulation_bit_exact(M, N, K):
    rng = np.random.default_rng(M * 7 + N * 3 + K)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    plan = gops.baseline_plan(M, N, K)
    if K >= 512:
        plan = plan._replace(splits=math.ceil(K / 256), k_split=256)
    got = emulate_w8a8_kernel(x, w, plan)
    want = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got, gref.baseline_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(w)).numpy())


# ---------------------------------------------------------------------------
# The APSQ kernels' dataflow, emulated: tile partials, then Algorithm 1
# ---------------------------------------------------------------------------

def tile_slots(plan, n_p, bk):
    """(begin, end) K range of each partial slot z, as ``tile_range``
    reads the plan: PSUM tile z // splits, range z % splits of it."""
    out = []
    for z in range(n_p * plan.splits):
        i, s = divmod(z, plan.splits)
        kb = i * bk + s * plan.k_split
        out.append((kb, min(i * bk + bk, kb + plan.k_split)))
    return out


def _shl(a, s):
    """XLA ShiftLeft on int32 values held in int64: 0 outside [0, 32)."""
    ok = (s >= 0) & (s < 32)
    v = (np.asarray(a, np.int64) % 2**32) << np.where(ok, s, 0)
    return np.where(ok, _wrap(v), 0)


def _sra(a, s):
    """XLA ShiftRightArithmetic: the sign outside [0, 32)."""
    return np.asarray(a, np.int64) >> np.where((s >= 0) & (s < 32), s, 31)


def _quant(v, e):
    r = np.where(e > 0, _sra(_wrap(v + _shl(1, e - 1)), e), v)
    return np.clip(r, -128, 127)


def emulate_epilogue(parts, exps, n_p, splits, gs):
    """``apsq_epilogue_kernel`` over the int32 slots ``parts``
    [n_p * splits] x [M, N], every element at once: tile i sums its slots
    mod 2^32, then the Algorithm-1 step, each group's codes dequantized
    into one running sum (``carry``) as they are made."""
    exps = np.asarray(exps, np.int64)
    exp_at = (lambda i: exps[i]) if exps.ndim == 1 else \
        (lambda i: exps[i][None, :])
    carry = result = np.zeros(parts[0].shape, np.int64)
    last = n_p - 1
    for i in range(n_p):
        p = _wrap(sum(parts[i * splits + s] for s in range(splits)))
        e = exp_at(i)
        if i % gs == 0:                               # group start: APSQ
            carry = result = _shl(_quant(_wrap(p + carry), e), e)
        elif i < last:                                # tail tile: PSQ
            carry = _wrap(carry + _shl(_quant(p, e), e))
        else:                                 # final tile closes mid-group
            result = _shl(_quant(_wrap(p + carry), e), e)
    return result.astype(np.int32)


def emulate_apsq_kernel(x, w, exps, gs, plan=None):
    """``apsq_matmul_int8`` on the card, in numpy: the wrapper's ragged-K
    pad, the plan's tile-aligned K slots (tensor-core or one-row body),
    the partials stored as int32, then the epilogue."""
    exps = np.asarray(exps)
    n_p = exps.shape[0]
    pad = (-x.shape[1]) % n_p
    x = np.pad(x, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, pad), (0, 0)))
    (M, K), N = x.shape, w.shape[1]
    bk = K // n_p
    plan = plan or gops.apsq_plan(M, N, K, n_p)
    parts = [_wrap(p) for p in range_partials(
        x, w, tile_slots(plan, n_p, bk), plan.bm)]
    return emulate_epilogue(parts, exps, n_p, plan.splits, min(gs, n_p))


APSQ_PLAN_SHAPES = [  # (M, N, K, n_p): serving shapes, then ragged tiles
    (1, 2048, 5632, 8), (1, 5632, 2048, 8), (1, 2048, 2048, 4),
    (1, 256, 2048, 4), (2, 2048, 2048, 4), (4, 5632, 2048, 8),
    (8, 2048, 2048, 4), (8, 256, 2048, 4), (8, 5632, 2048, 8),
    (8, 2048, 5632, 8), (16, 5632, 2048, 8), (16, 2048, 5632, 8),
    (17, 2048, 2048, 4), (32, 5632, 2048, 8), (128, 2048, 2048, 4),
    (6, 16, 48, 4), (3, 9, 39, 3), (5, 40, 148, 4), (17, 300, 1104, 8),
    (8, 64, 1100, 2), (1, 48, 45, 1), (8, 2048, 0, 4),
]


@pytest.mark.parametrize("M,N,K,n_p", APSQ_PLAN_SHAPES)
def test_apsq_plan_covers_every_tile_row_once(M, N, K, n_p):
    plan = gops.apsq_plan(M, N, K, n_p)
    assert plan == gops.apsq_plan(M, N, K, n_p)            # deterministic
    assert plan.bm == (gops.M1_BM if M == 1 else 16 if M <= 16 else 32)
    rnd = gops.W8_WARPS * gops.W8_KS
    assert plan.k_split % rnd == 0 and plan.splits >= 1
    bk = math.ceil(K / n_p)
    seen = np.zeros(n_p * bk, np.int64)
    for z, (kb, ke) in enumerate(tile_slots(plan, n_p, bk)):
        tile = z // plan.splits
        assert kb < ke or bk == 0                          # no empty split
        assert tile * bk <= kb and ke <= (tile + 1) * bk   # inside its tile
        # every warp slice of the block stays inside the tile too
        for k0 in range(kb, ke, gops.W8_KS):
            assert min(k0 + gops.W8_KS, ke) <= (tile + 1) * bk
        seen[kb:ke] += 1
    assert (seen == 1).all()
    blocks = math.ceil(N / gops.W8_BN) * math.ceil(M / plan.bm) * n_p
    if blocks * (bk // rnd) >= 3 * gops.NUM_SMS:
        assert blocks * plan.splits >= gops.NUM_SMS        # the card is full
    if blocks >= 3 * gops.NUM_SMS:
        assert plan.splits == 1


def _apsq_case(m, k, n, n_p, gs, exps, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, w, _exps(exps, x, w, n_p, gs, n)


def _check_apsq_emulation(x, w, e, gs, plan=None):
    n_p = e.shape[0]
    got = emulate_apsq_kernel(x, w, e, gs, plan)
    want = gref.apsq_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(e), n_p=n_p, gs=gs)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jref.apsq_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(e), n_p=n_p, gs=gs)))


APSQ_EMU_CASES = GEMM_CASES + [
    (5, 148, 40, 4, 2, "cols"),          # bk = 37
    (17, 1100, 300, 8, 4, "cols"),       # bk = 138
    (8, 1100, 64, 2, 1, "auto"),         # 3 K ranges per tile
    (4, 64, 16, 4, 2, [33, 1, 40, 2]),   # shift counts >= 32
    (3, 480, 24, 24, 17, "cols"),        # gs past the expert kernels' 16
]


@pytest.mark.parametrize("m,k,n,n_p,gs,exps", APSQ_EMU_CASES)
def test_apsq_kernel_dataflow_emulation_bit_exact(m, k, n, n_p, gs, exps):
    x, w, e = _apsq_case(m, k, n, n_p, gs, exps, 4000 + m * 7 + k + n + gs)
    _check_apsq_emulation(x, w, e, gs)
    if m == 1:                              # the other M == 1 body too
        plan = gops.apsq_plan(m, n, k, n_p)
        _check_apsq_emulation(x, w, e, gs, plan._replace(
            bm=16 if plan.bm == 1 else 1))


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 128])
@pytest.mark.parametrize("k,n,n_p,gs", [(300, 72, 4, 2), (600, 24, 8, 3)])
def test_apsq_kernel_emulation_over_m_bit_exact(m, k, n, n_p, gs):
    x, w, e = _apsq_case(m, k, n, n_p, gs, "cols", 5000 + m + k + n)
    _check_apsq_emulation(x, w, e, gs)


# ---------------------------------------------------------------------------
# The expert kernels' dataflow, emulated: stream, Algorithm 1 in registers
# ---------------------------------------------------------------------------

def _source_ints(src: str, prefix: str) -> dict:
    """``constexpr int PREFIX... = expr;`` of a CUDA source, evaluated in
    order (an expression may name an earlier constant)."""
    out = {}
    for name, expr in re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);",
                                 (KERNELS / src).read_text()):
        out[name] = eval(expr, {}, dict(out))
    return out


XS = _source_ints("apsq_matmul/csrc/apsq_matmul.cu", "XS_")
XS_BK = XS["XS_BK"]                  # K rows per stage of the expert ring
SMEM_PER_BLOCK = 232448              # shared memory an H100 block can use


def expert_stages(k, n_p):
    """(PSUM tile, first K row, end) of each stage of an expert block's
    walk, in order: ``max(1, ceil(bk / XS_BK))`` stages per tile, the
    last cut at the tile's end (the kernel loads zeros past it)."""
    bk = k // n_p
    spt = max(1, math.ceil(bk / XS_BK))
    return [(i, i * bk + j * XS_BK, min(i * bk + bk, i * bk + (j + 1) * XS_BK))
            for i in range(n_p) for j in range(spt)]


def expert_smem_bytes(plan, apsq=True):
    """Dynamic shared memory of one expert block, as the launch sizes it:
    the ring's stages of weights, activations and (APSQ) one int32
    exponent per column."""
    return plan.stages * (XS_BK * (plan.bn + XS["XS_WPAD"])
                          + plan.bm * XS["XS_XROW"]
                          + (4 * plan.bn if apsq else 0))


def test_expert_kernel_plan_matches_source():
    """The wrapper's rows per block are the kernel's, and every plan it
    can make has a kernel instance."""
    assert gops.XS_BM == XS["XS_BM"] and XS_BK % 32 == 0
    text = (KERNELS / "apsq_matmul/csrc/apsq_matmul.cu").read_text()
    for bn in (64, 128):
        assert f"EXPERT_CASE({bn // 32}, {gops.EXPERT_STAGES})" in text


def _expert_plan_checks(e, m, n, k, n_p):
    plan = gops.expert_plan(e, m, n, k, n_p)
    assert plan == gops.expert_plan(e, m, n, k, n_p)         # pure
    assert plan.bn in (64, 128) and plan.bm == gops.XS_BM
    assert plan.stages >= 3
    assert expert_smem_bytes(plan) <= SMEM_PER_BLOCK
    assert expert_smem_bytes(plan, apsq=False) \
        < expert_smem_bytes(plan)
    # the grid (column block, row block, expert) covers every output once
    seen = np.zeros((e, m, n), np.int64)
    for z in range(e):
        for y in range(math.ceil(m / plan.bm)):
            for x in range(math.ceil(n / plan.bn)):
                seen[z, y * plan.bm:(y + 1) * plan.bm,
                     x * plan.bn:(x + 1) * plan.bn] += 1
    assert (seen == 1).all()
    # the walk: every K row of every PSUM tile once, no stage across a
    # tile's end, at most XS_BK rows a stage, in order
    kp = n_p * math.ceil(k / n_p)                  # the wrapper's pad
    bk = kp // n_p
    rows = np.zeros(kp, np.int64)
    walk = expert_stages(kp, n_p)
    assert len(walk) == n_p * max(1, math.ceil(bk / XS_BK))
    for i, kb, ke in walk:
        assert i * bk <= kb <= ke <= (i + 1) * bk
        assert ke - kb <= XS_BK
        rows[kb:ke] += 1
    assert (rows == 1).all()
    assert [i for i, _, _ in walk] == sorted(i for i, _, _ in walk)
    if e * math.ceil(n / 128) * math.ceil(m / plan.bm) >= 2 * gops.NUM_SMS:
        assert plan.bn == 128                      # wide blocks still fill


EXPERT_PLAN_SHAPES = [  # (E, M, K, N, n_p): OLMoE serving, then ragged
    (64, 2, 2048, 1024, 8), (64, 2, 1024, 2048, 8), (64, 1, 2048, 1024, 8),
    (64, 3, 2048, 1024, 8), (64, 16, 1024, 2048, 8), (64, 17, 2048, 1024, 1),
    (8, 2, 2048, 1024, 8), (4, 3, 45, 24, 4), (2, 9, 1100, 70, 8),
    (1, 1, 64, 32, 4), (3, 16, 480, 20, 24), (5, 2, 0, 40, 4),
]


@pytest.mark.parametrize("e,m,k,n,n_p", EXPERT_PLAN_SHAPES)
def test_expert_plan_covers_every_output_and_k_row_once(e, m, k, n, n_p):
    _expert_plan_checks(e, m, n, k, n_p)


@given(st.integers(1, 80), st.integers(1, 40), st.integers(0, 3000),
       st.integers(1, 700), st.integers(1, 32))
def test_expert_plan_property(e, m, k, n, n_p):
    _expert_plan_checks(e, m, n, k, n_p)


def po2_of(e):
    """The expert kernel's ``po2_of``: quant and deq at 2^e as (bias, sh,
    dsh, dmask), elementwise over an int array of exponents."""
    e = np.asarray(e, np.int64)
    bias = np.where(e > 0, _shl(1, np.maximum(e, 1) - 1), 0)
    sh = np.where(e <= 0, 0, np.minimum(e, 31))
    dmask = np.where((e >= 0) & (e < 32), -1, 0)
    return bias, sh, e & 31, dmask


def quant_deq(v, po2):
    """The expert kernel's ``quant_deq``: clip((v + bias) >> sh), then
    (code << dsh) & dmask, on int32 values held in int64."""
    bias, sh, dsh, dmask = po2
    r = np.clip(_wrap(np.asarray(v, np.int64) + bias) >> sh, -128, 127)
    return _wrap((r % 2**32) << dsh) & dmask


def test_po2_shift_operands_equal_quant_deq_at_every_exponent():
    """The kernel's three shift operands per exponent give the reference's
    dequantize(quantize(v, e), e) bit for bit: e in [-40, 40] and the
    int32 extremes, v over the int32 range's edges and random values."""
    e = np.concatenate([np.arange(-40, 41), [-2**31, 2**31 - 1, 63, 64]])
    rng = np.random.default_rng(32)
    v = np.concatenate([[0, 1, -1, 127, -128, 2**31 - 1, -2**31, 2**30,
                         -2**30 - 1], rng.integers(-2**31, 2**31, 300)])
    ee, vv = np.meshgrid(e, v)
    got = quant_deq(vv, po2_of(ee))
    tv = torch.from_numpy(vv.astype(np.int32))
    te = torch.from_numpy(ee.astype(np.int32))
    want = gref.dequantize_psum(gref.quantize_psum(tv, te), te).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _shl(_quant(vv, ee), ee))
    jv, je = jnp.asarray(vv.astype(np.int32)), jnp.asarray(ee.astype(np.int32))
    np.testing.assert_array_equal(got, np.asarray(jref.dequantize_psum(
        jref.quantize_psum(jv, je), je)))


def mma_shared_a(acc, a_regs, b_regs):
    """A batch of m16n8k32 mmas sharing one A: acc [B, 32, 4] += A @ B_b,
    A from a_regs [32, 4], each B_b from b_regs [B, 32, 2]."""
    A = np.zeros((16, 32), np.int64)
    A[A_RC[..., 0], A_RC[..., 1]] = _bytes(a_regs)
    B = np.zeros((b_regs.shape[0], 32, 8), np.int64)
    B[:, B_RC[..., 0], B_RC[..., 1]] = _bytes(b_regs)
    return acc + (A @ B)[:, C_RC[..., 0], C_RC[..., 1]]


def xcol(v, sel):
    """The expert kernel's xcol per lane: v [32, 4] words (16 bytes) ->
    bytes t, t+4, t+8, t+12 (lane group t) as one word."""
    out = np.zeros(32, np.uint32)
    for t in range(4):
        s = sel["PRMT_COL_BASE"] + t * sel["PRMT_COL_STEP"]
        ln = TIG == t
        out[ln] = byte_perm(byte_perm(v[ln, 0], v[ln, 1], s),
                            byte_perm(v[ln, 2], v[ln, 3], s),
                            sel["PRMT_HALF_LO"])
    return out


GARBAGE = np.int8(0x5a)        # shared bytes no load may read


def emulate_expert_kernel(x, w, exps, gs, plan, stats=None, skip=True):
    """``apsq_expert_matmul_int8`` (``exps`` given) or
    ``baseline_expert_matmul_int8`` (``exps`` None) on the card, in
    numpy: the wrapper's ragged-K pad, then ``expert_stream_kernel`` block
    by block, all warps of a (expert, row block) at once.  ``stats``
    counts skipped blocks and weight bytes staged; ``skip=False`` runs
    the empty blocks through the walk too."""
    sel = _selectors("apsq_matmul/csrc/apsq_matmul.cu")
    apsq = exps is not None
    n_p = exps.shape[1] if apsq else 1
    pad = (-x.shape[2]) % n_p
    x = np.pad(x, ((0, 0), (0, 0), (0, pad)))
    w = np.pad(w, ((0, 0), (0, pad), (0, 0)))
    E, M, K = x.shape
    N = w.shape[2]
    bk, last, gs = K // n_p, n_p - 1, min(gs, n_p)
    S, BK, bn = plan.stages, XS_BK, plan.bn
    walk = expert_stages(K, n_p)
    spt = len(walk) // n_p
    # every warp of the row: its first column (column block, warp)
    wcol = (np.arange(math.ceil(N / bn))[:, None] * bn
            + 32 * np.arange(bn // 32)[None]).reshape(-1)
    lane_col = wcol[:, None] + 8 * TIG[None]               # [NW, 32]
    # element (q, c) of a lane: row g + 8*(c//2), column + 4*(c%2) + q
    qc_col = np.array([[4 * (c % 2) + q for c in range(4)]
                       for q in range(4)])                  # [4, 4]
    col_el = lane_col[:, None, :, None] + qc_col[None, :, None, :]
    row_el = GRP[None, None, :, None] + 8 * (np.arange(4)[None, None, None]
                                             // 2)          # [1, 1, 32, 4]
    out = np.full((E, M, N), 0x13572468, np.int64)        # poison
    stats = {} if stats is None else stats
    stats.setdefault("skipped", 0)
    stats.setdefault("weight_bytes", 0)
    for e in range(E):
        for m0 in range(0, M, plan.bm):
            rows = min(plan.bm, M - m0)
            if skip and not x[e, m0:m0 + rows].any():   # __syncthreads_or
                out[e, m0:m0 + rows] = 0
                stats["skipped"] += 1
                continue
            ring = [None] * S              # slot -> (stage, w, x, exps)
            consumed = set()

            def issue(it):
                old = ring[it % S]
                assert old is None or old[0] in consumed   # slot is free
                i, kb, ke = walk[it]
                est = None              # a tile's last stage: its exps
                if apsq and (it + 1) % spt == 0:
                    est = np.zeros(wcol.size // (bn // 32) * bn + 64,
                                   np.int64)
                    if exps.ndim == 3:          # per column, 0 past N
                        est[:N] = exps[e, i]
                    else:                       # every lane reads the one
                        est[:] = exps[e, i]
                wst = np.zeros((BK, wcol.size // (bn // 32) * bn + 64),
                               np.int8)
                hi = min(ke, K) - kb
                wst[:hi, :N] = w[e, kb:kb + hi]
                xst = np.full((plan.bm, BK), GARBAGE, np.int8)
                xst[:rows] = 0
                xst[:rows, :hi] = x[e, m0:m0 + rows, kb:kb + hi]
                stats["weight_bytes"] += hi * N
                ring[it % S] = (it, wst, xst, est)

            for it in range(min(S - 1, len(walk))):              # prologue
                issue(it)
            acc = np.zeros((wcol.size, 4, 32, 4), np.int64)
            carry = np.zeros_like(acc)
            for it, (i, _, _) in enumerate(walk):
                if it + S - 1 < len(walk):
                    issue(it + S - 1)
                tag, wst, xst, est = ring[it % S]
                assert tag == it
                for s in range(BK // 32):
                    a = []
                    for rr in (GRP, GRP + 8):      # rows g and g + 8
                        live = (rr < rows)[:, None]
                        run = [np.where(live, _words(np.ascontiguousarray(
                            xst[np.minimum(rr, plan.bm - 1),
                                32 * s + 16 * h:32 * s + 16 * h + 16]
                            .reshape(32, 4, 4))), 0) for h in (0, 1)]
                        a.append([xcol(r.astype(np.uint32), sel)
                                  for r in run])
                    a_regs = np.stack([a[0][0], a[1][0], a[0][1], a[1][1]],
                                      -1)
                    b = []
                    for hh in (0, 1):
                        r = [_words(np.ascontiguousarray(np.stack(
                            [wst[32 * s + 16 * hh + TIG + 4 * ii,
                                 wc + 4 * GRP + j]
                             for j in range(4)], -1)))
                             for ii in range(4) for wc in [wcol[:, None]]]
                        b.append(transpose4x4(r, sel))   # [q] of [NW, 32]
                    b_regs = np.stack([np.stack(b[0], 1), np.stack(b[1], 1)],
                                      -1)                 # [NW, 4, 32, 2]
                    acc = mma_shared_a(acc.reshape(-1, 32, 4), a_regs,
                                       b_regs.reshape(-1, 32, 2)
                                       ).reshape(acc.shape)
                consumed.add(it)
                if apsq and (it + 1) % spt == 0:        # tile i complete
                    pe = po2_of(est[col_el])   # zeros past N
                    p = _wrap(acc)
                    if i % gs == 0 or i == last:    # group start or final
                        step = quant_deq(_wrap(p + carry), pe)
                    else:                           # a tail: its PSQ code
                        step = _wrap(carry + quant_deq(p, pe))
                    nc = 4 if rows > 8 else 2       # rows g + 8 held none
                    carry[..., :nc] = step[..., :nc]
                    acc = np.zeros_like(acc)
            val = carry if apsq else _wrap(acc)
            keep = (row_el < rows) & (col_el < N)
            rr = np.broadcast_to(row_el, val.shape)[keep]
            out[e, m0 + rr, np.broadcast_to(col_el, val.shape)[keep]] = \
                val[keep]
    assert (out != 0x13572468).all()                 # every output stored
    return out.astype(np.int32)


def _expert_case(e, m, k, n, n_p, layout, seed, zero=(), one_live=()):
    """Random codes [E, M, K] @ [E, K, N], exponents in [-2, 19] (or an
    explicit list for every expert), with the experts in ``zero`` all
    zero and those in ``one_live`` with one nonzero row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (e, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (e, k, n)).astype(np.int8)
    for i in zero:
        x[i] = 0
    for i in one_live:
        x[i] = 0
        x[i, m - 1] = rng.integers(-128, 128, k)
    if isinstance(layout, list):
        ex = np.tile(np.asarray(layout, np.int32), (e, 1))
    else:
        shape = (e, n_p) if layout == "vec" else (e, n_p, n)
        ex = rng.integers(-2, 20, shape).astype(np.int32)
    return x, w, ex


EXPERT_EMU_CASES = [  # (E, M, K, N, n_p, gs, layout, zero, one_live)
    (2, 2, 2048, 1024, 8, 4, "cols", (), ()),       # OLMoE wg / wi, cut
    (2, 3, 1024, 2048, 8, 4, "vec", (), ()),        # OLMoE wo, cut
    (4, 1, 256, 64, 8, 4, "cols", (1,), ()),
    (3, 2, 256, 72, 4, 2, "cols", (0, 2), ()),      # two empty experts
    (4, 3, 192, 40, 4, 2, "vec", (1,), (2,)),
    (2, 9, 320, 48, 8, 3, "cols", (), (1,)),
    (3, 16, 256, 33, 8, 4, "cols", (), (0,)),
    (2, 17, 192, 40, 4, 1, "vec", (), (1,)),        # two row blocks
    (2, 3, 48, 24, 4, 2, "cols", (), ()),           # bk = 12
    (2, 5, 148, 40, 4, 2, "cols", (), ()),          # bk = 37
    (2, 9, 1100, 70, 8, 4, "cols", (), ()),         # bk = 138 (ragged K)
    (2, 3, 480, 24, 24, 17, "cols", (), ()),        # gs > 16
    (2, 2, 640, 16, 20, 20, "vec", (), ()),         # gs > 16, PSQ
    (2, 4, 256, 16, 4, 2, [33, 1, 40, 2], (), ()),  # shift counts >= 32
    (2, 4, 256, 16, 4, 1, [31, 32, 40, 0], (), (1,)),
    (2, 2, 128, 16, 1, 1, "vec", (), ()),           # n_p = 1
]


@pytest.mark.parametrize("e,m,k,n,n_p,gs,layout,zero,one_live",
                         EXPERT_EMU_CASES)
def test_expert_kernel_dataflow_emulation_bit_exact(e, m, k, n, n_p, gs,
                                                    layout, zero, one_live):
    x, w, ex = _expert_case(e, m, k, n, n_p, layout, 6000 + e * m + k + n,
                            zero, one_live)
    tx, tw, te = map(torch.from_numpy, (x, w, ex))
    want = gref.apsq_expert_matmul_ref(tx, tw, te, gs=gs).numpy()
    np.testing.assert_array_equal(want, np.asarray(
        j_get_backend("oracle").int_expert_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ex), gs=gs)))
    want_b = gref.baseline_expert_matmul_ref(tx, tw).numpy()
    plan = gops.expert_plan(e, m, n, k, n_p)
    stats = {}
    np.testing.assert_array_equal(
        emulate_expert_kernel(x, w, ex, gs, plan, stats), want)
    np.testing.assert_array_equal(
        emulate_expert_kernel(x, w, None, 1, plan), want_b)
    # the empty experts' blocks returned before reading a weight byte
    blocks = e * math.ceil(m / plan.bm)
    empty = sum(not x[i, r:r + plan.bm].any() for i in range(e)
                for r in range(0, m, plan.bm))
    assert stats["skipped"] == empty >= len(zero)
    kp = k + (-k) % n_p
    assert stats["weight_bytes"] == (blocks - empty) * kp * n
    if empty or m <= 3:
        # the skip is exact: the same bits walking the empty blocks, and
        # the other column width walks the same
        other = plan._replace(bn=192 - plan.bn)
        np.testing.assert_array_equal(
            emulate_expert_kernel(x, w, ex, gs, other, skip=False), want)


@pytest.mark.parametrize("layout", ["vec", "cols"])
def test_zero_code_rows_give_zero_under_every_exponent(layout):
    """One expert per exponent in [-40, 40] (and random mixtures of them
    per tile and column): an all-zero activation row gives 0 through
    both plain versions and the JAX oracle, which is what lets the
    kernels skip an empty expert."""
    e_all, m, k, n, n_p = 81, 2, 24, 8, 4
    rng = np.random.default_rng(81)
    x = np.zeros((e_all, m, k), np.int8)
    w = rng.integers(-128, 128, (e_all, k, n)).astype(np.int8)
    v = np.arange(-40, 41, dtype=np.int32)
    if layout == "vec":
        ex = np.repeat(v[:, None], n_p, 1)
        ex[1::2] = rng.integers(-40, 41, (e_all // 2, n_p))
    else:
        ex = np.repeat(np.repeat(v[:, None, None], n_p, 1), n, 2)
        ex[1::2] = rng.integers(-40, 41, (e_all // 2, n_p, n))
    tx, tw, te = map(torch.from_numpy, (x, w, ex))
    for gs in (1, 2, n_p):
        got = gref.apsq_expert_matmul_ref(tx, tw, te, gs=gs)
        assert not got.any(), gs
        assert not np.asarray(j_get_backend("oracle").int_expert_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ex), gs=gs)).any()
    assert not gref.baseline_expert_matmul_ref(tx, tw).any()
    assert not np.asarray(j_get_backend("oracle").int_expert_gemm(
        jnp.asarray(x), jnp.asarray(w), None, gs=1)).any()


# ---------------------------------------------------------------------------
# The plain version at extreme codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127), (-128, 127),
                                   (-127, -128), ("mixed", -128)])
def test_baseline_oracle_extreme_codes_bit_exact_vs_jax(xv, wv):
    m, k, n = 9, 5632, 24
    rng = np.random.default_rng(5632)
    if xv == "mixed":
        x = rng.choice(np.array([-128, 127], np.int8), (m, k))
    else:
        x = np.full((m, k), xv, np.int8)
    w = np.full((k, n), wv, np.int8)
    w[:, 1::2] = rng.choice(np.array([-128, -127, 127], np.int8),
                            (k, n // 2))
    want = np.asarray(jref.baseline_matmul_ref(jnp.asarray(x),
                                               jnp.asarray(w)))
    got = gref.baseline_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, (x.astype(np.int64) @ w.astype(np.int64)).astype(np.int32))
