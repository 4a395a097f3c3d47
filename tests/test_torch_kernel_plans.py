"""What the redesigned CUDA kernels decide and compute, checked on the CPU.

The kernels themselves run only on the card (``test_torch_cuda.py``).
Here, without a card:

* The wrappers' plans (``attention_plan``, ``baseline_plan``) are pure
  functions of the shapes that cover every cache position / K row
  exactly once and fill the card where the shapes allow (for attention:
  where S holds splits of ``MIN_SPLIT_TILES`` tiles, the shortest that
  pays for the merge).
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

from repro.kernels.apsq_matmul import ref as jref
from repro_torch.kernels.apsq_matmul import ops as gops
from repro_torch.kernels.apsq_matmul import ref as gref
from repro_torch.kernels.int8_kv_attention import ops as kops
from repro_torch.kernels.int8_kv_attention import ref as kref

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


def emulate_w8a8_kernel(x, w, plan):
    """w8a8_mma_kernel, lane by lane (lanes vectorised), on int8 numpy
    operands; returns the int32 output."""
    sel = _selectors("apsq_matmul/csrc/apsq_matmul.cu")
    M, K = x.shape
    N = w.shape[1]
    bm, mt_n = plan.bm, plan.bm // 16
    out = np.zeros((M, N), np.int64)
    for kb, ke in k_ranges(plan, K):
        # what the loads return: zeros at k >= ke and past M or N
        xz = np.zeros((M + bm + 8, K + 64), np.int8)
        xz[:M, kb:ke] = x[:, kb:ke]
        wz = np.zeros((K + 64, N + 64), np.int8)
        wz[kb:ke, :N] = w[kb:ke]
        for m0 in range(0, M, bm):
            for n0 in range(0, N, gops.W8_BN):
                tile = np.zeros((bm, gops.W8_BN), np.int64)
                for warp in range(gops.W8_WARPS):
                    acc = np.zeros((mt_n, 8, 32, 4), np.int64)
                    for k0 in range(kb + warp * gops.W8_KS, ke,
                                    gops.W8_WARPS * gops.W8_KS):
                        kr = k0 + 16 * TIG           # the lane's K rows
                        col = n0 + 8 * GRP           # its 8 columns
                        wr = [np.stack([wz[kr + i, col + j]
                                        for j in range(8)], -1)
                              for i in range(16)]    # [32 lanes, 8]
                        wlo = [_words(r[:, :4].copy()) for r in wr]
                        whi = [_words(r[:, 4:].copy()) for r in wr]
                        xr = [[_words(np.stack(
                            [xz[m0 + 16 * mt + GRP + 8 * hh, kr + j]
                             for j in range(16)], -1).reshape(32, 4, 4))
                            for hh in range(2)] for mt in range(mt_n)]
                        for s in range(2):
                            b = []
                            for hh in range(2):
                                i = 8 * s + 4 * hh
                                b.append(transpose4x4(wlo[i:i + 4], sel)
                                         + transpose4x4(whi[i:i + 4], sel))
                            for mt in range(mt_n):
                                lo, hi = xr[mt]
                                a = np.stack([lo[:, 2 * s], hi[:, 2 * s],
                                              lo[:, 2 * s + 1],
                                              hi[:, 2 * s + 1]], -1)
                                for q in range(8):
                                    acc[mt, q] = mma_m16n8k32(
                                        acc[mt, q], a,
                                        np.stack([b[0][q], b[1][q]], -1))
                    # the fold: accumulator c of n8 tile q sits at row
                    # g + 8*(c//2), column 16t + 8*(c%2) + q
                    for mt in range(mt_n):
                        for q in range(8):
                            for c in range(4):
                                np.add.at(tile, (16 * mt + GRP + 8 * (c // 2),
                                                 16 * TIG + 8 * (c % 2) + q),
                                          acc[mt, q, :, c])
                rows = min(bm, M - m0)
                cols = min(gops.W8_BN, N - n0)
                out[m0:m0 + rows, n0:n0 + cols] += tile[:rows, :cols]
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)


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
