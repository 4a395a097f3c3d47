"""The port's kernel references against the JAX package's, on the CPU.

* The torch integer oracle (``repro_torch.kernels.apsq_matmul.ref``) is
  bit-exact against ``repro.kernels.apsq_matmul.ref`` over shapes, M=1,
  gs in {1..4}, n_p=1, ragged K, [n_p] and [n_p, N] exponents and
  adversarial exponents (shift counts >= 32 and < 0 follow XLA).
* The INT8-KV attention reference matches ``int8_kv_attention_ref`` in
  the decode (3-D) and chunk (4-D) forms within rtol 2e-5 / atol 2e-6,
  the bound the JAX package holds its own kernel to.
* The exact PO2-exponent helper is pinned at its boundaries.
* On a tensor that lies on the CPU the kernel wrappers run the plain
  version and launch nothing (the kernels themselves are held against
  the plain versions on the card in ``test_torch_cuda.py``).

Inputs come from seeded numpy generators and go through both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.apsq_matmul import ref as jref
from repro.kernels.int8_kv_attention import ref as jkv
from repro_torch.core.po2 import ceil_log2, floor_log2, pow2
from repro_torch.kernels import _build
from repro_torch.kernels.apsq_matmul import ops as tops
from repro_torch.kernels.apsq_matmul import ref as tref
from repro_torch.kernels.int8_kv_attention import ops as tkv_ops
from repro_torch.kernels.int8_kv_attention import ref as tkv


def _codes(rng, shape):
    return rng.integers(-128, 128, size=shape).astype(np.int8)


# (m, k, n, n_p, gs, exps): exps "auto" = choose_exps, "cols" = per-column
# [n_p, N] built from it, or an explicit adversarial [n_p] list.
GEMM_CASES = [
    (8, 64, 32, 4, 2, "auto"),
    (1, 64, 48, 4, 2, "auto"),          # M = 1
    (5, 128, 24, 8, 1, "auto"),
    (5, 128, 24, 8, 2, "auto"),
    (5, 128, 24, 8, 3, "auto"),         # final tile closes mid-group
    (5, 128, 24, 8, 4, "auto"),
    (7, 96, 20, 1, 1, "auto"),          # n_p = 1
    (6, 45, 16, 4, 2, "auto"),          # ragged K
    (3, 37, 9, 3, 2, "auto"),           # ragged K, odd tile
    (1, 45, 16, 4, 3, "cols"),          # ragged + per-column, M = 1
    (9, 64, 40, 4, 2, "cols"),
    (4, 128, 16, 8, 8, "cols"),         # gs = n_p (PSQ)
    (4, 64, 16, 4, 2, [0, 0, 0, 0]),
    (4, 64, 16, 4, 2, [20, 20, 20, 20]),
    (4, 64, 16, 4, 2, [0, 20, 0, 20]),
    (4, 64, 16, 4, 1, [31, 32, 40, 0]),  # shift counts >= 32
    (4, 64, 16, 4, 2, [-1, 3, -2, 5]),   # negative counts
]


def _exps(case_exps, x, w, n_p, gs, n):
    if isinstance(case_exps, list):
        return np.asarray(case_exps, np.int32)
    base = np.array(jref.choose_exps(jnp.asarray(x), jnp.asarray(w),
                                     n_p=n_p, gs=gs))
    if case_exps == "cols":
        return (base[:, None] + np.arange(n)[None, :] % 3).astype(np.int32)
    return base


@pytest.mark.parametrize("m,k,n,n_p,gs,exps", GEMM_CASES)
def test_apsq_oracle_bit_exact_vs_jax(m, k, n, n_p, gs, exps):
    rng = np.random.default_rng(1000 + m * 31 + k * 7 + n + gs)
    x, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    e = _exps(exps, x, w, n_p, gs, n)
    want = np.asarray(jref.apsq_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(e), n_p=n_p, gs=gs))
    got = tref.apsq_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(e), n_p=n_p, gs=gs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n,n_p,gs", [(8, 64, 32, 4, 2), (1, 45, 16, 4, 3),
                                          (5, 128, 24, 8, 4), (3, 32, 8, 1, 1)])
def test_choose_exps_and_tiles_bit_exact_vs_jax(m, k, n, n_p, gs):
    rng = np.random.default_rng(7 + k)
    x, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        tref.choose_exps(tx, tw, n_p=n_p, gs=gs).numpy(),
        np.asarray(jref.choose_exps(jx, jw, n_p=n_p, gs=gs)))
    np.testing.assert_array_equal(tref.psum_tiles(tx, tw, n_p).numpy(),
                                  np.asarray(jref.psum_tiles(jx, jw, n_p)))


@pytest.mark.parametrize("m,k,n", [(8, 64, 32), (1, 45, 16), (17, 96, 8)])
def test_baseline_oracle_bit_exact_vs_jax(m, k, n):
    rng = np.random.default_rng(k * n)
    x, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    want = np.asarray(jref.baseline_matmul_ref(jnp.asarray(x),
                                               jnp.asarray(w)))
    got = tref.baseline_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_shift_helpers_follow_xla_semantics():
    rng = np.random.default_rng(3)
    v = rng.integers(-2**31, 2**31 - 1, size=64).astype(np.int32)
    e = rng.integers(-3, 40, size=64).astype(np.int32)
    for jf, tf in ((jref.rshift_round, tref.rshift_round),
                   (jref.dequantize_psum, tref.dequantize_psum)):
        arg = v if jf is jref.rshift_round else v.astype(np.int8)
        np.testing.assert_array_equal(
            tf(torch.from_numpy(arg), torch.from_numpy(e)).numpy(),
            np.asarray(jf(jnp.asarray(arg), jnp.asarray(e))))
    np.testing.assert_array_equal(
        tref.quantize_psum(torch.from_numpy(v), torch.from_numpy(e)).numpy(),
        np.asarray(jref.quantize_psum(jnp.asarray(v), jnp.asarray(e))))


def test_wrappers_take_plain_version_on_cpu_and_launch_nothing():
    rng = np.random.default_rng(5)
    x, w = torch.from_numpy(_codes(rng, (4, 45))), torch.from_numpy(
        _codes(rng, (45, 16)))
    e = tref.choose_exps(x, w, n_p=4, gs=2)
    before = dict(_build.launch_counts)
    assert torch.equal(tops.apsq_matmul_int8(x, w, e, gs=2),
                       tref.apsq_matmul_ref(x, w, e, n_p=4, gs=2))
    assert torch.equal(tops.apsq_matmul_int8(x[:1], w, e, gs=2),
                       tref.apsq_matmul_ref(x[:1], w, e, n_p=4, gs=2))
    assert torch.equal(tops.baseline_matmul_int8(x, w),
                       tref.baseline_matmul_ref(x, w))
    assert _build.launch_counts == before


# ---------------------------------------------------------------------------
# INT8-KV attention reference
# ---------------------------------------------------------------------------

KV_CASES = [  # (B, C, S, Hq, Hkv, hd, lengths); C = 0 -> 3-D decode q
    (2, 0, 32, 4, 2, 16, [17, 32]),
    (3, 0, 48, 8, 2, 8, [1, 20, 48]),
    (2, 4, 32, 4, 2, 16, [9, 32]),
    (1, 8, 64, 8, 4, 16, [30]),
    (2, 1, 16, 4, 4, 8, [5, 16]),       # C = 1 chunk == decode
]


def _kv_inputs(rng, B, C, S, Hq, Hkv, hd):
    qshape = (B, Hq, hd) if C == 0 else (B, C, Hq, hd)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32) * 2.0
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths", KV_CASES)
def test_kv_attention_ref_matches_jax(B, C, S, Hq, Hkv, hd, lengths):
    rng = np.random.default_rng(B * 100 + C * 10 + S)
    q, k, v = _kv_inputs(rng, B, C, S, Hq, Hkv, hd)
    jkc, jke = jkv.quantize_kv_po2(jnp.asarray(k))
    jvc, jve = jkv.quantize_kv_po2(jnp.asarray(v))
    tkc, tke = tkv.quantize_kv_po2(torch.from_numpy(k))
    tvc, tve = tkv.quantize_kv_po2(torch.from_numpy(v))
    for a, b in ((tkc, jkc), (tke, jke), (tvc, jvc), (tve, jve)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    length = np.asarray(lengths, np.int32)
    want = np.asarray(jkv.int8_kv_attention_ref(
        jnp.asarray(q), jkc, jvc, jke, jve, jnp.asarray(length)))
    got = tkv.int8_kv_attention_ref(torch.from_numpy(q), tkc, tvc, tke, tve,
                                    torch.from_numpy(length))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    # the wrapper on CPU tensors is the reference itself
    np.testing.assert_array_equal(
        tkv_ops.int8_kv_attention(torch.from_numpy(q), tkc, tvc, tke, tve,
                                  torch.from_numpy(length)).numpy(),
        got.numpy())


# ---------------------------------------------------------------------------
# Exact PO2 exponents
# ---------------------------------------------------------------------------

def _true_ceil_log2(v: float) -> int:
    m, e = math.frexp(v)
    return e - 1 if m == 0.5 else e


def test_po2_helper_boundaries_against_jax():
    """Sweep amax = 127 * 2^n and +-1 ulp (the KV / choose_exps form
    ``ceil(log2(amax / 127))``) and 2^n +-1 ulp (the export form
    ``floor(log2 .)``).  The port is exact at every point.  XLA's float
    ``log2`` is not exact there; the points where JAX differs are listed
    and must all lie within one ulp of a power of two.  Away from those
    points (a broad random sample) the port equals JAX exactly."""
    ns = np.arange(-110, 121)
    base = np.ldexp(np.float32(127), ns).astype(np.float32)
    jax_off = {}
    for label, amax in (("exact", base),
                        ("+1ulp", np.nextafter(base, np.float32(np.inf))),
                        ("-1ulp", np.nextafter(base, np.float32(0)))):
        q = (amax / np.float32(127)).astype(np.float32)
        true = np.array([_true_ceil_log2(float(v)) for v in q])
        port = ceil_log2(torch.from_numpy(amax) / 127.0).numpy()
        np.testing.assert_array_equal(port, true)
        jx = np.asarray(jnp.ceil(jnp.log2(jnp.asarray(amax) / 127.0)))
        jax_off[f"ceil {label}"] = ns[jx.astype(np.int64) != true].tolist()
        if label == "exact":
            np.testing.assert_array_equal(port, ns)

    ps = np.arange(-125, 127)
    p2 = np.ldexp(np.float32(1), ps).astype(np.float32)
    for label, y in (("exact", p2),
                     ("+1ulp", np.nextafter(p2, np.float32(np.inf))),
                     ("-1ulp", np.nextafter(p2, np.float32(0)))):
        true = np.array([math.frexp(float(v))[1] - 1 for v in y])
        port = floor_log2(torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(port, true)
        jx = np.asarray(jnp.floor(jnp.log2(jnp.asarray(y))))
        jax_off[f"floor {label}"] = ps[jx.astype(np.int64) != true].tolist()

    # Reported, not hidden: where XLA's log2 moves an exponent.
    print({k: len(v) for k, v in jax_off.items()}, jax_off)

    rng = np.random.default_rng(0)
    y = rng.lognormal(0.0, 8.0, 200_000).astype(np.float32)
    y = y[(y > 1e-30) & (y < 1e30)]
    np.testing.assert_array_equal(
        ceil_log2(torch.from_numpy(y) / 127.0).numpy(),
        np.asarray(jnp.ceil(jnp.log2(jnp.asarray(y) / 127.0))).astype(
            np.int32))
    np.testing.assert_array_equal(
        floor_log2(torch.from_numpy(y)).numpy(),
        np.asarray(jnp.floor(jnp.log2(jnp.asarray(y)))).astype(np.int32))


def test_pow2_is_exact_where_xla_exp2_is_not():
    """The port builds 2^e from its bits: exact for every normal exponent.
    XLA's float ``exp2`` of an integer is not exact everywhere; the
    exponents where it is off are listed.  The parity tests rely on
    [-12, 12], where it is exact."""
    e = torch.arange(-126, 128, dtype=torch.int32)
    want = torch.tensor([math.ldexp(1.0, int(i)) for i in e],
                        dtype=torch.float64)
    assert torch.equal(pow2(e).double(), want)
    jx = np.asarray(jnp.exp2(jnp.asarray(e.numpy().astype(np.float32))))
    off = e.numpy()[jx.astype(np.float64) != want.numpy()].tolist()
    print(f"XLA exp2 inexact at {len(off)} of {len(e)} exponents: {off}")
    assert not [i for i in off if -12 <= i <= 12]
