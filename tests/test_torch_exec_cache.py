"""The port's exec layer and paged INT8 KV cache against the JAX package.

* ``execute_gemm`` on linears calibrated and exported by the JAX package
  and carried across with ``repro_torch.checkpoint.convert_params``:
  bit-exact against the JAX ``oracle`` backend given the same float
  input (per-channel and per-tensor weights, APSQ / PSQ / W8A8, M = 1
  and M > 1).  The port's ``_export_one`` gives the same codes and
  exponents from the same float state.
* The paged cache writers (``paged_update_and_attend`` and the chunked
  writer, stable and replay regimes) given identical float k/v: pools
  bit-equal except the null page 0, running exponents equal, attention
  outputs within rtol 2e-5 / atol 2e-6 (two float softmax
  implementations; the INT8 codes they read are identical).

Inputs come from seeded numpy generators and go through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantConfig as JQC
from repro.core import calibrate_dense as j_calibrate_dense
from repro.core import quant_params_init as j_quant_params_init
from repro.exec import execute_gemm as j_execute_gemm
from repro.quant.export import _export_one as j_export_one
from repro.serving import paged_cache as jpc
from repro_torch.checkpoint import convert_params
from repro_torch.exec import (execute_gemm, kv_block_size,
                              quantize_activations)
from repro_torch.quant.export import _export_one as t_export_one
from repro_torch.serving import paged_cache as tpc

GEMM_CASES = [  # (k, n, config, per_channel, leading shape of x)
    (64, 32, JQC.apsq(gs=2, n_p=4), True, (7,)),
    (64, 32, JQC.apsq(gs=2, n_p=4), True, (1,)),
    (128, 48, JQC.apsq(gs=4, n_p=8), True, (2, 5)),
    (128, 48, JQC.apsq(gs=3, n_p=8), False, (3,)),
    (96, 16, JQC.psq(n_p=4), True, (4,)),
    (64, 40, JQC.w8a8(), True, (6,)),
    (64, 40, JQC.w8a8(), True, (1, 1)),
]


def _jax_layer(k, n, cfg, per_channel, seed):
    import dataclasses
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    xcal = rng.standard_normal((32, k)).astype(np.float32)
    cfg = dataclasses.replace(cfg, per_channel_w=per_channel)
    qp = j_calibrate_dense(j_quant_params_init(jnp.asarray(w), cfg),
                           jnp.asarray(xcal), jnp.asarray(w))
    dq, _ = j_export_one(jnp.asarray(w), qp)
    return w, qp, dq


@pytest.mark.parametrize("k,n,cfg,per_channel,lead", GEMM_CASES)
def test_execute_gemm_bit_exact_on_jax_exported_layer(k, n, cfg, per_channel,
                                                      lead):
    w, qp, dq = _jax_layer(k, n, cfg, per_channel, seed=k + n)
    rng = np.random.default_rng(k * n)
    x = (rng.standard_normal(lead + (k,)) * 1.3).astype(np.float32)
    want = np.asarray(j_execute_gemm(dq, jnp.asarray(x), backend="oracle"))
    tq = convert_params({"qp": dq}, device="cpu")["qp"]
    got = execute_gemm(tq, torch.from_numpy(x), backend="oracle")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # "auto" on CPU tensors is the oracle
    assert torch.equal(execute_gemm(tq, torch.from_numpy(x)), got)
    # the port's export of the same float state gives the same integers
    tstate = convert_params({"qp": qp, "w": w}, device="cpu")
    tdq, _ = t_export_one(tstate["w"], tstate["qp"])
    for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
        a, b = getattr(tdq, f), getattr(tq, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_quantize_activations_and_block_size_match_jax():
    from repro.exec import kv_block_size as j_kv_block_size
    from repro.exec import quantize_activations as j_quantize_activations
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((9, 24)) * 40).astype(np.float32)
    for e in (-7, -3, 0, 2):
        np.testing.assert_array_equal(
            quantize_activations(torch.from_numpy(x),
                                 torch.tensor(e, dtype=torch.int32)).numpy(),
            np.asarray(j_quantize_activations(jnp.asarray(x),
                                              jnp.asarray(e, jnp.int32))))
    for s, r in ((96, 512), (96, 64), (7, 4), (64, 16)):
        assert kv_block_size(s, r) == j_kv_block_size(s, r)


# ---------------------------------------------------------------------------
# Paged INT8 KV cache
# ---------------------------------------------------------------------------

P, HKV, HD, HQ, N_PAGES = 4, 2, 8, 4, 12
TABLE = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)   # slot 1: 2 pages


def _fresh(batch):
    return {"k_pages": np.zeros((N_PAGES, P, HKV, HD), np.int8),
            "v_pages": np.zeros((N_PAGES, P, HKV, HD), np.int8),
            "k_exp": np.full((batch, HKV), jpc.EXP_FLOOR, np.int32),
            "v_exp": np.full((batch, HKV), jpc.EXP_FLOOR, np.int32)}


def _jcache(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _tcache(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


def _assert_cache_equal(tc, jc):
    for key in ("k_pages", "v_pages"):   # page 0 is the junk null page
        np.testing.assert_array_equal(tc[key].numpy()[1:],
                                      np.asarray(jc[key])[1:], err_msg=key)
    for key in ("k_exp", "v_exp"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)


def _stream(rng, t, batch, growth):
    """Token t's q/k/v; magnitudes grow with t so exponents bump."""
    s = growth ** t
    q = rng.standard_normal((batch, HQ, HD)).astype(np.float32)
    k = (rng.standard_normal((batch, 1, HKV, HD)) * s).astype(np.float32)
    v = (rng.standard_normal((batch, 1, HKV, HD)) * s).astype(np.float32)
    return q, k, v


def test_paged_decode_writer_matches_jax():
    rng = np.random.default_rng(21)
    jc, tc = _jcache(_fresh(2)), _tcache(_fresh(2))
    jt, tt = jnp.asarray(TABLE), torch.from_numpy(TABLE)
    bumps = 0
    for t in range(8):                     # slot 1 fills its 2 pages
        q, k, v = _stream(rng, t, 2, growth=1.6)
        pos = np.asarray([t, t], np.int32)
        jo, jc = jpc.paged_update_and_attend(
            jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), jt, backend="oracle")
        prev = tc["k_exp"].clone()
        to, tc = tpc.paged_update_and_attend(
            tc, torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(pos), tt, backend="oracle")
        bumps += int((tc["k_exp"] != prev).sum()) if t else 0
        _assert_cache_equal(tc, jc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                                   atol=2e-6)
    assert bumps > 0, "no exponent bump exercised the shift path"


@pytest.mark.parametrize("regime", ["stable", "replay"])
def test_paged_chunk_writer_matches_jax(regime):
    """A prefill chunk at a non-zero position over a populated slot.
    stable: the chunk's first token is its largest, so the exponents
    after it cover the chunk.  replay: a late large token bumps an
    exponent mid-chunk."""
    rng = np.random.default_rng(5 if regime == "stable" else 6)
    jc, tc = _jcache(_fresh(2)), _tcache(_fresh(2))
    jt, tt = jnp.asarray(TABLE), torch.from_numpy(TABLE)
    for t in range(2):                     # history written token by token
        q, k, v = _stream(rng, t, 2, growth=1.0)
        pos = np.asarray([t, t], np.int32)
        _, jc = jpc.paged_update_and_attend(
            jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), jt, backend="oracle")
        _, tc = tpc.paged_update_and_attend(
            tc, torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(pos), tt, backend="oracle")
    C = 4
    scale = np.ones((1, C, 1, 1), np.float32)
    if regime == "stable":
        scale[0, 0] = 8.0
    else:
        scale[0, C - 1] = 8.0
    q = rng.standard_normal((2, C, HQ, HD)).astype(np.float32)
    k = (rng.standard_normal((2, C, HKV, HD)) * scale).astype(np.float32)
    v = (rng.standard_normal((2, C, HKV, HD)) * scale).astype(np.float32)
    pos = np.asarray([2, 2], np.int32)
    _, _, _, seq = tpc._update_pool_chunk(
        tc["k_pages"], tc["k_exp"], torch.from_numpy(k), torch.from_numpy(pos),
        tt)
    assert torch.equal(seq[0], seq[-1]) == (regime == "stable")
    jo, jc = jpc.paged_prefill_chunk_update_and_attend(
        jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jt, backend="oracle")
    to, tc = tpc.paged_prefill_chunk_update_and_attend(
        tc, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), tt, backend="oracle")
    _assert_cache_equal(tc, jc)
    assert to.shape == (2, C, HQ, HD)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-6)


def test_po2_exponent_quantize_and_shift_match_jax():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 5, HKV, HD)) * 3).astype(np.float32)
    e = np.asarray(jpc.po2_exponent(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tpc.po2_exponent(torch.from_numpy(x)).numpy(), e)
    np.testing.assert_array_equal(
        tpc.quantize_at(torch.from_numpy(x), torch.from_numpy(np.array(e)))
        .numpy(), np.asarray(jpc.quantize_at(jnp.asarray(x), jnp.asarray(e))))
    codes = rng.integers(-127, 128, size=(3, 2, P, HKV, HD)).astype(np.int8)
    shift = rng.integers(0, 9, size=(3, HKV)).astype(np.int32)
    np.testing.assert_array_equal(
        tpc._shift_codes(torch.from_numpy(codes),
                         torch.from_numpy(shift)).numpy(),
        np.asarray(jpc._shift_codes(jnp.asarray(codes), jnp.asarray(shift))))
    assert list(tpc.page_span(5, 13, 4)) == list(jpc.page_span(5, 13, 4))
