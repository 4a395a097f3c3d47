"""The port's sliding-window and softcap attention, its dense float KV
cache and one dense decode step, held to the JAX package on the CPU at
smoke size (float32, inputs from numpy seeds).  Tolerance rtol 1e-5 /
atol 1e-6 unless a test states a tighter one: the frameworks sum the
softmax and the value products in other orders.  The cache writes and
the KV codes are integer moves and held bit for bit.  The JAX functions
run under one ``jax.jit`` each.

* ``local_attention`` at S in {window - 1, window, 3 * window + 5}, with
  and without a softcap, GQA and MQA, the port in query chunks smaller
  than the sequence; ``multi_head_attention`` (causal, offset queries,
  a softcap, a window).
* ``decode_attention`` over a full cache and over a ring through its
  wraparound, with a window and a softcap, at a scalar position and at
  per-slot positions; ``update_kv_cache`` plain and ring.
* ``quantize_kv`` / ``dequantize_kv``.
* ``recurrentgemma-2b`` and ``recurrentgemma-smoke`` equal the JAX
  configs; ``decode_step`` of ``recurrentgemma-smoke`` (float params from
  JAX's ``init_lm``) from JAX's state at each of 20 positions (its
  16-slot ring wraps): logits and every state leaf against JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn
from repro.configs import get_smoke as j_get_smoke
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_decode_state as j_init_decode_state
from repro.models.model import init_lm as j_init_lm
from repro.serving import dequantize_kv as j_dequantize_kv
from repro.serving import quantize_kv as j_quantize_kv
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import decode_step, init_decode_state, tree_leaves
from repro_torch.models.attention import (causal_attention, decode_attention,
                                          local_attention, update_kv_cache)
from repro_torch.serving import dequantize_kv, quantize_kv

TOL = dict(rtol=1e-5, atol=1e-6)
WINDOW = 8

_j_local = jax.jit(j_attn.local_attention,
                   static_argnames=("window", "softcap", "chunk_q"))
_j_mha = jax.jit(j_attn.multi_head_attention,
                 static_argnames=("causal", "window", "softcap"))
_j_decode_attention = jax.jit(j_attn.decode_attention,
                              static_argnames=("window", "ring", "softcap"))
_j_update = jax.jit(j_attn.update_kv_cache, static_argnames=("ring",))
_j_decode_step = jax.jit(j_decode_step, static_argnums=1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _qkv(seed, B, Sq, Sk, Hq, Hkv, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
@pytest.mark.parametrize("softcap", [None, 2.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("S", [WINDOW - 1, WINDOW, 3 * WINDOW + 5])
def test_local_attention_matches_jax(S, softcap, heads):
    """Scores scaled by 1/4 (hd 16) and N(0, 1) inputs: a softcap of 2
    bends them.  The port runs queries in chunks of 5 (its own chunking
    at every S here), JAX in one."""
    q, k, v = _qkv(S, 2, S, S, *heads)
    want = _j_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=WINDOW, softcap=softcap)
    got = local_attention(_t(q), _t(k), _t(v), window=WINDOW,
                          softcap=softcap, chunk_q=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the chunked form is the plain masked softmax
    plain = causal_attention(_t(q), _t(k), _t(v), window=WINDOW,
                             softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window"])
def test_multi_head_attention_with_softcap_matches_jax(window):
    """Causal attention of 9 queries at offset 4 over 13 keys, softcap
    2.0, GQA 4/2: the port's ``causal_attention``."""
    q, k, v = _qkv(3, 2, 9, 13, 4, 2)
    want = _j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window, q_offset=4, softcap=2.0)
    got = causal_attention(_t(q), _t(k), _t(v), q_offset=4, window=window,
                           softcap=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_decode_attention_matches_jax(ring):
    """12 cache slots, 3 slots of a batch: each slot's query at its own
    position (per-slot vector) against JAX at that slot's scalar
    position, window 6 and softcap 2.0, and without both.  The ring's
    positions run past 12, so its slots hold wrapped positions."""
    q, k, v = _qkv(4, 3, 1, 12, 4, 1)
    positions = [3, 17, 30] if ring else [0, 7, 11]
    for kw in (dict(window=6, softcap=2.0), dict(window=None, softcap=None)):
        got = decode_attention(_t(q), _t(k), _t(v),
                               torch.tensor(positions), ring=ring, **kw)
        for b, pos in enumerate(positions):
            want = _j_decode_attention(
                jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                jnp.asarray(v[b:b + 1]), jnp.int32(pos), ring=ring, **kw)
            np.testing.assert_allclose(got[b:b + 1].numpy(),
                                       np.asarray(want), **TOL)
            # a scalar position equals the vector's slot
            one = decode_attention(_t(q[b:b + 1]), _t(k[b:b + 1]),
                                   _t(v[b:b + 1]), pos, ring=ring, **kw)
            assert torch.equal(one, got[b:b + 1])


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_update_kv_cache_bit_equal(ring):
    """Writes of 1 and 3 tokens at scalar positions (the ring's past its
    size, a plain write past the end clamped as ``dynamic_update_slice``
    clamps), and per-slot positions against JAX slot by slot."""
    rng = np.random.default_rng(6)
    kc, vc = (rng.standard_normal((2, 8, 1, 4)).astype(np.float32)
              for _ in range(2))
    for S, positions in ((1, (0, 5, 13)), (3, (2, 7, 11))):
        kn, vn = (rng.standard_normal((2, S, 1, 4)).astype(np.float32)
                  for _ in range(2))
        for pos in positions:
            want = _j_update(*map(jnp.asarray, (kc, vc, kn, vn)),
                             jnp.int32(pos), ring=ring)
            got = update_kv_cache(*map(_t, (kc, vc, kn, vn)), pos,
                                  ring=ring)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        got = update_kv_cache(*map(_t, (kc, vc, kn, vn)),
                              torch.tensor(positions[1:]), ring=ring)
        for b, pos in enumerate(positions[1:]):
            want = _j_update(*(jnp.asarray(a[b:b + 1])
                               for a in (kc, vc, kn, vn)),
                             jnp.int32(pos), ring=ring)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[b:b + 1].numpy(),
                                              np.asarray(w))


def test_quantize_kv_matches_jax():
    """Codes bit-equal, scales and dequantized values equal, on values
    spread over four decades."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 16, 4, 8))
         * 10.0 ** rng.uniform(-2, 2, (2, 1, 4, 1))).astype(np.float32)
    jc, js = j_quantize_kv(jnp.asarray(x))
    tc, ts = quantize_kv(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_kv(tc, ts, torch.float32).numpy(),
        np.asarray(j_dequantize_kv(jc, js, jnp.float32)))


# ---------------------------------------------------------------------------
# recurrentgemma
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_recurrentgemma_config_is_the_jax_packages(which):
    """Every field the port's ``ModelConfig`` has equals the JAX
    package's; it validates and is ported (the registry serves it)."""
    import repro.configs.recurrentgemma_2b as j_mod
    import repro_torch.configs.recurrentgemma_2b as t_mod
    jc, tc = ((j_mod.CONFIG, t_mod.CONFIG) if which == "CONFIG"
              else (j_mod.smoke_config(), t_mod.smoke_config()))
    for f in dataclasses.fields(tc):
        if f.name not in ("quant", "quant_policy"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.n_units, tc.n_rem, tc.recurrent) == (8 if which == "CONFIG"
                                                    else 1,
                                                    2 if which == "CONFIG"
                                                    else 0, True)
    tc.validate().check_ported()
    assert get_config("recurrentgemma-2b").local_window == 2048
    assert get_smoke("recurrentgemma-2b") == t_mod.smoke_config()


def test_decode_steps_match_jax():
    """``recurrentgemma-smoke`` (float32, JAX's ``init_lm`` converted):
    20 tokens through JAX's ``decode_step`` from a fresh state of
    cache_len 20 at batch 2 (the local layer's ring has 16 slots and
    wraps at step 16).  At every step the port takes JAX's state as it
    stood and runs one ``decode_step`` (the two slots as one batch with a
    per-slot position vector; JAX: a scalar position): its logits and
    every leaf of its new state (RG-LRU ``h`` / ``conv``, the ring's K/V)
    against JAX's, within rtol 1e-5 / atol 1e-6 (measured: at most
    2.2e-6 apart, on values of order 1)."""
    jcfg = dataclasses.replace(j_get_smoke("recurrentgemma-2b"),
                               scan_layers=False)
    cfg = get_smoke("recurrentgemma-2b")
    jp = j_init_lm(jax.random.PRNGKey(3), jcfg)
    tp = convert_params(jp, device="cpu")
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 20))
    jst = j_init_decode_state(jcfg, 2, 20)
    fresh = init_decode_state(cfg, 2, 20, device="cpu")
    assert fresh["units"]["u0"]["2"]["k"].shape == (2, 16, 1, 32)
    assert sorted(dict(tree_leaves(fresh))) == sorted(
        dict(tree_leaves(convert_params(jst, device="cpu"))))
    for t in range(tokens.shape[1]):
        tl, tst = decode_step(tp, cfg, convert_params(jst, device="cpu"),
                              _t(tokens[:, t:t + 1]),
                              torch.tensor([t, t], dtype=torch.int32))
        jl, jst = _j_decode_step(jp, jcfg, jst,
                                 jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                 jnp.int32(t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        want = dict(tree_leaves(convert_params(jst, device="cpu")))
        for path, leaf in tree_leaves(tst):
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       err_msg=f"{path} at step {t}", **TOL)
