"""The port's recurrent blocks (RWKV-6, RG-LRU) and remainder layers held
to the JAX package on the CPU at smoke size (float32; numpy seeds).  Each
float bound below was measured on the CPU (torch 2.13, JAX 0.9.0) over
the seeds the test runs and is stated where it is asserted: the
frameworks order float sums differently, so RWKV-6's exponentials and
RG-LRU's scan agree to float rounding, compared as relative errors where
the values span orders of magnitude.  The JAX functions run under one
``jax.jit`` each (eagerly, JAX compiles every op apart); the bounds were
measured against them called eagerly and hold jitted.

* ``rwkv6-smoke`` (2 layers, d_model 64, 2 heads of 32, ``wkv_impl=
  "chunked"``): the time mix and channel mix, ``_wkv_scan`` and
  ``_wkv_chunked`` (a chunk that pads, a carried state, ``log_w`` on
  its clip bounds) and the forward logits against JAX; the port's
  calibrate + export on JAX's float params gives JAX's export bit for
  bit, and every deployed GEMM of it runs bit-exact against JAX's
  ``oracle``; the port's ``PagedServingEngine`` gives the JAX ``oracle``
  engine's greedy tokens from the same export.
* The port's own invariants: a prefill chunk leaves every state leaf
  and the logits bit-equal to per-token decode, a batch gives the
  single-stream tokens, and a slot reused by a second request gives that
  request's fresh tokens (the reset of a new slot's recurrent states).
* An RG-LRU block against JAX: the log-depth doubling scan against the
  associative scan, the exact scan and decode.
* The hybrid ``("attn", "rwkv", "rglru")`` stack of the reference's
  paged-serving test with ``n_layers=4``, so that one remainder layer
  (``rem.0``, attention) exists: params tree, forward logits and engine
  tokens against JAX; calibrate, export and serve in the port.
* One ``rwkv6-smoke`` QAT step (APSQ gs=2 n_p=8, two microbatches) on
  the power-of-two grid against JAX's ``make_train_step``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as j_rglru
import repro.models.rwkv as j_rwkv
import repro_torch.models.rglru as t_rglru
import repro_torch.models.rwkv as t_rwkv
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantState as JQuantState
from repro.core import deployed_dense as j_deployed_dense
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import forward as j_forward
from repro.models.model import init_lm as j_init_lm
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.quant.qat import policy_presets as j_policy_presets
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState, deployed_dense
from repro_torch.models import (forward, forward_paged_chunk, init_lm,
                                init_paged_decode_state, tree_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimConfig, init_opt_state
from repro_torch.quant import (calibrate_model, export_quantized,
                               policy_presets)
from repro_torch.serving import PagedServingEngine, Request
from repro_torch.train import TrainConfig, make_train_step

HYBRID = dict(name="m", family="dense", n_layers=4, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
              block_pattern=("attn", "rwkv", "rglru"), d_rnn=32,
              wkv_impl="chunked", wkv_chunk=4)
ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
PROMPTS = [(5, 6), (9, 7), (1, 5), (13, 6), (6, 8)]    # (prompt, new)

# The JAX package's functions, each under one ``jax.jit``: called eagerly,
# JAX compiles every op of them on its own, which dominates this file.
_j_init_lm = jax.jit(j_init_lm, static_argnums=1)
_j_forward = jax.jit(j_forward, static_argnums=1,
                     static_argnames=("backend",))
_j_deployed_dense = jax.jit(j_deployed_dense, static_argnames=("backend",))
_j_init_time_mix = jax.jit(j_rwkv.init_rwkv_time_mix,
                           static_argnums=(1, 2, 3, 4))
_j_init_channel_mix = jax.jit(j_rwkv.init_rwkv_channel_mix,
                              static_argnums=(1, 2, 3))
_j_init_rglru = jax.jit(j_rglru.init_rglru_block, static_argnums=(1, 2, 3))
_j_time_mix = jax.jit(j_rwkv.rwkv_time_mix, static_argnames=(
    "n_heads", "head_dim", "impl", "wkv_chunk"))
_j_channel_mix = jax.jit(j_rwkv.rwkv_channel_mix)
_j_wkv_scan = jax.jit(j_rwkv._wkv_scan)
_j_wkv_chunked = jax.jit(j_rwkv._wkv_chunked, static_argnames=("chunk",))
_j_rglru = jax.jit(j_rglru.rglru_block, static_argnames=("exact_scan",))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _keys(tree, path=""):
    if isinstance(tree, dict):
        return {k for key, v in tree.items()
                for k in _keys(v, f"{path}.{key}")}
    return {path}


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _spec(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(PROMPTS)]


def _run(engine, req_cls, spec, eos=None):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=m,
                    eos_token=eos.get(u) if eos else None)
            for u, t, m in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


def _po2_scales(tree):
    """Every quantizer scale a power of two (``snap_params_po2`` for
    ax/aw, ``floor`` of the log2 PSUM scales): fake quant is then exact."""
    def floor_ap(t):
        if isinstance(t, JQuantState):
            return dataclasses.replace(
                t, ap=None if t.ap is None else jnp.floor(t.ap))
        if isinstance(t, dict):
            return {k: floor_ap(v) for k, v in t.items()}
        return t
    return floor_ap(j_snap_params_po2(tree))


# ---------------------------------------------------------------------------
# rwkv6-smoke, built once: JAX float params, calibration, export
# ---------------------------------------------------------------------------

def _cfgs():
    jcfg = dataclasses.replace(j_get_smoke("rwkv6-3b"),
                               scan_layers=True).with_quant(
        j_policy_presets()["mix2_ffn4"])
    tcfg = get_smoke("rwkv6-3b").with_quant(policy_presets()["mix2_ffn4"])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_model() -> dict:
    jcfg, tcfg = _cfgs()
    p0 = _j_init_lm(jax.random.PRNGKey(11), jcfg)
    tok = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 16))
    calibrated = j_calibrate_model(p0, jcfg, {"tokens": jnp.asarray(tok)})
    deploy, _ = j_export_quantized(calibrated)
    return {"p0": p0, "tok": tok, "calibrated": calibrated,
            "deploy": deploy, "jcfg": jcfg, "tcfg": tcfg,
            "tdeploy": convert_params(deploy, device="cpu")}


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_rwkv6_config_is_the_jax_packages(which):
    """``rwkv6-3b`` and ``rwkv6-smoke``: every field the port's
    ``ModelConfig`` has equals the JAX package's; the config validates,
    and ``check_ported`` admits it and a hybrid with a remainder layer;
    the paged engine's state still refuses local attention."""
    import repro.configs.rwkv6_3b as j_mod
    import repro_torch.configs.rwkv6_3b as t_mod
    jc, tc = ((j_mod.CONFIG, t_mod.CONFIG) if which == "CONFIG"
              else (j_mod.smoke_config(), t_mod.smoke_config()))
    for f in dataclasses.fields(tc):
        if f.name not in ("quant", "quant_policy"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.n_units, tc.n_rem, tc.recurrent) == (jc.n_units, jc.n_rem,
                                                    True)
    tc.validate().check_ported()
    hybrid = ModelConfig(**HYBRID)
    assert (hybrid.n_units, hybrid.n_rem) == (1, 1)
    hybrid.validate().check_ported()
    with pytest.raises(ValueError):
        hybrid.scaled(d_rnn=None).validate()
    with pytest.raises(ValueError):
        tc.scaled(wkv_impl="parallel").validate()
    local = hybrid.scaled(block_pattern=("rglru", "local")).check_ported()
    with pytest.raises(NotImplementedError):
        init_paged_decode_state(local, 1, page_size=4, n_pages=2,
                                device="cpu")


# ---------------------------------------------------------------------------
# The blocks against their JAX functions
# ---------------------------------------------------------------------------

def _time_mix_case(seed: int):
    """JAX time-mix and channel-mix params (d 64, 2 heads of 32) with
    ``mu``, ``w0`` and ``u`` drawn so every mix and both clip bounds of
    ``log_w`` are exercised, an input [2, 37, 64] and a carried state."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    tm = _j_init_time_mix(key, 64, 2, 32, jnp.float32)
    tm["mu"] = jnp.asarray(rng.uniform(0, 1, (5, 64)), jnp.float32)
    tm["w0"] = jnp.asarray(rng.uniform(-9, 1.5, 64), jnp.float32)
    tm["ln_out"] = {"scale": jnp.asarray(rng.normal(1, .2, 64), jnp.float32),
                    "bias": jnp.asarray(rng.normal(0, .2, 64), jnp.float32)}
    cm = _j_init_channel_mix(jax.random.fold_in(key, 1), 64, 128,
                             jnp.float32)
    cm["mu"] = jnp.asarray(rng.uniform(0, 1, (2, 64)), jnp.float32)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    state = {"shift": rng.standard_normal((2, 1, 64)).astype(np.float32),
             "wkv": rng.standard_normal((2, 2, 32, 32)).astype(np.float32)}
    return tm, cm, x, state


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_time_mix_and_channel_mix_match_jax(seed, impl):
    """Outputs and carried states, fresh and from a state, chunk 8 (37
    tokens: the last chunk pads).  Measured relative error (max |diff| /
    max |JAX|) over seeds 0-2: time mix out 4.1e-7, wkv state 4.2e-7,
    channel mix 4.1e-8; held at 5e-6."""
    tm, cm, x, state = _time_mix_case(seed)
    ttm, tcm = convert_params(tm, device="cpu"), convert_params(
        cm, device="cpu")
    zeros = jax.tree.map(np.zeros_like, state)   # JAX's fresh state
    for st in (None, state):
        want, wst = _j_time_mix(
            tm, jnp.asarray(x), n_heads=2, head_dim=32, impl=impl,
            wkv_chunk=8, state=jax.tree.map(jnp.asarray,
                                            zeros if st is None else st))
        got, gst = t_rwkv.rwkv_time_mix(
            ttm, _t(x), n_heads=2, head_dim=32, impl=impl, wkv_chunk=8,
            state=None if st is None else {k: _t(v) for k, v in st.items()})
        assert _rel(got, want) <= 5e-6
        assert _rel(gst["wkv"], wst["wkv"]) <= 5e-6
        np.testing.assert_array_equal(gst["shift"].numpy(), wst["shift"])
    want, _ = _j_channel_mix(cm, jnp.asarray(x), state={
        "shift": jnp.asarray(state["shift"])})
    got, _ = t_rwkv.rwkv_channel_mix(tcm, _t(x),
                                     state={"shift": _t(state["shift"])})
    assert _rel(got, want) <= 5e-6


def _wkv_inputs(seed: int, S: int = 45):
    rng = np.random.default_rng(seed)
    B, H, hd = 2, 3, 16
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    log_w = np.clip(-np.exp(rng.uniform(-9, 1.5, (B, S, H, hd))), -2.0,
                    -1e-4).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, log_w, u, s0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wkv_scan_and_chunked_match_jax(seed):
    """45 tokens from a random state, ``log_w`` spanning [-2, -1e-4] (the
    clip): the chunked form at chunk 32 (one padded chunk, the
    ``exp(+-L)`` factors up to e^64) and 8, and the scan, each against
    JAX's; the port's chunked against its scan.  Measured relative error
    over seeds 0-2 (y and state): scan vs JAX 3.0e-7, chunked vs JAX
    5.2e-7, chunked vs scan 5.2e-7; held at 5e-6."""
    r, k, v, log_w, u, s0 = _wkv_inputs(seed)
    ja = [jnp.asarray(a) for a in (r, k, v, log_w, u, s0)]
    ta = [_t(a) for a in (r, k, v, log_w, u, s0)]
    jy, js = _j_wkv_scan(*ja)
    ty, ts = t_rwkv._wkv_scan(*ta)
    assert _rel(ty, jy) <= 5e-6 and _rel(ts, js) <= 5e-6
    for chunk in (32, 8):
        jcy, jcs = _j_wkv_chunked(*ja, chunk=chunk)
        tcy, tcs = t_rwkv._wkv_chunked(*ta, chunk=chunk)
        assert _rel(tcy, jcy) <= 5e-6 and _rel(tcs, jcs) <= 5e-6, chunk
        assert _rel(tcy, ty) <= 5e-6 and _rel(tcs, ts) <= 5e-6, chunk


def test_wkv_chunked_backward_matches_scan():
    """Under autograd the chunked WKV recomputes each chunk in the
    backward pass: its gradients equal the scan's to float order
    (measured 3.2e-7 relative; held at 5e-6)."""
    args = [_t(a).requires_grad_() for a in _wkv_inputs(3, S=21)]
    grads = []
    for fn in (t_rwkv._wkv_scan,
               functools.partial(t_rwkv._wkv_chunked, chunk=8)):
        y, s = fn(*args)
        g = torch.autograd.grad((y.square().sum() + s.square().sum()), args)
        grads.append(g)
    for a, b in zip(*grads):
        assert _rel(b, a) <= 5e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_rglru_block_matches_jax(seed):
    """A full sequence (23 tokens, from zeros and from a state) through
    the associative scan, the exact scan, and decode token by token,
    each against JAX.  Measured relative error over seeds 0-1: out
    3.4e-7, h 6.5e-7; held at 5e-6.  The port's exact scan equals its
    token-by-token decode bit for bit.  (d_rnn is a multiple of 32
    floats: on the CPU, ATen computes the last ``n mod 32`` elements of
    a tensor with scalar ``sigmoid``/``log1p``, which can round one ulp
    away from the vectorized ones, so there one element's value can
    depend on the tensor's size at other widths; the card runs one
    function for every element.)"""
    rng = np.random.default_rng(seed)
    jp = _j_init_rglru(jax.random.PRNGKey(seed), 48, 64, jnp.float32)
    jp["gate_a_b"] = jnp.asarray(rng.normal(0, 1, 64), jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(0, .1, 64), jnp.float32)
    tp = convert_params(jp, device="cpu")
    x = rng.standard_normal((2, 23, 48)).astype(np.float32)
    st = {"h": rng.standard_normal((2, 64)).astype(np.float32),
          "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)}
    zeros = jax.tree.map(np.zeros_like, st)      # JAX's fresh state
    for state in (None, st):
        js = jax.tree.map(jnp.asarray, zeros if state is None else state)
        ts = None if state is None else {k: _t(v) for k, v in state.items()}
        for exact in (False, True):
            want, wst = _j_rglru(jp, jnp.asarray(x), state=js,
                                 exact_scan=exact)
            got, gst = t_rglru.rglru_block(tp, _t(x), state=ts,
                                           exact_scan=exact)
            assert _rel(got, want) <= 5e-6, exact
            assert _rel(gst["h"], wst["h"]) <= 5e-6, exact
            np.testing.assert_array_equal(gst["conv"].numpy(), wst["conv"])
        if state is not None:
            outs, cur = [], ts
            for t in range(x.shape[1]):
                o, cur = t_rglru.rglru_block(tp, _t(x[:, t:t + 1]),
                                             state=cur)
                outs.append(o)
            exact_out, exact_st = t_rglru.rglru_block(tp, _t(x), state=ts,
                                                      exact_scan=True)
            assert torch.equal(torch.cat(outs, 1), exact_out)
            assert torch.equal(cur["h"], exact_st["h"])


# ---------------------------------------------------------------------------
# rwkv6-smoke as a model
# ---------------------------------------------------------------------------

def test_init_lm_builds_the_jax_tree():
    m = _jax_model()
    ttree = init_lm(m["tcfg"], seed=0, device="cpu")
    assert _keys(ttree) == _keys(convert_params(m["p0"], device="cpu"))
    mix = ttree["units"]["u0"]["0"]["mix"]
    assert "qp" in mix["wr"] and "qp" not in mix["mix_w1"]
    assert "qp" in ttree["units"]["u0"]["0"]["ffn"]["wk"]
    assert "qp" not in ttree["units"]["u0"]["0"]["ffn"]["wr"]
    assert float(mix["w0"][0]) == -6.0 and float(mix["mu"][0, 0]) == 0.5


@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_forward_logits_match_jax(impl):
    """Float logits and the integer path on JAX's export (``oracle``), at
    rtol/atol 1e-4, the dense families' bound (measured 9.5e-7 float and
    7.2e-7 integer, at both WKV forms)."""
    m = _jax_model()
    jcfg = dataclasses.replace(m["jcfg"], wkv_impl=impl)
    tcfg = m["tcfg"].scaled(wkv_impl=impl)
    tok = jnp.asarray(m["tok"])
    for tree in (m["p0"], m["deploy"]):
        want = np.asarray(_j_forward(tree, jcfg, tok, backend="oracle"))
        got = forward(convert_params(tree, device="cpu"), tcfg,
                      _t(m["tok"]), backend="oracle").detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_calibrate_export_bit_exact_vs_jax():
    """The port's calibrate + export on JAX's float params: every code and
    exponent of the 14 deployed linears (``mix.wr/wk/wv/wg/wo``,
    ``ffn.wk/wv`` per layer) equals JAX's, and every float leaf carried
    along (``mu``, the LoRAs, ``w0``, ``u``, ``ln_out``, the channel
    mix's ``wr``) too."""
    m = _jax_model()
    calibrated = calibrate_model(convert_params(m["p0"], device="cpu"),
                                 m["tcfg"], {"tokens": m["tok"]})
    got, report = export_quantized(calibrated)
    n = 0
    for path, t, j in _walk(got, m["tdeploy"]):
        if isinstance(t, DeployedQuantState):
            n += 1
            assert (t.spec, t.name, t.out_dims) == (j.spec, j.name,
                                                   j.out_dims), path
            for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
                assert torch.equal(getattr(t, f), getattr(j, f)), (path, f)
        else:
            assert torch.equal(t, j), path
    assert n == 14 and sum(r["count"] for r in report.values()) == 14


def test_deployed_gemms_bit_exact_vs_jax_oracle():
    """Each deployed GEMM of JAX's export, on the same activations [3, 5,
    K] in both packages: the port's integer path equals the JAX
    ``oracle``'s bit for bit."""
    m = _jax_model()
    rng = np.random.default_rng(5)
    units = m["deploy"]["units"]
    jtree = {f"u{i}": jax.tree.map(lambda a, i=i: np.asarray(a)[i], units)
             for i in range(m["jcfg"].n_units)}
    n = 0
    for path, t, j in _walk(m["tdeploy"]["units"], jtree):
        if not isinstance(t, DeployedQuantState):
            continue
        n += 1
        x = (rng.standard_normal((3, 5, t.w_codes.shape[0])) * 2).astype(
            np.float32)
        want = np.asarray(_j_deployed_dense(jnp.asarray(x), j,
                                            backend="oracle"))
        got = deployed_dense(_t(x), t, backend="oracle").numpy()
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert n == 14


def test_engine_greedy_tokens_match_jax_oracle():
    """From JAX's export: the port's engine against JAX's
    ``PagedServingEngine(backend="oracle")``, equal greedy tokens, with
    an EOS that first appears at step >= 1."""
    m = _jax_model()
    spec = _spec(m["tcfg"].vocab)
    probe = _run(PagedServingEngine(m["tdeploy"], m["tcfg"], **ENGINE_KW),
                 Request, spec)
    out1 = probe[1]
    step = next(i for i in range(1, len(out1)) if out1[i] not in out1[:i])
    eos = {1: out1[step]}
    port = _run(PagedServingEngine(m["tdeploy"], m["tcfg"], **ENGINE_KW),
                Request, spec, eos)
    ref = _run(JEngine(m["deploy"], m["jcfg"], backend="oracle",
                       **ENGINE_KW), JRequest, spec, eos)
    assert port == ref
    assert port[1] == out1[:step + 1]


def _chunked(params, cfg, tokens, chunks):
    """Prefill ``tokens`` [1, L] in ``chunks`` on a fresh slot; returns
    (last logits, state)."""
    st = init_paged_decode_state(cfg, 1, page_size=4, n_pages=8,
                                 device="cpu")
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    s0 = 0
    for c in chunks:
        lg, st = forward_paged_chunk(params, cfg, st, tokens[:, s0:s0 + c],
                                     torch.tensor([s0], dtype=torch.int32),
                                     table)
        s0 += c
    return lg, st


@pytest.mark.parametrize("model", ["rwkv6", "hybrid"])
@pytest.mark.parametrize("chunks", [(8, 4, 1), (4, 4, 4, 1), (13,)])
def test_chunked_prefill_bit_identical_to_per_token(model, chunks):
    """13 prompt tokens in chunks against one token per call: every state
    leaf (WKV state, token shifts, RG-LRU ``h`` and conv window, K/V pages
    and exponents) and the logits bit-equal.  A chunk runs the
    recurrences one token at a time, and the recurrent blocks' float
    GEMMs in fixed row blocks, so the chunk is the per-token computation
    (the JAX package's own test of this fails under JAX 0.9.0: its WKV
    state differs by up to 3.4e-6)."""
    if model == "rwkv6":
        params, cfg = _jax_model()["tdeploy"], _jax_model()["tcfg"]
    else:
        params, cfg = _hybrid_port()
    tokens = _t(np.random.default_rng(5).integers(0, cfg.vocab, (1, 13)))
    lg1, st1 = _chunked(params, cfg, tokens, [1] * 13)
    lg2, st2 = _chunked(params, cfg, tokens, chunks)
    assert torch.equal(lg1, lg2)
    want = dict(tree_leaves(st1))
    for path, leaf in tree_leaves(st2):
        assert torch.equal(leaf, want[path]), path


@pytest.mark.parametrize("model", ["rwkv6", "hybrid"])
def test_batched_equals_single_stream_and_horizon_equals_stepwise(model):
    if model == "rwkv6":
        params, cfg = _jax_model()["tdeploy"], _jax_model()["tcfg"]
    else:
        params, cfg = _hybrid_port()
    spec = _spec(cfg.vocab, seed=5)
    single = {}
    for uid, toks, n in spec:
        eng = PagedServingEngine(params, cfg, max_batch=1, page_size=4,
                                 n_pages=32, prefill_chunk=8,
                                 decode_horizon=1)
        single[uid] = _run(eng, Request, [(uid, toks, n)])[uid]
    for h in (4, 1):
        eng = PagedServingEngine(params, cfg, **dict(ENGINE_KW,
                                                     decode_horizon=h))
        assert _run(eng, Request, spec) == single, f"horizon {h}"


def _greedy_direct(params, cfg, prompt, n: int) -> list:
    """Greedy tokens of one request without the engine: the prompt
    prefilled in one chunk on a fresh ``init_paged_decode_state`` (zero
    recurrent states), then ``n - 1`` single-token decode steps."""
    st = init_paged_decode_state(cfg, 1, page_size=4, n_pages=16,
                                 device="cpu")
    table = torch.arange(1, 16, dtype=torch.int32)[None]
    lg, st = forward_paged_chunk(params, cfg, st, _t(prompt)[None],
                                 torch.tensor([0], dtype=torch.int32), table)
    out = [int(lg[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n - 1):
        lg, st = forward_paged_chunk(
            params, cfg, st, torch.tensor([[out[-1]]]),
            torch.tensor([pos], dtype=torch.int32), table)
        out.append(int(lg[0, -1].argmax()))
    return out


@pytest.mark.parametrize("model", ["rwkv6", "hybrid"])
def test_reused_slot_starts_fresh(model):
    """Request B served on the slot request A left gives the tokens of B
    decoded directly from a fresh state (``_greedy_direct``): the first
    prefill chunk resets the slot's recurrent states to zeros and its
    exponents to ``EXP_FLOOR``, a fresh state's values, whatever A left."""
    if model == "rwkv6":
        params, cfg = _jax_model()["tdeploy"], _jax_model()["tcfg"]
    else:
        params, cfg = _hybrid_port()
    (_, a, na), (_, b, nb) = _spec(cfg.vocab, seed=7)[3:5]
    eng = PagedServingEngine(params, cfg, max_batch=1, page_size=4,
                             n_pages=16, prefill_chunk=8, decode_horizon=2)
    _run(eng, Request, [(0, a, na)])
    assert _run(eng, Request, [(1, b, nb)])[1] == _greedy_direct(
        params, cfg, b, nb)


# ---------------------------------------------------------------------------
# The hybrid attn / rwkv / rglru stack with a remainder layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hybrid_jax():
    jcfg = JModelConfig(**HYBRID, scan_layers=True)
    return jcfg, _j_init_lm(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _hybrid_port():
    """The port alone: init -> calibrate -> export (mix2_ffn4)."""
    cfg = ModelConfig(**HYBRID).with_quant(policy_presets()["mix2_ffn4"])
    params = init_lm(cfg, seed=1, device="cpu")
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    deploy, report = export_quantized(calibrate_model(params, cfg,
                                                      {"tokens": tok}))
    # 3 unit layers and rem.0: attention 4 + SwiGLU 3 each, rwkv 5 + 3,
    # rglru 3 + 3
    assert sum(r["count"] for r in report.values()) == 7 + 8 + 6 + 7
    assert "rem.0.mix.wq" in report
    return deploy, cfg


def test_convert_and_checkpoint_carry_every_recurrent_leaf(tmp_path):
    """``convert_params`` carries every leaf of the recurrent blocks bit
    for bit with its dtype (bfloat16 blocks: ``lam`` and the gate biases
    stay float32), and of the scan-stacked hybrid tree with its
    remainder layer; the port's checkpoint writer and ``restore`` give
    the hybrid export back bit for bit."""
    from repro_torch.checkpoint import restore, save
    key = jax.random.PRNGKey(4)
    blocks = {"tm": _j_init_time_mix(key, 64, 2, 32, jnp.bfloat16),
              "cm": _j_init_channel_mix(key, 64, 128, jnp.bfloat16),
              "rec": _j_init_rglru(key, 64, 32, jnp.bfloat16)}
    jcfg, p0 = _hybrid_jax()
    units = p0["units"]
    jtree = {**p0, "units": {
        f"u{i}": jax.tree.map(lambda a, i=i: np.asarray(a)[i], units)
        for i in range(jcfg.n_units)}}
    for tree in (blocks, p0):
        want = tree if tree is blocks else jtree
        got = convert_params(tree, device="cpu")
        n = 0
        for path, t, j in _walk(got, want):
            j = np.asarray(j)
            assert str(t.dtype).split(".")[1] == j.dtype.name, path
            np.testing.assert_array_equal(t.float().numpy(),
                                          j.astype(np.float32), path)
            n += 1
        assert n == len(jax.tree.leaves(tree))
    assert str(convert_params(blocks, device="cpu")["rec"]["lam"].dtype) \
        == "torch.float32"
    deploy, _ = _hybrid_port()
    save(str(tmp_path), 3, deploy)
    back, _ = restore(str(tmp_path), device="cpu")
    want = dict(tree_leaves(deploy))
    got = dict(tree_leaves(back))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path


def test_hybrid_stack_with_remainder_matches_jax():
    """Params tree (``rem.0`` beside the units), float forward logits at
    rtol/atol 1e-4 (measured 1.5e-5), and the engine's greedy tokens on the
    same float tree against JAX's ``oracle`` engine (the JAX package's
    RG-LRU block cannot run an exported tree: it reads ``wx``'s float
    weight for its width)."""
    jcfg, p0 = _hybrid_jax()
    tcfg = ModelConfig(**HYBRID)
    assert tcfg.n_units == 1 and tcfg.n_rem == 1
    tp = convert_params(p0, device="cpu")
    assert _keys(init_lm(tcfg, seed=0, device="cpu")) == _keys(tp)
    assert sorted(tp["rem"]) == ["0"] and "wq" in tp["rem"]["0"]["mix"]
    tok = np.random.default_rng(3).integers(0, 128, (2, 19))
    want = np.asarray(_j_forward(p0, jcfg, jnp.asarray(tok)))
    got = forward(tp, tcfg, _t(tok)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # prompts of one chunk and one decode macro-step: few JAX compiles
    rng = np.random.default_rng(1)
    spec = [(i, rng.integers(0, 128, size=8).astype(np.int32), 5)
            for i in range(3)]
    port = _run(PagedServingEngine(tp, tcfg, **ENGINE_KW), Request, spec)
    ref = _run(JEngine(p0, jcfg, backend="oracle", **ENGINE_KW), JRequest,
               spec)
    assert port == ref


# ---------------------------------------------------------------------------
# One QAT step against JAX's
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _by_path(tree) -> dict:
    return dict(tree_leaves(tree))


def test_train_step_on_po2_grid_matches_jax():
    """``rwkv6-smoke`` under ``mix2_ffn4`` (APSQ on every quantized
    linear), JAX's calibrated scales snapped to powers of two (fake quant
    exact), one step of two microbatches (chunked WKV, per-unit remat)
    from the same params and batch in both packages.  Measured over the
    batches of seeds 21-23: loss and gradient norm within 3.2e-7
    relative; each moment leaf within 3.4e-3 (``m``) and 6.7e-3 (``v``)
    of its largest entry, at an activation scale's gradient (a sum over
    every element of its input that cancels most): JAX against itself,
    chunked WKV against scan, differs by 5.0e-3 on the same leaf.  Held
    at 1e-6, 1e-2 and 2e-2.  New params within 1% of one step's learning
    rate, except where Adam's first update ``u = g / (|g| + eps)`` meets
    a gradient far below 100 eps: there a last-ulp difference of g moves
    u by up to |dg| / eps, and the params are held to ``lr * (|dg| / eps
    + 1e-2)``, as the MoE slice's test holds them (measured <= 0.71 of
    that bound)."""
    m = _jax_model()
    tokens = np.random.default_rng(21).integers(0, 256, (4, 17))
    batch = {"tokens": tokens[:, :-1].astype(np.int32),
             "labels": tokens[:, 1:].astype(np.int32)}
    params = _po2_scales(m["calibrated"])
    jstep = jax.jit(j_make_train_step(m["jcfg"], JOptimConfig(**OCFG),
                                      JTrainConfig(microbatches=2)))
    jp, js, jst = jstep(params, j_init_opt_state(params,
                                                 JOptimConfig(**OCFG)),
                        jax.tree.map(jnp.asarray, batch))
    tp = convert_params(params, device="cpu")
    step = make_train_step(m["tcfg"], OptimConfig(**OCFG),
                           TrainConfig(microbatches=2))
    tp2, ts, tst = step(tp, init_opt_state(tp, OptimConfig(**OCFG)),
                        {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-6)
    for got, want, tol in ((ts["m"], js["m"], 1e-2), (ts["v"], js["v"], 2e-2)):
        w = _by_path(convert_params(want, device="cpu"))
        for path, t in _by_path(got).items():
            np.testing.assert_allclose(
                t.numpy(), w[path].numpy(), rtol=0,
                atol=tol * float(w[path].abs().max()) + 1e-30,
                err_msg=str(path))
    lr, eps = float(jst["lr"]), OptimConfig().eps
    want_m = _by_path(convert_params(js["m"], device="cpu"))
    got_m = _by_path(ts["m"])
    want_p = _by_path(convert_params(jp, device="cpu"))
    for path, t in _by_path(tp2).items():
        g, jg = got_m[path] / 0.1, want_m[path] / 0.1
        bound = torch.where(jg.abs() < 100 * eps,
                            lr * ((g - jg).abs() / eps + 1e-2),
                            torch.full_like(g, 1e-2 * lr))
        gap = (t.float() - want_p[path].float()).abs()
        assert bool((gap <= bound).all()), (path, float(gap.max()))
