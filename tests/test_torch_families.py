"""The rest of the dense decoder family in the port, held to the JAX package
on the CPU at smoke size: ``starcoder2-smoke`` (LayerNorm, GELU MLP),
``chatglm3-smoke`` (RoPE on half the head, GQA), ``deepseek-smoke``
(MHA) and ``tinyllama-smoke`` with a tied head.

* LayerNorm, the GELU MLP (tanh approximation) and partial RoPE against
  their JAX functions at rtol/atol 1e-5.
* ``init_lm`` builds the JAX package's tree: LayerNorm biases, no ``wg``
  in a GELU MLP, no ``head`` when the embeddings are tied.
* Forward logits at rtol/atol 1e-4, the bound of
  ``test_torch_serving.py``: float, fake quant on JAX's calibrated tree
  with its scales snapped to powers of two, and the integer path on
  JAX's export; fake quant with JAX's float scales gives the same
  greedy tokens, and each of its linears, fed the same inputs, agrees
  with JAX's but for at most two PSUM codes one step apart.
* The port's calibrate + export on JAX's float params (scan-stacked,
  quickstart policy ``mix2_ffn4``): every code and exponent equals
  JAX's, the tied head's ``qp_head`` included.
* The port's ``PagedServingEngine`` on JAX's export against JAX's
  ``PagedServingEngine(backend="oracle")``: equal greedy tokens, an EOS
  that first appears at step >= 1, decode horizon 4.
* The port's invariants per family: batched == single-stream, fused
  horizon == stepwise.
* What the engines still refuse: an encoder-decoder (both engines and
  the serve launcher; it decodes through ``decode_step(enc_out=)``),
  local attention on the paged path, as the reference's does; a vision
  stub's config builds ``frontend_proj`` and serves its text on the
  paged engine.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantState as JQuantState
from repro.core.layers import quant_dense as j_quant_dense
from repro.models import common as jcommon
from repro.models.model import forward as j_forward
from repro.models.model import init_lm as j_init_lm
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.quant.qat import policy_presets as j_policy_presets
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState
from repro_torch.core.layers import quant_dense
from repro_torch.models import common, forward, init_lm
from repro_torch.quant import (calibrate_model, export_quantized,
                               policy_presets)
from repro_torch.serving import PagedServingEngine, Request

FAMILIES = {  # id -> (arch, tie_embeddings)
    "starcoder2": ("starcoder2-15b", False),
    "chatglm3": ("chatglm3-6b", False),
    "deepseek": ("deepseek-7b", False),
    "tinyllama_tied": ("tinyllama-1.1b", True),
}


def _cfgs(family: str):
    """(JAX config, scan-stacked; the port's config), both mix2_ffn4."""
    arch, tie = FAMILIES[family]
    jcfg = dataclasses.replace(j_get_smoke(arch), scan_layers=True,
                               tie_embeddings=tie).with_quant(
        j_policy_presets()["mix2_ffn4"])
    tcfg = get_smoke(arch).scaled(tie_embeddings=tie).with_quant(
        policy_presets()["mix2_ffn4"])
    return jcfg, tcfg


# JAX's init, forward and quant_dense, each under one jit where the
# values they give are compared within a tolerance or by structure
# (eagerly JAX compiles every op apart).  Eager stay: calibrate_model
# (its capture tap sees tracers under jit), export (it reads array values
# into its report), the init of the compared models and the forward on
# float scales (a jit fuses float ops, which can move a fake-quant code:
# those tests hold exact greedy tokens on these seeds' values)
_j_init_lm = jax.jit(j_init_lm, static_argnums=1)
_j_forward = jax.jit(j_forward, static_argnums=1,
                     static_argnames="backend")
_j_quant_dense = jax.jit(j_quant_dense)


@functools.lru_cache(maxsize=None)
def _jax_model(family: str) -> dict:
    """JAX float params, calibration tokens, calibrated tree and export;
    built once per family."""
    jcfg, tcfg = _cfgs(family)
    p0 = j_init_lm(jax.random.PRNGKey(11), jcfg)
    tok = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 16))
    calibrated = j_calibrate_model(p0, jcfg, {"tokens": jnp.asarray(tok)})
    deploy, _ = j_export_quantized(calibrated)
    return {"p0": p0, "tok": tok, "calibrated": calibrated,
            "deploy": deploy, "jcfg": jcfg, "tcfg": tcfg}


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _keys(tree, path=""):
    if isinstance(tree, dict):
        return {k for key, v in tree.items()
                for k in _keys(v, f"{path}.{key}")}
    return {path}


# ---------------------------------------------------------------------------
# The new float ops against their JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 96)) * 3 + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(96).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(96).astype(np.float32)
    tp = common.init_norm(96, torch.float32, kind, device="cpu")
    assert sorted(tp) == sorted(jcommon.init_norm(96, jnp.float32, kind))
    want = np.asarray(jcommon.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind))
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_mlp_matches_jax(kind):
    jp = jcommon.init_mlp(jax.random.PRNGKey(2), 64, 128, jnp.float32, kind)
    gen = torch.Generator().manual_seed(0)
    tp = common.init_mlp(gen, 64, 128, torch.float32, kind, device="cpu")
    assert sorted(tp) == sorted(jp)           # GELU: wi and wo, no wg
    x = np.random.default_rng(3).standard_normal((2, 7, 64)).astype(
        np.float32) * 2
    want = np.asarray(jcommon.apply_mlp(jp, jnp.asarray(x), kind))
    got = common.apply_mlp(convert_params(jp, device="cpu"),
                           torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction", [0.5, 0.25, 1.0])
def test_partial_rope_matches_jax(fraction):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         fraction=fraction))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            fraction=fraction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rot = int(32 * fraction)
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_init_lm_builds_the_jax_tree(family):
    jcfg, tcfg = _cfgs(family)
    jtree = _j_init_lm(jax.random.PRNGKey(0),
                       dataclasses.replace(jcfg, scan_layers=False))
    ttree = init_lm(tcfg, seed=0, device="cpu")
    assert _keys(ttree) == _keys(jtree)
    assert ("head" in ttree) == (not tcfg.tie_embeddings)


def _po2_scales(tree):
    """JAX's calibrated tree with every quantizer scale a power of two:
    ``snap_params_po2`` for ``ax``/``aw`` and ``floor`` of the log2 PSUM
    scales ``ap``, so fake quant multiplies and sums exactly."""
    def floor_ap(t):
        if isinstance(t, JQuantState):
            return dataclasses.replace(
                t, ap=None if t.ap is None else jnp.floor(t.ap))
        if isinstance(t, dict):
            return {k: floor_ap(v) for k, v in t.items()}
        return t
    return floor_ap(j_snap_params_po2(tree))


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(family):
    """Float, fake-quant and integer (exported) forward logits on the same
    trees.  Fake quant is held at 1e-4 with power-of-two scales; with
    JAX's float scales it is held to the same greedy tokens: there a
    last-ulp difference upstream can move a value across a rounding
    boundary of ``round(x / scale)`` and change one code, which moves
    the logits of that token and of those attending to it by much more
    than 1e-4."""
    m = _jax_model(family)
    tok = jnp.asarray(m["tok"])
    for tree in (m["p0"], _po2_scales(m["calibrated"]), m["deploy"],
                 m["calibrated"]):
        fwd = j_forward if tree is m["calibrated"] else _j_forward
        want = np.asarray(fwd(tree, m["jcfg"], tok, backend="oracle"))
        got = forward(convert_params(tree, device="cpu"), m["tcfg"],
                      torch.from_numpy(m["tok"]), backend="oracle").numpy()
        if tree is m["calibrated"]:
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_float_scale_gap_is_one_psum_code(family):
    """Where the float-scale forwards part: every linear that JAX's
    forward runs on its calibrated tree, fed the same inputs, weights and
    state in both packages, gives the same output but at most two
    elements, each one step of the layer's last PSUM quantizer apart.
    So the gap is a PSUM code rounded the other way (the float tile sums
    add in another order), not a different formula upstream."""
    m = _jax_model(family)
    units = m["calibrated"]["units"]
    n = jax.tree.leaves(units)[0].shape[0]
    tree = {**m["calibrated"], "units": {
        f"u{i}": jax.tree.map(lambda a, i=i: np.asarray(a)[i], units)
        for i in range(n)}}
    tap = []
    j_forward(tree, dataclasses.replace(m["jcfg"], scan_layers=False),
              jnp.asarray(m["tok"]), tap=tap, backend="oracle")
    assert len(tap) == n * (6 if m["jcfg"].mlp == "gelu" else 7)
    for r in tap:
        assert r.qp.ap is not None, r.name       # mix2_ffn4: all APSQ
        want = np.asarray(_j_quant_dense(r.x, r.w, r.qp))
        got = quant_dense(torch.tensor(np.asarray(r.x)),
                          torch.tensor(np.asarray(r.w)),
                          convert_params({"qp": r.qp}, device="cpu")["qp"]
                          ).numpy()
        step = 2.0 ** np.floor(np.asarray(r.qp.ap)[-1])
        off = got != want
        assert off.sum() <= 2, (r.name, int(off.sum()))
        np.testing.assert_array_equal(np.abs(got - want)[off], step,
                                      err_msg=r.name)


@pytest.mark.parametrize("family", FAMILIES)
def test_calibrate_export_bit_exact_vs_jax(family):
    m = _jax_model(family)
    calibrated = calibrate_model(convert_params(m["p0"], device="cpu"),
                                 m["tcfg"], {"tokens": m["tok"]})
    got, report = export_quantized(calibrated)
    assert ("head" in report) == m["tcfg"].tie_embeddings
    n_deployed = 0
    for path, t, j in _walk(got, convert_params(m["deploy"], device="cpu")):
        if isinstance(t, DeployedQuantState):
            n_deployed += 1
            assert (t.spec, t.name, t.out_dims) == (j.spec, j.name,
                                                   j.out_dims), path
            for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
                a, b = getattr(t, f), getattr(j, f)
                assert (a is None) == (b is None), (path, f)
                assert a is None or torch.equal(a, b), (path, f, a, b)
        else:
            assert torch.equal(t, j), path
    n_proj = 6 if m["tcfg"].mlp == "gelu" else 7
    assert n_deployed == 2 * n_proj + m["tcfg"].tie_embeddings


ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
PROMPTS = [(5, 6), (9, 7), (1, 5), (13, 6), (6, 8)]    # (prompt, new)


def _spec(seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(PROMPTS)]


def _run(engine, req_cls, spec, eos=None):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=m,
                    eos_token=eos.get(u) if eos else None)
            for u, t, m in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_greedy_tokens_match_jax_oracle(family):
    m = _jax_model(family)
    tdeploy = convert_params(m["deploy"], device="cpu")
    spec = _spec()
    probe = _run(PagedServingEngine(tdeploy, m["tcfg"], **ENGINE_KW),
                 Request, spec)
    out1 = probe[1]    # EOS for stream 1: a token first seen at step >= 1
    step = next(i for i in range(1, len(out1)) if out1[i] not in out1[:i])
    eos = {1: out1[step]}
    port = _run(PagedServingEngine(tdeploy, m["tcfg"], **ENGINE_KW),
                Request, spec, eos)
    ref = _run(JEngine(m["deploy"], m["jcfg"], backend="oracle",
                       **ENGINE_KW), JRequest, spec, eos)
    assert port == ref
    assert port[1] == out1[:step + 1]


@functools.lru_cache(maxsize=None)
def _port_model(family: str):
    """The port alone, on the CPU: init -> calibrate -> export."""
    _, tcfg = _cfgs(family)
    params = init_lm(tcfg, seed=1, device="cpu")
    tok = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 16))
    deploy, _ = export_quantized(calibrate_model(params, tcfg,
                                                 {"tokens": tok}))
    return deploy, tcfg


@pytest.mark.parametrize("family", FAMILIES)
def test_batched_equals_single_stream_and_horizon_equals_stepwise(family):
    deploy, cfg = _port_model(family)
    spec = [(i, t, n) for i, t, n in _spec(seed=5)]
    single = {}
    for uid, toks, n in spec:
        eng = PagedServingEngine(deploy, cfg, max_batch=1, page_size=4,
                                 n_pages=32, prefill_chunk=8,
                                 decode_horizon=1)
        single[uid] = _run(eng, Request, [(uid, toks, n)])[uid]
    for h in (4, 1):
        eng = PagedServingEngine(deploy, cfg, max_batch=3, page_size=4,
                                 n_pages=40, prefill_chunk=8,
                                 decode_horizon=h)
        assert _run(eng, Request, spec) == single, f"horizon {h}"
        assert max(eng.horizon_hist) == h       # fusion engaged at h = 4


@pytest.mark.parametrize("change", [
    dict(block_pattern=("attn", "local")),
    dict(family="encdec", encdec=True, n_enc_layers=2, frontend="audio"),
    dict(family="vlm", frontend="vision", n_frontend_tokens=4)],
    ids=["local", "encdec", "frontend"])
def test_check_ported_still_refuses(change):
    cfg = get_smoke("starcoder2-15b").scaled(**change)
    params = init_lm(cfg.check_ported(), seed=0, device="cpu")
    if "block_pattern" in change:   # the dense ServingEngine's, not paged
        from repro_torch.models import init_paged_decode_state
        with pytest.raises(NotImplementedError):
            init_paged_decode_state(cfg, 1, page_size=4, n_pages=2,
                                    device="cpu")
        with pytest.raises(NotImplementedError):
            PagedServingEngine(params, cfg)
        return
    if cfg.encdec:      # no engine takes the encoder's output
        from repro_torch.launch.serve import main
        from repro_torch.serving import ServingEngine
        with pytest.raises(NotImplementedError):
            PagedServingEngine(params, cfg)
        with pytest.raises(NotImplementedError):
            ServingEngine(params, cfg)
        with pytest.raises(SystemExit, match="enc-dec"):
            main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device",
                  "cpu"])
        return
    assert sorted(params["frontend_proj"]) == ["w"]     # float, no qp
    eng = PagedServingEngine(params, cfg, max_batch=1, page_size=4,
                             n_pages=8)
    out = eng.run([Request(uid=0, tokens=np.arange(5, dtype=np.int32),
                           max_new_tokens=3)])
    assert len(out[0].out) == 3
