"""The encoder-decoder stack and the vision frontend stub in the port, held
to the JAX package on the CPU at smoke size (float32; numpy seeds).

* ``seamless-m4t-large-v2`` and ``internvl2-26b`` (and their smoke
  configs): every field the port's ``ModelConfig`` has equals JAX's.
* ``attention_block`` with ``xkv`` (cross-attention: K/V from the
  encoder output, no mask, no RoPE) and without the causal mask (the
  encoder) against JAX's at rtol 1e-5 / atol 1e-6.
* ``init_lm`` builds JAX's tree (``convert_params`` unstacks the
  encoder's units, which JAX stacks whatever ``scan_layers`` says);
  ``frontend_proj`` stays a float linear.
* ``seamless-smoke`` (``enc_heavy``): ``encode``, ``forward(enc_embeds=)``
  and 8 ``decode_step(enc_out=)`` steps against JAX's, on float params
  and on JAX's export (``oracle``): logits at 1e-4, greedy tokens equal.
  ``internvl2-smoke`` (``mix2_ffn4``): ``forward(embeds=)`` the same way,
  and the image prefix changes the text logits.  The port's batched
  encode + decode equals each request's alone.
* The port's ``calibrate_model`` + ``export_quantized`` on JAX's float
  params: every code and exponent equals JAX's export, every layer name
  and count of its report, and the exported ``oracle`` tokens equal
  JAX's.
* One QAT step's loss and gradients (``make_loss_fn``: ``enc_embeds``,
  and the VLM's text-logit slice) against JAX's on the power-of-two
  grid; ``make_distill_loss_fn`` hands the frontend inputs on; the
  training launcher's frontend data.
* A JAX export of ``seamless-smoke`` saved by JAX's store and restored by
  the port decodes JAX's tokens; the port's paged engine serves exported
  ``internvl2-smoke`` text with JAX's ``PagedServingEngine`` tokens.

JAX's calibration runs eagerly (under one ``jax.jit`` it gives other
scales), once per model; every other JAX function runs under one
``jax.jit``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attention
from repro.checkpoint.store import save as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantState as JQuantState
from repro.models.model import decode_step as j_decode_step
from repro.models.model import encode as j_encode
from repro.models.model import forward as j_forward
from repro.models.model import init_decode_state as j_init_decode_state
from repro.models.model import init_lm as j_init_lm
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.quant.qat import policy_presets as j_policy_presets
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.train.trainer import make_loss_fn as j_make_loss_fn
from repro_torch.checkpoint import convert_params, restore
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState
from repro_torch.models import (decode_step, encode, forward,
                                init_decode_state, init_lm, tree_leaves)
from repro_torch.models.attention import attention_block
from repro_torch.quant import (calibrate_model, export_quantized,
                               make_distill_loss_fn, policy_presets)
from repro_torch.serving import PagedServingEngine, Request
from repro_torch.train.trainer import make_loss_fn, value_and_grad

ARCHS = {  # id -> (arch, quant preset)
    "seamless": ("seamless-m4t-large-v2", "enc_heavy"),
    "internvl2": ("internvl2-26b", "mix2_ffn4"),
}
B, S, S_ENC = 2, 8, 12          # batch, decoder tokens, encoder frames
N_DECODE = 8                    # decode_step calls: 4 prompt + 4 greedy

_j_init_lm = jax.jit(j_init_lm, static_argnums=1)
_j_forward = jax.jit(j_forward, static_argnums=1,
                     static_argnames=("backend",))
_j_encode = jax.jit(j_encode, static_argnums=1, static_argnames=("backend",))
_j_decode_step = jax.jit(j_decode_step, static_argnums=1,
                         static_argnames=("backend",))
_j_attention_block = jax.jit(j_attention.attention_block, static_argnames=(
    "n_heads", "n_kv_heads", "head_dim", "causal", "use_rope"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


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


def _cfgs(model: str):
    arch, preset = ARCHS[model]
    jcfg = j_get_smoke(arch).with_quant(j_policy_presets()[preset])
    tcfg = get_smoke(arch).with_quant(policy_presets()[preset])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_model(model: str) -> dict:
    """JAX params (scan-stacked) with quantizer states and without
    (``float``, its configs ``jfloat``/``tfloat``), a batch (tokens,
    labels and the model's frontend input), the calibrated tree and its
    export."""
    jcfg, tcfg = _cfgs(model)
    p0 = _j_init_lm(jax.random.PRNGKey(11), jcfg)
    jfloat, tfloat = j_get_smoke(ARCHS[model][0]), get_smoke(ARCHS[model][0])
    rng = np.random.default_rng(12)
    seq = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if jcfg.encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (B, S_ENC, jcfg.d_model)).astype(np.float32)
    else:
        batch["embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    calibrated = j_calibrate_model(p0, jcfg, jbatch)
    deploy, report = j_export_quantized(calibrated)
    return {"p0": p0, "batch": batch, "jbatch": jbatch,
            "calibrated": calibrated, "deploy": deploy, "report": report,
            "jcfg": jcfg, "tcfg": tcfg, "jfloat": jfloat, "tfloat": tfloat,
            "float": _j_init_lm(jax.random.PRNGKey(13), jfloat)}


def _qp_nodes(tree):
    """``{"w", "qp"}`` subtrees of a calibrated tree as ``{"qp": state}``:
    the paths of its export's deployed states."""
    if isinstance(tree, dict):
        if "w" in tree and "qp" in tree:
            return {"qp": tree["qp"]}
        return {k: v for k, v in ((k, _qp_nodes(v)) for k, v in tree.items())
                if v is not None}
    return None


def _tree(m: dict, which: str):
    """(JAX tree, JAX config, port config) of ``which``: ``float`` (no
    quantizer) or ``deploy`` (JAX's export)."""
    if which == "float":
        return m["float"], m["jfloat"], m["tfloat"]
    return m["deploy"], m["jcfg"], m["tcfg"]


# ---------------------------------------------------------------------------
# Configs and modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
@pytest.mark.parametrize("model", ARCHS)
def test_config_is_the_jax_packages(model, which):
    import importlib
    mod = ARCHS[model][0].replace("-", "_").replace(".", "_")
    j_mod = importlib.import_module(f"repro.configs.{mod}")
    t_mod = importlib.import_module(f"repro_torch.configs.{mod}")
    jc, tc = ((j_mod.CONFIG, t_mod.CONFIG) if which == "CONFIG"
              else (j_mod.smoke_config(), t_mod.smoke_config()))
    for f in dataclasses.fields(tc):
        if f.name not in ("quant", "quant_policy"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    if model == "internvl2":
        assert t_mod.N_IMAGE_TOKENS == j_mod.N_IMAGE_TOKENS
    tc.validate().check_ported()
    assert (tc.encdec, tc.frontend) == (model == "seamless",
                                        "audio" if model == "seamless"
                                        else "vision")


@pytest.mark.parametrize("name", ["aggressive", "enc_heavy"])
def test_new_policy_presets_resolve_as_jax(name):
    tp, jp = policy_presets()[name], j_policy_presets()[name]
    for layer in ("encoder.unit.0.ffn.wi", "unit.0.xattn.wk",
                  "unit.0.mix.wq", "rem.0.ffn.wo", "head"):
        t, j = tp.resolve(layer), jp.resolve(layer)
        assert (t.psum.mode, t.psum.gs, t.psum.n_p) == (
            j.psum.mode, j.psum.gs, j.psum.n_p), layer


@pytest.mark.parametrize("mode", ["cross", "noncausal"])
def test_attention_block_matches_jax(mode):
    """Cross-attention (K/V from ``xkv`` of another length, no mask, no
    RoPE on q or k) and the encoder's non-causal self-attention (RoPE
    from position 0), GQA 4/2, float params."""
    rng = np.random.default_rng(3)
    jp = j_attention.init_attention(jax.random.PRNGKey(3), 64, 4, 2, 16,
                                    jnp.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    xkv = rng.standard_normal((2, 11, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16)
    if mode == "cross":
        jkw, tkw = dict(xkv=jnp.asarray(xkv), use_rope=False), \
            dict(xkv=_t(xkv), use_rope=False)
    else:
        jkw, tkw = dict(causal=False), dict(causal=False)
    want, _ = _j_attention_block(jp, jnp.asarray(x), **kw, **jkw)
    got, _ = attention_block(convert_params(jp, device="cpu"), _t(x),
                             **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    causal, _ = attention_block(convert_params(jp, device="cpu"), _t(x), **kw)
    assert not torch.allclose(causal, got)    # the mask (or xkv) mattered


@pytest.mark.parametrize("model", ARCHS)
def test_init_lm_builds_the_jax_tree(model):
    """Same leaves as JAX's tree carried across (the encoder's stacked
    units unstacked into ``u<i>``), ``encoder.unit.<j>`` names with no
    cross-attention, ``xattn`` in every decoder layer, a float
    ``frontend_proj``."""
    m = _jax_model(model)
    ttree = init_lm(m["tcfg"], seed=0, device="cpu")
    jtree = convert_params(m["p0"], device="cpu")
    assert _keys(ttree) == _keys(jtree)
    if model == "seamless":
        enc = ttree["encoder"]["units"]
        assert sorted(enc) == sorted(jtree["encoder"]["units"]) == [
            "u0", "u1"]
        assert "xattn" not in enc["u0"]["0"]
        assert enc["u1"]["0"]["ffn"]["wi"]["qp"].name == \
            "encoder.unit.0.ffn.wi"
        assert ttree["units"]["u0"]["0"]["xattn"]["wk"]["qp"].name == \
            "unit.0.xattn.wk"
    else:
        assert sorted(ttree["frontend_proj"]) == ["w"]
        assert "xattn" not in ttree["units"]["u0"]["0"]


# ---------------------------------------------------------------------------
# Whole models against JAX
# ---------------------------------------------------------------------------

def _decode_logits(step, init_state, enc_out, tokens):
    """``step(state, token [B, 1], t, enc_out)`` over ``tokens`` [B, T]
    from ``init_state``: the logits [B, T, V] of every step."""
    st, out = init_state, []
    for t in range(tokens.shape[1]):
        lg, st = step(st, tokens[:, t:t + 1], t, enc_out)
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, 1)


def _jax_decode(tree, jcfg, enc_out, tokens, backend="oracle"):
    return _decode_logits(
        lambda st, tok, t, e: _j_decode_step(
            tree, jcfg, st, jnp.asarray(tok), jnp.int32(t), enc_out=e,
            backend=backend),
        j_init_decode_state(jcfg, tokens.shape[0], N_DECODE), enc_out,
        tokens)


def _port_decode(tree, tcfg, enc_out, tokens, backend="oracle"):
    return _decode_logits(
        lambda st, tok, t, e: decode_step(tree, tcfg, st, _t(tok), t,
                                          enc_out=e, backend=backend),
        init_decode_state(tcfg, tokens.shape[0], N_DECODE, device="cpu"),
        enc_out, tokens)


def _greedy_sequence(jtree, jcfg, enc_out, prompt):
    """JAX's greedy continuation of ``prompt`` [B, 4] to ``N_DECODE``
    decode steps (prompt tokens fed, then each step's argmax)."""
    seq = prompt
    while seq.shape[1] < N_DECODE:
        lg = _jax_decode(jtree, jcfg, enc_out, seq)
        seq = np.concatenate([seq, lg[:, -1:].argmax(-1).astype(np.int32)],
                             1)
    return seq


@pytest.mark.parametrize("tree", ["float", "deploy"])
def test_seamless_encode_forward_and_decode_match_jax(tree):
    """``encode`` within rtol/atol 1e-5; ``forward(enc_embeds=)`` logits
    and 8 ``decode_step(enc_out=)`` steps (4 prompt tokens, then JAX's
    greedy tokens, teacher-forced) within 1e-4, with equal argmaxes; the
    first step's logits equal ``forward``'s position 0."""
    m = _jax_model("seamless")
    jtree, jcfg, tcfg = _tree(m, tree)
    ttree = convert_params(jtree, device="cpu")
    ee = m["batch"]["enc_embeds"]
    j_enc = _j_encode(jtree, jcfg, jnp.asarray(ee), backend="oracle")
    t_enc = encode(ttree, tcfg, _t(ee), backend="oracle")
    np.testing.assert_allclose(t_enc.detach().numpy(), np.asarray(j_enc),
                               rtol=1e-5, atol=1e-5)
    tok = m["batch"]["tokens"]
    want = np.asarray(_j_forward(jtree, jcfg, jnp.asarray(tok),
                                 enc_embeds=jnp.asarray(ee),
                                 backend="oracle"))
    with torch.no_grad():
        got = forward(ttree, tcfg, _t(tok), enc_embeds=_t(ee),
                      backend="oracle").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    seq = _greedy_sequence(jtree, jcfg, j_enc, tok[:, :4])
    j_lg = _jax_decode(jtree, jcfg, j_enc, seq)
    with torch.no_grad():
        t_lg = _port_decode(ttree, tcfg, t_enc, seq)
    np.testing.assert_allclose(t_lg, j_lg, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_lg.argmax(-1), j_lg.argmax(-1))
    np.testing.assert_array_equal(seq[:, 4:], t_lg[:, 3:-1].argmax(-1))
    np.testing.assert_allclose(t_lg[:, 0], got[:, 0], rtol=1e-5, atol=1e-5)


def test_seamless_batched_decode_equals_single_stream():
    """The port's own invariant on JAX's export: ``encode`` and 8
    ``decode_step(enc_out=)`` steps at B = 2 give each request's logits
    alone at B = 1 bit for bit (the float head in fixed row blocks)."""
    m = _jax_model("seamless")
    tree = convert_params(m["deploy"], device="cpu")
    ee, tok = _t(m["batch"]["enc_embeds"]), m["batch"]["tokens"]
    with torch.no_grad():
        both = _port_decode(tree, m["tcfg"], encode(tree, m["tcfg"], ee),
                            tok)
        for i in range(B):
            alone = _port_decode(tree, m["tcfg"],
                                 encode(tree, m["tcfg"], ee[i:i + 1]),
                                 tok[i:i + 1])
            np.testing.assert_array_equal(both[i:i + 1], alone)


@pytest.mark.parametrize("tree", ["float", "deploy"])
def test_internvl2_forward_with_embeds_matches_jax(tree):
    """``forward(embeds=)``: logits [B, n_img + S, V] within 1e-4 of
    JAX's, equal argmaxes; the image prefix changes the text logits."""
    m = _jax_model("internvl2")
    jtree, jcfg, tcfg = _tree(m, tree)
    ttree = convert_params(jtree, device="cpu")
    tok, emb = m["batch"]["tokens"], m["batch"]["embeds"]
    want = np.asarray(_j_forward(jtree, jcfg, jnp.asarray(tok),
                                 embeds=jnp.asarray(emb), backend="oracle"))
    with torch.no_grad():
        got = forward(ttree, tcfg, _t(tok), embeds=_t(emb),
                      backend="oracle").numpy()
        text = forward(ttree, tcfg, _t(tok), backend="oracle").numpy()
    n_img = tcfg.n_frontend_tokens
    assert got.shape == (B, n_img + S, tcfg.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert text.shape == (B, S, tcfg.vocab)
    assert np.abs(got[:, n_img:] - text).max() > 1e-2


@pytest.mark.parametrize("model", ARCHS)
def test_calibrate_export_bit_exact_vs_jax(model):
    """The port's calibrate + export on JAX's float params: every weight
    code and every exponent equals JAX's export, but for a PSUM tile's
    shift where JAX's float ``ap`` lies within 0.01 of an integer (there
    ``floor`` may go either way: the norms of XLA and ATen differ in the
    last ulp, the calibration's float scales inherit it, and a
    fake-quant code of its second pass can round the other way; measured
    on internvl2-smoke, unit 1: ``mix.wo`` tile 1 at ap -4.0016 and
    ``ffn.wo`` tile 4 at -4.0037, one step apart; none on seamless);
    the report has JAX's layer names, counts (JAX's per stack x its
    units) and specs; ``frontend_proj`` stays float.  Where the two
    exports are bit-equal (seamless), their greedy tokens on ``oracle``
    through 8 decode steps are too (the port's ``oracle`` on JAX's own
    export gives JAX's tokens for both models: the forward tests)."""
    m = _jax_model(model)
    calibrated = calibrate_model(convert_params(m["p0"], device="cpu"),
                                 m["tcfg"], m["batch"])
    got, report = export_quantized(calibrated)
    want = convert_params(m["deploy"], device="cpu")
    j_ap = {path: q.ap for path, q, _ in _walk(
        _qp_nodes(convert_params(m["calibrated"], device="cpu")),
        _qp_nodes(calibrated))}
    n_deployed = n_boundary = 0
    for path, t, j in _walk(got, want):
        if isinstance(t, DeployedQuantState):
            n_deployed += 1
            assert (t.spec, t.name, t.out_dims) == (j.spec, j.name,
                                                   j.out_dims), path
            for f in ("w_codes", "ax_exp", "aw_exp"):
                assert torch.equal(getattr(t, f), getattr(j, f)), (path, f)
            assert (t.psum_exps is None) == (j.psum_exps is None), path
            if t.psum_exps is None:
                continue
            off = t.psum_exps != j.psum_exps
            ap = j_ap[path]
            near = (ap - torch.round(ap)).abs() < 0.01
            n_boundary += int(off.any(dim=-1).sum())
            assert not (off.any(dim=-1) & ~near).any(), (path, ap)
            assert bool(((t.psum_exps - j.psum_exps).abs()[off] == 1).all())
        else:
            assert torch.equal(t, j), path
    assert n_boundary <= 2 and (model == "internvl2" or n_boundary == 0)
    assert set(report) == set(m["report"])
    for name, r in report.items():
        jr = m["report"][name]
        assert r["count"] == jr["count"] * jr["n_units"], name
        assert (r["k"], r["n"], r["gs"], r["n_p"], r["mode"]) == (
            jr["k"], jr["n"], jr["gs"], jr["n_p"], jr["mode"]), name
    if model == "seamless":
        assert n_deployed == 2 * 6 + 2 * 10     # encoder 6, decoder 10 each
        enc_out = encode(got, m["tcfg"], _t(m["batch"]["enc_embeds"]),
                         backend="oracle")
        j_enc = _j_encode(m["deploy"], m["jcfg"],
                          m["jbatch"]["enc_embeds"], backend="oracle")
        prompt = m["batch"]["tokens"][:, :4]
        seq = _greedy_sequence(m["deploy"], m["jcfg"], j_enc, prompt)
        with torch.no_grad():
            lg = _port_decode(got, m["tcfg"], enc_out, seq)
        np.testing.assert_array_equal(lg[:, 3:-1].argmax(-1), seq[:, 4:])
    else:
        assert n_deployed == 2 * 7
        assert isinstance(got["frontend_proj"]["w"], torch.Tensor)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ARCHS)
def test_train_loss_and_grads_match_jax(model):
    """One QAT step's loss and gradients through ``make_loss_fn`` (the
    encoder's frames, or the image prefix with only the text logits
    scored) on JAX's calibrated tree on the power-of-two grid, against
    ``jax.value_and_grad`` of JAX's ``make_loss_fn``.  Measured (CPU,
    torch 2.13, JAX 0.9.0): the losses equal; each weight, table and norm
    gradient within 9e-7 of its largest entry, held at 1e-5; each
    quantizer scale's (``aw``, ``ax``, ``ap``: sums over a whole input
    that cancel) within 2.4e-4, held at 1e-3."""
    m = _jax_model(model)
    params = _po2_scales(m["calibrated"])
    jl, jg = jax.jit(jax.value_and_grad(j_make_loss_fn(m["jcfg"])))(
        params, m["jbatch"])
    tl, tg = value_and_grad(make_loss_fn(m["tcfg"]),
                            convert_params(params, device="cpu"),
                            {k: _t(v) for k, v in m["batch"].items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(tree_leaves(convert_params(jg, device="cpu")))
    got = dict(tree_leaves(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        tol = 1e-3 if path[-1] in ("aw", "ax", "ap") else 1e-5
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=tol * float(w.abs().max()) + 1e-30, err_msg=str(path))
    if model == "seamless":     # the encoder's linears are reached
        enc = got[("encoder", "units", "u0", "0", "ffn", "wi", "w")]
        assert float(enc.abs().max()) > 0


@pytest.mark.parametrize("model", ARCHS)
def test_distill_loss_takes_frontend_inputs(model):
    """``make_distill_loss_fn`` hands a batch's ``enc_embeds`` / ``embeds``
    to both forwards: its loss equals ``distill_loss`` of the two models'
    logits with those inputs (``distill_loss`` itself is held to JAX's in
    ``test_torch_train.py``), and differs without them (internvl2's
    labels span the prefixed sequence: distillation scores every
    position, as JAX's does)."""
    from repro_torch.quant import distill_loss
    m = _jax_model(model)
    batch = {k: _t(v) for k, v in m["batch"].items()}
    if model == "internvl2":
        batch["labels"] = _t(np.random.default_rng(5).integers(
            0, m["tcfg"].vocab, (B, m["tcfg"].n_frontend_tokens + S)))
    student = convert_params(_po2_scales(m["calibrated"]), device="cpu")
    teacher = convert_params(m["p0"], device="cpu")
    fn = make_distill_loss_fn(m["tcfg"], m["tcfg"], teacher)
    kw = {k: batch[k] for k in ("embeds", "enc_embeds") if k in batch}
    with torch.no_grad():
        got = fn(student, batch)
        want = distill_loss(forward(student, m["tcfg"], batch["tokens"], **kw),
                            forward(teacher, m["tcfg"], batch["tokens"], **kw),
                            batch["labels"])
        other = {**kw, next(iter(kw)): torch.zeros_like(next(iter(
            kw.values())))}
        moved = fn(student, {**batch, **other})
    assert float(got) == float(want)
    assert float(moved) != float(got)


@pytest.mark.parametrize("model", ARCHS)
def test_launcher_trains_on_frontend_batches(model, tmp_path):
    """``launch.train`` gives the data its frontend (JAX's launcher's
    fields) and two steps train on the CPU with finite losses."""
    from repro_torch.launch.train import main
    arch = ARCHS[model][0]
    tr = main(["--arch", arch, "--smoke", "--quant", "apsq", "--np", "4",
               "--steps", "2", "--seq-len", "8", "--global-batch", "2",
               "--save-every", "2", "--ckpt-dir", str(tmp_path),
               "--device", "cpu"])
    assert len(tr.metrics_log) == 2
    assert all(np.isfinite(r["loss"]) for r in tr.metrics_log)
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import build, parser
    *_, data = build(parser().parse_args(["--arch", arch, "--smoke",
                                          "--seq-len", "8"]))
    cfg = get_smoke(arch)
    assert (data.frontend, data.d_model, data.n_frontend_tokens) == (
        cfg.frontend, cfg.d_model, cfg.n_frontend_tokens or 8)
    key = "enc_embeds" if cfg.encdec else "embeds"
    assert SyntheticCorpus(data).batch_at(0)[key].shape == (
        8, data.n_frontend_tokens, cfg.d_model)


# ---------------------------------------------------------------------------
# A JAX export from disk; serving
# ---------------------------------------------------------------------------

def test_jax_store_export_restored_decodes_jax_tokens(tmp_path):
    """JAX's export of ``seamless-smoke`` written by JAX's store, read by
    the port's ``restore`` (the stacked encoder units come back
    unstacked): ``encode`` then 8 ``decode_step`` give JAX's greedy
    tokens."""
    m = _jax_model("seamless")
    j_save(str(tmp_path), 0, m["deploy"])
    tree, _ = restore(str(tmp_path), device="cpu")
    assert sorted(tree["encoder"]["units"]) == ["u0", "u1"]
    j_enc = _j_encode(m["deploy"], m["jcfg"], m["jbatch"]["enc_embeds"],
                      backend="oracle")
    seq = _greedy_sequence(m["deploy"], m["jcfg"], j_enc,
                           m["batch"]["tokens"][:, :4])
    with torch.no_grad():
        enc_out = encode(tree, m["tcfg"], _t(m["batch"]["enc_embeds"]),
                         backend="oracle")
        lg = _port_decode(tree, m["tcfg"], enc_out, seq)
    np.testing.assert_array_equal(lg[:, 3:-1].argmax(-1), seq[:, 4:])


ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
PROMPTS = [(5, 6), (9, 7), (1, 5), (13, 6)]    # (prompt, new)


def test_paged_engine_serves_internvl2_text_like_jax():
    """JAX's export of ``internvl2-smoke`` on the port's paged engine and
    on JAX's ``PagedServingEngine(backend="oracle")``: equal greedy
    tokens (both serve the text, ``frontend_proj`` unused)."""
    m = _jax_model("internvl2")
    rng = np.random.default_rng(0)
    spec = [(i, rng.integers(0, 256, size=n).astype(np.int32), k)
            for i, (n, k) in enumerate(PROMPTS)]

    def run(engine, req_cls):
        return {r.uid: r.out for r in engine.run(
            [req_cls(uid=u, tokens=t, max_new_tokens=k)
             for u, t, k in spec])}

    port = run(PagedServingEngine(convert_params(m["deploy"], device="cpu"),
                                  m["tcfg"], **ENGINE_KW), Request)
    ref = run(JEngine(m["deploy"], m["jcfg"], backend="oracle",
                      **ENGINE_KW), JRequest)
    assert port == ref
