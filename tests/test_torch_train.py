"""Quantization-aware training in the port, held to the JAX package on the
CPU at small sizes (numpy seeds; each tolerance is stated where it is
asserted).

* ``lsq_quantize`` / ``po2_quantize`` values (bit-equal) and gradients
  against ``jax.grad``, with values built to land exactly on the clip
  bounds: there ``jnp.clip`` passes half the gradient, and so must the
  port (``torch.clamp`` would pass all of it).
* ``apsq_matmul`` and the accumulation forms (reference, scan, PSQ) for
  gs = 1, a partial last group, gs = n_p, with PSUM ties on the clip
  bounds; ``quant_dense`` with per-channel ``aw`` (apsq, psq, W8A8).
* ``lm_loss`` with z-loss and a mask, ``distill_loss``.
* ``apply_updates`` over several steps (clipping active, AdamW and the
  factored ``adafactor_like`` second moment), ``decay_mask`` on stacked
  and unstacked trees.
* ``SyntheticCorpus.batch_at`` bit-identical; ``get_config`` presets
  resolve JAX's per-layer specs.
* ``tinyllama-smoke`` under APSQ (gs=2, n_p=8): one ``train_step`` (two
  microbatches) from the same params, carried across by
  ``checkpoint.convert``, against JAX's jitted ``make_train_step`` — on
  the PO2 grid (scales snapped, PSUM scales floored: every fake-quant
  product and sum exact) tightly, and with JAX's calibrated float scales
  at the bound measured below; the port's two microbatches against one.
* activation checkpointing (``remat``, policies ``none``/``dots``) leaves
  values and gradients bit-equal.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantState as JQuantState
from repro.core import apsq as japsq
from repro.core import quantizers as jq
from repro.core.layers import quant_dense as j_quant_dense
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro.models.model import init_lm as j_init_lm
from repro.models.model import lm_loss as j_lm_loss
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import decay_mask as j_decay_mask
from repro.optim import init_opt_state as j_init_opt_state
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.quant.qat import distill_loss as j_distill_loss
from repro.quant.qat import make_distill_loss_fn as j_make_distill_loss_fn
from repro.quant.qat import quant_variants as j_quant_variants
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import QuantConfig, QuantState, apsq, quantizers
from repro_torch.core.layers import quant_dense
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticCorpus
from repro_torch.models import forward, init_lm, lm_loss, tree_leaves
from repro_torch.optim import (OptimConfig, apply_updates, decay_mask,
                               init_opt_state)
from repro_torch.quant import (calibrate_model, distill_loss,
                               make_distill_loss_fn, quant_variants,
                               snap_params_po2)
from repro_torch.train import (TrainConfig, Trainer, make_grads_fn,
                               make_train_step, value_and_grad)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, *, is_scale: bool):
    """Gradients against JAX's, the forward values being equal.  An
    element's gradient (to x or w) is the same products summed in
    another order: rtol 1e-5 and 1e-6 of the leaf's largest.  A scale's
    gradient (aw, ax, ap) is a sum over the whole tensor whose terms
    cancel, so its rounding error scales with the terms, not the result:
    within 1e-3 of the leaf's largest gradient."""
    top = np.abs(want).max() + 1e-12
    if is_scale:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * top)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * top)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def _x_with_ties(rng, alpha, shape=(6, 40)):
    """Random values, row 0 starting with values exactly on the clip
    bounds (127 and -128 steps of a power-of-two ``alpha``) and two far
    outside."""
    a = np.broadcast_to(alpha, shape[-1:]).astype(np.float32)
    x = (rng.standard_normal(shape) * 40 * a).astype(np.float32)
    x[0, :6] = a[:6] * np.array([127, -128, 127, -128, 300, -300],
                                np.float32)
    return x


@pytest.mark.parametrize("kind", ["lsq", "lsq_per_channel", "po2"])
def test_quantizer_values_and_grads_match_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "po2":
        la = np.float32(-1.3)                       # alpha = 2^-2
        alpha = np.float32(0.25)
        scale, jfn, tfn = la, jq.po2_quantize, quantizers.po2_quantize
    else:
        alpha = (np.float32(0.5) if kind == "lsq"
                 else (2.0 ** rng.integers(-4, 0, 40)).astype(np.float32))
        scale, jfn, tfn = alpha, jq.lsq_quantize, quantizers.lsq_quantize
    x = _x_with_ties(rng, alpha)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jval = jfn(jnp.asarray(x), jnp.asarray(scale))
    jgx, jga = jax.grad(lambda a, s: jnp.sum(jfn(a, s) * ct), (0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    tx, ts = _t(x, True), _t(scale, True)
    tval = tfn(tx, ts)
    (tval * _t(ct)).sum().backward()
    np.testing.assert_array_equal(tval.detach().numpy(), np.asarray(jval))
    # gradient to x: the same products on both sides, exact
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    # a value exactly on a bound passes half its cotangent
    ties = np.isin(x / alpha, np.float32([127, -128]))
    assert ties.sum() >= 4
    np.testing.assert_array_equal(tx.grad.numpy()[ties], 0.5 * ct[ties])
    # gradient to the scale: a sum over the tensor in another order
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jga), rtol=1e-5,
                               atol=1e-7)


def test_lsq_forward_is_exact_where_jax_grad_scale_is_not():
    """JAX's ``grad_scale`` returns ``a*g + a*(1-g)``, which can be one ulp
    off ``a`` when ``a`` is not a power of two, and its LSQ values move
    with it; the port's forward is ``round(clip(x/a)) * a`` exactly."""
    rng = np.random.default_rng(3)
    alpha = (rng.integers(3, 64, 40) / 64).astype(np.float32)
    x = (rng.standard_normal((6, 40)) * 40 * alpha).astype(np.float32)
    got = quantizers.lsq_quantize(_t(x, True), _t(alpha, True))
    exact = np.round(np.clip(x / alpha, -128, 127)) * alpha
    np.testing.assert_array_equal(got.detach().numpy(), exact)
    want = np.asarray(jq.lsq_quantize(jnp.asarray(x), jnp.asarray(alpha)))
    np.testing.assert_allclose(want, exact, rtol=2.4e-7, atol=0)


def test_ste_helpers_and_init_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(64) * 5).astype(np.float32)
    x[:4] = [0.5, 1.5, -0.5, -2.5]                  # rounding ties
    for jf, tf in ((jq.round_ste, quantizers.round_ste),
                   (jq.floor_ste, quantizers.floor_ste),
                   (jq.round_half_up_ste, quantizers.round_half_up_ste)):
        tx = _t(x, True)
        y = tf(tx)
        y.sum().backward()
        np.testing.assert_array_equal(y.detach().numpy(),
                                      np.asarray(jf(jnp.asarray(x))))
        np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))
    tx = _t(x, True)
    quantizers.grad_scale(tx, 0.25).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.full_like(x, 0.25))
    assert quantizers.lsq_gradient_scale(1000, 127) == \
        jq.lsq_gradient_scale(1000, 127)
    np.testing.assert_allclose(
        float(quantizers.init_log2_alpha_from(_t(x))),
        float(jq.init_log2_alpha_from(jnp.asarray(x))), rtol=1e-6)
    la = _t(np.float32(2.7), True)
    a = quantizers.po2_scale(la)
    a.backward()
    assert float(a.detach()) == 4.0
    np.testing.assert_allclose(float(la.grad), 4.0 * math.log(2.0),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# APSQ accumulation and GEMM
# ---------------------------------------------------------------------------

NP_GS = [(8, 1), (8, 3), (8, 8), (8, 2), (6, 4), (1, 1)]


def _tie_case(rng, n_p, M=5, K=48, N=12):
    """Integer-valued x, w (PSUMs exact) with log2 scale 0 on the first
    tile and PSUMs of the first tile exactly 127 and -128 in row 0."""
    x = rng.integers(-3, 4, (2, M, K)).astype(np.float32)
    w = rng.integers(-3, 4, (K, N)).astype(np.float32)
    kt = K // n_p
    x[0, 0, :kt] = 0
    x[0, 0, 0] = 1
    w[0, :2] = [127, -128]
    w[1:kt, :2] = 0
    la = rng.uniform(0.0, 4.0, n_p).astype(np.float32)
    la[0] = 0.0
    return x, w, la


@pytest.mark.parametrize("n_p,gs", NP_GS)
def test_apsq_matmul_values_and_grads_match_jax(n_p, gs):
    rng = np.random.default_rng(10 * n_p + gs)
    for x, w, la in (_tie_case(rng, n_p),
                     ((rng.standard_normal((2, 5, 48)) * 2).astype(
                         np.float32),
                      rng.standard_normal((48, 12)).astype(np.float32),
                      rng.uniform(-1.0, 3.0, n_p).astype(np.float32))):
        ct = rng.standard_normal((2, 5, 12)).astype(np.float32)

        def jf(x, w, la):
            return jnp.sum(japsq.apsq_matmul(x, w, la, n_p=n_p, gs=gs) * ct)

        jval = japsq.apsq_matmul(x, w, la, n_p=n_p, gs=gs)
        jg = jax.grad(jf, (0, 1, 2))(x, w, la)
        tx, tw, tla = _t(x, True), _t(w, True), _t(la, True)
        tval = apsq.apsq_matmul(tx, tw, tla, n_p=n_p, gs=gs)
        (tval * _t(ct)).sum().backward()
        # values: the same float additions in the same order
        np.testing.assert_array_equal(tval.detach().numpy(),
                                      np.asarray(jval))
        for i, (got, want) in enumerate(zip((tx, tw, tla), jg)):
            _close(got.grad.numpy(), np.asarray(want), is_scale=i == 2)


@pytest.mark.parametrize("n_p,gs", [(8, 1), (8, 3), (8, 8), (5, 2)])
def test_accumulate_forms_match_jax(n_p, gs):
    rng = np.random.default_rng(n_p * 7 + gs)
    tiles = (rng.standard_normal((n_p, 3, 5)) * 60).astype(np.float32)
    tiles[0, 0, :2] = [127.0, -128.0]               # ties at scale 1
    la = rng.uniform(0.0, 3.0, n_p).astype(np.float32)
    la[0] = 0.0
    ct = rng.standard_normal((3, 5)).astype(np.float32)
    forms = [(japsq.apsq_accumulate_reference, apsq.apsq_accumulate_reference,
              dict(gs=gs)),
             (japsq.apsq_accumulate, apsq.apsq_accumulate, dict(gs=gs)),
             (japsq.psq_accumulate, apsq.psq_accumulate, {})]
    for jf, tf, kw in forms:
        jval = jf(jnp.asarray(tiles), jnp.asarray(la), **kw)
        jg = jax.grad(lambda t, a: jnp.sum(jf(t, a, **kw) * ct), (0, 1))(
            jnp.asarray(tiles), jnp.asarray(la))
        tt, tla = _t(tiles, True), _t(la, True)
        tval = tf(tt, tla, **kw)
        (tval * _t(ct)).sum().backward()
        np.testing.assert_array_equal(tval.detach().numpy(),
                                      np.asarray(jval))
        _close(tt.grad.numpy(), np.asarray(jg[0]), is_scale=False)
        _close(tla.grad.numpy(), np.asarray(jg[1]), is_scale=True)


@pytest.mark.parametrize("mode", ["apsq", "psq", "none"])
def test_quant_dense_grads_per_channel_aw_match_jax(mode):
    rng = np.random.default_rng(5)
    K, N = 64, 24
    spec = {"apsq": JQuantConfig.apsq(gs=3, n_p=8),
            "psq": JQuantConfig.psq(n_p=8),
            "none": JQuantConfig.w8a8()}[mode]
    tspec = {"apsq": QuantConfig.apsq(gs=3, n_p=8),
             "psq": QuantConfig.psq(n_p=8),
             "none": QuantConfig.w8a8()}[mode]
    x = (rng.standard_normal((2, 7, K)) * 2).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    aw = rng.uniform(0.002, 0.006, N).astype(np.float32)
    ax = np.float32(0.03)
    ap = (rng.uniform(-1.0, 1.0, 8) + np.log2(
        np.abs(x).mean() * np.abs(w).mean() * 40)).astype(np.float32)
    ct = rng.standard_normal((2, 7, N)).astype(np.float32)
    ap_or_none = ap if mode != "none" else None

    def jf(x, w, aw, ax, ap):
        qp = JQuantState(aw=aw, ax=ax, ap=ap, spec=spec, name="l")
        return jnp.sum(j_quant_dense(x, w, qp) * ct)

    args = [jnp.asarray(a) for a in (x, w, aw, ax)] + [
        None if ap_or_none is None else jnp.asarray(ap)]
    argnums = (0, 1, 2, 3) + ((4,) if mode != "none" else ())
    jg = jax.grad(jf, argnums)(*args)
    leaves = [_t(a, True) for a in (x, w, aw, ax)] + (
        [_t(ap, True)] if mode != "none" else [])
    qp = QuantState(aw=leaves[2], ax=leaves[3],
                    ap=leaves[4] if mode != "none" else None, spec=tspec,
                    name="l")
    y = quant_dense(leaves[0], leaves[1], qp)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(j_quant_dense(
            args[0], args[1], JQuantState(aw=args[2], ax=args[3],
                                          ap=args[4], spec=spec, name="l"))))
    (y * _t(ct)).sum().backward()
    for i, (got, want) in enumerate(zip(leaves, jg)):
        _close(got.grad.numpy(), np.asarray(want), is_scale=i >= 2)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss,masked", [(0.0, False), (1e-4, False),
                                           (1e-4, True), (0.0, True)])
def test_lm_loss_matches_jax(z_loss, masked):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    jf = lambda lg: j_lm_loss(lg, jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask),
                              z_loss)
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
    tl = _t(logits, True)
    tv = lm_loss(tl, _t(labels), None if mask is None else _t(mask), z_loss)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_distill_loss_matches_jax():
    rng = np.random.default_rng(7)
    s = (rng.standard_normal((2, 6, 40)) * 2).astype(np.float32)
    t = (rng.standard_normal((2, 6, 40)) * 2).astype(np.float32)
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    jv, jg = jax.value_and_grad(lambda a: j_distill_loss(
        a, jnp.asarray(t), jnp.asarray(labels), 0.3, 1.5))(jnp.asarray(s))
    ts = _t(s, True)
    tv = distill_loss(ts, _t(t), _t(labels), 0.3, 1.5)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_make_distill_loss_fn_matches_jax_and_freezes_the_teacher():
    """Float student and teacher (different seeds): the loss within 1e-5
    (relative; the forwards agree to 1e-4 in the logits), gradients to
    the student's leaves only."""
    jcfg = dataclasses.replace(j_get_smoke("tinyllama-1.1b"),
                               scan_layers=False)
    student = j_init_lm(jax.random.PRNGKey(1), jcfg)
    teacher = j_init_lm(jax.random.PRNGKey(2), jcfg)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    want = j_make_distill_loss_fn(jcfg, jcfg, teacher, 0.4, 2.0)(
        student, jax.tree.map(jnp.asarray, batch))
    tcfg = get_smoke("tinyllama-1.1b")
    tteacher = convert_params(teacher, device="cpu")
    fn = make_distill_loss_fn(tcfg, tcfg, tteacher, 0.4, 2.0)
    loss, grads = value_and_grad(fn, convert_params(student, device="cpu"),
                                 {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert all(t.grad is None for _, t in tree_leaves(tteacher))
    assert any(float(g.abs().max()) > 0 for _, g in tree_leaves(grads))


def test_quant_variants_and_snap_match_jax():
    want, got = j_quant_variants((1, 3), n_p=4), quant_variants((1, 3),
                                                                n_p=4)
    assert want.keys() == got.keys()
    for name in want:
        for layer in ("unit.0.mix.wq", "unit.0.ffn.wo", "head"):
            assert dataclasses.asdict(got[name].resolve(layer)) == \
                dataclasses.asdict(want[name].resolve(layer))
    params, _ = _jax_calibrated(0)
    snapped = convert_params(j_snap_params_po2(params), device="cpu")
    mine = snap_params_po2(convert_params(params, device="cpu"))
    for (path, a), (_, b) in zip(tree_leaves(mine), tree_leaves(snapped)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _jcfg(scan_layers=False, tie=False, quant=None):
    cfg = dataclasses.replace(j_get_smoke("tinyllama-1.1b"),
                              scan_layers=scan_layers, tie_embeddings=tie)
    return cfg.with_quant(quant or JQuantConfig.apsq(gs=2, n_p=8))


def _by_path(tree):
    return {p: t for p, t in tree_leaves(tree)}


@pytest.mark.parametrize("tie", [False, True])
def test_decay_mask_matches_jax_stacked_and_unstacked(tie):
    unstacked = j_init_lm(jax.random.PRNGKey(0), _jcfg(tie=tie))
    if tie:   # a tied head's quantizer state (policy name "head")
        unstacked = {**unstacked, "embed": {
            **unstacked["embed"], "qp_head": JQuantState(
                aw=jnp.ones(16), ax=jnp.ones(()), ap=jnp.zeros(8))}}
    stacked = j_init_lm(jax.random.PRNGKey(0), _jcfg(scan_layers=True))
    got = decay_mask(convert_params(unstacked, device="cpu"))
    jl = jax.tree_util.tree_leaves_with_path(j_decay_mask(unstacked))
    want = {tuple(getattr(k, "key", getattr(k, "name", "")) for k in path):
            bool(v) for path, v in jl}
    assert _by_path(got) == want
    assert sum(want.values()) == 2 * 7 + 1 + (not tie)  # weights, table
    # stacked: a norm scale is [U, d] there, kept out by its name
    js = jax.tree_util.tree_leaves_with_path(j_decay_mask(stacked))
    stacked_mask = {tuple(str(getattr(k, "key", getattr(k, "name", "")))
                          for k in path): bool(v) for path, v in js}
    got_stacked = decay_mask(convert_params(stacked, device="cpu"))
    for path, v in _by_path(got_stacked).items():
        jpath = tuple(p for p in path if not (p.startswith("u")
                                              and p[1:].isdigit()))
        assert stacked_mask[jpath] == v, path


@pytest.mark.parametrize("adafactor", [False, True])
def test_apply_updates_matches_jax_over_steps(adafactor):
    jparams = j_init_lm(jax.random.PRNGKey(1), _jcfg())
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
                adafactor_like=adafactor)
    jo, to = JOptimConfig(**ocfg), OptimConfig(**ocfg)
    jstate = j_init_opt_state(jparams, jo)
    tparams = convert_params(jparams, device="cpu")
    tstate = init_opt_state(tparams, to)
    rng = np.random.default_rng(8)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    for step in range(4):
        # step 1 under the clip norm, the others far above it
        scale = 1e-3 if step == 1 else 1.0
        gl = [(rng.standard_normal(np.shape(v)) * scale).astype(np.float32)
              for _, v in leaves]
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), [jnp.asarray(g)
                                                    for g in gl])
        tgrads = convert_params(jgrads, device="cpu")
        jparams, jstate, jstats = j_apply_updates(jparams, jgrads, jstate, jo)
        tparams, tstate, tstats = apply_updates(tparams, tgrads, tstate, to)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
        assert int(tstats["step"]) == int(jstats["step"]) == step + 1
        # float32 elementwise updates: ulps from pow/cos/sqrt and the
        # norm's sum order
        for got, want in ((tparams, jparams), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            w = _by_path(convert_params(want, device="cpu")) \
                if not adafactor or got is not tstate["v"] else None
            if w is None:      # factored moments: dicts inside the states
                w = {tuple(str(getattr(k, "key", getattr(k, "name", "")))
                           for k in path): torch.from_numpy(np.array(v))
                     for path, v in jax.tree_util.tree_leaves_with_path(
                         want)}
            g = _by_path(got)
            assert g.keys() == w.keys()
            for path, t in g.items():
                np.testing.assert_allclose(t.numpy(), w[path].numpy(),
                                           rtol=2e-5, atol=1e-7,
                                           err_msg=str((step, path)))
    if adafactor:
        wq = tstate["v"]["units"]["u0"]["0"]["mix"]["wq"]
        assert sorted(wq["w"]) == ["col", "row"]
        assert sorted(wq["qp"].aw) == ["full"]


def test_bf16_params_update_in_float32_and_stay_bf16():
    p = {"w": torch.randn(4, 6).to(torch.bfloat16),
         "norm": {"scale": torch.ones(6, dtype=torch.bfloat16)}}
    g = {"w": torch.randn(4, 6).to(torch.bfloat16),
         "norm": {"scale": torch.randn(6).to(torch.bfloat16)}}
    cfg = OptimConfig(lr=1e-2, warmup_steps=1)
    new, st, _ = apply_updates(p, g, init_opt_state(p, cfg), cfg)
    assert new["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == torch.float32
    # JAX's update on the same values, cast back to bfloat16
    jp = {"w": jnp.asarray(p["w"].float().numpy()).astype(jnp.bfloat16),
          "norm": {"scale": jnp.ones(6, jnp.bfloat16)}}
    jg = {k: v for k, v in {"w": jnp.asarray(g["w"].float().numpy()).astype(
        jnp.bfloat16), "norm": {"scale": jnp.asarray(
            g["norm"]["scale"].float().numpy()).astype(jnp.bfloat16)}}.items()}
    jc = JOptimConfig(lr=1e-2, warmup_steps=1)
    jnew, _, _ = j_apply_updates(jp, jg, j_init_opt_state(jp, jc), jc)
    for got, want in ((new["w"], jnew["w"]),
                      (new["norm"]["scale"], jnew["norm"]["scale"])):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# Data and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
def test_batch_at_bit_identical_to_jax(frontend):
    kw = dict(vocab=1000, seq_len=40, global_batch=4, seed=3,
              frontend=frontend, d_model=8, n_frontend_tokens=5)
    jc, tc = JSyntheticCorpus(JDataConfig(**kw)), SyntheticCorpus(
        DataConfig(**kw))
    for step, host, hosts in ((0, 0, 1), (7, 1, 2), (123, 3, 4)):
        want, got = jc.batch_at(step, host, hosts), tc.batch_at(step, host,
                                                                 hosts)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = PrefetchIterator(tc, start_step=5)
    try:
        for s in range(5, 8):
            step, b = next(it)
            assert step == s
            np.testing.assert_array_equal(b["tokens"],
                                          jc.batch_at(s)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()


@pytest.mark.parametrize("quant,gs,n_p", [("none", 2, 8), ("w8a8", 2, 8),
                                          ("psq", 2, 4), ("apsq", 2, 8),
                                          ("apsq", 3, 16)])
def test_get_config_presets_resolve_jax_specs(quant, gs, n_p):
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                 vocab=128, dtype="float32")
    jcfg = dataclasses.replace(
        j_get_config("tinyllama-1.1b", quant=quant, gs=gs, n_p=n_p),
        scan_layers=False, **small)
    tcfg = get_config("tinyllama-1.1b", quant=quant, gs=gs,
                      n_p=n_p).scaled(**small)
    jtree = j_init_lm(jax.random.PRNGKey(0), jcfg)
    ttree = init_lm(tcfg, seed=0, device="cpu")
    jstates = {path: s for path, s in _states(jtree, JQuantState)}
    tstates = {path: s for path, s in _states(ttree, QuantState)}
    assert jstates.keys() == tstates.keys()
    assert bool(tstates) == (quant != "none")
    for path, s in tstates.items():
        j = jstates[path]
        assert s.name == j.name
        assert dataclasses.asdict(s.spec) == dataclasses.asdict(j.spec), path
    with pytest.raises(KeyError):
        get_config("tinyllama-1.1b", quant="int4")


def _states(tree, cls, path=()):
    if isinstance(tree, cls):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _states(v, cls, path + (k,))


# ---------------------------------------------------------------------------
# One train step against JAX's
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SEEDS = (0, 1)


def _floor_ap(tree):
    if isinstance(tree, JQuantState):
        return dataclasses.replace(
            tree, ap=None if tree.ap is None else jnp.floor(tree.ap))
    if isinstance(tree, dict):
        return {k: _floor_ap(v) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def _jax_step_fn():
    """JAX's train step, jitted once for the module (two microbatches)."""
    return jax.jit(j_make_train_step(_jcfg(scan_layers=True),
                                     JOptimConfig(**OCFG),
                                     JTrainConfig(microbatches=2)))


def _stacked_scales(jtree, calibrated, path=()):
    """JAX's scan-stacked tree with each quantizer state's scales taken
    from the port's calibrated (unstacked) tree, stacked over units."""
    if isinstance(jtree, JQuantState):
        units = [calibrated["units"][f"u{i}"] for i in range(len(
            calibrated["units"]))]

        def stack(field):
            vals = []
            for u in units:
                node = u
                for k in path[1:]:
                    node = node[k]
                vals.append(getattr(node, field).numpy())
            return jnp.asarray(np.stack(vals))
        return dataclasses.replace(jtree, aw=stack("aw"), ax=stack("ax"),
                                   ap=stack("ap"))
    if isinstance(jtree, dict):
        return {k: _stacked_scales(v, calibrated, path + (k,))
                for k, v in jtree.items()}
    return jtree


@functools.lru_cache(maxsize=None)
def _jax_calibrated(seed: int):
    """JAX's params for ``seed`` (scan-stacked) with calibrated scales,
    and a batch.  The scales come from the port's ``calibrate_model`` on
    the converted params (JAX's calibration is held to the port's in
    ``test_torch_families.py``; here it would only cost time)."""
    jcfg = _jcfg(scan_layers=True)
    corpus = JSyntheticCorpus(JDataConfig(vocab=256, seq_len=16,
                                          global_batch=4, seed=seed))
    batch = corpus.batch_at(seed)
    p0 = j_init_lm(jax.random.PRNGKey(seed), jcfg)
    calibrated = calibrate_model(convert_params(p0, device="cpu"),
                                 _tcfg(), {"tokens": batch["tokens"]})
    return _stacked_scales(p0, calibrated), batch


def _tcfg():
    return get_smoke("tinyllama-1.1b").with_quant(QuantConfig.apsq(gs=2,
                                                                   n_p=8))


@functools.lru_cache(maxsize=None)
def _jax_case(seed: int, grid: str):
    """JAX's calibrated params (float scales, or on the PO2 grid), a batch
    and JAX's step from them."""
    params, batch = _jax_calibrated(seed)
    if grid == "po2":
        params = _floor_ap(j_snap_params_po2(params))
    out = _jax_step_fn()(params, j_init_opt_state(params,
                                                  JOptimConfig(**OCFG)),
                         jax.tree.map(jnp.asarray, batch))
    return params, batch, out


def _port_step(params, batch, microbatches=2):
    tp = convert_params(params, device="cpu")
    step = make_train_step(_tcfg(), OptimConfig(**OCFG),
                           TrainConfig(microbatches=microbatches))
    return tp, step(tp, init_opt_state(tp, OptimConfig(**OCFG)),
                    {k: torch.as_tensor(v) for k, v in batch.items()})


def test_train_step_on_po2_grid_matches_jax():
    """Scales snapped to powers of two and PSUM scales floored: every
    fake-quant product and tile sum is exact in float32, so the loss and
    the gradient norm agree to their sums' order, the gradients (``m`` = 0.1 g) agree
    to the order of the backward's float sums and the new params to 1%
    of one step's learning rate (Adam's ``u = m / (sqrt(v) + eps)`` is a
    sign-like direction: where ``|g|`` is near ``eps`` a last-ulp change
    of ``g`` moves it)."""
    for seed in SEEDS:
        params, batch, (jp, js, jst) = _jax_case(seed, "po2")
        _, (tp, ts, tst) = _port_step(params, batch)
        assert float(tst["lr"]) == float(jst["lr"])
        # the loss's token mean and the norm's sum over ≈ 60 leaves (JAX's
        # stacked) add in another order
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tst[k]), float(jst[k]),
                                       rtol=1e-6)
        lr = float(jst["lr"])
        for got, want, rtol, atol in (
                (ts["m"], js["m"], 1e-5, 1e-8), (ts["v"], js["v"], 1e-5, 1e-10),
                (tp, jp, 0.0, 1e-2 * lr)):
            w = _by_path(convert_params(want, device="cpu"))
            for path, t in _by_path(got).items():
                np.testing.assert_allclose(t.numpy(), w[path].numpy(),
                                           rtol=rtol, atol=atol,
                                           err_msg=str((seed, path)))


def test_train_step_with_float_scales_within_measured_bound():
    """JAX's calibrated float scales: a tile's float sum adds in another
    order, one PSUM code rounds the other way
    (``test_torch_families.py::test_float_scale_gap_is_one_psum_code``),
    and loss and gradient move by a discrete step.  Measured on the CPU
    over seeds 0-5 (torch 2.13, JAX 0.9.0): loss within 2.1e-3
    (relative), gradient norm within 3.8e-3, the gradient tree's L2
    difference within 8.0% of its norm.  Held at 5e-3, 1e-2 and 15%."""
    for seed in SEEDS:
        params, batch, (jp, js, jst) = _jax_case(seed, "float")
        _, (tp, ts, tst) = _port_step(params, batch)
        loss, jloss = float(tst["loss"]), float(jst["loss"])
        assert abs(loss - jloss) <= 5e-3 * jloss
        gn, jgn = float(tst["grad_norm"]), float(jst["grad_norm"])
        assert abs(gn - jgn) <= 1e-2 * jgn
        w = _by_path(convert_params(js["m"], device="cpu"))
        diff = math.sqrt(sum(float(((t - w[p]) ** 2).sum())
                             for p, t in tree_leaves(ts["m"])))
        norm = math.sqrt(sum(float((t ** 2).sum())
                             for _, t in tree_leaves(ts["m"])))
        assert diff <= 0.15 * norm, (seed, diff / norm)


def test_two_microbatches_against_one():
    """Same tokens in one microbatch or two: the loss and the weights'
    gradients agree to float order; ``ax`` and ``ap`` gradients are
    sqrt(2) larger with two, as in JAX (LSQ's ``g = 1/sqrt(numel * Qp)``
    takes the activation tensor's size, which halves), and ``aw``'s
    (from the weight's size) equal."""
    params, batch, _ = _jax_case(0, "float")
    tcfg = _tcfg()
    tp = convert_params(params, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    l1, g1 = make_grads_fn(tcfg, TrainConfig(microbatches=1))(tp, tb)
    l2, g2 = make_grads_fn(tcfg, TrainConfig(microbatches=2))(tp, tb)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    one = _by_path(g1)
    for path, g in tree_leaves(g2):
        assert g.dtype == torch.float32
        want = one[path] * (math.sqrt(2) if path[-1] in ("ax", "ap") else 1)
        rtol = 1e-4 if path[-1] in ("aw", "ax", "ap") else 1e-5
        np.testing.assert_allclose(
            g.numpy(), want.numpy(), rtol=0,
            atol=rtol * float(want.abs().max()) + 1e-12, err_msg=str(path))


@pytest.mark.parametrize("remat,policy", [(True, "none"), (True, "dots")])
def test_remat_leaves_values_and_grads_unchanged(remat, policy):
    cfg = get_smoke("tinyllama-1.1b").with_quant(QuantConfig.apsq(gs=2,
                                                                  n_p=4))
    params = init_lm(cfg, seed=4, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 12)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def loss_of(c):
        return lambda p, b: lm_loss(forward(p, c, b["tokens"]), b["labels"])

    l0, g0 = value_and_grad(loss_of(cfg.scaled(remat=False)), params, batch)
    l1, g1 = value_and_grad(
        loss_of(cfg.scaled(remat=remat, remat_policy=policy)), params, batch)
    assert float(l0) == float(l1)
    want = _by_path(g0)
    for path, g in tree_leaves(g1):
        assert torch.equal(g, want[path]), path
    with pytest.raises(ValueError):
        cfg.scaled(remat_policy="everything").validate()


def test_trainer_is_single_device_and_defaults_to_the_card():
    cfg = get_smoke("tinyllama-1.1b")
    with pytest.raises(NotImplementedError):
        Trainer(cfg, OptimConfig(), TrainConfig(compress_dcn_grads=True),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Trainer(cfg, OptimConfig(), TrainConfig())
