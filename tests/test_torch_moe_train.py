"""Quantization-aware training through the port's MoE FFN, held to the JAX
package on the CPU at small sizes (numpy seeds; each tolerance is stated
where it is asserted).

* ``_expert_gemm`` under fake quant (a bank ``[E, C, K] @ [E, K, N]``
  with one shared quantizer state) against ``jax.grad`` of JAX's, which
  vmaps ``quant_dense`` over the experts: every LSQ and PSUM quantizer
  takes its gradient scale ``g = 1/sqrt(numel * Qp)`` from ONE expert's
  tensor, so the shared ``aw``/``ax``/``ap`` gradients are the sum of
  the experts' gradients at that ``g``.  E in {1, 4, 8}: E=1 is the
  dense case; at E > 1 a ``g`` taken over the whole bank is sqrt(E) too
  small.  APSQ gs=1, a partial last group, PSQ (gs = n_p) and W8A8;
  scalar and per-channel ``aw``; values built exactly on the clip
  bounds, where ``jnp.clip`` passes half the gradient.
* ``moe_ffn`` gradients (x, the float32 router, the banks, the shared
  states) against ``jax.grad`` of JAX's ``moe_ffn`` at capacity factors
  1.25 and 0.5 (drops), and exactly zero gradient to dropped entries.
* ``decay_mask`` and ``apply_updates`` (AdamW, and the factored
  ``adafactor_like`` second moment over the 3-D banks) on an
  ``olmoe-smoke`` tree against JAX's.
* One calibrated ``olmoe-smoke`` ``train_step`` (APSQ gs=2 n_p=8, two
  microbatches) against JAX's jitted ``make_train_step``: on the PO2
  grid at the dense slice's tolerances, and with float scales within a
  bound measured over seeds.
* Two microbatches against one; resume from a checkpoint equals
  continuous training bit for bit.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import repro.models.moe as j_moe
import repro_torch.models.moe as t_moe
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantState as JQuantState
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro.models.model import init_lm as j_init_lm
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import decay_mask as j_decay_mask
from repro.optim import init_opt_state as j_init_opt_state
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_smoke
from repro_torch.core import QuantConfig, QuantState
from repro_torch.data import DataConfig
from repro_torch.models import tree_leaves
from repro_torch.optim import (OptimConfig, apply_updates, decay_mask,
                               init_opt_state)
from repro_torch.quant import calibrate_model
from repro_torch.train import (TrainConfig, Trainer, make_grads_fn,
                               make_train_step)


# JAX's init, update and differentiated functions each under one jit
# (eagerly JAX compiles every op apart)
_j_init_lm = jax.jit(j_init_lm, static_argnums=1)
_j_apply_updates = jax.jit(j_apply_updates, static_argnums=3)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, *, is_scale: bool):
    """Gradients against JAX's, the forward values being equal (the
    dense slice's rule, ``tests/test_torch_train.py``): an element's
    gradient (to x or w) is the same products summed in another order,
    rtol 1e-5 and 1e-6 of the leaf's largest; a scale's gradient (aw,
    ax, ap) is a sum over the whole bank whose terms cancel, within 1e-3
    of the leaf's largest gradient."""
    top = np.abs(want).max() + 1e-12
    if is_scale:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * top)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * top)


def _by_path(tree):
    return {p: t for p, t in tree_leaves(tree)}


# ---------------------------------------------------------------------------
# _expert_gemm: the bank's fake quant against JAX's vmap
# ---------------------------------------------------------------------------

# (mode, n_p, gs, per-channel aw): gs 1, a partial last group (8 = 3 +
# 3 + 2) with per-channel and with scalar aw, PSQ, W8A8
MODES = {"gs1": ("apsq", 8, 1, True),
         "gs3_partial": ("apsq", 8, 3, True),
         "gs3_partial_aw_scalar": ("apsq", 8, 3, False),
         "psq": ("psq", 8, 8, True),
         "w8a8_aw_scalar": ("none", 1, 1, False)}


def _specs(mode, n_p, gs, per_channel):
    j = {"apsq": JQuantConfig.apsq(gs=gs, n_p=n_p),
         "psq": JQuantConfig.psq(n_p=n_p),
         "none": JQuantConfig.w8a8()}[mode]
    t = {"apsq": QuantConfig.apsq(gs=gs, n_p=n_p),
         "psq": QuantConfig.psq(n_p=n_p),
         "none": QuantConfig.w8a8()}[mode]
    return (dataclasses.replace(j, per_channel_w=per_channel),
            dataclasses.replace(t, per_channel_w=per_channel))


def _bank_case(rng, E, n_p, per_channel, C=5, K=48, N=12):
    """Power-of-two scales (every fake-quant product and tile sum exact,
    so the forwards are equal) and values exactly on the clip bounds:
    in expert 0, activations at +127 / -128 steps of ``ax`` and a weight
    at +127 / -128 steps of its ``aw``; its first PSUM tile of row 0 is
    exactly +127 / -128 at log2 scale 0 in columns 0 and 1."""
    ax = np.float32(0.5)
    aw = ((2.0 ** rng.integers(-3, -1, N)).astype(np.float32)
          if per_channel else np.float32(0.125))
    awv = np.broadcast_to(aw, (N,))
    x = (rng.standard_normal((E, C, K)) * 6 * ax).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * 30 * awv).astype(np.float32)
    kt = K // n_p
    # PSUM tie: row 0's first tile is 1 * w[0, 0, :2]
    x[0, 0, :kt] = 0
    x[0, 0, 0] = 1.0
    w[0, 0, :2] = np.float32([127, -128]) * awv[:2]
    w[0, 1:kt, :2] = 0
    # activation ties in row 1, a weight tie in column 5
    x[0, 1, -2:] = np.float32([127, -128]) * ax
    w[0, -1, 5] = np.float32(-128) * awv[5]
    la = rng.uniform(2.0, 6.0, n_p).astype(np.float32)
    la[0] = 0.0
    return x, w, aw, ax, la


@pytest.mark.parametrize("case", MODES)
@pytest.mark.parametrize("E", [1, 4, 8])
def test_expert_gemm_values_and_grads_match_jax(E, case):
    """JAX's ``_expert_gemm`` is ``jax.vmap(quant_dense)`` over E; the
    port's is one ``quant_dense`` over the bank.  Values bit-equal, and
    every gradient JAX's (a ``g`` over the whole bank would make the
    scales' sqrt(E) too small)."""
    mode, n_p, gs, per_channel = MODES[case]
    rng = np.random.default_rng(100 * E + 10 * n_p + gs + per_channel)
    jspec, tspec = _specs(mode, n_p, gs, per_channel)
    x, w, aw, ax, la = _bank_case(rng, E, n_p, per_channel)
    ct = rng.standard_normal((E, 5, 12)).astype(np.float32)
    has_ap = mode != "none"

    def jf(x, w, aw, ax, ap):
        qp = JQuantState(aw=aw, ax=ax, ap=ap, spec=jspec, name="e")
        return j_moe._expert_gemm(x, w, qp, None)

    jargs = [jnp.asarray(a) for a in (x, w, aw, ax)] + [
        jnp.asarray(la) if has_ap else None]
    argnums = (0, 1, 2, 3) + ((4,) if has_ap else ())
    jval = jax.jit(jf)(*jargs)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) * ct), argnums))(*jargs)
    leaves = [_t(a, True) for a in (x, w, aw, ax)] + (
        [_t(la, True)] if has_ap else [])
    qp = QuantState(aw=leaves[2], ax=leaves[3],
                    ap=leaves[4] if has_ap else None, spec=tspec, name="e")
    y = t_moe._expert_gemm(leaves[0], leaves[1], qp)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jval))
    (y * _t(ct)).sum().backward()
    # the tie elements are in x's and w's gradients: a value exactly on a
    # clip bound passes half its gradient in JAX, and so must the port
    # (all of it would be twice JAX's there)
    for i, (got, want) in enumerate(zip(leaves, jg)):
        _close(got.grad.numpy(), np.asarray(want), is_scale=i >= 2)


def test_expert_gemm_scale_grads_sum_per_expert_scales():
    """The rule itself, without JAX: the bank's scale gradients equal
    the sum over experts of E separate 2-D ``quant_dense`` calls."""
    rng = np.random.default_rng(7)
    E = 4
    _, tspec = _specs("apsq", 8, 3, True)
    x, w, aw, ax, la = _bank_case(rng, E, 8, True)
    ct = rng.standard_normal((E, 5, 12)).astype(np.float32)

    def grads(fn):
        leaves = [_t(a, True) for a in (aw, ax, la)]
        qp = QuantState(aw=leaves[0], ax=leaves[1], ap=leaves[2],
                        spec=tspec, name="e")
        (fn(qp) * _t(ct)).sum().backward()
        return [t.grad.numpy() for t in leaves]

    bank = grads(lambda qp: t_moe._expert_gemm(_t(x), _t(w), qp))
    from repro_torch.core.layers import quant_dense
    per = grads(lambda qp: torch.stack([quant_dense(_t(x[e]), _t(w[e]), qp)
                                        for e in range(E)]))
    for got, want in zip(bank, per):
        # the same terms; only the order of the sum over experts differs
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# moe_ffn gradients against jax.grad
# ---------------------------------------------------------------------------

def _floor_ap(tree):
    if isinstance(tree, JQuantState):
        return dataclasses.replace(
            tree, ap=None if tree.ap is None else jnp.floor(tree.ap))
    if isinstance(tree, dict):
        return {k: _floor_ap(v) for k, v in tree.items()}
    return tree


def _jcfg(scan_layers=False, quant=None):
    cfg = dataclasses.replace(j_get_smoke("olmoe-1b-7b"),
                              scan_layers=scan_layers)
    return cfg.with_quant(quant or JQuantConfig.apsq(gs=2, n_p=8))


def _tcfg():
    return get_smoke("olmoe-1b-7b").with_quant(QuantConfig.apsq(gs=2,
                                                                n_p=8))


def _with_scales(jtree, calibrated):
    """JAX's tree with each quantizer state's scales taken from the
    port's calibrated tree (same paths: both unstacked)."""
    if isinstance(jtree, JQuantState):
        return dataclasses.replace(jtree, **{
            f: jnp.asarray(getattr(calibrated, f).numpy())
            for f in ("aw", "ax", "ap")})
    if isinstance(jtree, dict):
        return {k: _with_scales(v, calibrated[k]) for k, v in jtree.items()}
    return jtree


@functools.lru_cache(maxsize=None)
def _jax_calibrated(seed: int):
    """JAX's olmoe-smoke params (unstacked units) under APSQ gs=2 n_p=8
    with calibrated scales, and a batch of 4 x 16.  The scales come from
    the port's ``calibrate_model`` on the converted params: calibration
    is held to JAX's bit for bit in ``test_torch_moe.py``, and JAX's
    takes 26 s here."""
    batch = JSyntheticCorpus(JDataConfig(vocab=256, seq_len=16,
                                         global_batch=4,
                                         seed=seed)).batch_at(seed)
    p0 = _j_init_lm(jax.random.PRNGKey(seed), _jcfg())
    calibrated = calibrate_model(convert_params(p0, device="cpu"), _tcfg(),
                                 {"tokens": batch["tokens"]})
    return _with_scales(p0, calibrated), batch


def _leaf_list(ffn):
    """The ffn's differentiable leaves in a fixed order, by name."""
    names = []
    for k in ("router", "wi", "wg", "wo"):
        if isinstance(ffn[k], dict):
            names.append((k, "w"))
        else:
            names.append((k,))
    for k in ("qp_wi", "qp_wg", "qp_wo"):
        names += [(k, "aw"), (k, "ax"), (k, "ap")]
    return names


def _get(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def _set_all(tree, paths, values):
    """A copy of an ffn tree (dicts and frozen states) with ``values`` at
    ``paths``."""
    def put(node, path, v):
        if not path:
            return v
        k = path[0]
        if isinstance(node, dict):
            return {**node, k: put(node[k], path[1:], v)}
        return dataclasses.replace(node, **{k: put(getattr(node, k),
                                                   path[1:], v)})
    for p, v in zip(paths, values):
        tree = put(tree, p, v)
    return tree


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
def test_moe_ffn_grads_match_jax(monkeypatch, cf):
    """Gradients of ``sum(moe_ffn(x) * ct)`` to x, the router, the three
    banks and their states, on JAX's calibrated layer with its scales on
    the PO2 grid (the expert GEMMs exact in both).  Element gradients:
    rtol 1e-4 and 1e-5 of the leaf's largest (the router's softmax and
    the SiLU round differently in the two frameworks, and the
    renormalised top-k weights carry it into x and the router); scale
    gradients within 1e-3 of the leaf's largest, as for one GEMM.
    Dropped entries get exactly zero gradient."""
    params, _ = _jax_calibrated(0)
    jffn = _floor_ap(j_snap_params_po2(params))["units"]["u0"]["0"]["ffn"]
    tffn = convert_params(jffn, device="cpu")
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    ct = rng.standard_normal((3, 5, 64)).astype(np.float32)
    kw = dict(n_experts=8, top_k=2, capacity_factor=cf)
    paths = _leaf_list(jffn)

    def jloss(x, *vals):
        p = _set_all(jffn, paths, vals)
        return jnp.sum(j_moe.moe_ffn(p, x, **kw) * ct)

    jvals = [_get(jffn, p) for p in paths]
    jg = jax.jit(jax.grad(jloss, tuple(range(len(paths) + 1))))(
        jnp.asarray(x), *jvals)
    # the port, recording the gradient that reaches each dispatched
    # entry: the gather of the [T, d] tokens by the T * top_k sorted
    # entries' token ids
    seen = {}
    orig_dispatch = t_moe._dispatch
    T, k = x.shape[0] * x.shape[1], kw["top_k"]

    def dispatch(*a):
        out = orig_dispatch(*a)
        seen["keep"] = out[2]
        return out

    class WatchGather(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func is torch.Tensor.__getitem__ and "entries" not in seen
                    and args[0].shape == (T, x.shape[-1])
                    and args[0].requires_grad
                    and isinstance(args[1], torch.Tensor)
                    and args[1].shape == (T * k,)):
                seen["entries"] = None
                out.register_hook(lambda g: seen.__setitem__("entries", g))
            return out

    monkeypatch.setattr(t_moe, "_dispatch", dispatch)
    tx = _t(x, True)
    tvals = [_get(tffn, p).detach().requires_grad_(True) for p in paths]
    with WatchGather():
        y = t_moe.moe_ffn(_set_all(tffn, paths, tvals), tx, **kw)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jax.jit(
            lambda p, x: j_moe.moe_ffn(p, x, **kw))(jffn, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    (y * _t(ct)).sum().backward()
    keep = seen["keep"].numpy()
    if cf == 0.5:
        assert (~keep).sum() > 0, "capacity 0.5 should drop entries"
    # dropped entries (sorted order): exactly zero, kept ones not
    ent = seen["entries"].numpy()
    assert np.all(ent[~keep] == 0)
    assert np.all(np.abs(ent[keep]).max(axis=-1) > 0)
    for i, (got, want) in enumerate(zip([tx] + tvals, jg)):
        name = "x" if i == 0 else "/".join(paths[i - 1])
        want = np.asarray(want)
        top = np.abs(want).max() + 1e-12
        if i > 0 and paths[i - 1][-1] in ("aw", "ax", "ap"):
            np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                       atol=1e-3 * top, err_msg=name)
        else:
            np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * top, err_msg=name)


# ---------------------------------------------------------------------------
# Optimizer on a MoE tree
# ---------------------------------------------------------------------------

def _path_key(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", ""))) for k in path)


def test_decay_mask_on_moe_tree_matches_jax():
    jparams = _j_init_lm(jax.random.PRNGKey(0), _jcfg())
    got = _by_path(decay_mask(convert_params(jparams, device="cpu")))
    want = {_path_key(p): bool(v) for p, v in
            jax.tree_util.tree_leaves_with_path(j_decay_mask(jparams))}
    assert got == want
    # per layer: the 4 attention weights, the 2-D router and the three
    # 3-D banks decay; no quantizer state does
    ffn = [p for p, v in got.items() if v and "ffn" in p]
    assert len(ffn) == 2 * 4 and sum(got.values()) == 2 * 8 + 2
    assert not any(v for p, v in got.items() if p[-1] in ("aw", "ax", "ap"))


@pytest.mark.parametrize("adafactor", [False, True])
def test_apply_updates_on_moe_tree_matches_jax(adafactor):
    """Three AdamW steps on JAX's olmoe-smoke tree with random gradients
    (clipping active on two): params and moments within the dense
    slice's bound (rtol 2e-5, atol 1e-7; float32 elementwise updates).
    With ``adafactor_like`` the 3-D banks' second moments factor over
    their last two dims, ``[E, K]`` rows and ``[E, N]`` columns."""
    jparams = _j_init_lm(jax.random.PRNGKey(1), _jcfg())
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
                adafactor_like=adafactor)
    jo, to = JOptimConfig(**ocfg), OptimConfig(**ocfg)
    jstate = j_init_opt_state(jparams, jo)
    tparams = convert_params(jparams, device="cpu")
    tstate = init_opt_state(tparams, to)
    rng = np.random.default_rng(8)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    for step in range(3):
        scale = 1e-3 if step == 1 else 1.0
        gl = [jnp.asarray((rng.standard_normal(np.shape(v)) * scale)
                          .astype(np.float32)) for _, v in leaves]
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), gl)
        tgrads = convert_params(jgrads, device="cpu")
        jparams, jstate, jstats = _j_apply_updates(jparams, jgrads, jstate,
                                                   jo)
        tparams, tstate, tstats = apply_updates(tparams, tgrads, tstate, to)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        for got, want in ((tparams, jparams), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            w = {_path_key(p): np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(want)}
            g = _by_path(got)
            assert g.keys() == w.keys()
            for path, t in g.items():
                np.testing.assert_allclose(t.numpy(), w[path], rtol=2e-5,
                                           atol=1e-7,
                                           err_msg=str((step, path)))
    if adafactor:
        wi = tstate["v"]["units"]["u0"]["0"]["ffn"]["wi"]
        assert wi["row"].shape == (8, 64) and wi["col"].shape == (8, 64)
        assert sorted(tstate["v"]["units"]["u0"]["0"]["ffn"]["qp_wi"].aw) \
            == ["full"]


# ---------------------------------------------------------------------------
# One train step against JAX's
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SEEDS = (0, 1)


@functools.lru_cache(maxsize=None)
def _jax_step_fn():
    """JAX's train step, jitted once for the module (two microbatches)."""
    return jax.jit(j_make_train_step(_jcfg(), JOptimConfig(**OCFG),
                                     JTrainConfig(microbatches=2)))


@functools.lru_cache(maxsize=None)
def _jax_case(seed: int, grid: str):
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
    return step(tp, init_opt_state(tp, OptimConfig(**OCFG)),
                {k: torch.as_tensor(v) for k, v in batch.items()})


def _expert_scale_paths(tree):
    return [p for p, _ in tree_leaves(tree)
            if "ffn" in p and p[-1] in ("aw", "ax", "ap")]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_on_po2_grid_matches_jax(seed):
    """Scales on the PO2 grid: the loss and the gradient norm agree to
    their sums' order (rtol 1e-6), the first moments (``m`` = 0.1 g)
    within rtol 1e-5 / atol 1e-8, ``v`` within rtol 1e-5 / atol 1e-10,
    the new params within 1% of one step's learning rate: the dense
    slice's tolerances.  The expert quantizers' moments are JAX's, not
    sqrt(E) = 2.83 times smaller.

    Adam's first update is ``u = g / (|g| + eps)``: where |g| is far
    below 100 eps (a few elements of a bank or the router whose terms
    cancel, |g| ~ 1e-9 at eps 1e-8: 3 elements at seed 0 move by more
    than 1%) a last-ulp difference of g moves u by up to |dg| / eps, so there
    the params are held to ``lr * (|dg| / eps + 1e-2)`` with ``dg`` the
    two gradients' difference (held itself by the ``m`` check)."""
    params, batch, (jp, js, jst) = _jax_case(seed, "po2")
    tp, ts, tst = _port_step(params, batch)
    assert float(tst["lr"]) == float(jst["lr"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-6)
    lr = float(jst["lr"])
    for got, want, rtol, atol in (
            (ts["m"], js["m"], 1e-5, 1e-8), (ts["v"], js["v"], 1e-5, 1e-10)):
        w = _by_path(convert_params(want, device="cpu"))
        for path, t in _by_path(got).items():
            np.testing.assert_allclose(t.numpy(), w[path].numpy(),
                                       rtol=rtol, atol=atol,
                                       err_msg=str((seed, path)))
    want_m = _by_path(convert_params(js["m"], device="cpu"))
    got_m = _by_path(ts["m"])
    want_p = _by_path(convert_params(jp, device="cpu"))
    eps = OptimConfig().eps
    for path, t in _by_path(tp).items():
        g, jg = got_m[path] / 0.1, want_m[path] / 0.1
        small = jg.abs() < 100 * eps
        bound = torch.where(small, lr * ((g - jg).abs() / eps + 1e-2),
                            torch.full_like(g, 1e-2 * lr))
        gap = (t.float() - want_p[path].float()).abs()
        assert bool((gap <= bound).all()), (seed, path, float(gap.max()))
    paths = _expert_scale_paths(ts["m"])
    assert len(paths) == 2 * 3 * 3
    for path in paths:
        ratio = (float(want_m[path].norm())
                 / max(float(_by_path(ts["m"])[path].norm()), 1e-30))
        assert abs(ratio - 1.0) < 1e-3, (path, ratio)


def test_train_step_with_float_scales_within_measured_bound():
    """JAX's calibrated float scales: a tile's float sum adds in another
    order and one PSUM code can round the other way (as in the dense
    slice), and a loss and gradient move by a discrete step.  Measured
    on the CPU over seeds 0-5 with these params and scales (torch 2.13,
    JAX 0.9.0): loss within 5.05e-3 (relative; seed 5), gradient norm
    within 1.15e-2 (seed 3), the first moments' L2 difference within
    16.6% of their norm (seed 3).  Held at 1e-2, 2e-2 and 25%."""
    for seed in SEEDS:
        params, batch, (jp, js, jst) = _jax_case(seed, "float")
        tp, ts, tst = _port_step(params, batch)
        loss, jloss = float(tst["loss"]), float(jst["loss"])
        assert abs(loss - jloss) <= 1e-2 * jloss
        gn, jgn = float(tst["grad_norm"]), float(jst["grad_norm"])
        assert abs(gn - jgn) <= 2e-2 * jgn
        w = _by_path(convert_params(js["m"], device="cpu"))
        diff = math.sqrt(sum(float(((t - w[p]) ** 2).sum())
                             for p, t in tree_leaves(ts["m"])))
        norm = math.sqrt(sum(float((t ** 2).sum())
                             for _, t in tree_leaves(ts["m"])))
        assert diff <= 0.25 * norm, (seed, diff / norm)


def test_two_microbatches_against_one():
    """The same tokens in one microbatch or two, at a capacity factor
    that drops nothing (cap = T: capacity comes from the call's token
    count, so at 1.25 a half batch drops other entries than the whole).
    The loss and the weights' gradients agree to float order (rtol
    1e-6 / 1e-5 of the leaf's largest); ``ax`` and ``ap`` gradients are
    sqrt(2) larger with two (LSQ's ``g`` counts one expert's activations
    ``[cap, K]``, and cap halves with the batch), ``aw``'s equal, within
    1e-4 of the leaf's largest."""
    params, batch = _jax_calibrated(0)
    tcfg = _tcfg().scaled(capacity_factor=4.0)
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


def test_resume_equals_continuous_bit_for_bit(tmp_path):
    """``Trainer.fit`` on olmoe-smoke (APSQ gs=2 n_p=8, two microbatches,
    remat): 3 steps straight, or 2 steps, a checkpoint and a resumed
    third step, give the same params and moments bit for bit."""
    cfg = _tcfg()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    ocfg = OptimConfig(**OCFG)

    def trainer(d, save_every):
        return Trainer(cfg, ocfg, TrainConfig(
            microbatches=2, steps=3, save_every=save_every, log_every=100,
            ckpt_dir=str(tmp_path / d)), device="cpu")

    p_all, o_all = trainer("a", 0).fit(data, log=lambda m: None)
    trainer("b", 2).fit(data, steps=2, log=lambda m: None)
    logs = []
    p_res, o_res = trainer("b", 0).fit(data, log=logs.append)
    assert logs[0] == "[trainer] resumed from step 2"
    want = _by_path({"p": p_all, "o": o_all})
    got = _by_path({"p": p_res, "o": o_res})
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
