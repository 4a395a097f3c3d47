"""The port's slice end to end against the JAX package, and its own
serving invariants, on the CPU at the ``tinyllama-smoke`` size.

* Calibrate + export: the port's ``calibrate_model`` + ``export_quantized``
  on float params carried across from JAX give exactly JAX's INT8 codes
  and every exponent, with and without ``scan_layers`` (quickstart
  policy: attention APSQ gs=2/n_p=4, FFN APSQ gs=4/n_p=8, rest W8A8).
* Serving: the JAX-exported tree through the port's
  ``PagedServingEngine`` (``device="cpu"``) gives the same greedy tokens
  as JAX's ``PagedServingEngine(backend="oracle")`` on ragged prompts
  (some power-of-two chunks of one token), EOS on one stream and
  ``decode_horizon=4``; last-chunk logits agree within rtol/atol 1e-4
  (the float ops around the integer GEMMs — RMSNorm, RoPE, SiLU,
  softmax, the float head — round differently in the two frameworks).
* The port's invariants: batched == single-stream, chunked prefill ==
  per-token scan (bit-equal cache), fused horizon == stepwise decode
  (including an EOS that first appears at step >= 1), and preemption
  replay.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tinyllama_1_1b import smoke_config as j_smoke
from repro.core import QuantConfig as JQC
from repro.models.model import forward_paged_chunk as j_forward_paged_chunk
from repro.models.model import init_lm as j_init_lm
from repro.models.model import init_paged_decode_state as j_init_paged
from repro.quant import QuantPolicy as JPolicy
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import convert_params
from repro_torch.configs.tinyllama_1_1b import smoke_config as t_smoke
from repro_torch.core import DeployedQuantState, QuantConfig
from repro_torch.models import (decode_horizon_paged, decode_step_paged,
                                forward_paged_chunk, init_lm,
                                init_paged_decode_state, paged_state_axes)
from repro_torch.models.model import tree_map
from repro_torch.quant import (QuantPolicy, calibrate_model,
                               export_quantized, policy_presets)
from repro_torch.serving import PagedServingEngine, Request
from repro_torch.serving.paged_cache import NULL_PAGE

J_POLICY = JPolicy.of(("*.mix.*", JQC.apsq(gs=2, n_p=4)),
                      ("*.ffn.*", JQC.apsq(gs=4, n_p=8)),
                      default=JQC.w8a8())
T_POLICY = policy_presets()["mix2_ffn4"]    # the same rules, port side


def _cfgs(scan):
    """(JAX config with ``scan_layers=scan``, the port's config); the port
    has one unit layout and reads a stacked JAX tree through
    ``convert_params``."""
    return (dataclasses.replace(j_smoke(), scan_layers=scan)
            .with_quant(J_POLICY), t_smoke().with_quant(T_POLICY))


@functools.lru_cache(maxsize=None)
def _jax_export(scan: bool) -> dict:
    """JAX float params, JAX calibrate + export, and the calibration
    tokens (quickstart recipe); built once per layout."""
    jcfg, tcfg = _cfgs(scan)
    p0 = j_init_lm(jax.random.PRNGKey(3), jcfg)
    tok = np.array(jax.random.randint(jax.random.PRNGKey(4), (2, 16), 0,
                                      jcfg.vocab))
    deploy, _ = j_export_quantized(
        j_calibrate_model(p0, jcfg, {"tokens": jnp.asarray(tok)}))
    return {"p0": p0, "deploy": deploy, "tok": tok, "jcfg": jcfg,
            "tcfg": tcfg}


@pytest.fixture(params=[False, True], ids=["unstacked", "scan_layers"])
def jax_export(request):
    return _jax_export(request.param)


def _walk(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _walk(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _distance_to_po2(v: torch.Tensor) -> str:
    lg = torch.log2(v.double())
    return f"log2={lg.tolist()} (off an integer by {(lg - lg.round()).abs().min().item():.3g})"


def test_calibrate_export_bit_exact_vs_jax(jax_export):
    tcfg = jax_export["tcfg"]
    tparams = convert_params(jax_export["p0"], device="cpu")
    calibrated = calibrate_model(tparams, tcfg,
                                 {"tokens": jax_export["tok"]})
    got, report = export_quantized(calibrated)
    want = convert_params(jax_export["deploy"], device="cpu")
    assert set(report) == {f"unit.0.{m}.w{w}" for m, ws in
                           (("mix", "qkvo"), ("ffn", "igo")) for w in ws}
    states = {path: s for path, s, _ in _walk(calibrated, calibrated)
              if not isinstance(s, torch.Tensor)}
    bad = []
    n_deployed = 0
    for path, t, j in _walk(got, want):
        if isinstance(t, DeployedQuantState):
            n_deployed += 1
            for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
                a, b = getattr(t, f), getattr(j, f)
                if a is None and b is None:
                    continue
                if a is None or b is None or not torch.equal(a, b):
                    qs = states[path]
                    src = {"ax_exp": qs.ax, "aw_exp": qs.aw,
                           "psum_exps": qs.ap}.get(f)
                    bad.append(f"{path}.{f}: port {a} != jax {b}; "
                               + (_distance_to_po2(src) if src is not None
                                  and f != "psum_exps" else f"ap={src}"))
        else:
            assert torch.equal(t, j), path
    assert n_deployed == 14
    assert not bad, "\n".join(bad)
    # The rescale 2^(ax_exp + aw_exp) stays where XLA's exp2 is exact
    # (test_torch_kernels), so execute_gemm on these layers is bit-exact.
    scale_exps = [int(e) for _, t, _ in _walk(got, got)
                  if isinstance(t, DeployedQuantState)
                  for e in (t.ax_exp + t.aw_exp).reshape(-1)]
    assert -12 <= min(scale_exps) and max(scale_exps) <= 12, (
        min(scale_exps), max(scale_exps))


# ---------------------------------------------------------------------------
# The slice end to end: JAX oracle engine vs the port's engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
PROMPT_LENS = [(5, 6), (9, 7), (1, 5), (13, 6), (6, 8)]  # (prompt, new)


def _spec():
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 256, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(PROMPT_LENS)]


def _run(engine, req_cls, spec, eos=None):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=m,
                    eos_token=eos.get(u) if eos else None)
            for u, t, m in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


def _first_divergence(a: dict, b: dict) -> str:
    for uid in sorted(a):
        for step, (x, y) in enumerate(zip(a[uid], b.get(uid, []))):
            if x != y:
                return f"stream {uid} step {step}: port {x} vs jax {y}"
    return "lengths differ"


def test_engine_greedy_tokens_match_jax_oracle():
    jax_export = _jax_export(False)
    deploy, jcfg, tcfg = (jax_export["deploy"], jax_export["jcfg"],
                          jax_export["tcfg"])
    tdeploy = convert_params(deploy, device="cpu")
    spec = _spec()
    probe = _run(PagedServingEngine(tdeploy, tcfg, **ENGINE_KW), Request,
                 spec)
    # EOS for stream 1: a token that first appears at step >= 1
    out1 = probe[1]
    step = next(i for i in range(1, len(out1)) if out1[i] not in out1[:i])
    eos = {1: out1[step]}
    port = _run(PagedServingEngine(tdeploy, tcfg, **ENGINE_KW), Request,
                spec, eos)
    ref = _run(JEngine(deploy, jcfg, backend="oracle", **ENGINE_KW),
               JRequest, spec, eos)
    assert port == ref, _first_divergence(port, ref)
    assert port[1] == out1[:step + 1]          # stopped at its EOS

    # last-chunk logits of a 13-token prompt (chunks 8 + 4 + 1)
    toks = spec[3][1]
    table = np.arange(1, 5, dtype=np.int32)[None]
    jst = j_init_paged(jcfg, 1, page_size=4, n_pages=8)
    tst = init_paged_decode_state(tcfg, 1, page_size=4, n_pages=8,
                                  device="cpu")
    j_chunk = jax.jit(lambda st, tk, ps: j_forward_paged_chunk(
        deploy, jcfg, st, tk, ps, jnp.asarray(table), backend="oracle"))
    done = 0
    for c in (8, 4, 1):
        jl, jst = j_chunk(jst, jnp.asarray(toks[done:done + c][None]),
                          jnp.asarray([done], jnp.int32))
        tl, tst = forward_paged_chunk(
            tdeploy, tcfg, tst, torch.from_numpy(toks[done:done + c][None]),
            torch.tensor([done], dtype=torch.int32), torch.from_numpy(table))
        done += c
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The port's own serving invariants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model():
    """The port alone: init -> calibrate -> export, all on the CPU."""
    _, tcfg = _cfgs(False)
    params = init_lm(tcfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    tok = rng.integers(0, tcfg.vocab, size=(2, 16))
    deploy, _ = export_quantized(calibrate_model(params, tcfg,
                                                 {"tokens": tok}))
    return deploy, tcfg


def _prompt(n, seed=0):
    return ((np.arange(n) * 7 + seed * 13) % 256).astype(np.int32)


def _single_stream(deploy, cfg, spec, **kw):
    outs = {}
    for uid, toks, n in spec:
        eng = PagedServingEngine(deploy, cfg, max_batch=1, page_size=4,
                                 n_pages=32, prefill_chunk=8,
                                 decode_horizon=1, **kw)
        outs[uid] = _run(eng, Request, [(uid, toks, n)])[uid]
    return outs


def test_batched_horizon_matches_single_stream(port_model):
    deploy, cfg = port_model
    spec = [(i, _prompt(4 + 3 * i, seed=i), 5 + i) for i in range(5)]
    single = _single_stream(deploy, cfg, spec)
    eng = PagedServingEngine(deploy, cfg, max_batch=3, page_size=4,
                             n_pages=40, prefill_chunk=8, decode_horizon=4)
    assert _run(eng, Request, spec) == single
    assert max(eng.horizon_hist) > 1          # fusion engaged
    eng.sched.assert_invariants()


def test_preemption_replays_exactly(port_model):
    deploy, cfg = port_model
    spec = [(i, _prompt(10 + i, seed=i), 6) for i in range(4)]
    single = _single_stream(deploy, cfg, spec)
    eng = PagedServingEngine(deploy, cfg, max_batch=4, page_size=4,
                             n_pages=8, prefill_chunk=4,
                             prefill_token_budget=4, decode_horizon=1)
    assert _run(eng, Request, spec) == single
    assert eng.sched.stats.preempted > 0, "pool was not small enough"
    assert eng.sched.alloc.n_free == 7


@pytest.mark.parametrize("L,chunks", [(13, [8, 4, 1]), (7, [4, 2, 1]),
                                      (8, [8])])
def test_chunked_prefill_bit_identical_to_scan(port_model, L, chunks):
    deploy, cfg = port_model
    toks = torch.from_numpy(_prompt(L, seed=3))
    table = torch.arange(1, -(-(L + 1) // 4) + 1, dtype=torch.int32)[None]
    st_a = init_paged_decode_state(cfg, 1, page_size=4, n_pages=16,
                                   device="cpu")
    for t in range(L):
        lg_a, st_a = decode_step_paged(deploy, cfg, st_a, toks[None, t:t + 1],
                                       torch.tensor([t]), table)
    st_b = init_paged_decode_state(cfg, 1, page_size=4, n_pages=16,
                                   device="cpu")
    done = 0
    for c in chunks:
        lg_b, st_b = forward_paged_chunk(deploy, cfg, st_b,
                                         toks[None, done:done + c],
                                         torch.tensor([done]), table)
        done += c
    tree_map(lambda p, a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy(), err_msg=str(p)), st_a, st_b)
    assert int(lg_a[0, -1].argmax()) == int(lg_b[0, -1].argmax())


def _horizon_case(deploy, cfg, *, h=4, eos=(-1, -1, -1),
                  remaining=(9, 9, 9)):
    """Fused horizon vs H masked single steps on a 3-slot batch (slot 2
    rides inert)."""
    B = 3
    state = init_paged_decode_state(cfg, B, page_size=4, n_pages=16,
                                    device="cpu")
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [NULL_PAGE] * 3],
                         dtype=torch.int32)
    pos = torch.tensor([0, 2, 0], dtype=torch.int32)
    tokens = torch.tensor([[7], [11], [0]], dtype=torch.int32)
    kw = dict(active=torch.tensor([True, True, False]),
              budget=torch.tensor([h, h, 0], dtype=torch.int32),
              remaining=torch.tensor(remaining, dtype=torch.int32),
              eos=torch.tensor(eos, dtype=torch.int32))
    fused = decode_horizon_paged(deploy, cfg, state, tokens, pos, table,
                                 horizon=h, **kw)
    # stepwise reference with the engine's host-side masking
    axes = paged_state_axes(state)
    act, bud, rem = kw["active"], kw["budget"], kw["remaining"]
    toks, ons = [], []
    for _ in range(h):
        on = act & (bud > 0)
        tbl = torch.where(on[:, None], table, torch.zeros_like(table))
        lg, st2 = decode_step_paged(deploy, cfg, state, tokens, pos, tbl)
        state = tree_map(lambda _, o, n, ax: n if ax == -1 else torch.where(
            on.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), state, st2,
            axes)
        nxt = lg[:, -1].argmax(-1).to(torch.int32)
        rem = torch.where(on, rem - 1, rem)
        fin = on & ((nxt == kw["eos"]) | (rem <= 0))
        tokens = torch.where(on, torch.where(fin, 0, nxt), tokens[:, 0])[:, None]
        pos = pos + on.to(torch.int32)
        act, bud = act & ~fin, bud - on.to(torch.int32)
        toks.append(nxt)
        ons.append(on)
    return fused, (torch.stack(toks, 1), torch.stack(ons, 1), state, pos)


def _assert_same(fused, ref):
    assert torch.equal(fused[0], ref[0]) and torch.equal(fused[1], ref[1])
    assert torch.equal(fused[3], ref[3])
    tree_map(lambda p, a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy(), err_msg=str(p)), fused[2], ref[2])


def test_fused_horizon_bit_identical_to_stepwise(port_model):
    deploy, cfg = port_model
    _assert_same(*_horizon_case(deploy, cfg))


def test_fused_horizon_mid_eos_and_exhaustion(port_model):
    """Slot 0 stops at an EOS that first appears at step >= 1; slot 1 runs
    out of tokens after 2 steps."""
    deploy, cfg = port_model
    (tok, *_), _ = _horizon_case(deploy, cfg)
    row = tok[0].tolist()
    step = next(i for i in range(1, len(row)) if row[i] not in row[:i])
    fused, ref = _horizon_case(deploy, cfg, eos=(row[step], -1, -1),
                               remaining=(9, 2, 9))
    _assert_same(fused, ref)
    assert fused[1][0].tolist() == [True] * (step + 1) + [False] * (3 - step)
    assert fused[1][1].tolist() == [True, True, False, False]
    assert fused[3].tolist() == [step + 1, 4, 0]


def test_entry_points_need_an_explicit_cpu_device(port_model):
    _, cfg = port_model
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_decode_state(cfg, 1, page_size=4, n_pages=4)
    assert QuantConfig.w8a8().enabled


# ---------------------------------------------------------------------------
# PSUM exponents where the calibrated magnitude sits at a power of two
# ---------------------------------------------------------------------------

_SQRT127 = np.float32(np.sqrt(127.0))


def _w_for_mags(target: np.float32) -> np.float32:
    """A float32 weight w with ``2 w / sqrt(127)`` == ``target`` in
    float32: the PSUM magnitude ``calibrate_dense`` computes for a
    running sum of w (one row of ones)."""
    w = np.float32(target * _SQRT127 / 2)
    for _ in range(64):
        m = np.float32(np.float32(2) * w) / _SQRT127
        if m == target:
            return w
        w = np.nextafter(w, np.float32(np.inf if m < target else -np.inf))
    raise AssertionError(f"no float32 weight gives mags {target}")


@pytest.mark.parametrize("e", [-7, -1, 0, 3, 9])
@pytest.mark.parametrize("where", ["on", "ulp_above", "ulp_below"])
def test_psum_exponents_at_a_power_of_two_match_jax(e, where):
    """One layer (K=4, n_p=2: tiles w0 + w1 and w2 + w3 against a row of
    ones, w1 = 0, w2 = w3 = 0.3 w0) whose first tile's PSUM magnitude
    ``mags`` is exactly 2^e or one float32 ulp either side; ``aw`` lies
    far from a power of two.  Both packages calibrate it (the same
    float32 ``mags``; ``ap`` the float log2 of it) and export it: the
    port's ``psum_exps`` equal JAX's.  One ulp below 2^e (|e| >= 2) the
    float32 log2 rounds up to e on both sides, so ``floor(ap)`` is e
    where the exact exponent of ``mags`` is e - 1: an exact
    ``floor_log2(mags)`` on the port's side alone would break the
    agreement."""
    p = np.float32(2.0) ** e
    target = {"on": p, "ulp_above": np.nextafter(p, np.float32(np.inf)),
              "ulp_below": np.nextafter(p, np.float32(0))}[where]
    w0 = _w_for_mags(target)
    w = np.array([[w0], [0], [0.3 * w0], [0.3 * w0]], np.float32)
    x = np.ones((1, 4), np.float32)
    from repro.core.layers import calibrate_dense as j_calibrate_dense
    from repro.core.layers import quant_params_init as j_qp_init
    from repro_torch.core import calibrate_dense, quant_params_init
    tq = calibrate_dense(quant_params_init(torch.from_numpy(w),
                                           QuantConfig.apsq(gs=1, n_p=2),
                                           name="l"),
                         torch.from_numpy(x), torch.from_numpy(w))
    jq = j_calibrate_dense(j_qp_init(jnp.asarray(w), JQC.apsq(gs=1, n_p=2),
                                     name="l"),
                           jnp.asarray(x), jnp.asarray(w),
                           JQC.apsq(gs=1, n_p=2))
    got = export_quantized({"l": {"w": torch.from_numpy(w), "qp": tq}})[0]
    want = j_export_quantized({"l": {"w": jnp.asarray(w), "qp": jq}})[0]
    got, want = got["l"]["qp"], want["l"]["qp"]
    # the float log2s may differ in their last bit (e=3, one ulp above:
    # ATen 3.0000002, XLA 3.0), never in their floor
    floors = np.floor(float(tq.ap[0])), np.floor(float(jq.ap[0]))
    rounds_up = where == "ulp_below" and abs(e) >= 2
    assert floors == ((e, e) if where != "ulp_below" or rounds_up
                      else (e - 1, e - 1))
    for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("e", [-7, 3, 9])
def test_weight_exponent_one_ulp_below_a_power_of_two(e):
    """Where a weight scale ``aw`` lies one float32 ulp below 2^e
    (|e| >= 2) the exports part: the port takes the exact exponent
    ``floor_log2(aw)`` = e - 1 (``core.po2``), JAX ``floor(log2(aw))``
    of a float32 log2 that rounds up to e.  Recorded, not changed
    (ROADMAP queue 3)."""
    target = np.nextafter(np.float32(2.0) ** e, np.float32(0))
    w = np.full((2, 1), _w_for_mags(target), np.float32)   # aw == target
    from repro.core.layers import quant_params_init as j_qp_init
    from repro_torch.core import quant_params_init
    tq = quant_params_init(torch.from_numpy(w), QuantConfig.w8a8(),
                           name="l")
    jq = j_qp_init(jnp.asarray(w), JQC.w8a8(), name="l")
    assert float(tq.aw[0]) == float(np.asarray(jq.aw)[0]) == target
    got = export_quantized({"l": {"w": torch.from_numpy(w), "qp": tq}})[0]
    want = j_export_quantized({"l": {"w": jnp.asarray(w), "qp": jq}})[0]
    assert got["l"]["qp"].aw_exp.tolist() == [e - 1]
    assert np.asarray(want["l"]["qp"].aw_exp).tolist() == [e]
