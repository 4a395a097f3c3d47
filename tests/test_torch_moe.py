"""The port's MoE slice against the JAX package, on the CPU at the
``olmoe-smoke`` size (2 layers, d_model 64, 8 experts, top-2, float32).

* Expert GEMM plain versions (``apsq_expert_matmul_ref``,
  ``baseline_expert_matmul_ref``, vectorised over E): bit-exact against
  the JAX ``oracle`` backend's ``int_expert_gemm`` (E unrolled
  ``int_gemm`` calls) over E, M, a ragged K, gs and both exponent
  layouts, and W8A8.
* ``execute_expert_gemm`` on a JAX-exported expert bank: bit-exact
  against per-expert ``execute_gemm`` and against JAX's own
  ``execute_expert_gemm``.
* ``moe_ffn`` against JAX ``moe_ffn`` (float, fake quant, deployed; a
  capacity that drops tokens): the dispatch buffer (which entries were
  kept, in which expert slot) bit-equal, outputs within rtol/atol 1e-5
  (float32; the float ops around the integer GEMMs round differently
  in the two frameworks).
* Calibrate + export on ``olmoe-smoke``: codes and every exponent
  bit-exact against JAX, ``n_experts`` in the report, from unstacked and
  scan-stacked JAX trees (``convert_params`` unstacks ``[U, E, ...]``).
* The port's ``PagedServingEngine`` against JAX's
  ``PagedServingEngine(backend="oracle")`` at ``max_batch=3``, where
  capacity drops occur: equal greedy tokens, last-chunk logits within
  rtol/atol 1e-4.  Batched serving is NOT held to single-stream: MoE
  capacity comes from the whole call, so a batch drops tokens a single
  stream would keep, in both packages.
* Fused decode horizon == stepwise decode, bit-identical, on the MoE
  model (idle slots ride along and take capacity in both).
* The paged-cache scatter leaves what a sequential scatter leaves where
  table rows repeat the null page (idle slots read it, and under MoE
  their routing reaches live tokens).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as j_moe
import repro_torch.models.moe as t_moe
from repro.configs.olmoe_1b_7b import smoke_config as j_smoke
from repro.core import QuantConfig as JQC
from repro.exec import execute_expert_gemm as j_execute_expert_gemm
from repro.exec import execute_gemm as j_execute_gemm
from repro.exec import get_backend as j_get_backend
from repro.models.model import forward_paged_chunk as j_forward_paged_chunk
from repro.models.model import init_lm as j_init_lm
from repro.models.model import init_paged_decode_state as j_init_paged
from repro.quant import QuantPolicy as JPolicy
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import convert_params
from repro_torch.configs.olmoe_1b_7b import smoke_config as t_smoke
from repro_torch.core import DeployedQuantState, QuantState
from repro_torch.exec import execute_expert_gemm, execute_gemm
from repro_torch.kernels.apsq_matmul import (apsq_expert_matmul_int8,
                                             baseline_expert_matmul_int8, ref)
from repro_torch.models import (decode_horizon_paged, decode_step_paged,
                                forward_paged_chunk, init_lm,
                                init_paged_decode_state, paged_state_axes)
from repro_torch.models.model import tree_map
from repro_torch.quant import calibrate_model, export_quantized, \
    policy_presets
from repro_torch.serving import PagedServingEngine, Request
from repro_torch.serving.paged_cache import NULL_PAGE

J_POLICY = JPolicy.of(("*.mix.*", JQC.apsq(gs=2, n_p=4)),
                      ("*.ffn.*", JQC.apsq(gs=4, n_p=8)),
                      default=JQC.w8a8())
T_POLICY = policy_presets()["mix2_ffn4"]    # the same rules, port side


# ---------------------------------------------------------------------------
# Expert GEMM plain versions against the JAX oracle
# ---------------------------------------------------------------------------

def _expert_operands(e, m, k, n, n_p, layout, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (e, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (e, k, n)).astype(np.int8)
    shape = (e, n_p) if layout == "vec" else (e, n_p, n)
    # exponents from -2 to 19 exercise negative and large shift counts
    exps = rng.integers(-2, 20, shape).astype(np.int32)
    return x, w, exps


@pytest.mark.parametrize("layout", ["vec", "cols"])
@pytest.mark.parametrize("gs", [1, 2, "n_p"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("e", [1, 4])
def test_apsq_expert_ref_bit_exact_vs_jax_oracle(e, m, gs, layout):
    k, n, n_p = 45, 24, 4                    # ragged K: 45 % 4 != 0
    gs = n_p if gs == "n_p" else gs
    x, w, exps = _expert_operands(e, m, k, n, n_p, layout,
                                  seed=100 * e + 10 * m + gs)
    want = j_get_backend("oracle").int_expert_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(exps), gs=gs)
    tx, tw, te = map(torch.from_numpy, (x, w, exps))
    got = ref.apsq_expert_matmul_ref(tx, tw, te, gs=gs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(apsq_expert_matmul_int8(tx, tw, te, gs=gs), got)
    # and E calls of the 2-D oracle give the same
    for i in range(e):
        assert torch.equal(got[i], ref.apsq_matmul_ref(
            tx[i], tw[i], te[i], n_p=n_p, gs=gs))


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("e", [1, 4])
def test_baseline_expert_ref_bit_exact_vs_jax_oracle(e, m):
    x, w, _ = _expert_operands(e, m, 45, 24, 1, "vec", seed=7 * e + m)
    want = j_get_backend("oracle").int_expert_gemm(
        jnp.asarray(x), jnp.asarray(w), None, gs=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = ref.baseline_expert_matmul_ref(tx, tw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(baseline_expert_matmul_int8(tx, tw), got)


def test_expert_wrappers_check_operands():
    x = torch.zeros((2, 3, 8), dtype=torch.int8)
    w = torch.zeros((2, 8, 5), dtype=torch.int8)
    with pytest.raises(TypeError):
        baseline_expert_matmul_int8(x.float(), w)
    with pytest.raises(ValueError):
        baseline_expert_matmul_int8(x, w[:1])
    with pytest.raises(ValueError):
        baseline_expert_matmul_int8(x[0], w[0])
    with pytest.raises(ValueError):       # exps for the wrong N
        apsq_expert_matmul_int8(x, w, torch.zeros((2, 4, 6),
                                                  dtype=torch.int32), gs=2)
    with pytest.raises(ValueError):       # exps for the wrong E
        apsq_expert_matmul_int8(x, w, torch.zeros((3, 4), dtype=torch.int32),
                                gs=2)


# ---------------------------------------------------------------------------
# JAX-built olmoe-smoke models
# ---------------------------------------------------------------------------

def _cfgs(scan):
    return (dataclasses.replace(j_smoke(), scan_layers=scan)
            .with_quant(J_POLICY), t_smoke().with_quant(T_POLICY))


@functools.lru_cache(maxsize=None)
def _jax_export(scan: bool) -> dict:
    """JAX float params, JAX calibrate + export, the calibration tokens."""
    jcfg, tcfg = _cfgs(scan)
    p0 = j_init_lm(jax.random.PRNGKey(5), jcfg)
    tok = np.array(jax.random.randint(jax.random.PRNGKey(6), (2, 16), 0,
                                      jcfg.vocab))
    calibrated = j_calibrate_model(p0, jcfg, {"tokens": jnp.asarray(tok)})
    deploy, report = j_export_quantized(calibrated)
    return {"p0": p0, "calibrated": calibrated, "deploy": deploy,
            "report": report, "tok": tok, "jcfg": jcfg, "tcfg": tcfg}


def _walk(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _walk(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _scale_exps(tree):
    return [int(e) for _, t, _ in _walk(tree, tree)
            if isinstance(t, DeployedQuantState)
            for e in (t.ax_exp.reshape(-1, 1) + t.aw_exp.reshape(
                t.ax_exp.numel(), -1)).reshape(-1)]


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unstacked", "scan_layers"])
def test_calibrate_export_bit_exact_vs_jax(scan):
    je = _jax_export(scan)
    tparams = convert_params(je["p0"], device="cpu")
    calibrated = calibrate_model(tparams, je["tcfg"], {"tokens": je["tok"]})
    got, report = export_quantized(calibrated)
    want = convert_params(je["deploy"], device="cpu")
    names = {f"unit.0.mix.w{w}" for w in "qkvo"} | {
        f"unit.0.ffn.w{w}" for w in "igo"}
    assert set(report) == names == set(je["report"])
    for w in "igo":
        assert report[f"unit.0.ffn.w{w}"]["n_experts"] == 8
        assert je["report"][f"unit.0.ffn.w{w}"]["n_experts"] == 8
    n_banks = 0
    for path, t, j in _walk(got, want):
        if isinstance(t, DeployedQuantState):
            if t.w_codes.dim() == 3:
                n_banks += 1
                assert t.w_codes.shape == (8, 64, 64), path
            assert t.out_dims == j.out_dims and t.name == j.name, path
            for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
                a, b = getattr(t, f), getattr(j, f)
                assert torch.equal(a, b), f"{path}.{f}"
        else:
            assert torch.equal(t, j), path
    assert n_banks == 2 * 3
    # the float banks are gone; the router stays float
    ffn = got["units"]["u1"]["0"]["ffn"]
    assert set(ffn) == {"router", "qp_wi", "qp_wg", "qp_wo"}
    # rescale exponents stay where XLA's exp2 is exact (see
    # test_torch_kernels), so the float rescale is bit-exact too
    se = _scale_exps(got)
    assert -12 <= min(se) and max(se) <= 12, (min(se), max(se))


def test_convert_params_unstacks_scan_stacked_moe_trees():
    je = _jax_export(True)
    for tree in (je["calibrated"], je["deploy"]):
        conv = convert_params(tree, device="cpu")
        units = tree["units"]["0"]
        assert sorted(conv["units"]) == ["u0", "u1"]
        for i in range(2):
            for path, t, j in _walk(conv["units"][f"u{i}"]["0"], units):
                if isinstance(t, (DeployedQuantState, QuantState)):
                    fields = [f.name for f in dataclasses.fields(t)
                              if isinstance(getattr(t, f.name), torch.Tensor)]
                    for f in fields:
                        np.testing.assert_array_equal(
                            getattr(t, f).numpy(),
                            np.asarray(getattr(j, f))[i], err_msg=path + f)
                else:
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(j)[i], err_msg=path)
    dq = convert_params(je["deploy"], device="cpu")["units"]["u1"]["0"][
        "ffn"]["qp_wo"]
    assert dq.w_codes.shape == (8, 64, 64) and dq.psum_exps.shape == (8, 8, 64)


def test_execute_expert_gemm_bit_exact_vs_per_expert_execute_gemm():
    je = _jax_export(False)
    jffn = je["deploy"]["units"]["u0"]["0"]["ffn"]
    tffn = convert_params(jffn, device="cpu")
    rng = np.random.default_rng(11)
    for name in ("qp_wi", "qp_wg", "qp_wo"):
        jdq, tdq = jffn[name], tffn[name]
        x = rng.standard_normal((8, 3, 64)).astype(np.float32)
        got = execute_expert_gemm(tdq, torch.from_numpy(x), backend="oracle")
        assert got.shape == (8, 3, 64)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_execute_expert_gemm(
                jdq, jnp.asarray(x), backend="oracle")))
        for e in range(8):
            jdq_e = dataclasses.replace(
                jdq, w_codes=jdq.w_codes[e], ax_exp=jdq.ax_exp[e],
                aw_exp=jdq.aw_exp[e], psum_exps=jdq.psum_exps[e])
            tdq_e = dataclasses.replace(
                tdq, w_codes=tdq.w_codes[e], ax_exp=tdq.ax_exp[e],
                aw_exp=tdq.aw_exp[e], psum_exps=tdq.psum_exps[e])
            want = np.asarray(j_execute_gemm(jdq_e, jnp.asarray(x[e]),
                                             backend="oracle"))
            np.testing.assert_array_equal(got[e].numpy(), want)
            assert torch.equal(
                execute_gemm(tdq_e, torch.from_numpy(x[e])), got[e])


# ---------------------------------------------------------------------------
# moe_ffn against JAX moe_ffn
# ---------------------------------------------------------------------------

def _record_expert_inputs(monkeypatch, module):
    """Wrap ``module._expert_gemm`` to keep each call's input buffer."""
    seen = []
    orig = module._expert_gemm

    def wrapped(x, *args, **kw):
        seen.append(np.array(x))
        return orig(x, *args, **kw)

    monkeypatch.setattr(module, "_expert_gemm", wrapped)
    return seen


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
@pytest.mark.parametrize("kind", ["float", "fakequant", "deployed"])
def test_moe_ffn_matches_jax(monkeypatch, kind, cf):
    je = _jax_export(False)
    src = {"float": je["p0"], "fakequant": je["calibrated"],
           "deployed": je["deploy"]}[kind]
    jffn = src["units"]["u0"]["0"]["ffn"]
    tffn = convert_params(jffn, device="cpu")
    x = np.random.default_rng(21).standard_normal((3, 5, 64)).astype(
        np.float32)
    kw = dict(n_experts=8, top_k=2, capacity_factor=cf)
    j_seen = _record_expert_inputs(monkeypatch, j_moe)
    t_seen = _record_expert_inputs(monkeypatch, t_moe)
    want = np.asarray(j_moe.moe_ffn(jffn, jnp.asarray(x), **kw))
    got = t_moe.moe_ffn(tffn, torch.from_numpy(x), **kw)
    # dispatch buffer [E, cap, d]: same kept entries in the same slots
    assert len(j_seen) == len(t_seen) == 3
    np.testing.assert_array_equal(t_seen[0], j_seen[0])
    kept = int((t_seen[0] != 0).any(axis=-1).sum())
    if cf == 0.5:
        assert kept < 15 * 2, "capacity 0.5 should drop entries"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_dispatch_rank_and_overflow_slot():
    """Stable sort by expert, rank within expert, overflow slot E*cap."""
    topi = torch.tensor([[1, 0], [1, 2], [1, 0], [3, 1]])
    order, slot, keep = t_moe._dispatch(topi, 4, cap=2)
    # flat entries: e = [1,0,1,2,1,0,3,1]; by expert: 0:[1,5] 1:[0,2,4,7]
    assert order.tolist() == [1, 5, 0, 2, 4, 7, 3, 6]
    assert keep.tolist() == [True, True, True, True, False, False, True,
                             True]
    assert slot.tolist() == [0, 1, 2, 3, 8, 8, 4, 6]


def test_scatter_pages_colliding_null_pages_take_the_last_entry():
    """Table rows repeat the null page; the pool must hold what a
    sequential row-major scatter leaves, whatever order a parallel
    scatter applies duplicates in (idle slots read the null page, and
    under MoE their routing reaches live tokens)."""
    from repro_torch.serving.paged_cache import _scatter_pages
    rng = np.random.default_rng(9)
    pages = torch.from_numpy(rng.integers(-127, 128, (6, 4, 2, 8))
                             .astype(np.int8))
    table = torch.tensor([[1, 2, 0], [0, 0, 0], [3, 0, 0], [4, 5, 0]],
                         dtype=torch.int32)
    gathered = torch.from_numpy(rng.integers(-127, 128, (4, 3, 4, 2, 8))
                                .astype(np.int8))
    want = pages.clone()
    for b in range(4):
        for j in range(3):
            want[int(table[b, j])] = gathered[b, j]
    assert torch.equal(_scatter_pages(pages, table, gathered), want)


# ---------------------------------------------------------------------------
# Serving: the port's engine against JAX's oracle engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
PROMPT_LENS = [(5, 6), (9, 7), (1, 5), (13, 6), (6, 8)]  # (prompt, new)


def _spec():
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 256, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(PROMPT_LENS)]


def _run(engine, req_cls, spec):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=m) for u, t, m in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


def test_engine_greedy_tokens_match_jax_oracle_with_drops(monkeypatch):
    je = _jax_export(False)
    deploy, jcfg, tcfg = je["deploy"], je["jcfg"], je["tcfg"]
    tdeploy = convert_params(deploy, device="cpu")
    spec = _spec()
    drops = []
    orig = t_moe._dispatch

    def counting(topi, n_experts, cap):
        order, slot, keep = orig(topi, n_experts, cap)
        drops.append(int((~keep).sum()))
        return order, slot, keep

    monkeypatch.setattr(t_moe, "_dispatch", counting)
    port = _run(PagedServingEngine(tdeploy, tcfg, **ENGINE_KW), Request,
                spec)
    monkeypatch.undo()
    ref_out = _run(JEngine(deploy, jcfg, backend="oracle", **ENGINE_KW),
                   JRequest, spec)
    assert sum(drops) > 0, "no capacity drop on this run"
    assert port == ref_out

    # last-chunk logits of a 13-token prompt (chunks 8 + 4 + 1)
    toks = spec[3][1]
    table = np.arange(1, 5, dtype=np.int32)[None]
    jst = j_init_paged(jcfg, 1, page_size=4, n_pages=8)
    tst = init_paged_decode_state(tcfg, 1, page_size=4, n_pages=8,
                                  device="cpu")
    done = 0
    for c in (8, 4, 1):
        jl, jst = j_forward_paged_chunk(
            deploy, jcfg, jst, jnp.asarray(toks[done:done + c][None]),
            jnp.asarray([done], jnp.int32), jnp.asarray(table),
            backend="oracle")
        tl, tst = forward_paged_chunk(
            tdeploy, tcfg, tst, torch.from_numpy(toks[done:done + c][None]),
            torch.tensor([done], dtype=torch.int32), torch.from_numpy(table))
        done += c
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def port_moe():
    """The port alone: init -> calibrate -> export on olmoe-smoke."""
    _, tcfg = _cfgs(False)
    params = init_lm(tcfg, seed=2, device="cpu")
    tok = np.random.default_rng(4).integers(0, tcfg.vocab, size=(2, 16))
    deploy, _ = export_quantized(calibrate_model(params, tcfg,
                                                 {"tokens": tok}))
    return deploy, tcfg


def _horizon_case(deploy, cfg, *, h=4, eos=(-1, -1, -1),
                  remaining=(9, 9, 9)):
    """Fused horizon vs H masked single steps on a 3-slot batch (slot 2
    rides inert, its token 0 taking expert capacity in both)."""
    state = init_paged_decode_state(cfg, 3, page_size=4, n_pages=16,
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
        tokens = torch.where(on, torch.where(fin, 0, nxt),
                             tokens[:, 0])[:, None]
        pos = pos + on.to(torch.int32)
        act, bud = act & ~fin, bud - on.to(torch.int32)
        toks.append(nxt)
        ons.append(on)
    return fused, (torch.stack(toks, 1), torch.stack(ons, 1), state, pos)


def _assert_same(fused, ref_):
    assert torch.equal(fused[0], ref_[0]) and torch.equal(fused[1], ref_[1])
    assert torch.equal(fused[3], ref_[3])
    tree_map(lambda p, a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy(), err_msg=str(p)), fused[2], ref_[2])


def test_fused_horizon_bit_identical_to_stepwise_moe(port_moe):
    deploy, cfg = port_moe
    fused, ref_ = _horizon_case(deploy, cfg)
    _assert_same(fused, ref_)
    # slot 1 stops early: its later steps feed token 0 like an idle slot
    row = fused[0][0].tolist()
    step = next((i for i in range(1, len(row)) if row[i] not in row[:i]),
                None)
    if step is not None:
        _assert_same(*_horizon_case(deploy, cfg, eos=(row[step], -1, -1),
                                    remaining=(9, 2, 9)))
    else:
        _assert_same(*_horizon_case(deploy, cfg, remaining=(9, 2, 9)))


def test_moe_engine_runs_and_rejects_nothing_it_serves(port_moe):
    deploy, cfg = port_moe
    eng = PagedServingEngine(deploy, cfg, **ENGINE_KW)
    out = _run(eng, Request, _spec())
    assert {u: len(o) for u, o in out.items()} == {
        i: m for i, (_, m) in enumerate(PROMPT_LENS)}
    assert max(eng.horizon_hist) > 1
    eng.sched.assert_invariants()
