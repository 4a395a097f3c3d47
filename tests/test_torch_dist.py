"""Tensor- and expert-parallel integer serving (``repro_torch.dist.tp``,
``ShardedBackend``, ``make_smoke_mesh``, ``PagedServingEngine(mesh=)``,
``serve --mesh``) held against the JAX package on the CPU.

The JAX side runs in this process on the 8-device CPU mesh that
``tests/conftest.py`` forces, with the ``oracle`` inner backend.  The
port's side runs in ONE spawned world of four gloo ranks
(``_torch_dist_ranks.py``, which imports no JAX), rendezvousing through a
file: its D=2 cases run on a ``(2, 2)`` mesh (two data replicas of a
two-rank model axis), its D=4 cases on ``(1, 4)``.  Every case gets the
same seeded inputs on both sides:

  * plans: ``plan_gemm``, ``gemm_mode``, ``LayerPlan.wire_bytes`` and
    ``wire_report`` equal JAX's over the reference's ``GEMM_CASES`` at
    D in {1, 2, 4, 8}, and ``shard_deployed``'s report on an exported
    tree equals JAX's;
  * GEMMs: ``sharded_int_gemm`` equals JAX's ``ShardedBackend`` bit for
    bit for every ``GEMM_CASES`` row and wire at D=2 (three rows at D=4),
    ``sharded_int_expert_gemm`` the same on both wires;
  * attention: ``sharded_kv_attention`` equals the port's one-rank
    result bit for bit and JAX's within rtol 2e-5 / atol 2e-6;
  * engines: ``PagedServingEngine(mesh=)`` gives JAX's single-device
    oracle engine's greedy tokens, and its pools and exponents gathered
    over heads equal JAX's state array for array (tinyllama-smoke with
    per-column and per-tensor exponents, olmoe-smoke expert-parallel),
    on both wires; PSQ and W8A8 exports give the port's one-rank tokens;
    one decode step moves the bytes ``wire_report`` prices;
  * the serve launcher with ``--mesh 2x2``, the mesh's errors and
    transport, and the meshless backend.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.checkpoint import restore as j_restore
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantConfig as JQC
from repro.dist import tp as jtp
from repro.exec import ShardedBackend as JSharded
from repro.exec import get_backend as j_get_backend
from repro.launch.mesh import make_smoke_mesh as j_mesh
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import save
from repro_torch.configs import get_smoke
from repro_torch.core import QuantConfig
from repro_torch.dist import tp
from repro_torch.exec import ShardedBackend, get_backend
from repro_torch.launch import serve
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_smoke_mesh, rank_device)
from repro_torch.models import init_lm
from repro_torch.quant import calibrate_model, export_quantized
from repro_torch.serving import PagedServingEngine, Request
from test_dist_tp import GEMM_CASES, _gemm_case

WORLD = 4
D4_CASES = [GEMM_CASES[0], GEMM_CASES[2], GEMM_CASES[5]]   # apsq, psq, w8a8
ENGINE_KW = dict(max_batch=2, page_size=8, n_pages=16, prefill_chunk=8,
                 decode_horizon=4)
NEW_TOKENS = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: six test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Exports, built by the port and read by JAX through its checkpoint format
# ---------------------------------------------------------------------------

_APSQ = dict(psum=QuantConfig.apsq(gs=2, n_p=4).psum)
ENGINE_CASES = {
    # (arch, port QuantConfig, JAX QuantConfig): the reference's cases
    "dense-percol": ("tinyllama-1.1b", QuantConfig(enabled=True, **_APSQ),
                     JQC(enabled=True, psum=JQC.apsq(gs=2, n_p=4).psum)),
    "dense": ("tinyllama-1.1b",
              QuantConfig(enabled=True, per_channel_w=False, **_APSQ),
              JQC(enabled=True, per_channel_w=False,
                  psum=JQC.apsq(gs=2, n_p=4).psum)),
    "moe-ep": ("olmoe-1b-7b", QuantConfig(enabled=True, **_APSQ),
               JQC(enabled=True, psum=JQC.apsq(gs=2, n_p=4).psum)),
}
PORT_ONLY_CASES = {        # K-sharded modes, held to the port's one rank
    "psq": ("tinyllama-1.1b", QuantConfig.apsq(gs=4, n_p=4)),
    "w8a8": ("tinyllama-1.1b", QuantConfig.w8a8()),
}


@functools.lru_cache(maxsize=None)
def _export(arch: str, quant: QuantConfig):
    cfg = get_smoke(arch).with_quant(quant)
    params = init_lm(cfg, seed=0, device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 16))
    deploy, _ = export_quantized(calibrate_model(params, cfg,
                                                 {"tokens": tok}))
    return cfg, deploy


@functools.lru_cache(maxsize=None)
def _jax_export(case: str, tmp: str):
    """JAX's tree of the port's export (``checkpoint.save`` -> JAX's
    ``restore``) and the JAX config, units unrolled as the port's."""
    arch, quant, jquant = ENGINE_CASES[case]
    _, deploy = _export(arch, quant)
    save(f"{tmp}/{case}", 0, deploy)
    jcfg = dataclasses.replace(j_get_smoke(arch),
                               scan_layers=False).with_quant(jquant)
    return j_restore(f"{tmp}/{case}")[0], jcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _jax_engine(case: str, tmp: str):
    """JAX's single-device oracle engine: greedy tokens and its state."""
    jdeploy, jcfg = _jax_export(case, tmp)
    eng = JEngine(jdeploy, jcfg, backend="oracle", **ENGINE_KW)
    done = eng.run([JRequest(uid=i, tokens=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(ranks.prompts(jcfg.vocab))])
    return ({r.uid: list(r.out) for r in done},
            _flat(jax.tree.map(np.asarray, eng.state)))


# ---------------------------------------------------------------------------
# The world: every port case on four spawned ranks, once per module
# ---------------------------------------------------------------------------

def _gemm_inputs(k, n, n_p, gs, per_col):
    x, w, exps = _gemm_case(k, n, n_p, gs, per_col)
    return np.asarray(x), np.asarray(w), (None if exps is None
                                          else np.asarray(exps))


def _expert_inputs(w8a8: bool):
    """The reference's expert case (E=4, M=2, K=32, N=16, n_p=4, gs=2);
    W8A8: the same codes without exponents."""
    from repro.kernels.apsq_matmul.ref import choose_exps
    key = jax.random.PRNGKey(3)
    x = jax.random.randint(key, (4, 2, 32), -128, 128, jax.numpy.int8)
    w = jax.random.randint(jax.random.fold_in(key, 1), (4, 32, 16), -128,
                           128, jax.numpy.int8)
    exps = None if w8a8 else jax.numpy.stack(
        [choose_exps(x[e], w[e], n_p=4, gs=2) for e in range(4)])
    return (np.asarray(x), np.asarray(w),
            None if exps is None else np.asarray(exps))


def _attention_inputs(chunk: bool):
    """q [B, (C,) Hq, hd] against an INT8 cache of S positions: Hq=4,
    Hkv=2 (two query heads a kv-head), hd=16, B=2, lengths 11 and 23."""
    rng = np.random.default_rng(7 if chunk else 5)
    b, s, hq, hkv, hd = 2, 24, 4, 2, 16
    q = rng.standard_normal((b, 4, hq, hd) if chunk else (b, hq, hd))
    kc, vc = (rng.integers(-127, 128, (b, s, hkv, hd)).astype(np.int8)
              for _ in range(2))
    ke, ve = (rng.integers(-9, -5, (b, hkv)).astype(np.int32)
              for _ in range(2))
    return (q.astype(np.float32), kc, vc, ke, ve,
            np.array([11, 23], np.int32))


def _engine_job(arch, quant):
    cfg, deploy = _export(arch, quant)
    return {"cfg": cfg, "deploy": deploy, "kw": ENGINE_KW, "new": NEW_TOKENS,
            "prompts": ranks.prompts(cfg.vocab)}


SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--smoke", "--requests", "3",
              "--max-new-tokens", "4", "--max-batch", "2", "--cache-len",
              "64", "--page-size", "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    gemm = []
    for tag, k, n, n_p, gs, per_col in GEMM_CASES:
        x, w, exps = _gemm_inputs(k, n, n_p, gs, per_col)
        for wire, d in [("int8", 2), ("fp32", 2)] + (
                [("int8", WORLD)] if tag in [c[0] for c in D4_CASES] else []):
            gemm.append({"key": ("gemm", tag, wire, d), "x": _t(x),
                         "w": _t(w), "exps": _t(exps), "gs": gs,
                         "wire": wire, "d": d})
    for mode in ("apsq", "w8a8"):
        x, w, exps = _expert_inputs(mode == "w8a8")
        for wire in ("int8", "fp32"):
            gemm.append({"key": ("expert", mode, wire), "x": _t(x),
                         "w": _t(w), "exps": _t(exps), "gs": 2,
                         "wire": wire, "d": 2, "experts": True})
    job = {"gemm": gemm,
           "attention": {form: tuple(_t(a) for a in _attention_inputs(
               form == "chunk")) for form in ("decode", "chunk")},
           "engines": {c: _engine_job(a, q) for c, (a, q, _) in
                       {**ENGINE_CASES,
                        **{k: (*v, None) for k, v in
                           PORT_ONLY_CASES.items()}}.items()},
           "serve_argv": SERVE_ARGV + ["--mesh", f"{WORLD // 2}x2"]}
    tmp = str(tmp_path_factory.getbasetemp())

    def jax_engines():          # JAX's engines run while the ranks do
        for case in ENGINE_CASES:
            _jax_engine(case, tmp)

    return ranks.spawn(WORLD, job, str(tmp_path_factory.mktemp("world")),
                       meanwhile=jax_engines)


# ---------------------------------------------------------------------------
# Plans (pure; no world)
# ---------------------------------------------------------------------------

def _layer_plan(mod, tag, k, n, n_p, gs, per_col, d):
    g = mod.plan_gemm(k=k, n=n, n_p=n_p, gs=gs, d=d)
    return g, mod.LayerPlan(name=tag, kind="linear", mode=g.mode,
                            axis=g.axis, d=d, k=k, n=n, n_p=n_p, gs=gs,
                            per_col=per_col)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("tag,k,n,n_p,gs,per_col", GEMM_CASES,
                         ids=[c[0] for c in GEMM_CASES])
def test_plans_and_wire_report_match_jax(tag, k, n, n_p, gs, per_col, d):
    g, lp = _layer_plan(tp, tag, k, n, n_p, gs, per_col, d)
    jg, jlp = _layer_plan(jtp, tag, k, n, n_p, gs, per_col, d)
    assert (g.axis, g.mode, g.d, g.sharded) == (jg.axis, jg.mode, jg.d,
                                                jg.sharded)
    assert tp.gemm_mode(n_p, gs) == jtp.gemm_mode(n_p, gs)
    experts = dataclasses.replace(lp, kind="expert", axis="expert",
                                  experts=4)
    jexperts = dataclasses.replace(jlp, kind="expert", axis="expert",
                                   experts=4)
    for m in (1, 4):
        assert lp.wire_bytes(m) == jlp.wire_bytes(m)
        assert experts.wire_bytes(m) == jexperts.wire_bytes(m)
        assert tp.wire_report({tag: lp, "e": experts}, m=m) == \
            jtp.wire_report({tag: jlp, "e": jexperts}, m=m)


def _rank0_mesh(d):
    """Rank 0's view of a (1, d) mesh: placement plans without a world."""
    return Mesh(shape={"data": 1, "model": d}, rank=0,
                coords={"data": 0, "model": 0}, groups={}, backend="gloo",
                device=torch.device("cpu"))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_shard_deployed_report_matches_jax(case, d, tmp_path_factory):
    """Per layer name the port's plan is JAX's; the port unrolls units,
    so a name counts every unit holding it (a scan-stacked JAX tree's
    ``units``) where JAX's unrolled tree keeps the last one."""
    tmp = str(tmp_path_factory.getbasetemp())
    arch, quant, _ = ENGINE_CASES[case]
    cfg, deploy = _export(arch, quant)
    jdeploy, _ = _jax_export(case, tmp)
    _, plans = tp.shard_deployed(deploy, _rank0_mesh(d))
    _, jplans = jtp.shard_deployed(jdeploy, j_mesh((1, d)))
    assert set(plans) == set(jplans)
    for name, jp in jplans.items():
        assert plans[name].units == cfg.n_layers // len(cfg.block_pattern)
        assert dataclasses.asdict(dataclasses.replace(plans[name], units=1)) \
            == dataclasses.asdict(jp), name
    assert any(p.axis != "replicate" for p in plans.values())
    wr = tp.wire_report(plans, m=1)
    assert wr["switchable"]["ratio"] >= 3.5


# ---------------------------------------------------------------------------
# GEMMs and attention on the world
# ---------------------------------------------------------------------------

def _all_ranks_equal(world, key):
    vals = [r[key] for r in world if key in r]
    assert len(vals) >= 2
    for v in vals[1:]:
        torch.testing.assert_close(v, vals[0], rtol=0, atol=0)
    return vals[0]


@pytest.mark.parametrize("wire,d", [("int8", 2), ("fp32", 2)])
@pytest.mark.parametrize("tag,k,n,n_p,gs,per_col", GEMM_CASES,
                         ids=[c[0] for c in GEMM_CASES])
def test_sharded_gemm_bit_exact_vs_jax(world, tag, k, n, n_p, gs, per_col,
                                       wire, d):
    x, w, exps = _gemm_case(k, n, n_p, gs, per_col)
    want = JSharded(mesh=j_mesh((1, d)), inner="oracle",
                    wire=wire).int_gemm(x, w, exps, gs=gs)
    got = _all_ranks_equal(world, ("gemm", tag, wire, d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tag,k,n,n_p,gs,per_col", D4_CASES,
                         ids=[c[0] for c in D4_CASES])
def test_sharded_gemm_bit_exact_vs_jax_4ranks(world, tag, k, n, n_p, gs,
                                              per_col):
    x, w, exps = _gemm_case(k, n, n_p, gs, per_col)
    want = JSharded(mesh=j_mesh((1, WORLD)),
                    inner="oracle").int_gemm(x, w, exps, gs=gs)
    got = _all_ranks_equal(world, ("gemm", tag, "int8", WORLD))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wire", ["int8", "fp32"])
@pytest.mark.parametrize("mode", ["apsq", "w8a8"])
def test_sharded_expert_gemm_bit_exact_vs_jax(world, mode, wire):
    x, w, exps = _expert_inputs(mode == "w8a8")
    want = JSharded(mesh=j_mesh((1, 2)), inner="oracle",
                    wire=wire).int_expert_gemm(x, w, exps, gs=2)
    got = _all_ranks_equal(world, ("expert", mode, wire))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_sharded_kv_attention(world, form):
    got, one_rank = _all_ranks_equal(world, form)
    torch.testing.assert_close(got, one_rank, rtol=0, atol=0)
    q, kc, vc, ke, ve, length = _attention_inputs(form == "chunk")
    want = j_get_backend("oracle").kv_attention(q, kc, vc, ke, ve, length,
                                                block_s=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _rank_outputs(world, key):
    """(tokens, gathered state) that every rank holds alike."""
    outs = [r[key] for r in world if key in r]
    assert len(outs) == 2
    for o in outs[1:]:
        assert o["tokens"] == outs[0]["tokens"]
    return outs[0]


@pytest.mark.parametrize("wire", ["int8", "fp32"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_on_two_ranks_matches_jax_single_device(world, case, wire,
                                                       tmp_path_factory):
    want_tokens, want_state = _jax_engine(
        case, str(tmp_path_factory.getbasetemp()))
    got = _rank_outputs(world, (case, wire))
    assert got["tokens"] == want_tokens
    state = _flat(got["state"])
    assert set(state) == set(want_state)
    for path, a in state.items():
        np.testing.assert_array_equal(a, want_state[path], err_msg=path)
    assert any(p.axis == "heads" for p in got["plans"].values())
    if case != "moe-ep":     # an expert GEMM's rows are its capacity
        assert got["step_wire"] == got["step_report"] > 0


@pytest.mark.parametrize("wire", ["int8", "fp32"])
@pytest.mark.parametrize("case", list(PORT_ONLY_CASES))
def test_engine_on_two_ranks_k_sharded_matches_one_rank(world, case, wire):
    cfg, deploy = _export(*PORT_ONLY_CASES[case])
    eng = PagedServingEngine(deploy, cfg, backend="oracle", **ENGINE_KW)
    done = eng.run([Request(uid=i, tokens=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(ranks.prompts(cfg.vocab))])
    got = _rank_outputs(world, (case, wire))
    assert got["tokens"] == {r.uid: list(r.out) for r in done}
    for path, a in _flat(got["state"]).items():
        np.testing.assert_array_equal(a, _flat(eng.state)[path],
                                      err_msg=path)
    assert {p.axis for p in got["plans"].values()
            if p.kind == "linear"} == {"k"}
    assert got["step_wire"] == got["step_report"] > 0


def test_serve_launcher_mesh_matches_one_rank(world):
    want = sorted((r.uid, list(r.out)) for r in serve.main(
        SERVE_ARGV + ["--engine", "paged", "--exported"]))
    assert all(r["serve"] == want for r in world)


# ---------------------------------------------------------------------------
# The mesh and the backend
# ---------------------------------------------------------------------------

def test_mesh_layout_and_transport(world):
    for rank, r in enumerate(world):
        assert r["mesh"][2] == ("gloo", False, {"data": 2, "model": 2},
                                {"data": rank // 2, "model": rank % 2})
        assert r["mesh"][WORLD] == ("gloo", False,
                                    {"data": 1, "model": WORLD},
                                    {"data": 0, "model": rank})


def test_mesh_errors_match_reference():
    with pytest.raises(ValueError, match="rank mismatch"):
        make_smoke_mesh((2, 2, 2), device="cpu")     # 3 dims, 2 axes
    with pytest.raises(ValueError, match="devices"):
        make_smoke_mesh((1, 4096), device="cpu")
    with pytest.raises(NotImplementedError, match="dist training slice"):
        make_production_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rank_device()


def test_sharded_backend_meshless_delegates_and_rejects_bad_wire():
    x, w, exps = (_t(a) for a in _gemm_inputs(32, 16, 4, 2, False))
    assert isinstance(get_backend("sharded"), ShardedBackend)
    y = get_backend("sharded").int_gemm(x, w, exps, gs=2)
    torch.testing.assert_close(y, get_backend("oracle").int_gemm(
        x, w, exps, gs=2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="wire"):
        ShardedBackend(wire="int7")
    with pytest.raises(ValueError, match="wire"):
        PagedServingEngine(*_export(*PORT_ONLY_CASES["w8a8"])[::-1],
                           mesh=_rank0_mesh(2), wire="int7")
