"""The port's roofline (``repro_torch.roofline``) held to the JAX
package's and to hand counts, on the CPU.

* ``cost_terms``, ``model_flops``, ``useful_fraction``,
  ``gemm_analytic_us`` and ``backend_corrected_terms`` equal
  ``repro.roofline``'s on the same inputs at ``hw=V5E`` (the port's
  correction reads ``cuda_us`` where the reference reads ``pallas_us``,
  and names the backend it read); the ``H100`` default by hand.
* ``op_cost.analyze`` gives exact hand counts: one GEMM's FLOPs and
  bytes, a loop of 7 GEMMs (7 x one, after the reference's
  ``test_analyze_hlo_scan_trip_multiplication``) and the gradient of a
  ``torch.utils.checkpoint`` chain (the backward recomputes the forward
  and runs two GEMMs per link: 3 x the forward, after
  ``test_analyze_hlo_grad_shows_remat_waste``); its FLOPs equal
  ``FlopCounterMode``'s on a train step; ``LiveBytes`` follows storages.
* ``tinyllama-smoke``'s float forward: the FLOPs the port counts equal
  the FLOPs ``analyze_hlo`` counts in JAX's jitted forward of the same
  config, exactly.  Both count matrix products only (XLA's ``dot``,
  aten's ``mm``/``bmm``), and the two programs run the same products:
  q/k/v/o, the SwiGLU's three, the two attention einsums and the head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import roofline as jroof
from repro.configs import get_smoke as j_get_smoke
from repro.models.model import forward as j_forward
from repro.models.model import init_lm as j_init_lm
from repro_torch import roofline
from repro_torch.configs import get_smoke
from repro_torch.roofline import H100, V5E, op_cost
from repro_torch.train.trainer import make_loss_fn, value_and_grad


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its tests run many small ops,
    which OpenMP's thread teams slow down many times over when the
    suite's workers share the cores (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------- the copied functions ---------------------------

COSTS = [({"flops": 197e12, "bytes accessed": 819e9 * 2}, {"total": 0}, 1, 0),
         ({"flops": 3.1e15, "bytes accessed": 2.5e12}, {"total": 7.5e11}, 256,
          0),
         ({"flops": 1.0e12}, {"total": 1e9}, 512, 4e9),
         ({}, {}, 1, 0)]


@pytest.mark.parametrize("cost,coll,n,dcn", COSTS)
def test_cost_terms_equal_jax(cost, coll, n, dcn):
    assert roofline.cost_terms(cost, coll, n, hw=V5E, dcn_bytes=dcn) == \
        jroof.cost_terms(cost, coll, n, dcn_bytes=dcn)


@pytest.mark.parametrize("n,tokens,training", [(1_000_000, 100, True),
                                               (1_100_048_384, 4096, False),
                                               (7, 3, True)])
def test_model_flops_and_useful_fraction_equal_jax(n, tokens, training):
    mf = roofline.model_flops(n, tokens, training)
    assert mf == jroof.model_flops(n, tokens, training)
    for counted in (0.0, 3 * mf, mf / 2):
        assert roofline.useful_fraction(mf, counted) == \
            jroof.useful_fraction(mf, counted)


@pytest.mark.parametrize("shape", [(8, 512, 512), (1, 2048, 5632),
                                   (2048, 1024, 8192)])
def test_gemm_analytic_and_correction_equal_jax(shape):
    assert roofline.gemm_analytic_us(*shape, hw=V5E) == \
        jroof.gemm_analytic_us(*shape)
    terms = jroof.cost_terms({"flops": 5e14, "bytes accessed": 4e11},
                             {"total": 2e9}, 1)
    for us in (3.25, 4123.4):
        want = jroof.backend_corrected_terms(
            terms, {"shape": list(shape), "pallas_us": us, "oracle_us": 9.0})
        got = roofline.backend_corrected_terms(
            terms, {"shape": list(shape), "cuda_us": us, "oracle_us": 9.0},
            hw=V5E)
        assert got.pop("probe_backend") == "cuda"
        assert got == want
        want = jroof.backend_corrected_terms(
            terms, {"shape": list(shape), "oracle_us": us})
        got = roofline.backend_corrected_terms(
            terms, {"shape": list(shape), "oracle_us": us}, hw=V5E)
        assert got.pop("probe_backend") == "oracle"
        assert got == want
    assert roofline.backend_corrected_terms(terms, {"skipped": "x"}) == {}


def test_h100_default_by_hand():
    t = roofline.cost_terms({"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                            {"total": 450e9 / 2}, 1)
    assert t["compute_s"] == pytest.approx(1.0, rel=1e-15)
    assert t["memory_s"] == pytest.approx(2.0, rel=1e-15)
    assert t["collective_s"] == pytest.approx(0.5, rel=1e-15)
    assert t["dominant"] == "memory_s" and t["bound_s"] == t["memory_s"]
    assert t["roofline_fraction"] == pytest.approx(0.5, rel=1e-15)
    # kernel 1's probe shape: bytes-bound at the int8 rate
    m, k, n = 8, 512, 512
    by = m * k + k * n + 4 * m * n
    assert by / 3.35e12 > 2 * m * k * n / 1979e12
    assert roofline.gemm_analytic_us(m, k, n) == by / 3.35e12 * 1e6
    m = k = n = 8192      # ops-bound at the int8 rate, not bf16's
    assert roofline.gemm_analytic_us(m, k, n) == \
        2.0 * m * k * n / 1979e12 * 1e6
    assert H100.hbm_bytes == 80e9 and V5E.int8_ops is None


# ------------------------------ op_cost -----------------------------------

def test_analyze_one_gemm_by_hand():
    x = torch.zeros(64, 128)
    w = torch.zeros(128, 96)
    r = op_cost.analyze(torch.matmul, x, w)
    assert r["flops"] == 2 * 64 * 128 * 96
    assert r["bytes"] == 4 * (64 * 128 + 128 * 96 + 64 * 96)
    assert r["collectives"]["total"] == 0 and r["warnings"] == []
    assert op_cost.attribute(r, 1, key="flops")[0][3] == "aten.mm"


def test_analyze_loop_of_7_gemms_is_7_times_one():
    x = torch.zeros(32, 64, dtype=torch.bfloat16)
    ws = torch.zeros(7, 64, 64, dtype=torch.bfloat16)

    def f(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]          # a select is a view: no bytes
        return x

    one = op_cost.analyze(torch.matmul, x, ws[0])
    r = op_cost.analyze(f, x, ws)
    assert r["flops"] == 7 * one["flops"] == 7 * 2 * 32 * 64 * 64
    assert r["bytes"] == 7 * one["bytes"] == 7 * 2 * (2 * 32 * 64 + 64 * 64)


def test_analyze_grad_of_checkpoint_chain_shows_remat():
    x = torch.randn(32, 64, requires_grad=True)
    ws = [torch.randn(64, 64, requires_grad=True) for _ in range(5)]
    fwd = 2 * 32 * 64 * 64 * 5

    def forward():
        y = x
        for w in ws:
            y = checkpoint(lambda a, b: torch.tanh(a @ b), y, w,
                           use_reentrant=False)
        return y.sum()

    r_fwd = op_cost.analyze(forward)
    assert r_fwd["flops"] == fwd
    loss = forward()
    r = op_cost.analyze(torch.autograd.grad, loss, [x, *ws])
    assert r["flops"] == 3 * fwd       # recompute + 2 GEMMs per link
    r_all = op_cost.analyze(lambda: torch.autograd.grad(forward(),
                                                        [x, *ws]))
    assert r_all["flops"] == 4 * fwd


def test_op_flops_equal_flop_counter_mode_on_a_train_step():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_smoke("tinyllama-1.1b")
    from repro_torch.models import init_lm
    params = init_lm(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    loss_fn = make_loss_fn(cfg)
    r = op_cost.analyze(value_and_grad, loss_fn, params, batch)
    with FlopCounterMode(display=False) as fc:
        value_and_grad(loss_fn, params, batch)
    assert r["flops"] == fc.get_total_flops() > 0


def test_collective_kind_and_gather_bytes():
    assert op_cost.collective_kind(torch.ops.aten.mm.default) is None
    c10d = torch.ops._c10d_functional
    assert op_cost.collective_kind(c10d.all_reduce.default) == "all-reduce"
    assert op_cost.collective_kind(
        c10d.all_gather_into_tensor.default) == "all-gather"
    assert op_cost.collective_kind(
        c10d.reduce_scatter_tensor.default) == "reduce-scatter"
    table = torch.zeros(1000, 16)
    idx = torch.zeros(5, dtype=torch.long)
    r = op_cost.analyze(lambda: table[idx])     # the rows moved, not 64 KB
    assert r["bytes"] == 2 * 5 * 16 * 4 + 5 * 8
    r = op_cost.analyze(lambda: table.index_put_((idx,), torch.ones(5, 16)))
    assert r["ops"]["aten.index_put_"]["bytes"] == 2 * 5 * 16 * 4 + 5 * 8
    # a 3-D matmul's reshape of its result (aten._unsafe_view) moves
    # nothing: the product's operands and result only
    x, w = torch.zeros(3, 8, 16), torch.zeros(16, 4)
    r = op_cost.analyze(torch.matmul, x, w)
    assert "aten._unsafe_view" in r["ops"]
    assert r["bytes"] == 4 * (3 * 8 * 16 + 16 * 4 + 3 * 8 * 4)
    r = op_cost.analyze(torch.full_like, x, 2.0)        # writes only
    assert r["bytes"] == 4 * 3 * 8 * 16


def test_live_bytes_follows_storages():
    live = op_cost.LiveBytes()
    with live:
        a = torch.zeros(1000, device="meta")             # 4000
        b = a * 2                                         # 8000 live
        v = b[10:20]                                      # a view: 0
        del a                                             # 4000
        c = b + v.sum()                                   # 8000 (+4)
        del b, c
    assert live.peak == 8004
    assert live.live == 4000           # v keeps b's storage alive
    del v
    assert live.live == 0


# ------------------- tinyllama-smoke forward vs analyze_hlo ---------------

def test_tinyllama_smoke_forward_flops_equal_jax_analyze_hlo():
    from repro_torch.launch.dryrun import init_params
    from repro_torch.models import forward
    B, S = 2, 32
    jcfg = j_get_smoke("tinyllama-1.1b")
    p_shapes = jax.eval_shape(lambda k: j_init_lm(k, jcfg),
                              jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    text = jax.jit(lambda p, t: j_forward(p, jcfg, t)).lower(
        p_shapes, tok).compile().as_text()
    want = jroof.analyze_hlo(text)["flops"]
    cfg = get_smoke("tinyllama-1.1b")
    params = init_params(cfg, "meta")
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with torch.no_grad():
        r = op_cost.analyze(forward, params, cfg, tokens)
    assert r["flops"] == want
    # the products by hand: per layer q, k, v, o, gate, up, down and the
    # two attention einsums; then the head
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    kv = cfg.n_kv_heads * hd
    per_layer = 2 * B * S * (d * d * 2 + d * kv * 2 + 3 * d * f) \
        + 2 * 2 * B * cfg.n_heads * S * S * hd
    assert want == np.float64(cfg.n_layers * per_layer
                              + 2 * B * S * d * cfg.vocab)
