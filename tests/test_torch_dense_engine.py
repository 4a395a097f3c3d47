"""The port's dense ``ServingEngine`` and temperature sampling, on the CPU
at smoke size.

Held to the JAX package's dense ``ServingEngine`` (greedy tokens equal):

* the integer path: a ``("local", "attn")`` stack with ``local_window``
  8 and ``softcap`` 30, calibrated and exported by JAX (mix2_ffn4),
  converted, both engines on ``oracle``, prompts that cross the window;
* ``recurrentgemma-smoke`` on float32 params from JAX's ``init_lm``, at
  ``decode_horizon`` 4 and 1 (JAX cannot serve an exported RG-LRU tree:
  ``rglru_block`` reads a float ``w``).

The port's own invariants, each as the reference's test of it: engine
== ``forward`` greedy (tinyllama, recurrentgemma, rwkv6 smoke); a fused
horizon == single steps, with a mid-horizon EOS; an EOS on the prefill
token frees the slot; a reused slot == a fresh engine (admission
overwrites every leaf of the slot); an MoE model routes each slot alone
(batched == single-stream where a capacity pooled over the slots would
drop a choice).  Sampling in both engines (seeded, horizon-independent,
T -> 0 is greedy, a chi-square test of ``sample_tokens``, greedy tokens
of the paged engine as before sampling existed), the calibration of
``recurrentgemma-smoke``, and the launcher on both engines.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import init_lm as j_init_lm
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.qat import policy_presets as j_policy_presets
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import convert_params
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState, QuantState
from repro_torch.models import (forward, init_lm, sample_tokens,
                                tree_leaves)
from repro_torch.models.config import ModelConfig
from repro_torch.quant import (calibrate_model, export_quantized,
                               policy_presets)
from repro_torch.serving import PagedServingEngine, Request, ServingEngine

STACK = dict(name="local-softcap", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
             block_pattern=("local", "attn"), local_window=8, softcap=30.0)
DENSE_KW = dict(max_batch=3, cache_len=32)
J_DENSE_KW = dict(DENSE_KW, prefill_chunk=16)   # the reference's bucket
PAGED_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8)

_j_init_lm = jax.jit(j_init_lm, static_argnums=1)


def _spec(vocab, lengths, seed=0):
    """[(uid, prompt, max_new_tokens)] for ``lengths`` = [(prompt, new)]."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(lengths)]


def _run(engine, spec, req_cls=Request, eos=None):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=m,
                    eos_token=eos.get(u) if eos else None)
            for u, t, m in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


# ---------------------------------------------------------------------------
# Held to the JAX engine
# ---------------------------------------------------------------------------

def test_exported_local_softcap_stack_matches_jax_engine():
    """JAX calibrates and exports the stack; the port converts the export.
    Prompts of 5-20 tokens (the window is 8), 6-9 new tokens, cache 32,
    3 slots for 4 requests (one waits for a slot)."""
    jcfg = JModelConfig(**STACK, scan_layers=False).with_quant(
        j_policy_presets()["mix2_ffn4"])
    cfg = ModelConfig(**STACK).with_quant(policy_presets()["mix2_ffn4"])
    p0 = _j_init_lm(jax.random.PRNGKey(4), jcfg)
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16))
    deploy, _ = j_export_quantized(j_calibrate_model(
        p0, jcfg, {"tokens": jnp.asarray(tok)}))
    spec = _spec(cfg.vocab, [(5, 9), (12, 8), (20, 6), (9, 7)], seed=6)
    want = _run(JServingEngine(deploy, jcfg, backend="oracle", **J_DENSE_KW),
                spec, JRequest)
    tdeploy = convert_params(deploy, device="cpu")
    got = _run(ServingEngine(tdeploy, cfg, backend="oracle", **DENSE_KW),
               spec)
    assert got == want


@functools.lru_cache(maxsize=None)
def _recurrentgemma_jax():
    jcfg = j_get_smoke("recurrentgemma-2b")
    return jcfg, _j_init_lm(jax.random.PRNGKey(2), jcfg)


def test_recurrentgemma_float_matches_jax_engine():
    """Float32 ``recurrentgemma-smoke`` (window 16): 3 requests of 9-23
    prompt tokens and 9 new tokens on 3 slots, cache 40, at
    ``decode_horizon`` 4 and 1 in both packages (one JAX engine, its
    horizon set between the runs).  The converted tree has the port's
    keys."""
    jcfg, jp = _recurrentgemma_jax()
    cfg = get_smoke("recurrentgemma-2b")
    tp = convert_params(jp, device="cpu")
    assert ({p for p, _ in tree_leaves(tp)}
            == {p for p, _ in tree_leaves(init_lm(cfg, device="cpu"))})
    spec = _spec(cfg.vocab, [(9, 9), (17, 9), (23, 9)], seed=7)
    kw = dict(max_batch=3, cache_len=40)
    jeng = JServingEngine(jp, jcfg, decode_horizon=4, prefill_chunk=8, **kw)
    for h in (4, 1):
        jeng.decode_horizon = h
        want = _run(jeng, spec, JRequest)
        got = _run(ServingEngine(tp, cfg, decode_horizon=h, **kw), spec)
        assert got == want, f"horizon {h}"


# ---------------------------------------------------------------------------
# The port's invariants
# ---------------------------------------------------------------------------

ARCHS = ["tinyllama-1.1b", "recurrentgemma-2b", "rwkv6-3b"]


@functools.lru_cache(maxsize=None)
def _float_model(arch):
    cfg = get_smoke(arch)
    return cfg, init_lm(cfg, seed=0, device="cpu")


def _greedy_ref(params, cfg, prompt, n):
    seq = [int(t) for t in prompt]
    for _ in range(n):
        lg = forward(params, cfg, torch.tensor([seq]))
        seq.append(int(lg[0, -1].argmax()))
    return seq[len(prompt):]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_forward_greedy(arch):
    """The reference's test: one request of 6 prompt tokens, 5 new."""
    cfg, params = _float_model(arch)
    prompt = np.arange(6) % cfg.vocab
    eng = ServingEngine(params, cfg, max_batch=2, cache_len=64)
    done = eng.run([Request(uid=0, tokens=prompt, max_new_tokens=5)])
    assert done[0].out == _greedy_ref(params, cfg, prompt, 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_horizon_matches_single_step(arch):
    """The reference's test: 3 requests on 2 slots at horizons 1 and 4,
    then a request that stops on an EOS first seen mid-flight."""
    cfg, params = _float_model(arch)
    engines = {h: ServingEngine(params, cfg, max_batch=2, cache_len=64,
                                decode_horizon=h)
               for h in (1, 4)}
    spec = [(i, np.arange(4 + 3 * i) % cfg.vocab, 3 + 2 * i)
            for i in range(3)]
    outs = {h: _run(engines[h], spec) for h in (1, 4)}
    assert outs[1] == outs[4]
    assert max(engines[4].horizon_hist) == 4     # fusion engaged
    eos = outs[1][2][1]
    stop = {h: _run(engines[h], [(9, np.arange(10) % cfg.vocab, 40)],
                    eos={9: eos})[9] for h in (1, 4)}
    assert stop[1] == stop[4] and stop[1][-1] == eos and len(stop[1]) < 40


def test_eos_on_the_prefill_token_frees_the_slot():
    cfg, params = _float_model("recurrentgemma-2b")
    prompt = np.arange(6) % cfg.vocab
    eng = ServingEngine(params, cfg, max_batch=1, cache_len=64)
    first = _run(eng, [(0, prompt, 6)])[0]
    done = eng.run([Request(uid=1, tokens=prompt, max_new_tokens=50,
                            eos_token=first[0])])
    assert done[0].out == first[:1] and done[0].done
    assert eng.slots == [None]


def test_reused_slot_equals_a_fresh_engine():
    """Request B admitted to the one slot request A left (A's prompt and
    decode wrapped the 16-slot ring and moved every RG-LRU state): right
    after admission every state leaf (ring K/V, ``h``, ``conv``) equals a
    fresh engine's after B's admission, bit for bit, and B's tokens are
    the fresh engine's: admission overwrites the whole slot, as the
    reference's does."""
    cfg, params = _float_model("recurrentgemma-2b")
    (_, a, na), (_, b, nb) = _spec(cfg.vocab, [(21, 6), (7, 8)], seed=9)
    kw = dict(max_batch=1, cache_len=40, decode_horizon=2)
    reused, fresh = (ServingEngine(params, cfg, **kw) for _ in range(2))
    _run(reused, [(0, a, na)])
    rb, fb = (Request(uid=1, tokens=b, max_new_tokens=nb) for _ in range(2))
    reused.add_request(rb)
    fresh.add_request(fb)
    want = dict(tree_leaves(fresh.state))
    for path, leaf in tree_leaves(reused.state):
        assert torch.equal(leaf, want[path]), path
    assert reused.run([]) and fresh.run([]) and rb.out == fb.out


def test_moe_routes_each_slot_alone():
    """``olmoe-smoke`` (8 experts, top-2): one slot's capacity is
    ceil(2/8 * 1.25) = 1 and drops nothing; pooled over 3 slots it would
    be 1 as well, so two slots choosing one expert would lose a choice.
    3 requests batched give each request's tokens served alone."""
    cfg = get_smoke("olmoe-1b-7b")
    params = init_lm(cfg, seed=0, device="cpu")
    spec = _spec(cfg.vocab, [(6, 12), (9, 12), (4, 12)], seed=11)
    single = {u: _run(ServingEngine(params, cfg, max_batch=1,
                                    cache_len=32), [(u, t, m)])[u]
              for u, t, m in spec}
    assert _run(ServingEngine(params, cfg, max_batch=3, cache_len=32),
                spec) == single


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _engines():
    """(name, make(**kw) -> engine) for both engines on float models."""
    rcfg, rparams = _float_model("recurrentgemma-2b")
    tcfg, tparams = _float_model("tinyllama-1.1b")
    return [("dense", lambda **kw: ServingEngine(rparams, rcfg, max_batch=3,
                                                 cache_len=48, **kw)),
            ("paged", lambda **kw: PagedServingEngine(tparams, tcfg,
                                                      **PAGED_KW, **kw))]


@pytest.mark.parametrize("which", ["dense", "paged"])
def test_sampling_is_seeded_and_horizon_independent(which):
    """At T = 0.8, three requests admitted and prefilled in the first
    heartbeat (20 prompt tokens, within the paged engine's budget of 24):
    one seed gives one set of tokens at horizons 1 and 4 (one [B, V] draw
    per step, however many steps a heartbeat fuses), another seed other
    tokens, and T = 1e-6 the greedy tokens."""
    make = dict(_engines())[which]
    spec = _spec(256, [(5, 9), (7, 7), (8, 5)], seed=12)
    sampled = dict(greedy=False, temperature=0.8)
    a = _run(make(decode_horizon=1, seed=3, **sampled), spec)
    assert _run(make(decode_horizon=4, seed=3, **sampled), spec) == a
    assert _run(make(decode_horizon=1, seed=3, **sampled), spec) == a
    assert _run(make(decode_horizon=4, seed=4, **sampled), spec) != a
    greedy = _run(make(decode_horizon=4), spec)
    assert greedy != a
    assert _run(make(decode_horizon=4, greedy=False, temperature=1e-6),
                spec) == greedy


def test_sample_tokens_follows_softmax():
    """20000 draws from fixed logits over 16 tokens at T = 0.7: the
    counts against 20000 * softmax(logits / T), chi-square with 15
    degrees of freedom below 37.70 (its 0.999 quantile), at seed 0."""
    logits = torch.linspace(-2.0, 1.0, 16)[torch.randperm(
        16, generator=torch.Generator().manual_seed(1))]
    n = 20000
    got = sample_tokens(logits.expand(n, 16), greedy=False,
                        temperature=0.7,
                        generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(got.long(), minlength=16).double()
    expect = n * torch.softmax(logits.double() / 0.7, dim=0)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 37.70, chi2
    assert torch.equal(sample_tokens(logits[None]),
                       logits.argmax()[None].to(torch.int32))


def test_paged_greedy_tokens_unchanged():
    """``tinyllama-smoke`` (seed 0) on the paged engine with the default
    ``greedy=True``: the tokens the engine gave before it could sample,
    at horizons 4 and 1."""
    make = dict(_engines())["paged"]
    spec = _spec(256, [(5, 6), (9, 7), (13, 5)], seed=0)
    want = {0: [227, 227, 227, 227, 116, 242],
            1: [160, 193, 18, 6, 132, 143, 230],
            2: [54, 173, 91, 16, 54]}
    for h in (4, 1):
        assert _run(make(decode_horizon=h), spec) == want


# ---------------------------------------------------------------------------
# Calibration, export and the launcher
# ---------------------------------------------------------------------------

def test_calibrate_and_export_cover_every_linear():
    """``recurrentgemma-smoke`` under mix2_ffn4: every linear with a
    quantizer (per layer: RG-LRU ``wx``/``wy``/``wo`` or attention
    ``wq``/``wk``/``wv``/``wo``, and the GELU MLP's ``wi``/``wo``; the
    gates and the head stay float) gets its activation scale from
    calibration and exports to INT8 codes: 16 in all."""
    cfg = get_smoke("recurrentgemma-2b").with_quant(
        policy_presets()["mix2_ffn4"])
    params = init_lm(cfg, seed=0, device="cpu")
    tok = np.random.default_rng(13).integers(0, cfg.vocab, (2, 24))
    calibrated = calibrate_model(params, cfg, {"tokens": tok})
    nodes0, nodes1, nodes2 = {}, {}, {}
    tree_leaves(params, nodes=nodes0)
    tree_leaves(calibrated, nodes=nodes1)
    deploy, report = export_quantized(calibrated)
    tree_leaves(deploy, nodes=nodes2)
    assert len(nodes0) == 16 and sorted(nodes0) == sorted(nodes1)
    for path, st in nodes0.items():
        assert isinstance(nodes1[path], QuantState)
        assert not torch.equal(nodes1[path].ax, st.ax), path
    assert sorted(nodes2) == sorted(nodes0)
    assert all(isinstance(s, DeployedQuantState) for s in nodes2.values())
    assert sum(r["count"] for r in report.values()) == 16


@pytest.mark.parametrize("exported", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_serve_launcher(engine, exported, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: the
    dense engine on recurrentgemma, the paged one on tinyllama."""
    from repro_torch.launch.serve import main
    arch = "recurrentgemma-2b" if engine == "dense" else "tinyllama-1.1b"
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--engine",
            engine, "--requests", "3", "--max-new-tokens", "4",
            "--max-batch", "2", "--cache-len", "64"]
    done = main(argv + ["--exported"] if exported else argv)
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out
    assert all(f"req {r.uid}: prompt[{len(r.tokens)}] -> {r.out}" in out
               for r in done)
