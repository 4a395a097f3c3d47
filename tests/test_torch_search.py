"""The port's energy model and policy search, held to the JAX package on
the CPU.

* Energy (pure Python, so equal to the last bit): ``access_counts``,
  ``layer_energy``, ``model_energy``, ``energy_summary`` and ``savings``
  on the paper's workloads (``bert_base``, ``segformer_b0``,
  ``efficientvit_b1`` and the ``llama2_7b`` walks) under IS and WS (and
  OS), gs 1-4, PSUM at 32 and 8 bits, both accelerator settings.
* Inventory and energy over the ten full configs: ``model_inventory``
  (prefill and decode), ``layer_classes``, ``energy_specs`` and
  ``energy_report`` for every preset, the five uniform baselines and the
  float model; the reference's own test that inventory names are the
  ``QuantState`` names ``init_lm`` builds, on the port's ``init_lm``.
* Candidates: ``uniform_baselines``, ``seed_candidates``, ``mutate``
  chains under ``random.Random(0)`` and ``pareto_front`` give JAX's
  names, assignments and members.
* ``accuracy_proxy`` on JAX's init weights (the port's ``init_lm``
  patched to return them through ``convert_params``) and the same batch:
  error, top-1 agreement and KL within rtol 1e-4 of JAX's (fake quant
  on float32; the two frameworks' calibrations may round a float scale
  in the last ulp).
* ``roundtrip_report`` on the CPU: its ``oracle`` decode equals JAX's
  ``ServingEngine(backend="oracle")`` tokens on the same weights; it
  names the one backend that ran and claims no kernel parity.
* One CLI run below ``SearchBudget.smoke()``: every scored energy equals
  JAX's ``energy_report`` of the same policy, no front member is
  dominated, the report saves, and the exit gate fails on the CPU
  because no kernel parity ran.
"""
import dataclasses
import json
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import energy as jenergy
from repro import search as jsearch
from repro.core import QuantConfig as JQuantConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import init_lm as j_init_lm
from repro.quant import QuantPolicy as JQuantPolicy
from repro.quant import export_quantized as j_export_quantized
from repro.quant.qat import policy_presets as j_policy_presets
from repro.search import candidates as jcand
from repro.search.pareto import ScoredCandidate as JScored
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs, energy, search
from repro_torch.checkpoint import convert_params
from repro_torch.core import QuantConfig, QuantState
from repro_torch.models import init_lm
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantPolicy, policy_presets
from repro_torch.search import candidates as cand
from repro_torch.search.cli import main as cli_main
from repro_torch.search.pareto import ScoredCandidate

# ---------------------------------------------------------------------------
# Energy model
# ---------------------------------------------------------------------------

WORKLOADS = {
    "bert_base": lambda m: m.bert_base(),
    "segformer_b0": lambda m: m.segformer_b0(),
    "efficientvit_b1": lambda m: m.efficientvit_b1(),
    "llama2_7b_prefill": lambda m: m.llama2_7b(4096, "prefill"),
    "llama2_7b_decode": lambda m: m.llama2_7b(4096, "decode"),
    "llama2_7b_combined": lambda m: m.llama2_7b_combined(4096),
    "llama2_7b_autoregressive": lambda m: m.llama2_7b_autoregressive(4096),
}


def _accs(mod):
    return {"default": mod.AcceleratorConfig(),
            "llm_decode": mod.AcceleratorConfig.llm_decode()}


def _shape(s) -> tuple:
    return (s.name, s.tokens, s.c_i, s.c_o, s.repeat)


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_energy_model_equals_jax(workload):
    layers = WORKLOADS[workload](energy)
    jlayers = WORKLOADS[workload](jenergy)
    assert [_shape(s) for s in layers] == [_shape(s) for s in jlayers]
    accs, jaccs = _accs(energy), _accs(jenergy)
    for key in accs:
        acc, jacc = accs[key], jaccs[key]
        assert dataclasses.asdict(acc) == dataclasses.asdict(jacc)
        for df in ("IS", "WS", "OS"):
            for bits in (32, 8):
                for gs in (1, 2, 3, 4):
                    for s, js in zip(layers, jlayers):
                        assert (energy.access_counts(s, acc, df,
                                                     beta=bits / 8, gs=gs)
                                == jenergy.access_counts(js, jacc, df,
                                                         beta=bits / 8,
                                                         gs=gs))
                        assert (energy.layer_energy(s, acc, df,
                                                    psum_bits=bits, gs=gs)
                                == jenergy.layer_energy(js, jacc, df,
                                                        psum_bits=bits,
                                                        gs=gs))
                    assert (energy.model_energy(layers, acc, df,
                                                psum_bits=bits, gs=gs)
                            == jenergy.model_energy(jlayers, jacc, df,
                                                    psum_bits=bits, gs=gs))
        summ = energy.energy_summary(layers, acc)
        jsumm = jenergy.energy_summary(jlayers, jacc)
        assert summ == jsumm
        for df in ("IS", "WS"):
            for g in (1, 2, 3, 4):
                assert (energy.savings(summ[df]["baseline"], summ[df][("gs", g)])
                        == jenergy.savings(jsumm[df]["baseline"],
                                           jsumm[df][("gs", g)]))


# ---------------------------------------------------------------------------
# Inventory, classes, specs and energy reports over the full configs
# ---------------------------------------------------------------------------

def _policies(classes, jclasses):
    """[(label, port policy, JAX policy)]: every preset, the five uniform
    baselines and the float model."""
    out = [("float", None, None)]
    presets, jpresets = policy_presets(), j_policy_presets()
    out += [(f"preset_{n}", presets[n], jpresets[n]) for n in presets]
    bases = cand.uniform_baselines(classes, cand.SearchSpace())
    jbases = jcand.uniform_baselines(jclasses, jcand.SearchSpace())
    assert len(bases) == 5
    out += [(c.name, c.policy(), jc.policy()) for c, jc in zip(bases, jbases)]
    return out


def _entry(e) -> tuple:
    return _shape(e.shape) + (e.policy_name,)


def _spec(s) -> tuple:
    return (_shape(s.layer), s.psum_bits, s.gs, s.dataflow, s.n_p)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_inventory_and_energy_reports_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for stage in ("prefill", "decode"):
        inv = search.model_inventory(cfg, 4096, stage)
        jinv = jsearch.model_inventory(jcfg, 4096, stage)
        assert [_entry(e) for e in inv] == [_entry(e) for e in jinv]
        classes, jclasses = (search.layer_classes(inv),
                             jsearch.layer_classes(jinv))
        assert list(classes.items()) == list(jclasses.items())
        assert search.quantizable_names(inv) == \
            jsearch.quantizable_names(jinv)
        for df in ("WS", "IS"):
            acc = (energy.AcceleratorConfig.llm_decode() if stage == "decode"
                   else energy.AcceleratorConfig())
            jacc = (jenergy.AcceleratorConfig.llm_decode()
                    if stage == "decode" else jenergy.AcceleratorConfig())
            for label, pol, jpol in _policies(classes, jclasses):
                assert ([_spec(s) for s in search.energy_specs(inv, pol, acc)]
                        == [_spec(s) for s in
                            jsearch.energy_specs(jinv, jpol, jacc)]), label
                rep = search.energy_report(cfg, pol, stage=stage,
                                           dataflow=df, inventory=inv)
                assert rep == jsearch.energy_report(
                    jcfg, jpol, stage=stage, dataflow=df,
                    inventory=jinv), label
    # arch_layers (the energy benchmarks' walk) reads the port's config
    assert ([_shape(s) for s in energy.arch_layers(cfg, 4096)]
            == [_shape(s) for s in jenergy.arch_layers(jcfg, 4096)])


def test_tinyllama_savings_are_the_papers_band():
    """Full TinyLlama-1.1B at seq 4096, prefill, WS: the savings the JAX
    package gives against the INT32-PSUM baseline."""
    cfg = configs.get_config("tinyllama-1.1b")
    presets = policy_presets()
    got = {n: search.energy_report(cfg, presets[n])
           for n in ("mix2_ffn4", "ffn_only", "aggressive")}
    assert round(got["mix2_ffn4"]["saving"], 4) == 0.3382
    assert round(got["mix2_ffn4"]["energy_j"], 3) == 14.511
    assert round(got["ffn_only"]["saving"], 4) == 0.2658
    assert round(got["aggressive"]["saving"], 4) == 0.3382
    inv = search.model_inventory(cfg, 4096)
    assert len(inv) == 10 and len(search.layer_classes(inv)) == 2


def tiny_cfg(**kw) -> ModelConfig:
    base = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                dtype="float32")
    base.update(kw)
    return ModelConfig(**base).validate()


def _state_names(tree) -> set:
    if isinstance(tree, QuantState):
        return {tree.name}
    if isinstance(tree, dict):
        return set().union(*(_state_names(v) for v in tree.values()))
    return set()


@pytest.mark.parametrize("kw", [
    {},                                                      # dense swiglu
    {"block_pattern": ("attn", "local"), "n_layers": 3},     # rem layer
    {"mlp": "moe", "n_experts": 2, "top_k": 1},              # MoE
    {"block_pattern": ("rwkv",), "mlp": "rwkv_cm"},          # RWKV
    {"block_pattern": ("rglru",), "d_rnn": 32},              # RG-LRU
    {"encdec": True, "n_enc_layers": 2},                     # enc-dec
], ids=["dense", "rem", "moe", "rwkv", "rglru", "encdec"])
def test_inventory_names_match_init_lm(kw):
    """Every QuantState name the port's ``init_lm`` creates appears in the
    inventory (and vice versa — ``head`` exists only for tied
    embeddings, and only after calibration)."""
    cfg = tiny_cfg(**kw).with_quant(
        QuantPolicy.uniform(QuantConfig.apsq(gs=2, n_p=4)))
    init_names = _state_names(init_lm(cfg, device="cpu"))
    inv_names = set(search.quantizable_names(search.model_inventory(cfg,
                                                                    64)))
    assert init_names, "no quantized linears built?"
    assert inv_names - {"head"} == init_names


# ---------------------------------------------------------------------------
# Candidates, mutation, Pareto
# ---------------------------------------------------------------------------

def _same_candidate(c, jc):
    assert (c.name, c.assignment, c.origin, c.heterogeneous) == \
        (jc.name, jc.assignment, jc.origin, jc.heterogeneous)
    assert c.describe() == jc.describe()


def _same_policy(pol, jpol, names):
    for n in names:
        r, jr = pol.resolve(n), jpol.resolve(n)
        assert (None if r is None else dataclasses.asdict(r)) == \
            (None if jr is None else dataclasses.asdict(jr)), n


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2", "olmoe-1b-7b"])
def test_candidates_and_mutation_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    classes = search.layer_classes(search.model_inventory(cfg, 4096))
    jclasses = jsearch.layer_classes(jsearch.model_inventory(jcfg, 4096))
    names = [n for ns in classes.values() for n in ns]
    for space, jspace in ((cand.SearchSpace(), jcand.SearchSpace()),
                          (cand.SearchSpace((1, 3), (2, 8)),
                           jcand.SearchSpace((1, 3), (2, 8)))):
        assert space.class_choices() == jspace.class_choices()
        bases = cand.uniform_baselines(classes, space)
        seeds = cand.seed_candidates(classes, space)
        jbases = jcand.uniform_baselines(jclasses, jspace)
        jseeds = jcand.seed_candidates(jclasses, jspace)
        assert len(bases) == len(jbases) and len(seeds) == len(jseeds) > 0
        for c, jc in zip(bases + seeds, jbases + jseeds):
            _same_candidate(c, jc)
            _same_policy(c.policy(), jc.policy(), names)
        rng, jrng = random.Random(0), random.Random(0)
        parents, jparents = list(seeds), list(jseeds)
        for _ in range(40):
            i = rng.randrange(len(parents))
            assert jrng.randrange(len(jparents)) == i
            child = cand.mutate(parents[i], rng, space)
            jchild = jcand.mutate(jparents[i], jrng, jspace)
            _same_candidate(child, jchild)
            parents.append(child)
            jparents.append(jchild)


def test_pareto_front_equals_jax():
    classes = search.layer_classes(search.model_inventory(tiny_cfg(), 64))
    seeds = cand.seed_candidates(classes, cand.SearchSpace())
    jclasses = jsearch.layer_classes(jsearch.model_inventory(
        JModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                     n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                     dtype="float32"), 64))
    jseeds = jcand.seed_candidates(jclasses, jcand.SearchSpace())
    rng = np.random.default_rng(0)
    energies = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], 40)
    errors = rng.choice([0.1, 0.2, 0.3, 0.4], 40)
    pts, jpts = [], []
    for i, (e, err) in enumerate(zip(energies, errors)):
        c, jc = seeds[i % len(seeds)], jseeds[i % len(jseeds)]
        pts.append(ScoredCandidate(
            candidate=dataclasses.replace(c, name=f"p{i}"),
            energy_j=float(e), error=float(err)))
        jpts.append(JScored(candidate=dataclasses.replace(jc, name=f"p{i}"),
                            energy_j=float(e), error=float(err)))
    front = search.pareto_front(pts)
    jfront = jsearch.pareto_front(jpts)
    assert [p.candidate.name for p in front] == \
        [p.candidate.name for p in jfront]
    assert [p.report() for p in front] == [p.report() for p in jfront]
    for a in pts[:10]:
        for b in pts[:10]:
            ja = jpts[pts.index(a)]
            jb = jpts[pts.index(b)]
            assert search.dominates(a, b) == jsearch.dominates(ja, jb)


def test_policy_sweep_and_fixed_candidates():
    """Presets enter the search as unmutatable fixed candidates, described
    as JAX describes them."""
    sweep = dict(search.policy_sweep("all"))
    jsweep = dict(jsearch.policy_sweep("all"))
    assert list(sweep) == list(jsweep)
    assert dict(search.policy_sweep("ffn_only"))
    with pytest.raises(KeyError):
        search.policy_sweep("nonesuch")
    for label in sweep:
        fc = search.FixedCandidate(name=label, fixed_policy=sweep[label])
        jfc = jsearch.FixedCandidate(name=label, fixed_policy=jsweep[label])
        assert fc.describe() == jfc.describe()
        assert search.describe_policy(sweep[label]) == \
            jsearch.describe_policy(jsweep[label])


# ---------------------------------------------------------------------------
# Accuracy proxy and round trip on JAX's weights
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=1, d_ff=64, vocab=64, dtype="float32")
# W8A8 attention and APSQ FFN: both quantizer kinds in one calibration
POLICIES = {
    "ffn_apsq": (QuantPolicy.of(("*.ffn.*", QuantConfig.apsq(gs=2, n_p=4)),
                                default=QuantConfig.w8a8()),
                 JQuantPolicy.of(("*.ffn.*", JQuantConfig.apsq(gs=2, n_p=4)),
                                 default=JQuantConfig.w8a8())),
}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's init weights (float and under each policy), one eval batch,
    JAX's oracle logits on it, and per policy JAX's ``accuracy_proxy``
    with the calibrated tree its ``calibrate_model`` returned inside it
    (recorded by a wrapper that calls the JAX function unchanged)."""
    import repro.quant.qat as j_qat
    jcfg = JModelConfig(**TINY, scan_layers=False)
    # eager, as JAX's accuracy_proxy inits: the two share compiled ops
    params = {None: j_init_lm(jax.random.PRNGKey(0), jcfg)}
    batch = search.make_eval_batch(ModelConfig(**TINY), 1, 16, 0,
                                   device="cpu")
    jbatch = {"tokens": jnp.asarray(batch["tokens"].numpy())}
    jref = jsearch.oracle_logits(jcfg, jbatch)
    want, calibrated = {}, {}
    orig = j_qat.calibrate_model
    try:
        for label, (_, jpol) in POLICIES.items():
            params[label] = j_init_lm(jax.random.PRNGKey(0),
                                      jcfg.with_quant(jpol))

            def record(*a, _label=label, **kw):
                calibrated[_label] = orig(*a, **kw)
                return calibrated[_label]
            j_qat.calibrate_model = record
            want[label] = jsearch.accuracy_proxy(jcfg, jpol, jbatch, jref)
    finally:
        j_qat.calibrate_model = orig
    return dict(jcfg=jcfg, params=params, batch=batch, jbatch=jbatch,
                jref=jref, want=want, calibrated=calibrated)


def _patch_init(monkeypatch, params, label):
    """The port's ``init_lm`` returns JAX's weights: the float tree for a
    config without a policy, the ``label`` policy's tree otherwise."""
    def fake_init(cfg, *, seed=0, device=None):
        assert seed == 0
        return convert_params(params[None if cfg.policy is None else label],
                              device=device)
    monkeypatch.setattr(model_mod, "init_lm", fake_init)


@pytest.mark.parametrize("label", list(POLICIES))
def test_accuracy_proxy_matches_jax(monkeypatch, jax_side, label):
    """The proxy on JAX's weights and JAX's calibration (the port's
    ``calibrate_model`` patched to return JAX's calibrated tree): error,
    top-1 agreement and KL within rtol 1e-4 of JAX's ``accuracy_proxy``.
    This holds the fake-quant forward and the three metrics; the port's
    own calibration is held below."""
    import repro_torch.quant.qat as qat
    j = jax_side
    _patch_init(monkeypatch, j["params"], label)
    monkeypatch.setattr(qat, "calibrate_model", lambda p, cfg, batch: (
        convert_params(j["calibrated"][label], device="cpu")))
    pol, _ = POLICIES[label]
    cfg = ModelConfig(**TINY)
    ref = search.oracle_logits(cfg, j["batch"], device="cpu")
    np.testing.assert_allclose(ref.numpy(), np.asarray(j["jref"]),
                               rtol=1e-5, atol=1e-5)
    got = search.accuracy_proxy(cfg, pol, j["batch"], ref, device="cpu")
    want = j["want"][label]
    assert got["error"] > 0
    for key in ("error", "top1_agreement", "kl"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    # without a reference it makes its own
    assert search.accuracy_proxy(cfg, pol, j["batch"], device="cpu") == got


@pytest.mark.parametrize("label", list(POLICIES))
def test_accuracy_proxy_end_to_end_on_jax_weights(monkeypatch, jax_side,
                                                  label):
    """The port's own ``calibrate_model`` on JAX's weights.  Its scales
    differ from JAX's in the last float32 bits (XLA's and ATen's norms
    and means round differently), and fake quant at float scales turns
    a last-bit difference into a code one step away wherever a value lies
    on a rounding boundary; the next unit's calibration inherits it.
    With PSUM quantization the metrics then leave rtol 1e-4 (the codes
    that move are PSUM codes, each worth 2^ap), so this test holds what
    is deterministic: the scales of the first layer's q/k/v projections
    (W8A8), which see the embedded tokens before any fake quant, within
    rtol 1e-5 of JAX's, and valid metrics."""
    import repro_torch.quant.qat as qat
    j = jax_side
    _patch_init(monkeypatch, j["params"], label)
    calibrated = {}

    def record(*a, **kw):
        calibrated["port"] = qat_calibrate(*a, **kw)
        return calibrated["port"]
    qat_calibrate = qat.calibrate_model
    monkeypatch.setattr(qat, "calibrate_model", record)
    pol, _ = POLICIES[label]
    got = search.accuracy_proxy(ModelConfig(**TINY), pol, j["batch"],
                                device="cpu")
    mine = calibrated["port"]["units"]["u0"]
    theirs = convert_params(j["calibrated"][label], device="cpu")
    theirs = theirs["units"]["u0"]
    n = 0
    for path, a in _states(mine).items():
        if path[1:3] not in (("mix", "wq"), ("mix", "wk"), ("mix", "wv")):
            continue        # downstream of a fake-quantized linear
        b = _states(theirs)[path]
        n += 1
        for f in ("ax", "ap"):
            if getattr(a, f) is not None:
                np.testing.assert_allclose(getattr(a, f).numpy(),
                                           getattr(b, f).numpy(), rtol=1e-5,
                                           err_msg=f"{path} {f}")
    assert n == 3
    assert got["error"] > 0 and got["kl"] > 0
    assert 0 <= got["top1_agreement"] <= 1


def _states(tree, path=()):
    if isinstance(tree, QuantState):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_states(v, path + (k,)))
    return out


def test_accuracy_proxy_orders_policies():
    """The reference's property on the port's own init: more aggressive
    PSUM quantization, larger proxy error."""
    cfg = ModelConfig(**TINY)
    batch = search.make_eval_batch(cfg, 1, 16, device="cpu")
    ref = search.oracle_logits(cfg, batch, device="cpu")
    w8a8 = search.accuracy_proxy(
        cfg, QuantPolicy.uniform(QuantConfig.w8a8()), batch, ref,
        device="cpu")
    apsq = search.accuracy_proxy(
        cfg, QuantPolicy.uniform(QuantConfig.apsq(gs=1, n_p=8)), batch, ref,
        device="cpu")
    assert 0 < w8a8["error"] < apsq["error"]
    assert 0 <= w8a8["top1_agreement"] <= 1


def test_roundtrip_oracle_decode_matches_jax_engine(monkeypatch, jax_side):
    """calibrate -> export -> the dense engine on ``oracle``, both from
    JAX's weights, each package calibrating on its own: the same greedy
    tokens as JAX's ``ServingEngine`` (``backend="oracle"``, max_batch 1,
    cache 64, prefill chunk 8)."""
    j = jax_side
    _patch_init(monkeypatch, j["params"], "ffn_apsq")
    pol, jpol = POLICIES["ffn_apsq"]
    rt = search.roundtrip_report(ModelConfig(**TINY), pol, j["batch"],
                                 max_new_tokens=6, device="cpu")
    jcfg_q = j["jcfg"].with_quant(jpol)
    deploy, _ = j_export_quantized(j["calibrated"]["ffn_apsq"])
    prompt = np.asarray(j["jbatch"]["tokens"])[0, :8].astype(np.int64)
    done = JServingEngine(deploy, jcfg_q, max_batch=1, cache_len=64,
                          prefill_chunk=8, backend="oracle").run(
        [JRequest(uid=0, tokens=prompt, max_new_tokens=6)])
    assert rt["decode"] == {"oracle": list(done[0].out)}
    # on the CPU only the oracle ran: no parity is claimed
    assert rt["backends"] == ["oracle"]
    assert rt["gemm_parity"]["backends"] == ["oracle"]
    assert rt["gemm_parity"]["psum"] and rt["gemm_parity"]["layer"] \
        .startswith("unit.0.ffn.")
    assert rt["gemm_parity"]["bit_equal"] is None
    assert rt["serving_parity"] is None and rt["ok"] is None
    rep = search.backend_parity_report(ModelConfig(**TINY).with_quant(pol),
                                       device="cpu")
    assert rep["mode"] == "apsq" and rep["layer"] == "unit.0.ffn.wi"
    assert rep["backends"] == ["oracle"] and rep["bit_equal"] is None


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _jax_policy(point: dict):
    """The JAX package's policy for one point of the port's report."""
    if point["origin"] == "preset":
        return dict(jsearch.policy_sweep("all"))[point["name"]]

    def choice(label):
        if label == "w8a8":
            return ("w8a8",)
        nums = [int(v) for v in re.findall(r"=(\d+)", label)]
        return ("apsq", *nums) if label.startswith("apsq") else \
            ("psq", 0, nums[0])

    return jcand.Candidate(name=point["name"], assignment=tuple(
        (pat, choice(lbl)) for pat, lbl in point["assignment"].items())
    ).policy()


def test_cli_on_cpu(tmp_path, capsys):
    """``--iterations 1`` (below the smoke budget's 2), presets included;
    the exit gate needs the kernels' parity, which the CPU cannot run."""
    rc = cli_main(["--arch", "tinyllama_1_1b", "--budget-smoke",
                   "--iterations", "1", "--include-presets", "--device",
                   "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "kernel parity is not proven" in out
    with open(tmp_path / "tinyllama-1.1b__pareto.json") as f:
        rep = json.load(f)
    assert rep["device"] == "cpu" and rep["budget"]["iterations"] == 1
    points = (rep["front"] + rep["dominated_points"])
    assert len(points) == rep["n_evaluated"] > 10
    jcfg = jconfigs.get_config("tinyllama-1.1b")
    jinv = jsearch.model_inventory(jcfg, 4096)
    for p in points + list(rep["uniform_baselines"].values()):
        want = jsearch.energy_report(jcfg, _jax_policy(p), inventory=jinv)
        assert p["energy_j"] == want["energy_j"], p["name"]
        assert p["energy_saving"] == want["saving"], p["name"]
    for f in rep["front"]:
        assert not any(
            q["energy_j"] <= f["energy_j"] and q["error"] <= f["error"]
            and (q["energy_j"] < f["energy_j"] or q["error"] < f["error"])
            for q in points), f["name"]
    assert rep["n_heterogeneous_on_front"] >= 2
    assert rep["baselines_energy_dominated"]
    assert rep["roundtrip"]["backends"] == ["oracle"]
    assert rep["roundtrip"]["ok"] is None
    assert rep["roundtrip_psum"]["ok"] is None
