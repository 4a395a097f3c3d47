"""The port's small APIs, held to the JAX package's on the CPU.

* Float helpers: ``quantize_operands``, ``apsq_matmul_f32`` and
  ``calibrate_exps`` bit-exact against the JAX package's (its
  ``apsq_matmul_f32`` reaches a Pallas kernel that cannot trace under
  this JAX, so its side is its ``quantize_operands`` and ``ref`` oracle
  composed as its ``apsq_matmul_f32`` composes them);
  ``int8_kv_attention_f32`` (the JAX kernel in interpret mode) within
  rtol 2e-5 / atol 2e-6, the bound the JAX package holds its kernel to;
  ``cache_bytes`` and ``count_params`` equal.
* Configs: ``SHAPE_CELLS``, ``cells_for``, ``canonical_arch``,
  ``pattern_kinds`` and ``sub_quadratic`` equal for every arch.
* ``QuantState`` as a mapping and ``QuantSpec``, against JAX's.
* The exec registry and ``backend_parity_check`` on the CPU (the
  ``cuda`` leg raises there; a single backend claims no parity).
* ``restore(quant_policy=)`` on checkpoints written the way the JAX
  package's legacy tests write them (``tests/test_quant_policy.py``):
  the same names, specs and values as JAX's restore, the vestigial
  ``.ffn.wr`` quantizer dropped.
"""
import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.store import restore as j_restore
from repro.checkpoint.store import save as j_save
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantSpec as JQuantSpec
from repro.core import QuantState as JQuantState
from repro.kernels.apsq_matmul import ops as j_apsq_ops
from repro.kernels.apsq_matmul import ref as j_apsq_ref
from repro.kernels.int8_kv_attention import ops as j_kv_ops
from repro.models.common import count_params as j_count_params
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import init_lm as j_init_lm
from repro.quant import QuantPolicy as JQuantPolicy
from repro_torch import configs
from repro_torch.checkpoint import convert_params, restore
from repro_torch.core import QuantConfig, QuantSpec, QuantState
from repro_torch.exec import (ExecBackend, OracleBackend, available_backends,
                              backend_parity_check, get_backend,
                              register_backend)
from repro_torch.kernels.apsq_matmul import (apsq_matmul_f32, calibrate_exps,
                                             quantize_operands)
from repro_torch.kernels.int8_kv_attention import (cache_bytes,
                                                   int8_kv_attention_f32)
from repro_torch.models import tree_leaves
from repro_torch.models.common import count_params
from repro_torch.quant import QuantPolicy, export_quantized


# JAX's functions under one jit each (eagerly JAX compiles every op
# apart): its export stays eager (it reads array values into its report)
_j_init_lm = jax.jit(j_init_lm, static_argnums=1)
_j_quantize_operands = jax.jit(j_apsq_ops.quantize_operands)
_j_calibrate_exps = jax.jit(j_apsq_ops.calibrate_exps,
                            static_argnames=("n_p", "gs"))


@functools.partial(jax.jit, static_argnames=("n_p", "gs"))
def _j_apsq_matmul_f32(xq, wq, exps, ax, aw, *, n_p, gs):
    """JAX's ``apsq_matmul_f32`` body with its ``ref`` oracle in the
    kernel's place."""
    return (j_apsq_ref.apsq_matmul_ref(xq, wq, exps, n_p=n_p, gs=gs)
            .astype(jnp.float32) * jnp.asarray(ax, jnp.float32)
            * jnp.asarray(aw, jnp.float32))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# Float helpers
# ---------------------------------------------------------------------------

GEMMS = [  # (M, K, N, n_p, gs, per-column aw)
    (8, 64, 32, 4, 2, False),
    (3, 96, 40, 8, 4, True),
    (1, 40, 24, 5, 3, True),      # gs does not divide n_p: a PSQ tail tile
    (5, 50, 16, 4, 1, False),     # K % n_p != 0: a ragged remainder
]


@pytest.mark.parametrize("m,k,n,n_p,gs,per_col", GEMMS)
def test_apsq_float_helpers_bit_exact(m, k, n, n_p, gs, per_col):
    rng = np.random.default_rng(m * 100 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    ax = np.float32(0.03)
    aw = (rng.uniform(0.002, 0.004, n).astype(np.float32) if per_col
          else np.float32(0.003))
    jxq, jwq = _j_quantize_operands(jnp.asarray(x), jnp.asarray(w),
                                    ax=jnp.asarray(ax), aw=jnp.asarray(aw))
    xq, wq = quantize_operands(torch.from_numpy(x), torch.from_numpy(w),
                               ax=torch.tensor(ax), aw=torch.from_numpy(
                                   np.asarray(aw)))
    np.testing.assert_array_equal(_np(xq), np.asarray(jxq))
    np.testing.assert_array_equal(_np(wq), np.asarray(jwq))
    jexps = _j_calibrate_exps(jxq, jwq, n_p=n_p, gs=gs)
    exps = calibrate_exps(xq, wq, n_p=n_p, gs=gs)
    np.testing.assert_array_equal(_np(exps), np.asarray(jexps))
    want = _j_apsq_matmul_f32(jxq, jwq, jexps, jnp.asarray(ax),
                              jnp.asarray(aw), n_p=n_p, gs=gs)
    got = apsq_matmul_f32(torch.from_numpy(x), torch.from_numpy(w), exps,
                          gs=gs, ax=torch.tensor(ax),
                          aw=torch.from_numpy(np.asarray(aw)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("q_shape", [(2, 4, 16), (2, 3, 4, 16)],
                         ids=["decode", "chunk"])
def test_int8_kv_attention_f32_matches_jax(q_shape):
    """rtol 2e-5 / atol 2e-6: the bound the JAX package holds its own
    kernel to against its reference."""
    rng = np.random.default_rng(len(q_shape))
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = (rng.standard_normal((2, 32, 2, 16)) * 0.5).astype(np.float32)
    length = np.array([20, 32], np.int32)
    want = j_kv_ops.int8_kv_attention_f32(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        block_s=16)
    got = int8_kv_attention_f32(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(length))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("dims", [(1, 1, 1, 8), (8, 4096, 4, 64),
                                  (3, 100, 16, 128)])
def test_cache_bytes_equal(dims):
    assert cache_bytes(*dims) == j_kv_ops.cache_bytes(*dims)


TINY = dict(name="apis", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, dtype="float32")


@pytest.mark.parametrize("quant", ["float", "apsq", "exported"])
def test_count_params_equal(quant):
    jcfg = JModelConfig(**TINY, scan_layers=False, tie_embeddings=True)
    if quant != "float":
        jcfg = jcfg.with_quant(JQuantConfig.apsq(gs=2, n_p=4))
    jp = _j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = convert_params(jp, device="cpu")
    if quant == "exported":
        from repro.quant import export_quantized as j_export_quantized
        jp, _ = j_export_quantized(jp)
        tp, _ = export_quantized(tp)
    assert count_params(tp) == j_count_params(jp) > 0


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_shape_cells_equal():
    assert list(configs.SHAPE_CELLS) == list(jconfigs.SHAPE_CELLS)
    for name, cell in configs.SHAPE_CELLS.items():
        jcell = jconfigs.SHAPE_CELLS[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
        assert cell.is_serving == jcell.is_serving


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_arch_shape_apis_equal(arch):
    assert set(configs.ARCH_NAMES) == set(jconfigs.ARCH_NAMES)
    module = arch.replace("-", "_").replace(".", "_")
    for spelling in (arch, module):
        assert (configs.canonical_arch(spelling)
                == jconfigs.canonical_arch(spelling))
    assert list(configs.cells_for(arch)) == list(jconfigs.cells_for(arch))
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.pattern_kinds == jcfg.pattern_kinds
        assert cfg.sub_quadratic == jcfg.sub_quadratic


def test_canonical_arch_refuses_unknown():
    with pytest.raises(KeyError):
        configs.canonical_arch("nonesuch")
    with pytest.raises(KeyError):
        configs.get_config("nonesuch")


# ---------------------------------------------------------------------------
# QuantState as a mapping, QuantSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_ap", [True, False])
def test_quant_state_mapping_equals_jax(with_ap):
    rng = np.random.default_rng(3)
    aw = rng.standard_normal(4).astype(np.float32)
    ax = np.float32(0.5)
    ap = rng.standard_normal(2).astype(np.float32) if with_ap else None
    spec = QuantConfig.apsq(gs=2, n_p=2) if with_ap else QuantConfig.w8a8()
    jspec = (JQuantConfig.apsq(gs=2, n_p=2) if with_ap
             else JQuantConfig.w8a8())
    d = {"aw": torch.from_numpy(aw), "ax": torch.tensor(ax)}
    jd = {"aw": jnp.asarray(aw), "ax": jnp.asarray(ax)}
    if with_ap:
        d["ap"], jd["ap"] = torch.from_numpy(ap), jnp.asarray(ap)
    qs = QuantState.from_dict(d, spec=spec, name="unit.0.mix.wq")
    jqs = JQuantState.from_dict(jd, spec=jspec, name="unit.0.mix.wq")
    assert (qs.spec, qs.name) == (spec, jqs.name)
    for key in ("aw", "ax", "ap", "w", "spec", "name"):
        assert (key in qs) == (key in jqs), key
        got, want = qs.get(key, "missing"), jqs.get(key, "missing")
        if isinstance(want, str):
            assert got == want, key
            with pytest.raises(KeyError):
                qs[key]
        else:
            np.testing.assert_array_equal(_np(got), np.asarray(want))
            np.testing.assert_array_equal(_np(qs[key]), np.asarray(jqs[key]))
    assert list(qs.as_dict()) == list(jqs.as_dict())
    for k, v in qs.as_dict().items():
        np.testing.assert_array_equal(_np(v), np.asarray(jqs.as_dict()[k]))
    # still a frozen dataclass with spec and name
    assert [f.name for f in dataclasses.fields(qs)] == [
        "aw", "ax", "ap", "spec", "name"]
    with pytest.raises(dataclasses.FrozenInstanceError):
        qs.name = "other"


@pytest.mark.parametrize("bits,signed,po2", [(8, True, False),
                                             (8, False, False),
                                             (4, True, True), (2, False, True)])
def test_quant_spec_equals_jax(bits, signed, po2):
    s, js = QuantSpec(bits, signed, po2), JQuantSpec(bits, signed, po2)
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    assert (s.qn, s.qp) == (js.qn, js.qp)
    assert QuantSpec() == QuantSpec(8, True, False)


# ---------------------------------------------------------------------------
# Exec registry, backend_parity_check
# ---------------------------------------------------------------------------

def _deployed_linear(spec: QuantConfig, k=48, n=24, seed=0):
    from repro_torch.core import calibrate_dense, quant_params_init
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((6, k), generator=gen)
    w = torch.randn((k, n), generator=gen) * 0.05
    qp = calibrate_dense(quant_params_init(w, spec, name="lin"), x, w)
    dep, _ = export_quantized({"lin": {"w": w, "qp": qp}})
    return dep["lin"]["qp"], x


def test_backend_registry():
    assert available_backends() == ("auto", "cuda", "oracle", "sharded")
    assert get_backend().name == "auto"
    assert get_backend("oracle") is get_backend(get_backend("oracle"))
    with pytest.raises(KeyError, match="known"):
        get_backend("pallas")

    class Probe(OracleBackend):
        name = "probe"

    from repro_torch.exec import backends as backends_mod
    try:
        register_backend("probe", Probe())
        assert "probe" in available_backends()
        assert isinstance(get_backend("probe"), ExecBackend)
    finally:
        backends_mod._REGISTRY.pop("probe", None)
    assert "probe" not in available_backends()


@pytest.mark.parametrize("spec", [QuantConfig.apsq(gs=2, n_p=4),
                                  QuantConfig.w8a8()], ids=["apsq", "w8a8"])
def test_backend_parity_check_on_cpu(spec):
    dq, x = _deployed_linear(spec)
    outs, times, bit_equal = backend_parity_check(dq, x,
                                                  backends=("oracle", "auto"))
    assert bit_equal is True and set(outs) == set(times) == {"oracle",
                                                             "auto"}
    assert all(t > 0 for t in times.values())
    outs, times, bit_equal = backend_parity_check(dq, x, backends=("oracle",),
                                                  reps=2, warmup=0)
    assert bit_equal is None and list(outs) == ["oracle"]
    with pytest.raises(ValueError, match="cuda"):
        backend_parity_check(dq, x)        # the default pair has cuda


# ---------------------------------------------------------------------------
# restore(quant_policy=) on pre-metadata checkpoints
# ---------------------------------------------------------------------------

def _degrade(t):
    """What a checkpoint's tree looked like before quantizer metadata."""
    if isinstance(t, JQuantState):
        return t.as_dict()
    if isinstance(t, dict):
        return {k: _degrade(v) for k, v in t.items()}
    return t


def _write_legacy(d, tree):
    j_save(d, 1, tree)
    mf = glob.glob(os.path.join(d, "step-*", "manifest.json"))[0]
    with open(mf) as f:
        m = json.load(f)
    m.pop("quant_states", None)
    with open(mf, "w") as f:
        json.dump(m, f)


def _states(tree, path=()):
    """{path: QuantState} of a port tree."""
    out = {}
    if isinstance(tree, QuantState):
        out[path] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_states(v, path + (k,)))
    return out


def _assert_same_tree(got, want):
    """The port's restored tree == JAX's restored tree converted: the same
    leaves bit for bit, the same quantizer names and specs."""
    assert ([p for p, _ in tree_leaves(got)]
            == [p for p, _ in tree_leaves(want)])
    for (p, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(p))
    sg, sw = _states(got), _states(want)
    assert sg and list(sg) == list(sw)
    for p in sg:
        assert (sg[p].name, sg[p].spec) == (sw[p].name, sw[p].spec), p


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_restore_upgrades_legacy_checkpoint_like_jax(tmp_path, scan):
    """``tests/test_quant_policy.py``'s legacy checkpoint (uniform APSQ
    gs=2 n_p=4, restored under that policy), with an optimizer moment
    mirror as its second legacy test writes."""
    jcfg = JModelConfig(**TINY, scan_layers=scan,
                        quant=JQuantConfig.apsq(gs=2, n_p=4))
    p = _j_init_lm(jax.random.PRNGKey(0), jcfg)
    legacy = _degrade(p)
    _write_legacy(str(tmp_path), {
        "params": legacy, "opt": {"m": jax.tree.map(jnp.zeros_like,
                                                    legacy)}})
    jtree, _ = j_restore(str(tmp_path), quant_policy=JQuantPolicy.uniform(
        JQuantConfig.apsq(gs=2, n_p=4)))
    tree, manifest = restore(str(tmp_path), device="cpu",
                             quant_policy=QuantPolicy.uniform(
                                 QuantConfig.apsq(gs=2, n_p=4)))
    assert "quant_states" not in manifest
    _assert_same_tree(tree, convert_params(jtree, device="cpu"))
    names = {s.name for s in _states(tree["params"]).values()}
    assert "unit.0.mix.wq" in names
    assert names == {s.name for s in _states(tree["opt"]["m"]).values()}
    # a plain QuantConfig resolves every layer alike
    tree2, _ = restore(str(tmp_path), device="cpu",
                       quant_policy=QuantConfig.apsq(gs=2, n_p=4))
    _assert_same_tree(tree2, tree)
    # without a policy the raw dicts come back as they are
    raw, _ = restore(str(tmp_path), device="cpu")
    assert not _states(raw)


def test_restore_drops_vestigial_ffn_wr(tmp_path):
    """An RWKV channel mix's gate ``wr`` once carried a quantizer its
    forward never used: both restores drop it, and a ``qp_<w>`` bank
    quantizer is named after its weight."""
    jcfg = JModelConfig(**TINY, scan_layers=False,
                        quant=JQuantConfig.apsq(gs=2, n_p=4))
    legacy = _degrade(_j_init_lm(jax.random.PRNGKey(1), jcfg))
    ffn = legacy["units"]["u0"]["0"]["ffn"]
    ffn["wr"] = {"w": np.ones((32, 32), np.float32),
                 "qp": {"aw": np.ones((32,), np.float32),
                        "ax": np.float32(1.0)}}
    ffn["qp_wx"] = {"aw": np.full((8,), 0.5, np.float32),
                    "ax": np.float32(0.25),
                    "ap": np.zeros((4,), np.float32)}
    _write_legacy(str(tmp_path), {"params": legacy})
    policy = JQuantPolicy.of(("*.ffn.*", JQuantConfig.apsq(gs=4, n_p=4)),
                             default=JQuantConfig.w8a8())
    jtree, _ = j_restore(str(tmp_path), quant_policy=policy)
    tree, _ = restore(str(tmp_path), device="cpu", quant_policy=QuantPolicy.of(
        ("*.ffn.*", QuantConfig.apsq(gs=4, n_p=4)),
        default=QuantConfig.w8a8()))
    _assert_same_tree(tree, convert_params(jtree, device="cpu"))
    tffn = tree["params"]["units"]["u0"]["0"]["ffn"]
    assert "qp" not in tffn["wr"] and tffn["wr"]["w"].shape == (32, 32)
    assert tffn["qp_wx"].name == "unit.0.ffn.wx"
    assert tffn["qp_wx"].spec == QuantConfig.apsq(gs=4, n_p=4)
    assert tree["params"]["units"]["u0"]["0"]["mix"]["wq"]["qp"].spec \
        == QuantConfig.w8a8()
