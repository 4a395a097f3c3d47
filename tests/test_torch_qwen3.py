"""The Qwen3-MoE family in the port, held to the JAX package on the CPU at
smoke size (``qwen3-smoke``: 2 layers, d_model 64, 4/2 heads at
head_dim 16, 8 experts top-2, float32; quickstart policy
``mix2_ffn4``).

* The port's configs carry the JAX package's fields, full and smoke
  (no QK-norm: the JAX config has none).
* Forward logits at rtol/atol 1e-4 on the same trees: float, fake quant
  with JAX's calibrated scales snapped to powers of two, and the integer
  path on JAX's export.
* The port's calibrate + export on JAX's float params (scan-stacked):
  every code and exponent equals JAX's.
* The port's ``PagedServingEngine`` on JAX's export against JAX's
  ``PagedServingEngine(backend="oracle")``: equal greedy tokens;
  last-chunk logits within rtol/atol 1e-4.
* An attention wider than the model (``n_heads * head_dim`` = 128
  against d_model 64, as the full config's 8192 against 4096): ``wq``
  ``[d, H*hd]`` and ``wo`` ``[H*hd, d]``, float and fake-quant logits
  against JAX's.
* The MoE slice's modules import and train with ``jax``, ``ml_dtypes``
  and the JAX package unimportable.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantState as JQuantState
from repro.models.model import forward as j_forward
from repro.models.model import forward_paged_chunk as j_forward_paged_chunk
from repro.models.model import init_lm as j_init_lm
from repro.models.model import init_paged_decode_state as j_init_paged
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.export import snap_params_po2 as j_snap_params_po2
from repro.quant.qat import policy_presets as j_policy_presets
from repro.serving import PagedServingEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import convert_params
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.core import DeployedQuantState
from repro_torch.models import (forward, forward_paged_chunk, init_lm,
                                init_paged_decode_state)
from repro_torch.quant import (calibrate_model, export_quantized,
                               policy_presets)
from repro_torch.serving import PagedServingEngine, Request

ARCH = "qwen3-moe-235b-a22b"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _cfgs():
    jcfg = dataclasses.replace(j_get_smoke(ARCH), scan_layers=True
                               ).with_quant(j_policy_presets()["mix2_ffn4"])
    return jcfg, get_smoke(ARCH).with_quant(policy_presets()["mix2_ffn4"])


@functools.lru_cache(maxsize=None)
def _jax_model() -> dict:
    """JAX float params, calibration tokens, calibrated tree and export."""
    jcfg, tcfg = _cfgs()
    p0 = j_init_lm(jax.random.PRNGKey(13), jcfg)
    tok = np.random.default_rng(14).integers(0, jcfg.vocab, (2, 16))
    calibrated = j_calibrate_model(p0, jcfg, {"tokens": jnp.asarray(tok)})
    deploy, report = j_export_quantized(calibrated)
    return {"p0": p0, "tok": tok, "calibrated": calibrated,
            "deploy": deploy, "report": report, "jcfg": jcfg, "tcfg": tcfg}


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _po2_scales(tree):
    """Every quantizer scale a power of two (``snap_params_po2``, the PSUM
    scales floored): fake quant multiplies and sums exactly."""
    def floor_ap(t):
        if isinstance(t, JQuantState):
            return dataclasses.replace(
                t, ap=None if t.ap is None else jnp.floor(t.ap))
        if isinstance(t, dict):
            return {k: floor_ap(v) for k, v in t.items()}
        return t
    return floor_ap(j_snap_params_po2(tree))


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def test_configs_carry_the_jax_fields():
    assert ARCH in ARCH_NAMES
    for mine, want in ((get_config(ARCH), j_get_config(ARCH)),
                       (get_smoke(ARCH), j_get_smoke(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name in ("quant", "quant_policy"):
                continue
            assert getattr(mine, f.name) == getattr(want, f.name), f.name
    full = get_config(ARCH)
    assert full.n_heads * full.hd == 8192 != full.d_model
    assert (full.n_experts, full.top_k, full.d_ff) == (128, 8, 1536)
    # the quant presets resolve as JAX's on every linear, experts included
    q = get_config(ARCH, quant="apsq", gs=2, n_p=8)
    jq = j_get_config(ARCH, quant="apsq", gs=2, n_p=8)
    for layer in ("unit.0.mix.wq", "unit.0.ffn.wi", "unit.0.ffn.wo"):
        assert dataclasses.asdict(q.policy.resolve(layer)) == \
            dataclasses.asdict(jq.policy.resolve(layer))


# ---------------------------------------------------------------------------
# Forward, calibrate + export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "fakequant_po2", "deployed"])
def test_forward_logits_match_jax(kind):
    m = _jax_model()
    tree = {"float": m["p0"], "fakequant_po2": _po2_scales(m["calibrated"]),
            "deployed": m["deploy"]}[kind]
    want = np.asarray(j_forward(tree, m["jcfg"], jnp.asarray(m["tok"]),
                                backend="oracle"))
    got = forward(convert_params(tree, device="cpu"), m["tcfg"],
                  torch.from_numpy(m["tok"]), backend="oracle").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_calibrate_export_bit_exact_vs_jax():
    m = _jax_model()
    calibrated = calibrate_model(convert_params(m["p0"], device="cpu"),
                                 m["tcfg"], {"tokens": m["tok"]})
    got, report = export_quantized(calibrated)
    assert set(report) == set(m["report"])
    for w in "igo":
        assert report[f"unit.0.ffn.w{w}"]["n_experts"] == 8
    n_deployed = n_banks = 0
    for path, t, j in _walk(got, convert_params(m["deploy"], device="cpu")):
        if isinstance(t, DeployedQuantState):
            n_deployed += 1
            n_banks += t.w_codes.dim() == 3
            assert (t.spec, t.name, t.out_dims) == (j.spec, j.name,
                                                   j.out_dims), path
            for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
                a, b = getattr(t, f), getattr(j, f)
                assert (a is None) == (b is None), (path, f)
                assert a is None or torch.equal(a, b), (path, f)
        else:
            assert torch.equal(t, j), path
    assert (n_deployed, n_banks) == (2 * 7, 2 * 3)


# ---------------------------------------------------------------------------
# Serving: the port's engine against JAX's oracle engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
                 decode_horizon=4)
# (prompt, new): whole prefill chunks, so JAX compiles one chunk shape
PROMPTS = [(8, 6), (16, 7), (8, 5), (16, 6)]


def _run(engine, req_cls, spec):
    reqs = [req_cls(uid=u, tokens=t, max_new_tokens=n) for u, t, n in spec]
    return {r.uid: r.out for r in engine.run(reqs)}


def test_engine_greedy_tokens_and_logits_match_jax_oracle():
    m = _jax_model()
    tdeploy = convert_params(m["deploy"], device="cpu")
    rng = np.random.default_rng(15)
    spec = [(i, rng.integers(0, 256, size=n).astype(np.int32), k)
            for i, (n, k) in enumerate(PROMPTS)]
    port = _run(PagedServingEngine(tdeploy, m["tcfg"], **ENGINE_KW),
                Request, spec)
    ref = _run(JEngine(m["deploy"], m["jcfg"], backend="oracle",
                       **ENGINE_KW), JRequest, spec)
    assert port == ref
    # last-chunk logits of a 16-token prompt (chunks 8 + 8)
    toks = spec[3][1]
    table = np.arange(1, 5, dtype=np.int32)[None]
    jst = j_init_paged(m["jcfg"], 1, page_size=4, n_pages=8)
    tst = init_paged_decode_state(m["tcfg"], 1, page_size=4, n_pages=8,
                                  device="cpu")
    done = 0
    for c in (8, 8):
        jl, jst = j_forward_paged_chunk(
            m["deploy"], m["jcfg"], jst,
            jnp.asarray(toks[done:done + c][None]),
            jnp.asarray([done], jnp.int32), jnp.asarray(table),
            backend="oracle")
        tl, tst = forward_paged_chunk(
            tdeploy, m["tcfg"], tst,
            torch.from_numpy(toks[done:done + c][None]),
            torch.tensor([done], dtype=torch.int32), torch.from_numpy(table))
        done += c
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# An attention wider than the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "fakequant_po2"])
def test_attention_wider_than_the_model_matches_jax(kind):
    """head_dim 32: 4 heads x 32 = 128 query features from d_model 64
    (one layer).  Logits at rtol/atol 1e-4 (fake quant on JAX's initial quantizer
    states, snapped to powers of two)."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, head_dim=32, scan_layers=False,
                               n_layers=1)
    tcfg = tcfg.scaled(head_dim=32, n_layers=1)
    if kind == "float":
        jcfg = dataclasses.replace(jcfg, quant_policy=None)
        tcfg = tcfg.scaled(quant_policy=None)
    p = j_init_lm(jax.random.PRNGKey(16), jcfg)
    if kind != "float":
        p = _po2_scales(p)
    mix = p["units"]["u0"]["0"]["mix"]
    assert mix["wq"]["w"].shape == (64, 128)
    assert mix["wo"]["w"].shape == (128, 64)
    tok = np.random.default_rng(17).integers(0, 256, (2, 12))
    want = np.asarray(j_forward(p, jcfg, jnp.asarray(tok)))
    got = forward(convert_params(p, device="cpu"), tcfg,
                  torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # and the port's own tree has the same shapes
    mine = init_lm(tcfg, seed=0, device="cpu")["units"]["u0"]["0"]["mix"]
    assert tuple(mine["wq"]["w"].shape) == (64, 128)
    assert tuple(mine["wo"]["w"].shape) == (128, 64)


# ---------------------------------------------------------------------------
# Without JAX
# ---------------------------------------------------------------------------

def test_moe_slice_runs_without_jax(tmp_path):
    """The config registry (the Qwen3-MoE module included), and an
    olmoe-smoke APSQ training run through the launcher (a step, a save
    and a resumed step), with ``jax``, ``ml_dtypes`` and the JAX package
    unimportable."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[m] = None
sys.path.insert(0, {SRC!r})
import repro_torch.configs.qwen3_moe_235b_a22b
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.launch.train import main
from repro_torch.models import init_lm
for arch in ARCH_NAMES:
    get_config(arch, quant="apsq")
init_lm(get_smoke("qwen3-moe-235b-a22b"), seed=0, device="cpu")
argv = ["--arch", "olmoe-1b-7b", "--smoke", "--quant", "apsq", "--gs",
        "2", "--np", "4", "--steps", "1", "--seq-len", "8",
        "--global-batch", "2", "--save-every", "1", "--ckpt-dir",
        {str(tmp_path)!r}, "--device", "cpu"]
main(argv)
argv[10] = "2"
tr = main(argv)
assert not any(m == "repro" or m.startswith(("repro.", "jax", "ml_dtypes"))
               for m in sys.modules if sys.modules[m] is not None)
print(len(tr.metrics_log), tr.cfg.n_experts)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[trainer] resumed from step 1" in out.stdout
    assert out.stdout.split()[-2:] == ["1", "8"]
