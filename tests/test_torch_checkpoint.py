"""The port's checkpoint loader (``repro_torch.checkpoint.restore``) against
the JAX package's ``checkpoint.save``, on the CPU.

* A JAX export of ``starcoder2-smoke`` with a tied head (LayerNorm
  biases, a deployed ``qp_head``), float32 and bfloat16, stacked and
  unstacked units, saved by JAX and restored by the port, is bit-equal
  leaf by leaf to ``convert_params`` of the in-memory tree, and its
  states carry the same ``spec``, ``name`` and ``out_dims``.
* A calibrated tree saved before export, restored and exported by the
  port, gives JAX's export exactly.
* ``step=None`` takes the latest finished step and ignores ``tmp-*``.
* The committed fixture (``tests/fixtures/jax_export_starcoder2_smoke``)
  restores in a process where ``jax`` and ``ml_dtypes`` cannot be
  imported; its generator reproduces it bit for bit; served by the
  port's engine it gives the JAX oracle engine's recorded tokens.
"""
import dataclasses
import filecmp
import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save as j_save
from repro.configs.starcoder2_15b import smoke_config as j_smoke
from repro.models.model import init_lm as j_init_lm
from repro.quant import calibrate_model as j_calibrate_model
from repro.quant import export_quantized as j_export_quantized
from repro.quant.qat import policy_presets as j_policy_presets
from repro_torch.checkpoint import (convert_params, latest_step, list_steps,
                                    restore)
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState, QuantState
from repro_torch.quant import export_quantized
from repro_torch.serving import PagedServingEngine, Request

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "jax_export_starcoder2_smoke")
SRC = os.path.join(os.path.dirname(HERE), "src")


@functools.lru_cache(maxsize=None)
def _jax_trees(scan: bool, dtype: str) -> dict:
    """JAX ``starcoder2-smoke`` (tied head, mix2_ffn4): the calibrated
    tree and its export; built once per (layout, dtype)."""
    cfg = dataclasses.replace(j_smoke(), scan_layers=scan,
                              tie_embeddings=True, dtype=dtype).with_quant(
        j_policy_presets()["mix2_ffn4"])
    p0 = j_init_lm(jax.random.PRNGKey(7), cfg)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 16))
    calibrated = j_calibrate_model(p0, cfg, {"tokens": jnp.asarray(tok)})
    deploy, _ = j_export_quantized(calibrated)
    return {"calibrated": calibrated, "deploy": deploy}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_bit_equal(got: dict, want: dict):
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(a) == sorted(b)
    n_states = 0
    for path, t in a.items():
        w = b[path]
        assert type(t) is type(w), path
        if isinstance(t, torch.Tensor):
            assert t.dtype == w.dtype and torch.equal(t, w), path
            continue
        n_states += 1
        assert (t.spec, t.name) == (w.spec, w.name), path
        fields = (("w_codes", "ax_exp", "aw_exp", "psum_exps")
                  if isinstance(t, DeployedQuantState) else ("aw", "ax", "ap"))
        if isinstance(t, DeployedQuantState):
            assert t.out_dims == w.out_dims, path
        for f in fields:
            x, y = getattr(t, f), getattr(w, f)
            assert (x is None) == (y is None), (path, f)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), (path, f)
    return n_states


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", [False, True],
                         ids=["unstacked", "scan_layers"])
def test_restore_bit_equal_to_convert_params(tmp_path, scan, dtype):
    deploy = _jax_trees(scan, dtype)["deploy"]
    j_save(str(tmp_path), 0, deploy, extra={"note": "smoke"})
    got, manifest = restore(str(tmp_path), device="cpu")
    assert manifest["extra"] == {"note": "smoke"}
    assert got["embed"]["table"].dtype == getattr(torch, dtype)
    assert isinstance(got["embed"]["qp_head"], DeployedQuantState)
    assert sorted(got["units"]) == ["u0", "u1"]
    assert "bias" in got["units"]["u0"]["0"]["ln1"]
    n_states = _assert_bit_equal(got, convert_params(deploy, device="cpu"))
    assert n_states == 2 * 6 + 1          # 6 projections a layer + head


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unstacked", "scan_layers"])
def test_restore_calibrated_then_export_matches_jax(tmp_path, scan):
    trees = _jax_trees(scan, "float32")
    j_save(str(tmp_path), 3, trees["calibrated"])
    calibrated, _ = restore(str(tmp_path), device="cpu")
    assert isinstance(calibrated["embed"]["qp_head"], QuantState)
    _assert_bit_equal(calibrated,
                      convert_params(trees["calibrated"], device="cpu"))
    got, report = export_quantized(calibrated)
    assert report["head"]["tied_head"] and report["head"]["mode"] == "none"
    _assert_bit_equal(got, convert_params(trees["deploy"], device="cpu"))


def test_latest_step_ignores_tmp_dirs(tmp_path):
    d = str(tmp_path)
    assert list_steps(d) == [] and latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore(d, device="cpu")
    for step in (3, 7):
        j_save(d, step, {"x": np.full((2,), step, np.int32)})
    os.makedirs(os.path.join(d, "tmp-9"))       # a save in flight
    assert list_steps(d) == [3, 7] and latest_step(d) == 7
    tree, manifest = restore(d, device="cpu")
    assert manifest["step"] == 7 and tree["x"].tolist() == [7, 7]
    tree, _ = restore(d, 3, device="cpu")
    assert tree["x"].tolist() == [3, 3]


def test_fixture_restores_without_jax_or_ml_dtypes():
    """The loader on a machine without JAX: ``jax`` and ``ml_dtypes`` (and
    the JAX package) are made unimportable before anything loads."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[m] = None
sys.path.insert(0, {SRC!r})
from repro_torch.checkpoint import restore
tree, manifest = restore({FIXTURE!r}, device="cpu")
assert not any(m == "repro" or m.startswith(("repro.", "jax", "ml_dtypes"))
               for m in sys.modules if sys.modules[m] is not None)
print(type(tree["embed"]["qp_head"]).__name__, sorted(tree["units"]),
      tree["embed"]["table"].dtype, len(manifest["leaves"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["DeployedQuantState", "['u0',", "'u1']",
                                  "torch.float32", "34"]


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_jax_export", os.path.join(HERE, "fixtures",
                                        "make_jax_export.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_generator_reproduces_committed_fixture(tmp_path):
    made = _generator().make(str(tmp_path))
    want = os.path.join(FIXTURE, "step-000000000")
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(made)) == names
    with open(os.path.join(made, "manifest.json")) as f, \
            open(os.path.join(want, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    differ = [n for n in names
              if not filecmp.cmp(os.path.join(made, n),
                                 os.path.join(want, n), shallow=False)]
    assert not differ, differ


def test_restored_fixture_serves_jax_tokens():
    tree, manifest = restore(FIXTURE, device="cpu")
    extra = manifest["extra"]
    assert extra["engine"]["backend"] == "oracle"
    cfg = get_smoke(extra["arch"]).scaled(tie_embeddings=True)
    kw = {k: v for k, v in extra["engine"].items() if k != "backend"}
    reqs = extra["requests"]
    done = PagedServingEngine(tree, cfg, **kw).run([
        Request(uid=r["uid"], tokens=np.array(r["tokens"], np.int32),
                max_new_tokens=r["max_new_tokens"]) for r in reqs])
    assert {r.uid: r.out for r in done} == {r["uid"]: r["out"] for r in reqs}
