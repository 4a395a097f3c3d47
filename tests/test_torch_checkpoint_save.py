"""The port's checkpoint writer and trainer loop, on the CPU.

* ``save`` writes the JAX package's format: the JAX package's
  ``restore`` reads a port checkpoint of a trainer state (bf16 params,
  quantizer states, float32 moments, the int32 step) and gets JAX's
  leaves bit for bit, and the manifest (leaves, ``quant_states``, step,
  extra) equals the one JAX's ``save`` writes for the same state; a
  deployed tree comes back as JAX ``DeployedQuantState``s.
* The port's own round trip: bit-equal leaves, the same states (spec,
  name, out_dims), factored ``adafactor_like`` moments included.
* ``AsyncCheckpointer`` keeps the last ``keep`` steps, leaves no
  ``tmp-*`` behind and re-raises a failed write; ``install_signal_handler``
  saves on SIGTERM.
* Resuming from a checkpoint equals continuous training, bit for bit on
  the CPU (``Trainer.fit``, and the ``repro_torch.launch.train`` CLI).
* Every module of the training slice imports, trains a step and writes
  and reads a checkpoint with ``jax``, ``ml_dtypes`` and the JAX package
  unimportable.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.checkpoint import save as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.core import DeployedQuantState as JDeployedQuantState
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantState as JQuantState
from repro.models.model import init_lm as j_init_lm
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.checkpoint import (AsyncCheckpointer, convert_params,
                                    latest_step, list_steps, restore, save)
from repro_torch.configs import get_smoke
from repro_torch.core import DeployedQuantState, QuantConfig, QuantState
from repro_torch.data import DataConfig
from repro_torch.models import init_lm, tree_leaves, tree_map
from repro_torch.optim import OptimConfig, apply_updates, init_opt_state
from repro_torch.quant import calibrate_model, export_quantized
from repro_torch.train import TrainConfig, Trainer

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _bits(a) -> np.ndarray:
    """An array's bits (bfloat16 as uint16: NaN-safe, sign of zero)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind not in "iu" else a


def _jax_leaves(tree) -> dict:
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_state(seed=0):
    """A JAX trainer state after one AdamW step: bf16 params (unstacked,
    APSQ states), a tied head's state, float32 moments, the int32 step."""
    cfg = dataclasses.replace(j_get_smoke("tinyllama-1.1b"), dtype="bfloat16",
                              scan_layers=False, tie_embeddings=True
                              ).with_quant(JQuantConfig.apsq(gs=2, n_p=8))
    params = j_init_lm(jax.random.PRNGKey(seed), cfg)
    params["embed"]["qp_head"] = JQuantState(
        aw=jnp.full((cfg.vocab,), 0.01), ax=jnp.asarray(0.5),
        ap=jnp.arange(8, dtype=jnp.float32), spec=JQuantConfig.w8a8(),
        name="head")
    ocfg = JOptimConfig(lr=1e-2, warmup_steps=1)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape).astype(np.float32)).astype(p.dtype), params)
    params, opt, _ = j_apply_updates(params, grads,
                                     j_init_opt_state(params, ocfg), ocfg)
    return {"params": params, "opt": opt}


def test_port_save_is_read_by_jax_bit_for_bit(tmp_path):
    jstate = _jax_state()
    j_save(str(tmp_path / "jax"), 7, jstate, {"note": "x"})
    tstate = convert_params(jstate, device="cpu")
    assert tstate["params"]["embed"]["table"].dtype == torch.bfloat16
    assert isinstance(tstate["opt"]["m"]["units"]["u0"]["0"]["mix"]["wq"][
        "qp"], QuantState)
    path = save(str(tmp_path / "port"), 7, tstate, {"note": "x"})
    assert os.path.basename(path) == "step-000000007"
    with open(os.path.join(path, "manifest.json")) as f, \
            open(tmp_path / "jax" / "step-000000007" / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    got, manifest = j_restore(str(tmp_path / "port"))
    want = _jax_leaves(jstate)
    got_leaves = _jax_leaves(got)
    assert got_leaves.keys() == want.keys()
    for k, v in want.items():
        assert got_leaves[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(got_leaves[k]), _bits(v),
                                      err_msg=str(k))
    qs = got["opt"]["m"]["units"]["u1"]["0"]["ffn"]["wo"]["qp"]
    ref = jstate["params"]["units"]["u1"]["0"]["ffn"]["wo"]["qp"]
    assert isinstance(qs, JQuantState)
    assert (qs.spec, qs.name) == (ref.spec, ref.name)
    assert got["params"]["embed"]["qp_head"].name == "head"
    assert manifest["extra"] == {"note": "x"}


def test_port_deployed_tree_is_read_by_jax(tmp_path):
    cfg = get_smoke("tinyllama-1.1b").with_quant(QuantConfig.apsq(gs=2,
                                                                  n_p=4))
    params = init_lm(cfg, seed=1, device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    deploy, _ = export_quantized(calibrate_model(params, cfg,
                                                 {"tokens": tok}))
    save(str(tmp_path), 0, deploy)
    got, _ = j_restore(str(tmp_path))
    t = deploy["units"]["u0"]["0"]["ffn"]["wi"]["qp"]
    j = got["units"]["u0"]["0"]["ffn"]["wi"]["qp"]
    assert isinstance(j, JDeployedQuantState)
    assert (j.name, j.out_dims) == (t.name, t.out_dims)
    assert dataclasses.asdict(j.spec) == dataclasses.asdict(t.spec)
    for f in ("w_codes", "ax_exp", "aw_exp", "psum_exps"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy())
    back, _ = restore(str(tmp_path), device="cpu")
    _assert_trees_bit_equal(back, deploy)


def _assert_trees_bit_equal(a, b):
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        y = lb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k
    states_a, states_b = {}, {}
    tree_leaves(a, nodes=states_a)
    tree_leaves(b, nodes=states_b)
    assert states_a.keys() == states_b.keys()
    for k, s in states_a.items():
        t = states_b[k]
        assert type(s) is type(t) and s.spec == t.spec and s.name == t.name
        assert getattr(s, "out_dims", None) == getattr(t, "out_dims", None)


@pytest.mark.parametrize("adafactor", [False, True])
def test_port_round_trip_and_jax_reads_it(tmp_path, adafactor):
    cfg = get_smoke("tinyllama-1.1b").scaled(dtype="bfloat16").with_quant(
        QuantConfig.apsq(gs=2, n_p=8))
    params = init_lm(cfg, seed=2, device="cpu")
    ocfg = OptimConfig(lr=1e-2, warmup_steps=1, adafactor_like=adafactor)
    gen = torch.Generator().manual_seed(0)
    grads = tree_map(lambda _, t: torch.randn(t.shape, generator=gen).to(
        t.dtype), params)
    params, opt, _ = apply_updates(params, grads,
                                   init_opt_state(params, ocfg), ocfg)
    state = {"params": params, "opt": opt}
    save(str(tmp_path), 1, state)
    back, manifest = restore(str(tmp_path), device="cpu")
    _assert_trees_bit_equal(back, state)
    assert back["opt"]["step"].dtype == torch.int32
    assert manifest["leaves"]["params/embed/table"]["dtype"] == "bfloat16"
    jgot, _ = j_restore(str(tmp_path))
    jl = _jax_leaves(jgot)
    for path, t in tree_leaves(state):
        want = t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(_bits(jl[path]), _bits(want),
                                      err_msg=str(path))
    if adafactor:
        v = back["opt"]["v"]["units"]["u0"]["0"]["mix"]["wq"]
        assert sorted(v["w"]) == ["col", "row"] and sorted(v["qp"].aw) == [
            "full"]


def test_async_checkpointer_keeps_last_and_raises(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "a"), keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "s": torch.tensor(1)}
    for step in (1, 2, 3):
        tree = {**tree, "s": torch.tensor(step)}
        ck.save(step, tree)
    ck.wait()
    assert list_steps(str(tmp_path / "a")) == [2, 3]
    assert latest_step(str(tmp_path / "a")) == 3
    assert not [n for n in os.listdir(tmp_path / "a") if n.startswith("tmp")]
    back, _ = restore(str(tmp_path / "a"), device="cpu")
    assert int(back["s"]) == 3
    (tmp_path / "b").write_text("a file, not a directory")
    bad = AsyncCheckpointer.__new__(AsyncCheckpointer)
    bad.ckpt_dir, bad.keep, bad._thread, bad._error = str(
        tmp_path / "b"), 1, None, None
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()          # the error is reported once


def test_signal_handler_saves_on_sigterm(tmp_path):
    code = f"""
import os, signal, sys, torch
sys.path.insert(0, {SRC!r})
from repro_torch.checkpoint import AsyncCheckpointer, install_signal_handler
ck = AsyncCheckpointer({str(tmp_path)!r})
install_signal_handler(ck, lambda: (5, {{"w": torch.ones(3)}}))
os.kill(os.getpid(), signal.SIGTERM)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == -15, out.stderr
    back, manifest = restore(str(tmp_path), device="cpu")
    assert manifest["step"] == 5 and manifest["extra"] == {"emergency": True}
    assert torch.equal(back["w"], torch.ones(3))


def _smoke_trainer(ckpt_dir, steps, save_every):
    cfg = get_smoke("tinyllama-1.1b").with_quant(QuantConfig.apsq(gs=2,
                                                                  n_p=4))
    ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    tcfg = TrainConfig(microbatches=2, steps=steps, save_every=save_every,
                       log_every=100, ckpt_dir=str(ckpt_dir))
    return Trainer(cfg, ocfg, tcfg, device="cpu")


DATA = DataConfig(vocab=256, seq_len=16, global_batch=4)


def test_resume_equals_continuous_bit_for_bit(tmp_path):
    logs = []
    cont = _smoke_trainer(tmp_path / "c", 4, 0).fit(DATA, log=logs.append)
    _smoke_trainer(tmp_path / "r", 2, 2).fit(DATA, log=logs.append)
    assert list_steps(str(tmp_path / "r")) == [2]
    res = _smoke_trainer(tmp_path / "r", 4, 0).fit(DATA, log=logs.append)
    assert "[trainer] resumed from step 2" in logs
    _assert_trees_bit_equal({"p": res[0], "o": res[1]},
                            {"p": cont[0], "o": cont[1]})
    assert int(res[1]["step"]) == 4


def test_launcher_trains_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--quant", "apsq",
            "--gs", "2", "--np", "4", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--save-every",
            "3", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    tr = main(argv)
    assert len(tr.metrics_log) == 3 and list_steps(str(tmp_path)) == [3]
    assert tr.cfg.policy.resolve("unit.0.ffn.wi").psum.gs == 2
    main(argv[:10] + ["5"] + argv[11:])
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 3" in out
    assert "[train] finished 5 steps" in out


def test_training_slice_runs_without_jax(tmp_path):
    """The new modules with ``jax``, ``ml_dtypes`` and the JAX package
    unimportable: a train step, a save and a restore."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[m] = None
sys.path.insert(0, {SRC!r})
import repro_torch.checkpoint, repro_torch.configs, repro_torch.core
import repro_torch.data, repro_torch.launch.train, repro_torch.models
import repro_torch.optim, repro_torch.quant, repro_torch.train
from repro_torch.launch.train import main
tr = main(["--arch", "tinyllama-1.1b", "--smoke", "--quant", "apsq",
           "--steps", "1", "--seq-len", "8", "--global-batch", "2",
           "--save-every", "1", "--ckpt-dir", {str(tmp_path)!r},
           "--device", "cpu"])
tree, manifest = repro_torch.checkpoint.restore({str(tmp_path)!r},
                                                device="cpu")
assert not any(m == "repro" or m.startswith(("repro.", "jax", "ml_dtypes"))
               for m in sys.modules if sys.modules[m] is not None)
print(manifest["step"], sorted(tree))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-3:] == ["1", "['opt',", "'params']"]
