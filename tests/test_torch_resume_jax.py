"""The port resumes a JAX training run, on the CPU at smoke size.

The JAX ``Trainer`` keeps units scan-stacked (``scan_layers=True``, its
default), in the params and in both Adam moments, and its checkpoints
hold them so: ``params/units``, ``opt/m/units``, ``opt/v/units``.  Here
a JAX ``Trainer`` trains ``olmoe-smoke`` under APSQ (gs=2, n_p=8, two
microbatches) for two steps, saving after each, into ``tmp_path``.

* The port's ``checkpoint.restore`` of step 1 gives JAX's restored tree
  leaf for leaf, bit for bit, once JAX's is unstacked with
  ``convert.unstack_units``: every ``units`` subtree is unstacked.
* The port's ``Trainer.fit`` resumes from that checkpoint and takes
  step 2; it agrees with JAX's step 2 within the float-scale bound of
  ``tests/test_torch_moe_train.py`` (the scales are calibrated floats),
  and its expert quantizers' scale gradients are JAX's within a
  measured factor.
"""
import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import restore as j_restore
from repro.configs import get_smoke as j_get_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantState as JQuantState
from repro.data import DataConfig as JDataConfig
from repro.models.model import init_lm as j_init_lm
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint import convert_params, restore, unstack_units
from repro_torch.configs import get_smoke
from repro_torch.core import QuantConfig
from repro_torch.data import DataConfig
from repro_torch.models import tree_leaves
from repro_torch.optim import OptimConfig
from repro_torch.quant import calibrate_model
from repro_torch.train import TrainConfig, Trainer

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DATA = dict(vocab=256, seq_len=16, global_batch=4, seed=2)


def _stacked_scales(jtree, calibrated, path=()):
    """JAX's scan-stacked tree with each quantizer state's scales taken
    from the port's calibrated (unstacked) tree, stacked over units."""
    if isinstance(jtree, JQuantState):
        units = [calibrated["units"][f"u{i}"]
                 for i in range(len(calibrated["units"]))]

        def stack(field):
            vals = []
            for u in units:
                node = u
                for k in path[1:]:
                    node = node[k]
                vals.append(getattr(node, field).numpy())
            return jnp.asarray(np.stack(vals))
        return dataclasses.replace(jtree, aw=stack("aw"), ax=stack("ax"),
                                   ap=stack("ap"))
    if isinstance(jtree, dict):
        return {k: _stacked_scales(v, calibrated, path + (k,))
                for k, v in jtree.items()}
    return jtree


def _port_tree(jtree):
    """JAX's restored checkpoint tree as the port holds it: ``params``,
    ``opt/m`` and ``opt/v`` each unstacked by ``convert.unstack_units``."""
    out = convert_params({"params": jtree["params"], "m": jtree["opt"]["m"],
                          "v": jtree["opt"]["v"],
                          "step": jtree["opt"]["step"]}, device="cpu")
    for k in ("params", "m", "v"):
        out[k]["units"] = unstack_units(out[k]["units"])
    return {"params": out["params"],
            "opt": {"m": out["m"], "v": out["v"], "step": out["step"]}}


def test_port_restores_and_resumes_a_jax_trainer_checkpoint(tmp_path):
    jcfg = j_get_smoke("olmoe-1b-7b").with_quant(
        JQuantConfig.apsq(gs=2, n_p=8))
    assert jcfg.scan_layers
    tcfg = get_smoke("olmoe-1b-7b").with_quant(QuantConfig.apsq(gs=2,
                                                                n_p=8))
    p0 = j_init_lm(jax.random.PRNGKey(3), jcfg)
    calib_tokens = np.random.default_rng(4).integers(0, 256, (4, 16))
    params = _stacked_scales(p0, calibrate_model(
        convert_params(p0, device="cpu"), tcfg, {"tokens": calib_tokens}))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtrainer = JTrainer(jcfg, JOptimConfig(**OCFG), JTrainConfig(
        microbatches=2, steps=2, save_every=1, log_every=100,
        ckpt_dir=str(jdir)))
    jp, jo = jtrainer.fit(JDataConfig(**DATA), params=params,
                          opt_state=j_init_opt_state(params,
                                                     JOptimConfig(**OCFG)),
                          log=lambda m: None)

    # the port's restore == JAX's restore, unstacked, bit for bit
    jtree, jman = j_restore(str(jdir), 1)
    assert jtree["params"]["units"]["0"]["ffn"]["wi"].shape[:2] == (2, 8)
    tree, man = restore(str(jdir), 1, device="cpu")
    assert man["step"] == jman["step"] == 1
    assert sorted(tree["params"]["units"]) == ["u0", "u1"]
    for k in ("m", "v"):
        assert sorted(tree["opt"][k]["units"]) == ["u0", "u1"]
    want = dict(tree_leaves(_port_tree(jtree)))
    got = dict(tree_leaves(tree))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = want[path]
        assert t.dtype == w.dtype and t.shape == w.shape, path
        assert torch.equal(t, w), path

    # the port resumes from it and takes JAX's step 2
    tdir.mkdir()
    shutil.copytree(jdir / "step-000000001", tdir / "step-000000001")
    logs = []
    trainer = Trainer(tcfg, OptimConfig(**OCFG), TrainConfig(
        microbatches=2, steps=2, save_every=0, log_every=1,
        ckpt_dir=str(tdir)), device="cpu")
    tp, to = trainer.fit(DataConfig(**DATA), log=logs.append)
    assert logs[0] == "[trainer] resumed from step 1"
    assert [m["step"] for m in trainer.metrics_log] == [1]
    mine, theirs = trainer.metrics_log[0], jtrainer.metrics_log[1]
    # the float-scale bound of test_torch_moe_train.py
    assert abs(mine["loss"] - theirs["loss"]) <= 1e-2 * theirs["loss"]
    assert abs(mine["grad_norm"] - theirs["grad_norm"]) <= \
        2e-2 * theirs["grad_norm"]
    assert int(to["step"]) == int(jo["step"]) == 2
    w = dict(tree_leaves(_port_tree({"params": jp, "opt": jo})["opt"]["m"]))
    diff = math.sqrt(sum(float(((t - w[p]) ** 2).sum())
                         for p, t in tree_leaves(to["m"])))
    norm = math.sqrt(sum(float((t ** 2).sum())
                         for _, t in tree_leaves(to["m"])))
    assert diff <= 0.25 * norm, diff / norm
    # step 2's gradient to each expert quantizer's scale, from m2 - b1 m1
    # with the restored m1, against JAX's (the bounds above pass scale
    # gradients sqrt(E) = 2.83 times too small).  With float scales one
    # path's ratio ranges 0.61-2.64; their geometric mean over the 18
    # paths measured 1.03-1.15 (seeds 3, 5, 7, 9 of this case), and 3.08
    # and 3.25 with the gradient scale taken over the whole bank (seeds 3
    # and 5).  Held within a factor 1.5.
    b1, m1 = OptimConfig().b1, dict(tree_leaves(tree["opt"]["m"]))
    logs = []
    for path, t in tree_leaves(to["m"]):
        if "ffn" in path and path[-1] in ("aw", "ax", "ap"):
            g, jg = t - b1 * m1[path], w[path] - b1 * m1[path]
            logs.append(math.log(float(jg.norm()) / float(g.norm())))
    assert len(logs) == 2 * 3 * 3
    assert abs(sum(logs) / len(logs)) <= math.log(1.5), \
        math.exp(sum(logs) / len(logs))
