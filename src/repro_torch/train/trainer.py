"""Trainer: the train step and a fault-tolerant host loop (port of the
single-device part of ``repro/train/trainer.py``).

``train_step(params, opt_state, batch)``:
  microbatch loop (gradient accumulation in float32 accumulators, the
  loss averaged over microbatches as the JAX scan does)
    -> global-norm clip -> AdamW (``repro_torch.optim``).

Gradients come from ``torch.autograd.grad`` over the params' leaves
(``models.model.tree_leaves``): every float tensor of the tree, the
``QuantState`` scales ``aw``/``ax``/``ap`` included, is a trainable
leaf; a leaf the loss does not reach gets a zero gradient, as
``jax.grad`` gives it.  The step is eager PyTorch on the params' device.

Host loop (``Trainer.fit``): resume from the latest checkpoint if one
exists, step-indexed deterministic data (replay-exact after a restart),
async checkpoints every ``save_every`` steps, and a straggler watchdog
(wall time per step against a running median).

The JAX trainer's multi-device parts (INT8-compressed cross-pod
gradients, ZeRO-1 moment sharding, meshes and shardings) are not ported:
``TrainConfig`` keeps their fields, and ``compress_dcn_grads=True``
raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data import DataConfig, SyntheticCorpus, device_put_batch
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward, init_lm, lm_loss, tree_leaves,
                                      tree_map)
from repro_torch.optim import (OptimConfig, apply_updates, decay_mask,
                               init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_dcn_grads: bool = False   # multi-device: not ported
    zero1: bool = True                 # multi-device: no effect here
    save_every: int = 100
    log_every: int = 10
    straggler_factor: float = 2.0
    ckpt_dir: str = "/tmp/repro_torch_ckpt"
    steps: int = 100


def _check_single_device(tcfg: TrainConfig):
    if tcfg.compress_dcn_grads:
        raise NotImplementedError(
            "compress_dcn_grads is the JAX trainer's INT8 cross-pod "
            "gradient psum; the port trains on one device until the dist "
            "training slice (ROADMAP queue 1)")


# ---------------------------------------------------------------------------
# Step factory
# ---------------------------------------------------------------------------

def _split_micro(batch: dict, n: int) -> list:
    out = []
    for i in range(n):
        mb = {}
        for k, x in batch.items():
            b = x.shape[0]
            if b % n:
                raise ValueError(f"batch {b} does not split into {n} "
                                 "microbatches")
            mb[k] = x[i * (b // n):(i + 1) * (b // n)]
        out.append(mb)
    return out


def make_loss_fn(cfg: ModelConfig):
    """(params, batch) -> the token-mean LM loss; a batch's ``embeds``
    (vision) and ``enc_embeds`` (encoder-decoder) reach ``forward``, and
    where an image prefix makes the logits longer than the labels only
    the text positions' logits are scored, as in the JAX trainer."""
    def loss_fn(params, batch):
        logits = forward(params, cfg, batch["tokens"],
                         embeds=batch.get("embeds"),
                         enc_embeds=batch.get("enc_embeds"))
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:   # vlm: text logits only
            logits = logits[:, -labels.shape[1]:]
        return lm_loss(logits, labels, batch.get("mask"), cfg.z_loss)
    return loss_fn


def value_and_grad(loss_fn, params, batch) -> tuple:
    """``(loss, grads)`` of ``loss_fn(params, batch)`` over every leaf of
    ``params`` (grads in each leaf's dtype, zeros where unused)."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _, t: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _, t: next(it), params)


def grad_carry(params, n: int):
    """The microbatch loop's carry before its first microbatch: None for
    one microbatch, else float32 zero accumulators ``(loss, grads)``
    shaped like ``params``."""
    if n == 1:
        return None
    g_acc = tree_map(lambda _, p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    return (torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(g_acc)[0][1].device), g_acc)


def microbatch_step(carry, loss_fn, params, mb):
    """One microbatch's forward and backward, added into ``carry`` (None:
    its ``(loss, grads)`` become the carry, in the params' dtypes)."""
    loss, g = value_and_grad(loss_fn, params, mb)
    if carry is None:
        return loss, g
    loss_sum, g_acc = carry
    for (_, a), (_, b) in zip(tree_leaves(g_acc), tree_leaves(g)):
        a.add_(b)            # float32 accumulators, our own
    return loss_sum + loss, g_acc


def finish_grads(carry, n: int) -> tuple:
    """``(loss, grads)`` averaged over ``n`` microbatches."""
    loss, grads = carry
    if n == 1:
        return loss, grads
    inv = 1.0 / n
    for _, a in tree_leaves(grads):
        a.mul_(inv)
    return loss * inv, grads


def update_step(params, opt_state, loss, grads, ocfg: OptimConfig):
    """The AdamW update (global-norm clip first) from averaged grads;
    ``(params, opt_state, stats)`` with the loss in ``stats``."""
    params, opt_state, stats = apply_updates(params, grads, opt_state,
                                             ocfg, decay_mask(params))
    stats["loss"] = loss
    return params, opt_state, stats


def make_grads_fn(cfg: ModelConfig, tcfg: TrainConfig, loss_fn=None):
    """(params, batch) -> (loss, grads); microbatched, float32
    accumulation (one microbatch: the grads in the params' dtypes)."""
    loss_fn = loss_fn or make_loss_fn(cfg)
    n = tcfg.microbatches

    def grads_fn(params, batch):
        carry = grad_carry(params, n)
        for mb in [batch] if n == 1 else _split_micro(batch, n):
            carry = microbatch_step(carry, loss_fn, params, mb)
        return finish_grads(carry, n)

    return grads_fn


def make_train_step(cfg: ModelConfig, ocfg: OptimConfig, tcfg: TrainConfig,
                    loss_fn=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, stats)`` with stats ``loss``, ``grad_norm``, ``lr`` and
    ``step`` (tensors)."""
    _check_single_device(tcfg)
    grads_fn = make_grads_fn(cfg, tcfg, loss_fn)

    def train_step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        return update_step(params, opt_state, loss, grads, ocfg)

    return train_step


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------

class StragglerWatchdog:
    """Flags steps slower than ``factor`` x running median."""

    def __init__(self, factor: float = 2.0, window: int = 50):
        self.factor = factor
        self.times: list = []
        self.window = window
        self.flagged: list = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and dt > self.factor * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow


class Trainer:
    """Single-device trainer on ``device`` (``None``: the card; raises
    without one unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, ocfg: OptimConfig,
                 tcfg: TrainConfig, *, device=None):
        _check_single_device(tcfg)
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.device = resolve_device(device)
        self.watchdog = StragglerWatchdog(tcfg.straggler_factor)
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        self.metrics_log: list = []

    def init_state(self, seed: int = 0):
        params = init_lm(self.cfg, seed=seed, device=self.device)
        return params, init_opt_state(params, self.ocfg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, data_cfg: DataConfig | None = None,
            steps: int | None = None, params=None, opt_state=None,
            log=print):
        """Train to step ``steps`` (``tcfg.steps``); returns ``(params,
        opt_state)``.  Without ``params`` it resumes from the latest
        checkpoint under ``tcfg.ckpt_dir``, or starts from ``init_state``;
        given ``params`` without ``opt_state``, fresh moments."""
        cfg, tcfg = self.cfg, self.tcfg
        steps = steps or tcfg.steps
        data_cfg = data_cfg or DataConfig(vocab=cfg.vocab, seq_len=256,
                                          global_batch=8)
        corpus = SyntheticCorpus(data_cfg)

        start = 0
        if params is None:
            if latest_step(tcfg.ckpt_dir) is not None:
                state, manifest = restore(tcfg.ckpt_dir, device=self.device)
                params, opt_state = state["params"], state["opt"]
                opt_state["step"] = opt_state["step"].to(
                    torch.int32).reshape(())
                start = int(manifest["step"])
                log(f"[trainer] resumed from step {start}")
            else:
                params, opt_state = self.init_state()
        elif opt_state is None:
            opt_state = init_opt_state(params, self.ocfg)

        step_fn = make_train_step(cfg, self.ocfg, tcfg)
        for step in range(start, steps):
            batch = device_put_batch(corpus.batch_at(step), self.device)
            t0 = time.perf_counter()
            params, opt_state, stats = step_fn(params, opt_state, batch)
            stats = {k: float(v) for k, v in stats.items()}
            self._sync()
            dt = time.perf_counter() - t0
            slow = self.watchdog.record(step, dt)
            self.metrics_log.append({**stats, "step": step, "dt": dt})
            if step % tcfg.log_every == 0 or slow:
                tag = " STRAGGLER" if slow else ""
                log(f"[trainer] step {step} loss {stats['loss']:.4f} "
                    f"gnorm {stats['grad_norm']:.3f} {dt*1e3:.0f}ms{tag}")
            if tcfg.save_every and (step + 1) % tcfg.save_every == 0:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state})
        self.ckpt.wait()
        return params, opt_state
