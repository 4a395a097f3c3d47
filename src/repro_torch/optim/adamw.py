"""AdamW with gradient clipping, schedules and a weight-decay mask (port
of ``repro/optim/adamw.py``).

State = ``{"m", "v", "step"}``: ``m`` and ``v`` mirror the params tree
(dicts and ``QuantState``s, the states' ``spec`` and ``name`` kept, as
``jax.tree.map`` keeps them) in float32, ``step`` an int32 scalar.
Quantizer scales (LSQ alphas ``aw``/``ax``, PO2 log-alphas ``ap``) and
norm params are kept out of weight decay by their path names, as in the
JAX package.  Params are updated in float32 and cast back to their dtype.

``adafactor_like=True`` factors the second moment of each 2-D+ param
into row and column statistics over its last two dims (O(m+n) memory in
place of O(mn)); a MoE bank ``[E, K, N]`` keeps ``[E, K]`` rows and
``[E, N]`` columns, one factorisation per expert, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.model import tree_leaves, tree_map

NO_DECAY_KEYS = ("scale", "bias", "ln", "norm", "ax", "aw", "ap", "mu",
                 "u", "w0", "lam", "gate_a_b", "gate_x_b")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    adafactor_like: bool = False


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr`` (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def decay_mask(params) -> dict:
    """True where weight decay applies: 2-D+ weights whose path names no
    scale, norm or quantizer (``NO_DECAY_KEYS``)."""
    return tree_map(lambda path, leaf: (
        not any(str(n) in NO_DECAY_KEYS for n in path) and leaf.dim() >= 2),
        params)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def init_opt_state(params, cfg: OptimConfig) -> dict:
    m = tree_map(lambda _, p: _zeros_f32(p), params)
    if cfg.adafactor_like:
        def v_init(_, p):
            if _factored(p.shape):
                return {"row": _zeros_f32(p, p.shape[:-1]),
                        "col": _zeros_f32(p, p.shape[:-2] + p.shape[-1:])}
            return {"full": _zeros_f32(p)}
        v = tree_map(v_init, params)
    else:
        v = tree_map(lambda _, p: _zeros_f32(p), params)
    device = tree_leaves(params)[0][1].device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def _at(tree, path):
    """The node at ``path`` (dict keys and state field names)."""
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def _second_moment_value(v: dict) -> torch.Tensor:
    if "full" in v:
        return v["full"]
    row, col = v["row"], v["col"]
    denom = torch.clamp(row.mean(dim=-1, keepdim=True), min=1e-30)
    return row[..., None] * col[..., None, :] / denom[..., None]


def apply_updates(params, grads, state: dict, cfg: OptimConfig,
                  mask=None) -> tuple:
    """One AdamW step.  Returns ``(new_params, new_state, stats)`` with
    stats ``lr``, ``grad_norm`` and ``step`` (tensors)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    if mask is None:
        mask = decay_mask(params)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    # one param at a time (the JAX package maps tree by tree; every op is
    # elementwise within a param, so the values are the same and only
    # one param's temporaries are alive at once)
    new = {}

    def upd(path, p, g, m, use_wd):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = _at(state["v"], path)
        if cfg.adafactor_like:
            g2 = torch.square(g)
            if "full" in v:
                v = {"full": b2 * v["full"] + (1 - b2) * g2}
            else:
                v = {"row": b2 * v["row"] + (1 - b2) * g2.mean(dim=-1),
                     "col": b2 * v["col"] + (1 - b2) * g2.mean(dim=-2)}
            vh = _second_moment_value(v) / bc2
        else:
            v = b2 * v + (1 - b2) * torch.square(g)
            vh = v / bc2
        u = (m / bc1) / (torch.sqrt(vh) + cfg.eps)
        if use_wd:
            u = u + cfg.weight_decay * p.float()
        new[path] = (m, v)
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, grads, state["m"], mask)
    new_m = tree_map(lambda path, _: new[path][0], params)
    new_v = tree_map(lambda path, _: new[path][1], params)
    stats = {"lr": lr, "grad_norm": gnorm, "step": step}
    return new_params, {"m": new_m, "v": new_v, "step": step}, stats
