"""Decoder-only LM assembly (port of ``repro/models/model.py``: attention
layers with a SwiGLU, GELU or MoE channel mix).

Params are nested dicts: ``{"embed": {"table"}, "units": {"u0": {"0":
layer}, ...}, "final_norm": {"scale"}, "head": {"w"}}``; LayerNorms add
a ``bias``, and a tied head has no ``head`` entry: the logits GEMM runs
over the embedding table, quantized through ``embed.qp_head`` once
``calibrate_model`` has made one.  The JAX
package stacks units along a leading axis for ``lax.scan`` when
``cfg.scan_layers`` is set; the port always keeps one entry per unit and
loops over them (``checkpoint.convert`` unstacks a JAX tree), which is
the same computation.  Layer names follow the JAX package
(``unit.<pattern position>.mix.wq`` ...), so policies resolve the same.

Entry points: ``init_lm``, ``forward`` (full sequence; calibration),
``forward_paged_chunk`` / ``decode_step_paged`` (serving over the paged
INT8 KV cache) and ``decode_horizon_paged`` (H greedy decode steps with
per-slot EOS / budget masking, a Python loop in place of ``lax.scan``).
"""
from __future__ import annotations

import torch

from repro_torch.core import (DeployedQuantState, QuantState, deployed_dense,
                              quant_dense, tied_head_weight)
from repro_torch.device import resolve_device
from .attention import attention_block, init_attention
from .common import (Params, apply_mlp, apply_norm, dense, embed,
                     init_embedding, init_linear, init_mlp, init_norm)
from .config import ModelConfig
from .moe import init_moe, moe_ffn


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, kind: str, *, device,
               name: str = "unit.0") -> Params:
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    dt, quant = cfg.torch_dtype, cfg.policy
    p = {"ln1": init_norm(cfg.d_model, dt, cfg.norm, device=device),
         "ln2": init_norm(cfg.d_model, dt, cfg.norm, device=device),
         "mix": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, dt, device=device, quant=quant,
                               name=f"{name}.mix")}
    if cfg.mlp == "moe":
        p["ffn"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.top_k, dt, device=device, quant=quant,
                            name=f"{name}.ffn")
    else:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, cfg.mlp,
                            device=device, quant=quant, name=f"{name}.ffn")
    return p


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (fan-in normal weights, unit norms; the global RNG is not
    touched), with ``QuantState`` leaves where ``cfg.policy`` quantizes a
    linear.  A tied head gets no ``head``: its quantizer state comes
    from ``calibrate_model``, as in the JAX package."""
    cfg.validate().check_ported()
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.torch_dtype
    p = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                device=device),
        "units": {f"u{i}": {str(j): init_layer(gen, cfg, kind, device=device,
                                               name=f"unit.{j}")
                            for j, kind in enumerate(cfg.block_pattern)}
                  for i in range(cfg.n_units)},
        "final_norm": init_norm(cfg.d_model, dt, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, (cfg.d_model, cfg.vocab), dt,
                                device=device)
    return p


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def apply_layer(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
                state: Params | None = None, pos=0,
                tap: list | None = None, backend=None, page_table=None):
    """One pre-norm attention + SwiGLU/MoE block; returns (x, new_state)."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    out, kv = attention_block(
        p["mix"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_fraction=cfg.rope_fraction,
        rope_theta=cfg.rope_theta, cache=state, pos=pos, tap=tap,
        backend=backend, page_table=page_table)
    x = x + out
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    if cfg.mlp == "moe":
        y = moe_ffn(p["ffn"], h2, n_experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor, tap=tap,
                    backend=backend)
    else:
        y = apply_mlp(p["ffn"], h2, cfg.mlp, tap=tap, backend=backend)
    return x + y, kv


def apply_unit(p: Params, x, *, cfg: ModelConfig, state=None, pos=0,
               tap: list | None = None, backend=None, page_table=None):
    new_state = {}
    for j in range(len(cfg.block_pattern)):
        x, s = apply_layer(p[str(j)], x, cfg=cfg,
                           state=state[str(j)] if state is not None else None,
                           pos=pos, tap=tap, backend=backend,
                           page_table=page_table)
        new_state[str(j)] = s
    return x, new_state


def embed_inputs(p: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return embed(p["embed"], tokens)


def logits_from_hidden(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                       backend=None) -> torch.Tensor:
    """Final norm + the head.  Untied: ``dense`` on ``head``.  Tied: a
    deployed ``embed.qp_head`` runs the integer GEMM, a ``QuantState``
    fake-quantizes over ``tied_head_weight(table)``, and without one the
    head is ``x @ table.T``.  A float head is a plain ``torch.matmul`` in
    the model dtype: for a float32 model on the card the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default)."""
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if not cfg.tie_embeddings:
        return dense(p["head"], x, backend=backend)
    table = p["embed"]["table"]
    qp_head = p["embed"].get("qp_head")
    if isinstance(qp_head, DeployedQuantState):
        return deployed_dense(x, qp_head, backend=backend)
    if isinstance(qp_head, QuantState):
        return quant_dense(x, tied_head_weight(table), qp_head)
    return x @ table.T.to(x.dtype)


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *, pos=0,
            tap: list | None = None, backend=None) -> torch.Tensor:
    """Full-sequence causal forward; returns logits [B, S, V]."""
    x = embed_inputs(p, cfg, tokens)
    for i in range(len(p["units"])):
        x, _ = apply_unit(p["units"][f"u{i}"], x, cfg=cfg, pos=pos, tap=tap,
                          backend=backend)
    return logits_from_hidden(p, cfg, x, backend=backend)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def init_paged_layer_state(cfg: ModelConfig, kind: str, batch: int,
                           page_size: int, n_pages: int, *, device) -> Params:
    """Shared INT8 page pools + per-(slot, kv-head) running exponents."""
    from repro_torch.serving.paged_cache import EXP_FLOOR
    if kind != "attn":
        raise NotImplementedError(f"paged state for {kind!r} is not ported")
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_exp": torch.full((batch, cfg.n_kv_heads), EXP_FLOOR,
                                dtype=torch.int32, device=device),
            "v_exp": torch.full((batch, cfg.n_kv_heads), EXP_FLOOR,
                                dtype=torch.int32, device=device)}


def init_paged_decode_state(cfg: ModelConfig, batch: int, *, page_size: int,
                            n_pages: int, device=None) -> Params:
    device = resolve_device(device)
    return {"units": {
        f"u{i}": {str(j): init_paged_layer_state(cfg, kind, batch, page_size,
                                                 n_pages, device=device)
                  for j, kind in enumerate(cfg.block_pattern)}
        for i in range(cfg.n_units)}}


def forward_paged_chunk(p: Params, cfg: ModelConfig, state: Params,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        page_table: torch.Tensor, *, backend=None):
    """One prefill chunk (or decode step, C=1) over the paged INT8 cache.

    tokens [B, C] whose first token sits at per-slot position ``pos``
    [B]; page_table [B, n_max].  Returns (logits [B, 1, V] of the LAST
    chunk row, new_state)."""
    x = embed_inputs(p, cfg, tokens)
    new_units = {}
    for i in range(len(p["units"])):
        key = f"u{i}"
        x, new_units[key] = apply_unit(
            p["units"][key], x, cfg=cfg, state=state["units"][key], pos=pos,
            backend=backend, page_table=page_table)
    logits = logits_from_hidden(p, cfg, x[:, -1:], backend=backend)
    return logits, {**state, "units": new_units}


def decode_step_paged(p: Params, cfg: ModelConfig, state: Params,
                      token: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, *, backend=None):
    """One decode step: ``forward_paged_chunk`` with a chunk of one."""
    return forward_paged_chunk(p, cfg, state, token, pos, page_table,
                               backend=backend)


# ---------------------------------------------------------------------------
# State-tree slot axes and the fused decode horizon
# ---------------------------------------------------------------------------

def tree_map(f, *trees, path=()):
    """Map over nested dicts of tensors; ``f(path, *leaves)``."""
    if isinstance(trees[0], dict):
        return {k: tree_map(f, *(t[k] for t in trees), path=path + (k,))
                for k in trees[0]}
    return f(path, *trees)


def paged_state_axes(state: Params) -> Params:
    """Per-leaf slot axis of a paged state: -1 for the shared page pools,
    0 for per-slot leaves (the port never stacks units)."""
    return tree_map(lambda path, a: -1 if path[-1] in ("k_pages", "v_pages")
                    else 0, state)


def _keep_slots(old, new, ax: int, on: torch.Tensor):
    """Revert a state leaf to ``old`` for slots where ``on`` is False
    (``ax`` -1: a shared pool leaf, always new)."""
    if ax == -1:
        return new
    m = on.reshape((1,) * ax + (-1,) + (1,) * (new.dim() - ax - 1))
    return torch.where(m, new, old)


def decode_horizon_paged(p: Params, cfg: ModelConfig, state: Params,
                         tokens: torch.Tensor, pos: torch.Tensor,
                         page_table: torch.Tensor, *, horizon: int,
                         active: torch.Tensor, budget: torch.Tensor,
                         remaining: torch.Tensor, eos: torch.Tensor,
                         backend=None):
    """``horizon`` greedy decode steps with per-slot masking, as a Python
    loop (the JAX package's ``lax.scan``; its temperature sampling is not
    ported: greedy is what the cross-framework parity compares).

    Step t masks a slot (zeroed table row -> null-page writes, per-slot
    leaves reverted, token 0 fed, position frozen) once it is inactive,
    out of ``budget`` steps, has hit ``eos`` or has no ``remaining``
    tokens — bit-identical to ``horizon`` single ``decode_step_paged``
    calls with the same masking.

    Returns (tok_block [B, horizon], emitted [B, horizon] prefix mask,
    new_state, new_pos).
    """
    from repro_torch.serving.paged_cache import NULL_PAGE
    axes = paged_state_axes(state)
    st, tok, ps = state, tokens, pos.to(torch.int32)
    act, bud, rem = active.clone(), budget.to(torch.int32), \
        remaining.to(torch.int32)
    toks, ons = [], []
    for _ in range(horizon):
        on = act & (bud > 0)
        tbl = torch.where(on[:, None], page_table,
                          torch.full_like(page_table, NULL_PAGE))
        lg, st2 = decode_step_paged(p, cfg, st, tok, ps, tbl,
                                    backend=backend)
        st = tree_map(lambda _, o, n, ax: _keep_slots(o, n, ax, on),
                      st, st2, axes)
        nxt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        rem = torch.where(on, rem - 1, rem)
        fin = on & ((nxt == eos) | (rem <= 0))
        tok = torch.where(on, torch.where(fin, torch.zeros_like(nxt), nxt),
                          tok[:, 0])[:, None]
        ps = ps + on.to(ps.dtype)
        act = act & ~fin
        bud = bud - on.to(bud.dtype)
        toks.append(nxt)
        ons.append(on)
    return torch.stack(toks, 1), torch.stack(ons, 1), st, ps
