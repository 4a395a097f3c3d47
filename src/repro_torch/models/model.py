"""LM assembly (port of ``repro/models/model.py``: attention,
sliding-window ``local`` attention, RWKV-6 and RG-LRU layers with a
SwiGLU, GELU, MoE or RWKV channel mix; decoder-only, or an
encoder-decoder with cross-attention; modality stubs).

Params are nested dicts: ``{"embed": {"table"}, "units": {"u0": {"0":
layer}, ...}, "rem": {"0": layer, ...}, "final_norm": {"scale"}, "head":
{"w"}}``; LayerNorms add a ``bias``, and a tied head has no ``head``
entry: the logits GEMM runs over the embedding table, quantized through
``embed.qp_head`` once ``calibrate_model`` has made one.  An
encoder-decoder (``cfg.encdec``) adds ``"encoder": {"units": {"u<i>":
{"<j>": layer}}, "final_norm"}`` (``n_enc_layers`` layers named
``encoder.unit.<j>``, no cross-attention) and gives every decoder layer
``lnx`` and ``xattn``, a cross-attention over the encoder's output.  A
vision stub (``cfg.frontend == "vision"``) adds ``frontend_proj``, a
float linear that projects patch embeddings to be prepended to the
tokens; an audio stub's frame embeddings feed the encoder as they are.
``n_units`` repeats of ``cfg.block_pattern`` are followed by ``n_rem``
remainder layers (the pattern's first kinds, applied after the units, named
``rem.<i>``; only present when ``n_layers`` is not a multiple of the
pattern).  The JAX package stacks units along a leading axis for
``lax.scan`` when ``cfg.scan_layers`` is set; the port always keeps one
entry per unit and loops over them (``checkpoint.convert`` unstacks a
JAX tree), which is the same computation.  Layer names follow the JAX
package (``unit.<pattern position>.mix.wq`` ...), so policies resolve
the same.

Entry points: ``init_lm``, ``forward`` (full sequence; calibration and
training, each unit under activation checkpointing when ``cfg.remat``),
``encode`` (the encoder over frame embeddings), ``lm_loss``,
``init_decode_state`` / ``decode_step`` (the dense ``ServingEngine``'s
float KV caches, a ring buffer for ``local`` layers; an encoder-decoder
passes ``enc_out`` and recomputes the cross-attention's K/V from it at
every step, as the reference does), ``forward_paged_chunk`` /
``decode_step_paged`` (serving over the paged INT8 KV cache; recurrent
layers carry per-slot states) and
``decode_horizon`` / ``decode_horizon_paged`` (H decode steps, greedy or
sampled by ``sample_tokens``, with per-slot EOS / budget masking, a
Python loop in place of ``lax.scan``).  ``tree_map``
/ ``tree_leaves`` walk a params tree (nested dicts and ``QuantState``s),
in one order: the optimizer and the checkpoint writer share them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import (DeployedQuantState, QuantState, deployed_dense,
                              quant_dense, tied_head_weight)
from repro_torch.device import resolve_device
from .attention import attention_block, init_attention
from .common import (Params, apply_mlp, apply_norm, dense, embed,
                     init_embedding, init_linear, init_mlp, init_norm,
                     matmul, row_blocks)
from .config import ModelConfig
from .moe import init_moe, moe_ffn
from .rglru import init_rglru_block, init_rglru_state, rglru_block
from .rwkv import (init_rwkv_channel_mix, init_rwkv_state,
                   init_rwkv_time_mix, rwkv_channel_mix, rwkv_time_mix)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _init_ffn(gen, cfg: ModelConfig, *, device, name: str) -> Params:
    dt, quant = cfg.torch_dtype, cfg.policy
    if cfg.mlp == "moe":
        return init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                        dt, device=device, quant=quant, name=name)
    if cfg.mlp == "rwkv_cm":
        return init_rwkv_channel_mix(gen, cfg.d_model, cfg.d_ff, dt,
                                     device=device, quant=quant, name=name)
    return init_mlp(gen, cfg.d_model, cfg.d_ff, dt, cfg.mlp, device=device,
                    quant=quant, name=name)


def init_layer(gen, cfg: ModelConfig, kind: str, *, device,
               cross: bool = False, name: str = "unit.0") -> Params:
    """One layer's params; ``cross`` adds the cross-attention (``lnx``,
    ``xattn``) of an encoder-decoder's decoder."""
    dt, quant = cfg.torch_dtype, cfg.policy
    kw = dict(device=device, quant=quant, name=f"{name}.mix")
    p = {"ln1": init_norm(cfg.d_model, dt, cfg.norm, device=device),
         "ln2": init_norm(cfg.d_model, dt, cfg.norm, device=device)}
    if kind in ("attn", "local"):
        p["mix"] = init_attention(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd, dt, **kw)
    elif kind == "rwkv":
        p["mix"] = init_rwkv_time_mix(gen, cfg.d_model, cfg.n_heads, cfg.hd,
                                      dt, **kw)
    elif kind == "rglru":
        p["mix"] = init_rglru_block(gen, cfg.d_model, cfg.d_rnn, dt, **kw)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    p["ffn"] = _init_ffn(gen, cfg, device=device, name=f"{name}.ffn")
    if cross:
        p["lnx"] = init_norm(cfg.d_model, dt, cfg.norm, device=device)
        p["xattn"] = init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, dt, device=device,
                                    quant=quant, name=f"{name}.xattn")
    return p


def _init_units(gen, cfg: ModelConfig, n: int, *, device, cross: bool,
                name: str) -> Params:
    return {f"u{i}": {str(j): init_layer(gen, cfg, kind, device=device,
                                         cross=cross, name=f"{name}.{j}")
                      for j, kind in enumerate(cfg.block_pattern)}
            for i in range(n)}


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random params from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (fan-in normal weights, unit norms; the global RNG is not
    touched), with ``QuantState`` leaves where ``cfg.policy`` quantizes a
    linear.  A tied head gets no ``head``: its quantizer state comes
    from ``calibrate_model``, as in the JAX package.  The float
    ``head`` and ``frontend_proj`` are never quantized."""
    cfg.validate().check_ported()
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.torch_dtype
    cross = cfg.encdec
    p = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                device=device),
        "units": _init_units(gen, cfg, cfg.n_units, device=device,
                             cross=cross, name="unit"),
    }
    if cfg.n_rem:
        p["rem"] = {str(i): init_layer(gen, cfg, cfg.block_pattern[i],
                                       device=device, cross=cross,
                                       name=f"rem.{i}")
                    for i in range(cfg.n_rem)}
    p["final_norm"] = init_norm(cfg.d_model, dt, cfg.norm, device=device)
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, (cfg.d_model, cfg.vocab), dt,
                                device=device)
    if cfg.encdec:
        p["encoder"] = {
            "units": _init_units(
                gen, cfg, cfg.n_enc_layers // len(cfg.block_pattern),
                device=device, cross=False, name="encoder.unit"),
            "final_norm": init_norm(cfg.d_model, dt, cfg.norm,
                                    device=device)}
    if cfg.frontend == "vision":
        p["frontend_proj"] = init_linear(gen, (cfg.d_model, cfg.d_model), dt,
                                         device=device)
    return p


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def apply_layer(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
                kind: str, state: Params | None = None, pos=0,
                enc_out: torch.Tensor | None = None, causal: bool = True,
                tap: list | None = None, backend=None, page_table=None):
    """One pre-norm block of ``kind`` (time mix, then, in a layer with
    ``xattn`` given ``enc_out``, the cross-attention, then channel mix);
    returns (x, new_state).  ``causal`` False: the encoder's attention.
    ``state`` is None for a full sequence
    (calibration, training: the new state is then the attention K/V or
    the recurrent state), else the layer's serving state: paged with
    ``page_table``, else the dense engine's (one token per slot).  A
    multi-token chunk against paged state (``page_table`` set, S > 1)
    runs the recurrences one token at a time (rwkv ``impl="scan"``,
    rglru ``exact_scan``), as the per-token decode does.  Against the
    dense state an MoE channel mix routes each slot alone (capacity from
    its one token), as the reference's per-slot ``vmap`` does."""
    exact = page_table is not None and x.shape[1] > 1
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind in ("attn", "local"):
        out, new_state = attention_block(
            p["mix"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_fraction=cfg.rope_fraction,
            rope_theta=cfg.rope_theta,
            causal=causal,
            window=cfg.local_window if kind == "local" else None,
            softcap=cfg.softcap, cache=state, pos=pos, tap=tap,
            backend=backend, page_table=page_table)
    elif kind == "rwkv":
        out, tm = rwkv_time_mix(
            p["mix"], h, n_heads=cfg.n_heads, head_dim=cfg.hd,
            impl="scan" if exact else cfg.wkv_impl, wkv_chunk=cfg.wkv_chunk,
            state=state["tm"] if state is not None else None, tap=tap,
            backend=backend)
        new_state = {"tm": tm}
    elif kind == "rglru":
        out, rec = rglru_block(
            p["mix"], h, state=state["rec"] if state is not None else None,
            tap=tap, backend=backend, exact_scan=exact)
        new_state = {"rec": rec}
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    x = x + out
    if "xattn" in p and enc_out is not None:
        outx, _ = attention_block(
            p["xattn"], apply_norm(p["lnx"], x, cfg.norm),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            xkv=enc_out, use_rope=False, tap=tap, backend=backend)
        x = x + outx
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    if cfg.mlp == "moe":
        per_slot = state is not None and page_table is None
        y = moe_ffn(p["ffn"], h2, n_experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor, tap=tap,
                    backend=backend, groups=x.shape[0] if per_slot else 1)
    elif cfg.mlp == "rwkv_cm":
        y, cm = rwkv_channel_mix(
            p["ffn"], h2,
            state=state.get("cm") if state is not None else None,
            tap=tap, backend=backend)
        if state is not None:
            new_state["cm"] = cm
    else:
        y = apply_mlp(p["ffn"], h2, cfg.mlp, tap=tap, backend=backend)
    # an RWKV layer always carries the channel mix's shift in decode
    if kind == "rwkv" and state is not None and "cm" not in new_state:
        new_state["cm"] = {"shift": h2[:, -1:]}
    return x + y, new_state


def apply_unit(p: Params, x, *, cfg: ModelConfig, state=None, pos=0,
               enc_out=None, causal: bool = True, tap: list | None = None,
               backend=None, page_table=None):
    new_state = {}
    for j, kind in enumerate(cfg.block_pattern):
        x, s = apply_layer(p[str(j)], x, cfg=cfg, kind=kind,
                           state=state[str(j)] if state is not None else None,
                           pos=pos, enc_out=enc_out, causal=causal, tap=tap,
                           backend=backend, page_table=page_table)
        new_state[str(j)] = s
    return x, new_state


def apply_rem(p: Params, x, *, cfg: ModelConfig, state=None, pos=0,
              enc_out=None, tap: list | None = None, backend=None,
              page_table=None):
    """The ``n_rem`` remainder layers after the units; their states sit
    at ``state["rem<i>"]``.  Returns (x, {"rem<i>": new state})."""
    new_state = {}
    for i in range(cfg.n_rem):
        x, new_state[f"rem{i}"] = apply_layer(
            p["rem"][str(i)], x, cfg=cfg, kind=cfg.block_pattern[i],
            state=state[f"rem{i}"] if state is not None else None, pos=pos,
            enc_out=enc_out, tap=tap, backend=backend, page_table=page_table)
    return x, new_state


def embed_inputs(p: Params, cfg: ModelConfig, tokens: torch.Tensor | None,
                 embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embedding, with a vision stub's patch embeddings ``embeds``
    [B, n_img, d] projected by ``frontend_proj`` (in the model dtype) and
    prepended: [B, n_img + S, d].  An audio stub's frames go to
    ``encode``, not here."""
    parts = []
    if embeds is not None and cfg.frontend == "vision":
        parts.append(dense(p["frontend_proj"], embeds.to(cfg.torch_dtype)))
    if tokens is not None:
        parts.append(embed(p["embed"], tokens))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


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
    return matmul(x, table.T)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant), the port of
    the JAX package's ``_remat``: ``remat_policy="none"`` saves nothing
    and recomputes the unit in the backward pass; ``"dots"`` saves the
    matrix products' outputs (``checkpoint_dots``) and recomputes the
    rest."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat_policy == "dots":
        aten = torch.ops.aten
        dots = (aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default)

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in dots
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_units(units: Params, x: torch.Tensor, *, cfg: ModelConfig, pos,
               enc_out, causal: bool, tap: list | None, backend):
    """The units in order.  With ``cfg.remat`` and autograd recording,
    each runs under activation checkpointing (``_remat``); the values
    are the same either way.  A capture ``tap`` runs each once,
    unwrapped."""
    remat = cfg.remat and tap is None and torch.is_grad_enabled()
    for i in range(len(units)):
        def unit(h, _p=units[f"u{i}"]):
            return apply_unit(_p, h, cfg=cfg, pos=pos, enc_out=enc_out,
                              causal=causal, tap=tap, backend=backend)[0]
        x = _remat(unit, cfg)(x) if remat else unit(x)
    return x


def encode(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
           backend=None) -> torch.Tensor:
    """The encoder over frame embeddings [B, S_enc, d] (the audio stub):
    its units without the causal mask (RoPE from position 0), then its
    final norm; returns ``enc_out`` [B, S_enc, d] in the model dtype."""
    x = _run_units(p["encoder"]["units"], enc_embeds.to(cfg.torch_dtype),
                   cfg=cfg, pos=0, enc_out=None, causal=False, tap=None,
                   backend=backend)
    return apply_norm(p["encoder"]["final_norm"], x, cfg.norm)


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor | None, *,
            embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None, pos=0,
            tap: list | None = None, backend=None) -> torch.Tensor:
    """Full-sequence causal forward; returns logits [B, S_out, V]:
    S_out = n_img + S with a vision stub's ``embeds`` [B, n_img, d]
    (prepended), S otherwise.  An encoder-decoder needs ``enc_embeds``
    [B, S_enc, d]: ``encode`` runs first (the ``tap`` does not reach
    it; ``calibrate_model`` captures the encoder apart), and every
    decoder layer cross-attends to its output."""
    enc_out = None
    if cfg.encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "enc_embeds")
        enc_out = encode(p, cfg, enc_embeds, backend=backend)
    x = embed_inputs(p, cfg, tokens, embeds)
    x = _run_units(p["units"], x, cfg=cfg, pos=pos, enc_out=enc_out,
                   causal=True, tap=tap, backend=backend)
    x, _ = apply_rem(p, x, cfg=cfg, pos=pos, enc_out=enc_out, tap=tap,
                     backend=backend)
    return logits_from_hidden(p, cfg, x, backend=backend)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None,
            z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy in fp32 (+ optional z-loss).

    logits [B, S, V]; labels [B, S] int; mask [B, S] (1 = contributes)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Dense decode (the ``ServingEngine``'s float KV caches)
# ---------------------------------------------------------------------------

def init_layer_state(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, *, device) -> Params:
    """Fresh dense decode state of one layer: float K/V caches [batch,
    cache_len, Hkv, hd] (a ``local`` layer: a ring of ``min(local_window,
    cache_len)`` slots), a recurrent layer's zero states."""
    dt = cfg.torch_dtype
    if kind in ("attn", "local"):
        n = min(cfg.local_window, cache_len) if kind == "local" else cache_len
        shape = (batch, n, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "rwkv":
        return init_rwkv_state(batch, cfg.d_model, cfg.n_heads, cfg.hd, dt,
                               device=device)
    if kind == "rglru":
        return {"rec": init_rglru_state(batch, cfg.d_rnn, dt,
                                        device=device)}
    raise ValueError(kind)


def _init_state(cfg: ModelConfig, layer) -> Params:
    """``{"units": {"u<i>": {position: layer(kind)}}, "rem<i>": ...}``."""
    state = {"units": {f"u{i}": {str(j): layer(kind)
                                 for j, kind in enumerate(cfg.block_pattern)}
                       for i in range(cfg.n_units)}}
    for i in range(cfg.n_rem):
        state[f"rem{i}"] = layer(cfg.block_pattern[i])
    return state


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device=None) -> Params:
    """The whole model's dense decode state (``init_layer_state`` per
    layer, units unstacked)."""
    device = resolve_device(device)
    return _init_state(cfg, lambda kind: init_layer_state(
        cfg, kind, batch, cache_len, device=device))


def _serve_step(p: Params, cfg: ModelConfig, state: Params,
                tokens: torch.Tensor, pos, page_table, backend,
                enc_out=None):
    """tokens [B, S] against a serving state (dense, or paged with
    ``page_table``; ``enc_out`` for an encoder-decoder's
    cross-attention); returns (logits [B, 1, V] of the last row,
    new_state).  A model with recurrent layers, and an encoder-decoder,
    runs its float GEMMs and norms in fixed blocks
    (``common.row_blocks``), so a token's values do not depend on the
    chunk or the batch it rides in.  For an encoder-decoder on an H100
    both round by the row count otherwise (``scripts/
    encdec_batch_rows.py``): the float head [M, 1024] @ [1024, 256206]
    at M = 1, 2, 3 against M = 8, and a decode step's LayerNorm on some
    rows; its attention and its encoder do not."""
    with row_blocks(cfg.recurrent or cfg.encdec):
        x = embed_inputs(p, cfg, tokens)
        new_units = {}
        for i in range(len(p["units"])):
            key = f"u{i}"
            x, new_units[key] = apply_unit(
                p["units"][key], x, cfg=cfg, state=state["units"][key],
                pos=pos, enc_out=enc_out, backend=backend,
                page_table=page_table)
        x, new_rem = apply_rem(p, x, cfg=cfg, state=state, pos=pos,
                               enc_out=enc_out, backend=backend,
                               page_table=page_table)
        logits = logits_from_hidden(p, cfg, x[:, -1:], backend=backend)
    return logits, {**state, "units": new_units, **new_rem}


def decode_step(p: Params, cfg: ModelConfig, state: Params,
                token: torch.Tensor, pos, *,
                enc_out: torch.Tensor | None = None, backend=None):
    """One decode step against the dense state: token [B, 1] at ``pos``
    (a scalar, or a per-slot [B] vector: the reference ``vmap``s a
    batch-1 step over the slots, the port batches them; the fixed blocks
    make the per-token prefill at B = 1 and the decode at B = slots
    round alike).  An encoder-decoder passes ``enc_out`` [B, S_enc, d]
    (``encode``'s): each layer's cross-attention projects its K/V from
    it again at every step, as the reference does.  Returns (logits
    [B, 1, V], new_state)."""
    return _serve_step(p, cfg, state, token, pos, None, backend,
                       enc_out=enc_out)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def init_paged_layer_state(cfg: ModelConfig, kind: str, batch: int,
                           page_size: int, n_pages: int, *, device) -> Params:
    """Fresh paged state of one layer: an attention layer's shared INT8
    page pools + per-(slot, kv-head) running exponents, a recurrent
    layer's per-slot states (zeros).  A ``local`` layer is refused, as
    in the reference."""
    from repro_torch.serving.paged_cache import EXP_FLOOR
    if kind == "local":
        raise NotImplementedError(
            "paged serving does not cover local-attention layers yet")
    if kind == "attn":
        shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
        return {"k_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "k_exp": torch.full((batch, cfg.n_kv_heads), EXP_FLOOR,
                                    dtype=torch.int32, device=device),
                "v_exp": torch.full((batch, cfg.n_kv_heads), EXP_FLOOR,
                                    dtype=torch.int32, device=device)}
    return init_layer_state(cfg, kind, batch, cache_len=1, device=device)


def init_paged_decode_state(cfg: ModelConfig, batch: int, *, page_size: int,
                            n_pages: int, device=None) -> Params:
    """``{"units": {"u<i>": {position: layer state}}, "rem<i>": layer
    state}``."""
    device = resolve_device(device)
    return _init_state(cfg, lambda kind: init_paged_layer_state(
        cfg, kind, batch, page_size, n_pages, device=device))


def forward_paged_chunk(p: Params, cfg: ModelConfig, state: Params,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        page_table: torch.Tensor, *, backend=None):
    """One prefill chunk (or decode step, C=1) over the paged INT8 cache.

    tokens [B, C] whose first token sits at per-slot position ``pos``
    [B]; page_table [B, n_max].  Returns (logits [B, 1, V] of the LAST
    chunk row, new_state); a recurrent model's float ops run in fixed
    row blocks (``_serve_step``)."""
    return _serve_step(p, cfg, state, tokens, pos, page_table, backend)


def decode_step_paged(p: Params, cfg: ModelConfig, state: Params,
                      token: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, *, backend=None):
    """One decode step: ``forward_paged_chunk`` with a chunk of one."""
    return forward_paged_chunk(p, cfg, state, token, pos, page_table,
                               backend=backend)


# ---------------------------------------------------------------------------
# State-tree slot axes and the fused decode horizon
# ---------------------------------------------------------------------------

_META_FIELDS = ("spec", "name", "out_dims")    # static, as in JAX's pytree


def _data_fields(state) -> list:
    """A quantizer state's data fields that hold a value (an ``ap`` that
    is None is no leaf): its pytree leaves, in field order."""
    return [f.name for f in dataclasses.fields(state)
            if f.name not in _META_FIELDS
            and getattr(state, f.name) is not None]


def tree_map(f, *trees, path=()):
    """Map over nested dicts of tensors and quantizer states; ``f(path,
    *leaves)`` with ``path`` the tuple of dict keys and state field names.
    A ``QuantState`` (or ``DeployedQuantState``) maps to one of its kind
    with the first tree's ``spec`` and ``name`` (an ``ap`` that is None
    stays None), as ``jax.tree.map`` maps the JAX package's registered
    dataclasses."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees), path=path + (k,))
                for k in t0}
    if isinstance(t0, (QuantState, DeployedQuantState)):
        return dataclasses.replace(t0, **{
            k: tree_map(f, *(getattr(t, k) for t in trees), path=path + (k,))
            for k in _data_fields(t0)})
    return f(path, *trees)


def tree_leaves(tree, path=(), nodes: dict | None = None) -> list:
    """``[(path, leaf), ...]`` in ``tree_map``'s order.  ``nodes``, when
    given, also receives ``{path: state}`` for every quantizer state met
    (the checkpoint's ``quant_states``)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in tree_leaves(v, path + (k,), nodes)]
    if isinstance(tree, (QuantState, DeployedQuantState)):
        if nodes is not None:
            nodes[path] = tree
        return [kv for k in _data_fields(tree)
                for kv in tree_leaves(getattr(tree, k), path + (k,), nodes)]
    return [(path, tree)]


def batch_state_axes(state: Params) -> Params:
    """Per-leaf slot axis of a dense decode state: 0 everywhere (the
    port never stacks units)."""
    return tree_map(lambda path, a: 0, state)


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


def sample_tokens(logits: torch.Tensor, *, greedy: bool = True,
                  temperature: float = 1.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Next tokens [B] int32 from logits [B, V]: ``argmax`` when
    ``greedy``; else ``argmax(logits / max(T, 1e-6) + G)`` with G Gumbel
    noise from one [B, V] uniform draw of ``generator``, a sample of
    ``softmax(logits / T)`` (the method of ``jax.random.categorical``,
    not its bits)."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / max(temperature, 1e-6) + gumbel,
                        dim=-1).to(torch.int32)


def decode_horizon(step, state: Params, tokens: torch.Tensor,
                   pos: torch.Tensor, *, horizon: int, active: torch.Tensor,
                   budget: torch.Tensor, remaining: torch.Tensor,
                   eos: torch.Tensor, greedy: bool = True,
                   temperature: float = 1.0,
                   generator: torch.Generator | None = None):
    """``horizon`` decode steps with per-slot masking, a Python loop in
    place of the reference's ``lax.scan``.  ``step(state, tokens [B, 1],
    pos [B], on [B]) -> (logits [B, 1, V], state)``.

    Step t runs every slot and picks each one's next token (one
    ``sample_tokens`` call, so a sampled step draws [B, V] whatever the
    slots do, and H fused steps consume what H single steps would); a
    slot that is inactive, out of ``budget`` steps, has hit ``eos`` or has
    no ``remaining`` tokens is fed token 0 and keeps its position.
    Returns (tok_block [B, horizon], emitted [B, horizon] prefix mask,
    new_state, new_pos)."""
    st, tok, ps = state, tokens, pos.to(torch.int32)
    act, bud, rem = active.clone(), budget.to(torch.int32), \
        remaining.to(torch.int32)
    toks, ons = [], []
    for _ in range(horizon):
        on = act & (bud > 0)
        lg, st = step(st, tok, ps, on)
        nxt = sample_tokens(lg[:, -1], greedy=greedy,
                            temperature=temperature, generator=generator)
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


def decode_horizon_paged(p: Params, cfg: ModelConfig, state: Params,
                         tokens: torch.Tensor, pos: torch.Tensor,
                         page_table: torch.Tensor, *, horizon: int,
                         active: torch.Tensor, budget: torch.Tensor,
                         remaining: torch.Tensor, eos: torch.Tensor,
                         greedy: bool = True, temperature: float = 1.0,
                         generator: torch.Generator | None = None,
                         backend=None):
    """``decode_horizon`` over ``decode_step_paged``: a slot masked at a
    step gets a zeroed table row (null-page writes) and its per-slot
    leaves reverted, so ``horizon`` fused steps are bit-identical to
    ``horizon`` single ``decode_step_paged`` calls with the same masking.

    Returns (tok_block [B, horizon], emitted [B, horizon] prefix mask,
    new_state, new_pos).
    """
    from repro_torch.serving.paged_cache import NULL_PAGE
    axes = paged_state_axes(state)

    def step(st, tok, ps, on):
        tbl = torch.where(on[:, None], page_table,
                          torch.full_like(page_table, NULL_PAGE))
        lg, st2 = decode_step_paged(p, cfg, st, tok, ps, tbl,
                                    backend=backend)
        return lg, tree_map(lambda _, o, n, ax: _keep_slots(o, n, ax, on),
                            st, st2, axes)

    return decode_horizon(step, state, tokens, pos, horizon=horizon,
                          active=active, budget=budget, remaining=remaining,
                          eos=eos, greedy=greedy, temperature=temperature,
                          generator=generator)
