"""RWKV-6 "Finch" time and channel mixing (port of ``repro/models/rwkv.py``).

Token shift with a data-dependent lerp (``_ddlerp``: five static mixes
plus a shared LoRA), per-channel data-dependent decay
``w_t = exp(-exp(w0 + lora(x_w)))``, bonus ``u`` and the per-head WKV
state recurrence

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

then a per-head group norm, the gate ``silu(g)`` and ``wo``; the channel
mix is a squared ReLU under a sigmoid gate.  Two WKV forms, as in the
JAX package:

  * ``_wkv_scan``: one step per token (decode, and every paged prefill
    chunk, where it keeps the carried state equal to the per-token one);
  * ``_wkv_chunked``: chunks of C tokens, a [C, C] decay-weighted score
    inside a chunk and the state carried across chunks (calibration and
    training; under autograd each chunk recomputes in the backward pass,
    ``torch.utils.checkpoint`` standing for ``jax.checkpoint``).

The quantized projections are ``wr``, ``wk``, ``wv``, ``wg`` and ``wo``
of the time mix and ``wk`` and ``wv`` of the channel mix: they go through
``dense`` (fake quant, or the APSQ kernels once exported).  The LoRAs
(``mix_w1``/``mix_w2``, ``decay_w1``/``decay_w2``) and the channel mix's
``wr`` stay float.  The WKV state and ``log_w`` are float32 whatever the model's dtype,
where the JAX package casts them.  The JAX package's sharding hints
have no counterpart: the port runs on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, dense, init_linear, matmul

LORA_R = 64        # ddlerp LoRA rank
DECAY_LORA_R = 64  # decay LoRA rank


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_rwkv_time_mix(gen, d_model: int, n_heads: int, head_dim: int,
                       dtype, *, device, quant=None, name: str = "") -> Params:
    d_attn = n_heads * head_dim
    q = dict(device=device, quant=quant)

    def proj(key, shape):
        return init_linear(gen, shape, dtype, name=f"{name}.{key}", **q)

    return {
        "mu": torch.full((5, d_model), 0.5, dtype=dtype, device=device),
        "mix_w1": init_linear(gen, (d_model, 5 * LORA_R), dtype,
                              device=device),
        "mix_w2": _normal(gen, (5, LORA_R, d_model), 0.01, dtype, device),
        "wr": proj("wr", (d_model, d_attn)),
        "wk": proj("wk", (d_model, d_attn)),
        "wv": proj("wv", (d_model, d_attn)),
        "wg": proj("wg", (d_model, d_attn)),
        "wo": proj("wo", (d_attn, d_model)),
        "w0": torch.full((d_attn,), -6.0, dtype=dtype, device=device),
        "decay_w1": init_linear(gen, (d_model, DECAY_LORA_R), dtype,
                                device=device),
        "decay_w2": _normal(gen, (DECAY_LORA_R, d_attn), 0.01, dtype, device),
        "u": _normal(gen, (n_heads, head_dim), 0.1, dtype, device),
        "ln_out": {"scale": torch.ones((d_attn,), dtype=dtype, device=device),
                   "bias": torch.zeros((d_attn,), dtype=dtype,
                                       device=device)},
    }


def init_rwkv_channel_mix(gen, d_model: int, d_ff: int, dtype, *, device,
                          quant=None, name: str = "") -> Params:
    q = dict(device=device, quant=quant)
    return {
        "mu": torch.full((2, d_model), 0.5, dtype=dtype, device=device),
        # the sigmoid gate, applied unquantized
        "wr": init_linear(gen, (d_model, d_model), dtype, device=device),
        "wk": init_linear(gen, (d_model, d_ff), dtype, name=f"{name}.wk", **q),
        "wv": init_linear(gen, (d_ff, d_model), dtype, name=f"{name}.wv", **q),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """xx_t = x_{t-1} (zeros, or the carried state, at t=0).  x [B, S, d]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """The five mixed inputs (r, w, k, v, g): [5, B, S, d]."""
    sx = xx - x
    base = x + sx * p["mu"][:, None, None, :].to(x.dtype)
    b = torch.tanh(dense(p["mix_w1"], x))
    b = b.reshape(b.shape[:-1] + (5, LORA_R))             # [B, S, 5, R]
    adj = torch.stack([matmul(b[..., f, :], p["mix_w2"][f])
                       for f in range(5)])
    return base + sx[None] * adj


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """log(w_t) = -exp(w0 + lora(xw)) in float32."""
    lo = matmul(torch.tanh(dense(p["decay_w1"], xw)), p["decay_w2"])
    return -torch.exp(p["w0"].float() + lo.float())


def _wkv_scan(r, k, v, log_w, u, state):
    """One step per token.  r/k/v/log_w [B, S, H, hd] float32, u [H, hd],
    state [B, H, hd, hd].  Returns (y [B, S, H, hd], final state).

    A step's ``r . (S + u k v^T)`` is a product and a sum over ``k``
    (not a batched GEMM), so a token's step runs the same reduction
    whatever the batch, and a chunk's steps equal single-token calls."""
    ys = []
    s = state
    uk = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, hd, hd]
        ys.append((r[:, t, :, :, None] * (s + uk * kv)).sum(dim=-2))
        s = torch.exp(log_w[:, t])[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_chunk_step(s, rt, kt, vt, lwt, u):
    """One chunk of ``_wkv_chunked``: rt/kt/vt/lwt [B, C, H, hd], s the
    state entering the chunk.  Returns (state after it, y [B, C, H, hd])."""
    C = rt.shape[1]
    L = torch.cumsum(lwt, dim=1)            # in-chunk cumulative log-decay
    L_prev = L - lwt                        # L_{t-1}, L_{-1} = 0
    L_end = L[:, -1:]
    r_in = rt * torch.exp(L_prev)
    y_inter = torch.einsum("bchk,bhkv->bchv", r_in, s)
    # strictly causal in-chunk scores: decay(s+1 .. t-1) = L_{t-1} - L_s
    k_out = kt * torch.exp(-L)
    scores = torch.einsum("bchk,bdhk->bhcd", r_in, k_out)
    idx = torch.arange(C, device=rt.device)
    causal = idx[:, None] > idx[None, :]
    scores = torch.where(causal[None, None], scores,
                         torch.zeros_like(scores))
    y_intra = torch.einsum("bhcd,bdhv->bchv", scores, vt)
    # bonus (current token): (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bchk,bchk->bch", rt, u[None, None] * kt)
    y_bonus = bonus[..., None] * vt
    # S' = D(L_end) S + sum_s D(L_end - L_s) k_s v_s^T
    k_fold = kt * torch.exp(L_end - L)
    s_new = (torch.exp(L_end[:, 0])[..., None] * s
             + torch.einsum("bchk,bchv->bhkv", k_fold, vt))
    return s_new, y_inter + y_intra + y_bonus


def _wkv_chunked(r, k, v, log_w, u, state, chunk: int = 32):
    """Chunk-parallel WKV (float32 operands).  Exponents are in-chunk
    cumulative log-decay differences; ``rwkv_time_mix`` clips ``log_w``
    to [-2, -1e-4], so ``exp(-L)`` stays below e^(2·chunk) (e^64 at
    chunk 32), inside float32's range.  Under autograd each chunk is
    recomputed in the backward pass (only the carried state is saved)."""
    B, S, H, hd = r.shape
    C = min(chunk, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    remat = torch.is_grad_enabled()
    if remat:
        from torch.utils.checkpoint import checkpoint
    ys = []
    s = state
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        args = (s, r[:, sl], k[:, sl], v[:, sl], log_w[:, sl], u)
        s, y = (checkpoint(_wkv_chunk_step, *args, use_reentrant=False)
                if remat else _wkv_chunk_step(*args))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


def rwkv_time_mix(p: Params, x: torch.Tensor, *, n_heads: int,
                  head_dim: int, impl: str = "scan",
                  state: Params | None = None, wkv_chunk: int = 32,
                  tap: list | None = None, backend=None):
    """RWKV-6 time mixing.  ``state`` (decode / carry) = ``{"shift": [B,
    1, d], "wkv": [B, H, hd, hd] float32}``, None for a fresh sequence.
    Returns (out [B, S, d], new state)."""
    B, S, _ = x.shape
    H, hd = n_heads, head_dim
    carry = state is not None
    kw = dict(tap=tap, backend=backend)
    xx = _token_shift(x, state["shift"] if carry else None)
    xr, xw, xk, xv, xg = _ddlerp(p, x, xx)
    r = dense(p["wr"], xr, **kw).reshape(B, S, H, hd).float()
    k = dense(p["wk"], xk, **kw).reshape(B, S, H, hd).float()
    v = dense(p["wv"], xv, **kw).reshape(B, S, H, hd).float()
    g = dense(p["wg"], xg, **kw)
    # |cumsum(log_w)| <= 2 * wkv_chunk keeps exp(+-L) inside float32
    log_w = torch.clamp(_decay(p, xw).reshape(B, S, H, hd), -2.0, -1e-4)
    s0 = (state["wkv"] if carry
          else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=x.device))
    u = p["u"].float()
    if impl == "chunked" and S > 1:
        y, s_new = _wkv_chunked(r, k, v, log_w, u, s0, chunk=wkv_chunk)
    else:
        y, s_new = _wkv_scan(r, k, v, log_w, u, s0)
    # per-head group norm, eps 1e-5
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    yf = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, H * hd)
    yf = (yf * p["ln_out"]["scale"].float()
          + p["ln_out"]["bias"].float())
    out = dense(p["wo"], yf.to(x.dtype) * F.silu(g), **kw)
    return out, {"shift": x[:, -1:], "wkv": s_new}


def rwkv_channel_mix(p: Params, x: torch.Tensor, *,
                     state: Params | None = None, tap: list | None = None,
                     backend=None):
    """Squared-ReLU channel mix.  ``state`` = ``{"shift": [B, 1, d]}``."""
    kw = dict(tap=tap, backend=backend)
    xx = _token_shift(x, state["shift"] if state is not None else None)
    sx = xx - x
    mu = p["mu"].to(x.dtype)
    xk = x + sx * mu[1][None, None]
    xr = x + sx * mu[0][None, None]
    kk = torch.square(F.relu(dense(p["wk"], xk, **kw)))
    out = torch.sigmoid(dense(p["wr"], xr, **kw)) * dense(p["wv"], kk, **kw)
    return out, {"shift": x[:, -1:]}


def init_rwkv_state(batch: int, d_model: int, n_heads: int, head_dim: int,
                    dtype, *, device) -> Params:
    """Fresh decode state for one RWKV layer (time mix + channel mix)."""
    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    return {"tm": {"shift": zeros((batch, 1, d_model), dtype),
                   "wkv": zeros((batch, n_heads, head_dim, head_dim),
                                torch.float32)},
            "cm": {"shift": zeros((batch, 1, d_model), dtype)}}
