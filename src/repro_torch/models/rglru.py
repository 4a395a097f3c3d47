"""RG-LRU recurrent block (port of ``repro/models/rglru.py``; RecurrentGemma
/ Griffin, arXiv:2402.19427).

    x -> {wx -> causal depthwise conv1d (width 4) -> RG-LRU} * gelu(wy x)
      -> wo

with, per channel,

    r_t = sigmoid(gate_a x_t + b_a),  i_t = sigmoid(gate_x x_t + b_x)
    a_t = exp(-8 softplus(lam) r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

``wx``, ``wy`` and ``wo`` go through ``dense`` (quantizable); the gates
stay float.  A full sequence runs the recurrence as a log-depth doubling
scan (the JAX package's ``associative_scan`` with the same combine);
``exact_scan`` runs it one token at a time instead, bit-identical to S
single-token calls (paged prefill chunks use it); decode (S = 1) takes
one step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Params, dense, init_linear

RGLRU_C = 8.0
CONV_WIDTH = 4


def init_rglru_block(gen, d_model: int, d_rnn: int, dtype, *, device,
                     quant=None, name: str = "") -> Params:
    q = dict(device=device, quant=quant)
    # lam so that the decay a lies in [0.9, 0.999] at r = 1: the inverse
    # softplus of -log(u) / 8, u ~ U(0.9, 0.999)
    u = 0.9 + 0.099 * torch.rand((d_rnn,), generator=gen,
                                 dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    conv_w = torch.randn((CONV_WIDTH, d_rnn), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "wx": init_linear(gen, (d_model, d_rnn), dtype, name=f"{name}.wx",
                          **q),
        "wy": init_linear(gen, (d_model, d_rnn), dtype, name=f"{name}.wy",
                          **q),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=device),
        "gate_a": init_linear(gen, (d_rnn, d_rnn), dtype, device=device),
        "gate_x": init_linear(gen, (d_rnn, d_rnn), dtype, device=device),
        "gate_a_b": torch.zeros((d_rnn,), dtype=torch.float32, device=device),
        "gate_x_b": torch.zeros((d_rnn,), dtype=torch.float32, device=device),
        "lam": lam,
        "wo": init_linear(gen, (d_rnn, d_model), dtype, name=f"{name}.wo",
                          **q),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None):
    """Depthwise causal conv of width ``CONV_WIDTH``.  x [B, S, d]; state
    [B, CONV_WIDTH - 1, d], the trailing inputs of the previous call."""
    B, S, d = x.shape
    if state is None:
        state = torch.zeros((B, CONV_WIDTH - 1, d), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    out = xp[:, 0:S] * w[0][None, None]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out + b[None, None].to(x.dtype), xp[:, -(CONV_WIDTH - 1):]


def _rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t h_{t-1} + x_t over [B, S, d] float32: h0 folds into the
    first element, then ceil(log2 S) doubling steps of the combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` (e1 the earlier)."""
    x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], dim=1)
    S = x.shape[1]
    d = 1
    while d < S:
        a_prev, x_prev = a[:, :-d], x[:, :-d]
        x = torch.cat([x[:, :d], a[:, d:] * x_prev + x[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return x


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def rglru_block(p: Params, x: torch.Tensor, *, state: Params | None = None,
                tap: list | None = None, backend=None,
                exact_scan: bool = False):
    """The recurrent block.  ``state`` = ``{"h": [B, d_rnn] float32,
    "conv": [B, 3, d_rnn]}``, None for a fresh sequence.  Returns
    (out [B, S, d], new state)."""
    B, S, _ = x.shape
    kw = dict(tap=tap, backend=backend)
    y = F.gelu(dense(p["wy"], x, **kw), approximate="tanh")
    xr = dense(p["wx"], x, **kw)
    xr, new_conv = _causal_conv1d(xr, p["conv_w"], p["conv_b"],
                                  state["conv"] if state is not None
                                  else None)
    xf = xr.float()
    r = torch.sigmoid(dense(p["gate_a"], xr, **kw).float() + p["gate_a_b"])
    i = torch.sigmoid(dense(p["gate_x"], xr, **kw).float() + p["gate_x_b"])
    a = torch.exp(-RGLRU_C * _softplus(p["lam"])[None, None] * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    h0 = (state["h"] if state is not None
          else torch.zeros((B, xr.shape[-1]), dtype=torch.float32,
                           device=x.device))
    if S == 1:                                # decode
        h = (a[:, 0] * h0 + gated[:, 0])[:, None]
    elif exact_scan:
        hs, hc = [], h0
        for t in range(S):
            hc = a[:, t] * hc + gated[:, t]
            hs.append(hc)
        h = torch.stack(hs, dim=1)
    else:
        h = _rglru_scan(gated, a, h0)
    out = dense(p["wo"], h.to(x.dtype) * y, **kw)
    return out, {"h": h[:, -1], "conv": new_conv}


def init_rglru_state(batch: int, d_rnn: int, dtype, *, device) -> Params:
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, d_rnn), dtype=dtype,
                                device=device)}
