"""Shared building blocks (port of ``repro/models/common.py``, dense path).

Params are nested dicts of tensors.  Every projection goes through
``dense``, which dispatches on the layer's state: a ``QuantState`` runs
W8A8 (+ PSQ/APSQ) fake quant, a ``DeployedQuantState`` the integer path
through ``repro_torch.exec``, no state a plain float GEMM.
``count_params`` counts a tree's elements.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.core import (DeployedQuantState, QuantState, deployed_dense,
                              quant_dense, quant_params_init)
from repro_torch.quant.policy import resolve_quant

Params = dict


def init_linear(gen: torch.Generator, shape, dtype, *, device, quant=None,
                name: str = "", scale: float | None = None) -> Params:
    """Fan-in normal weight [K, *out] plus, when the policy quantizes
    ``name``, its ``QuantState``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = (torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=device) * scale).to(dtype)
    p = {"w": w}
    resolved = resolve_quant(quant, name)
    if resolved is not None:
        p["qp"] = quant_params_init(w.reshape(shape[0], -1).float(),
                                    resolved, name=name)
    return p


ROW_BLOCK = 16
_ROW_BLOCKS = contextvars.ContextVar("row_blocks", default=False)


@contextlib.contextmanager
def row_blocks(on: bool = True):
    """Within it (when ``on``), every float GEMM of ``matmul``/``dense``
    and every ``apply_norm`` runs through ``rows_apply``.  The serving paths
    of a model with recurrent layers turn it on
    (``model.forward_paged_chunk``, ``model.decode_step``): float results
    there feed recurrent states and the residual stream without an INT8
    quantizer between, so a prefill chunk equals per-token decode, and a
    batch one stream, only if a row's result does not depend on the rows
    beside it."""
    token = _ROW_BLOCKS.set(on)
    try:
        yield
    finally:
        _ROW_BLOCKS.reset(token)


def rows_apply(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of x[..., K] in blocks of ``ROW_BLOCK`` rows
    (the last block padded with zero rows), for a row-wise ``fn``
    [ROW_BLOCK, K] -> [ROW_BLOCK, ...].  Every row then goes through
    kernels of one shape, so its result does not depend on how many rows
    the call holds: a GEMM library picks its kernel (and its order of
    summation) by M, and PyTorch's reductions on the card pick their
    thread layout by the number of rows.  At RWKV6-3B's shapes on an
    H100 only the norms need it, on the CPU the GEMMs too
    (``scripts/rwkv_row_blocks.py``)."""
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    pad = -m % ROW_BLOCK
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    ys = [fn(x2[i:i + ROW_BLOCK]) for i in range(0, m + pad, ROW_BLOCK)]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y[:m].reshape(tuple(x.shape[:-1]) + tuple(y.shape[1:]))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float x[..., K] @ w[K, N] in x's dtype; in fixed row blocks
    (``rows_apply``) within ``row_blocks``."""
    w = w.to(x.dtype)
    if _ROW_BLOCKS.get():
        return rows_apply(lambda b: b @ w, x)
    return x @ w


def dense(p: Params, x: torch.Tensor, *, tap: list | None = None,
          backend=None) -> torch.Tensor:
    """x[..., K] @ w[K, *out] as the layer's state says."""
    qp = p.get("qp")
    if isinstance(qp, DeployedQuantState):
        return deployed_dense(x, qp, backend=backend)
    w = p["w"]
    w2d = w.reshape(w.shape[0], -1)
    if isinstance(qp, QuantState):
        y = quant_dense(x, w2d, qp, tap=tap)
    else:
        y = matmul(x, w2d)
    return y.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def init_norm(dim: int, dtype, kind: str = "rmsnorm", *, device) -> Params:
    """Unit ``scale``; LayerNorm adds a zero ``bias``."""
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm in float32, result in x's dtype.  LayerNorm is
    the JAX package's ``(x - mean) * rsqrt(var + eps) * scale + bias``
    with the population variance and eps 1e-6 (not ``F.layer_norm``'s
    1e-5).  In fixed row blocks within ``row_blocks``."""
    if _ROW_BLOCKS.get():
        return rows_apply(lambda b: _norm(p, b, kind, eps), x)
    return _norm(p, x, kind, eps)


def _norm(p: Params, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (xf * p["scale"].float()).to(x.dtype)
    if kind != "layernorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    d = xf - xf.mean(dim=-1, keepdim=True)
    xf = d * torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, dim: int, dtype, *,
                   device) -> Params:
    return {"table": (torch.randn((vocab, dim), generator=gen,
                                  dtype=torch.float32, device=device)
                      * (1.0 / math.sqrt(dim))).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token lookup: table[tokens]."""
    return p["table"][tokens]


def rope_frequencies(head_dim: int, fraction: float, theta: float, *,
                     device=None):
    """Inverse frequencies for the rotary slice of the head."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return inv, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]),
    the JAX package's layout (not the half-split one).

    x: [..., S, H, head_dim]; positions broadcastable to [..., S].
    """
    head_dim = x.shape[-1]
    inv, rot_dim = rope_frequencies(head_dim, fraction, theta,
                                    device=x.device)
    if rot_dim == 0:
        return x
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    ang = positions[..., None].float() * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             kind: str = "swiglu", *, device, quant=None,
             name: str = "") -> Params:
    """SwiGLU: ``wi``, ``wg``, ``wo``; the GELU MLP (StarCoder2): ``wi``
    and ``wo`` only."""
    kw = dict(device=device, quant=quant)
    p = {"wi": init_linear(gen, (d_model, d_ff), dtype, name=f"{name}.wi",
                           **kw)}
    if kind == "swiglu":
        p["wg"] = init_linear(gen, (d_model, d_ff), dtype, name=f"{name}.wg",
                              **kw)
    p["wo"] = init_linear(gen, (d_ff, d_model), dtype, name=f"{name}.wo",
                          **kw)
    return p


def apply_mlp(p: Params, x: torch.Tensor, kind: str = "swiglu", *,
              tap: list | None = None, backend=None) -> torch.Tensor:
    """SwiGLU: wo(silu(wg x) * wi x); GELU: wo(gelu(wi x)) with the tanh
    approximation, ``jax.nn.gelu``'s default (torch's default is erf)."""
    if kind == "swiglu":
        h = (F.silu(dense(p["wg"], x, tap=tap, backend=backend))
             * dense(p["wi"], x, tap=tap, backend=backend))
    elif kind == "gelu":
        h = F.gelu(dense(p["wi"], x, tap=tap, backend=backend),
                   approximate="tanh")
    else:
        raise NotImplementedError(f"mlp {kind!r} is not ported yet")
    return dense(p["wo"], h, tap=tap, backend=backend)


def count_params(params) -> int:
    """Elements over every tensor leaf of a params tree (quantizer states'
    scales included, as ``jax.tree.leaves`` counts them)."""
    from .model import tree_leaves       # lazy: model imports common
    return sum(int(t.numel()) for _, t in tree_leaves(params)
               if isinstance(t, torch.Tensor))
