"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, one device).

Top-k token-choice routing with capacity-based dropping, as the JAX
package computes it:

  * a float32 softmax router, ``torch.topk`` and renormalised weights;
  * sort-based capacity dispatch (no [T, E, C] one-hot): the flat
    (token, choice) entries are stably sorted by expert, each entry's
    rank inside its expert is its position minus the expert's first
    position, and ranks at or past ``cap = ceil(T*top_k/E*cf)`` drop.
    ``cap`` comes from the call's token count, so a decode batch's idle
    slots (token 0) take capacity too, exactly as in the reference;
  * SwiGLU experts over the dispatch buffer [E, cap, d], each GEMM one
    op over all experts (``exec.execute_expert_gemm`` once deployed;
    under fake quant ``quant_dense`` on the bank, with JAX's per-expert
    LSQ gradient scales);
  * a combine that adds each token's contributions from zero in
    ascending expert order, one add at a time in the model dtype: the
    order XLA's scatter-add applies them on the CPU.  No atomics, so
    the result is the same on every run and on both devices.

Training differentiates the same code: gradients reach ``x``, the
float32 router (through ``topk`` and the renormalised weights), the
expert banks and their shared quantizer states, as ``jax.grad`` of the
JAX function gives them.  A dropped entry gets exactly zero (it is
zeroed before the buffer and weighted by zero in the combine; the
overflow row it lands in is discarded).  Every backward is a gather or
a scatter to distinct rows but one: the gather of each token's
``top_k`` copies, whose backward (``index_put_`` with accumulation)
sums them; on the card that sum is sort-based, so a step repeats bit
for bit there too (``tests/test_torch_cuda.py`` holds it).

The serving path has static shapes and no host round trip (no boolean
masks, ``nonzero`` or ``.item()``); only the calibration tap filters
live rows eagerly.  ``moe_ffn_sharded`` (expert parallelism over a mesh)
is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import (DeployedQuantState, QuantState, TapRecord,
                              quant_dense, quant_params_init)
from repro_torch.quant.policy import resolve_quant
from .common import Params, dense, init_linear


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, dtype, *, device, quant=None,
             name: str = "") -> Params:
    """Float32 router, expert banks [E, K, N] and, where the policy
    quantizes them, ONE ``QuantState`` per bank built from expert 0's
    weight and shared by every expert (the JAX package's choice)."""
    def bank(k, n):
        return (torch.randn((n_experts, k, n), generator=gen,
                            dtype=torch.float32, device=device)
                * (1.0 / math.sqrt(k))).to(dtype)

    p = {"router": init_linear(gen, (d_model, n_experts), torch.float32,
                               device=device),
         "wi": bank(d_model, d_ff), "wg": bank(d_model, d_ff),
         "wo": bank(d_ff, d_model)}
    for wname in ("wi", "wg", "wo"):
        resolved = resolve_quant(quant, f"{name}.{wname}")
        if resolved is not None:
            p[f"qp_{wname}"] = quant_params_init(
                p[wname][0].float(), resolved, name=f"{name}.{wname}")
    return p


def _expert_gemm(x: torch.Tensor, w, qp, backend=None) -> torch.Tensor:
    """x [E, C, K] @ w [E, K, N] -> [E, C, N] as the bank's state says:
    deployed codes through ``exec``, fake quant, or a float product."""
    if isinstance(qp, DeployedQuantState):
        from repro_torch.exec import execute_expert_gemm  # lazy: kernels
        return execute_expert_gemm(qp, x, backend=backend)
    if isinstance(qp, QuantState):
        return quant_dense(x.float(), w.float(), qp).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def _moe_tap(tap, qp, x2d: torch.Tensor, w) -> None:
    """Capture one expert GEMM for calibration: expert 0's weight with
    every expert's occupied rows (capacity padding is all-zero and must
    not bias the activation scale low).  Eager and calibration-only."""
    if tap is None or w is None or not isinstance(qp, QuantState):
        return
    live = x2d[(x2d != 0).any(dim=-1)]
    if live.shape[0] == 0:
        return
    tap.append(TapRecord(qp.name, live, w[0].float().reshape(w.shape[1], -1),
                         qp))


def _dispatch(topi: torch.Tensor, n_experts: int, cap: int):
    """Sort-based capacity dispatch of the flat (token, choice) entries.

    Returns ``(order, slot, keep)``: ``order`` sorts the entries stably
    by expert, ``slot[i]`` is sorted entry i's row in the [E*cap + 1]
    dispatch buffer (the last row collects dropped entries) and
    ``keep[i]`` whether it made its expert's capacity."""
    e_flat = topi.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sort = e_flat[order]
    starts = torch.searchsorted(
        e_sort, torch.arange(n_experts, device=e_sort.device,
                             dtype=e_sort.dtype))
    rank = torch.arange(e_sort.numel(), device=e_sort.device) \
        - starts[e_sort]
    keep = rank < cap
    slot = torch.where(keep, e_sort * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return order, slot, keep


def moe_ffn(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, tap: list | None = None,
            backend=None, groups: int = 1) -> torch.Tensor:
    """Top-k MoE FFN over all experts; x [B, S, d] -> [B, S, d].

    ``groups`` splits the B*S tokens into that many equal runs, each
    routed alone with the capacity of its own token count: the dense
    engine's decode passes one group per slot, as the reference decodes
    each slot apart.  A group g is routed as virtual experts g*E .. g*E +
    E - 1, and expert e's GEMM rows are the groups' rows side by side."""
    B, S, d = x.shape
    E = n_experts
    T = B * S
    xt = x.reshape(T, d)

    logits = dense(p["router"], xt.float())                     # [T, E]
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, top_k, dim=-1)               # [T, k]
    topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)

    cap = int(math.ceil(T // groups * top_k / E * capacity_factor))
    if groups > 1:
        group = torch.arange(T, device=x.device) // (T // groups)
        topi = topi + (group * E)[:, None]
    order, slot, keep = _dispatch(topi, groups * E, cap)
    t_sort = order // top_k
    w_sort = topw.reshape(-1)[order]

    buf = x.new_zeros((groups * E * cap + 1, d))
    buf[slot] = torch.where(keep[:, None], xt[t_sort], 0)
    h = buf[:-1].reshape(groups, E, cap, d).transpose(0, 1).reshape(
        E, groups * cap, d)

    _moe_tap(tap, p.get("qp_wg"), h.reshape(-1, d), p.get("wg"))
    _moe_tap(tap, p.get("qp_wi"), h.reshape(-1, d), p.get("wi"))
    a = _expert_gemm(h, p.get("wg"), p.get("qp_wg"), backend)
    b = _expert_gemm(h, p.get("wi"), p.get("qp_wi"), backend)
    hidden = F.silu(a) * b
    _moe_tap(tap, p.get("qp_wo"), hidden.reshape(-1, hidden.shape[-1]),
             p.get("wo"))
    y_exp = _expert_gemm(hidden, p.get("wo"), p.get("qp_wo"), backend)
    y_exp = y_exp.reshape(E, groups, cap, d).transpose(0, 1)

    # combine: entry i's output, weighted in the model dtype (0 if dropped)
    y_flat = torch.cat([y_exp.reshape(groups * E * cap, d),
                        y_exp.new_zeros((1, d))])
    y_ent = y_flat[slot] * torch.where(keep, w_sort, 0.0)[:, None].to(x.dtype)
    # a token's entries sit in ascending expert order in the sorted list;
    # gather them in that order and add them one at a time from zero
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(order.numel(), device=order.device)
    contrib = y_ent[sorted_pos.reshape(T, top_k).sort(dim=-1).values]
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        y = y + contrib[:, j]
    return y.reshape(B, S, d)
