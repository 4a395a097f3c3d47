"""Tensor- and expert-parallel integer serving (port of
``repro/dist/tp.py``).

It decides, per exported ``DeployedQuantState``, how the INT8 code banks
split over the mesh's ``model`` axis, and runs the collective bodies the
``sharded`` exec backend (``repro_torch.exec.ShardedBackend``) calls,
with INT8-on-the-wire combines wherever the PO2 grid makes them lossless.

Shard rules (``plan_gemm``, copied from the reference), from Algorithm 1:

  * **PSQ** (``gs >= n_p``): every PSUM tile but the last is quantized
    on its own, so K shards into whole-PSUM-tile spans (``n_p/D`` tiles a
    rank); the INT32 partials combine exactly.  A ragged ``K % n_p``
    remainder (zero-padded) falls in the LAST rank's span.  The int8
    wire combines by an int32 reduce-scatter, the final quantize per
    column slice and an int8 code gather (5 bytes an element against 8).
    Needs ``n_p % D == 0``.
  * **APSQ** (``gs < n_p``): the group-start chain is sequential along K,
    so APSQ layers shard **N**: each rank runs the whole recurrence on
    its columns, and the output, an INT8 code times ``2^e_last``,
    gathers as codes (right shift, gather, left shift): 1 byte an element
    against 4.  Needs ``N % D == 0``.
  * **W8A8** (``psum_exps is None``): K spans, an exact int32 all-reduce.
  * **MoE expert banks**: the expert axis shards (EP).  Activations are
    on every rank, so dispatch is a slice; the combine gathers each
    expert's output as INT8 codes (W8A8 banks: int32).
  * A layer that misses its divisibility constraint falls back
    (psq -> "n" -> replicate) and runs the one-device path.

The port's ranks are processes (``torch.distributed``), one per shard of
the ``model`` axis, and each holds only its own slices, where JAX's
arrays are logically global and its ``shard_map`` bodies slice them.  A
rank's codes are [K, N/D], say, so a GEMM's plan can never be re-derived
from the codes a body receives: ``shard_deployed`` plans each bank from
its full shape, cuts it with ``shard_codes`` and hangs the ``LayerPlan``
on the local code tensor (``placed_plan``), and the executors read it
there.  Given a whole, unplaced bank (the reference's API), an executor
plans from its shape and cuts it with the same ``shard_codes``.

Exponent banks (``psum_exps``, ``ax_exp``, ``aw_exp``) and float leaves
stay whole on every rank: the bodies slice their span of ``psum_exps``,
and the whole ``e_last`` row finishes a code gather with no sidecar.
Unlike the reference, an expert bank's ``ax_exp``/``aw_exp`` stay whole
too: ``exec.execute_expert_gemm`` quantizes and rescales every expert's
rows, and only the int8 codes split.

Attention splits heads (``split_heads``): a rank writes its KV heads
into its pools and attends its query heads (no collective), and
``gather_heads`` gathers the outputs over heads in float32 before the
out-projection, the collective the reference's ``"attn"`` ``LayerPlan``
prices.

The collectives (``all_gather_single``/``all_gather_into_tensor``,
``reduce_scatter_single``/``reduce_scatter_tensor``, ``all_reduce``)
run on the mesh's ``model`` process group and take tensors as they are:
torch 2.11's gloo takes CUDA tensors for all three (int8, int32 and
float32; it stages them through the host itself), as NCCL does.
Each mesh adds up the payload bytes its collectives move
(``Mesh.wire_bytes``, by op), by the convention of
``LayerPlan.wire_bytes``, so a run can be held to ``wire_report``'s
analytic bytes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import DeployedQuantState, QuantConfig
from repro_torch.kernels.apsq_matmul.ref import (dequantize_psum,
                                                 quantize_psum, shift_left,
                                                 shift_right)

# ---------------------------------------------------------------------------
# The shared placement/execution decision (copied from the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one [M, K] x [K, N] deployed GEMM splits over D shards."""

    axis: str   # "k" | "n" | "expert" | "replicate"
    mode: str   # "w8a8" | "psq" | "apsq"
    d: int

    @property
    def sharded(self) -> bool:
        return self.axis != "replicate" and self.d > 1


def gemm_mode(n_p: int | None, gs: int) -> str:
    """Mode from the exponent-bank geometry (what the kernel actually runs,
    regardless of what the spec *declares* — gs >= n_p executes as PSQ)."""
    if n_p is None:
        return "w8a8"
    return "psq" if gs >= n_p else "apsq"


def plan_gemm(*, k: int, n: int, n_p: int | None, gs: int,
              d: int) -> GemmPlan:
    """Pick the shard axis for one GEMM from its FULL shape.  Pure and
    static: placement plans with it and execution reads that plan."""
    mode = gemm_mode(n_p, gs)
    if d <= 1:
        return GemmPlan("replicate", mode, d)
    if mode == "psq" and n_p % d == 0 and n_p >= d:
        return GemmPlan("k", mode, d)
    if mode == "w8a8" and k % d == 0:
        return GemmPlan("k", mode, d)
    if n % d == 0:
        return GemmPlan("n", mode, d)
    return GemmPlan("replicate", mode, d)


def _dq_geometry(dq: DeployedQuantState, kind: str):
    """(k, n, n_p, gs, lead, units, experts) per-unit geometry of one bank.

    ``lead`` = leading axes before the per-unit [K, N]: scan stacking adds
    one, the expert axis adds one.  Stacking is detected from ``ax_exp``'s
    rank (scalar per plain linear, [E] per expert bank).
    """
    base = 1 if kind == "expert" else 0
    stacked = dq.ax_exp.ndim > base
    lead = base + (1 if stacked else 0)
    k, n = int(dq.w_codes.shape[-2]), int(dq.w_codes.shape[-1])
    units = int(dq.w_codes.shape[0]) if stacked else 1
    experts = int(dq.w_codes.shape[lead - 1]) if kind == "expert" else 1
    n_p = None
    gs = 1
    if dq.psum_exps is not None:
        n_p = int(dq.psum_exps.shape[lead])
        spec = dq.spec or QuantConfig.w8a8()
        gs = n_p if spec.psum.mode == "psq" else spec.psum.gs
    return k, n, n_p, gs, lead, units, experts


# ---------------------------------------------------------------------------
# Wire accounting (analytic, from the static plan; copied)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerPlan:
    """One placed layer: shard decision + analytic wire-byte model.

    Byte convention (both paths, so the ratio is meaningful):
    ``all_gather`` of a logical payload moves payload x itemsize;
    ``psum`` moves 2 x payload x 4 (reduce-scatter + all-gather halves);
    ``psum_scatter`` alone moves payload x 4.  Exponent banks are
    replicated at placement time, so no sidecar term appears.
    """

    name: str
    kind: str        # "linear" | "head" | "expert" | "attn"
    mode: str        # "w8a8" | "psq" | "apsq" | "-"
    axis: str        # "k" | "n" | "expert" | "heads" | "replicate"
    d: int
    k: int = 0
    n: int = 0
    n_p: int | None = None
    gs: int = 1
    units: int = 1
    experts: int = 1
    per_col: bool = False

    def wire_bytes(self, m: int) -> dict:
        """{"int8": bytes, "fp32": bytes} for one call with m rows
        (per expert, for expert banks) under each wire mode."""
        if self.axis == "replicate" or self.d <= 1:
            return {"int8": 0, "fp32": 0}
        payload = self.units * self.experts * m * self.n
        if self.kind == "attn":
            b = payload * 4          # fp32 head gather, identical both paths
            return {"int8": b, "fp32": b}
        if self.mode == "w8a8":
            b = 8 * payload if self.axis == "k" else 4 * payload
            return {"int8": b, "fp32": b}
        if self.axis == "k":         # PSQ: int32 scatter + int8 code gather
            return {"int8": 5 * payload, "fp32": 8 * payload}
        # column-parallel / expert-parallel PSUM-mode: lossless code gather
        return {"int8": payload, "fp32": 4 * payload}


def wire_report(plans: dict, m: int = 1) -> dict:
    """Aggregate ``LayerPlan.wire_bytes`` over a plan dict.

    ``switchable`` sums only the collectives the wire flag actually
    changes (PSUM-mode combines); ``total`` includes the flag-invariant
    ones (w8a8 psums, attention head gathers) so nothing is hidden.
    """
    layers, tot8, tot32, sw8, sw32 = {}, 0, 0, 0, 0
    for name, pl in plans.items():
        b = pl.wire_bytes(m)
        layers[name] = {"axis": pl.axis, "mode": pl.mode, **b}
        tot8 += b["int8"]
        tot32 += b["fp32"]
        if b["int8"] != b["fp32"]:
            sw8 += b["int8"]
            sw32 += b["fp32"]
    return {
        "m": m,
        "layers": layers,
        "total": {"int8": tot8, "fp32": tot32,
                  "ratio": (tot32 / tot8) if tot8 else None},
        "switchable": {"int8": sw8, "fp32": sw32,
                       "ratio": (sw32 / sw8) if sw8 else None},
    }


# ---------------------------------------------------------------------------
# The mesh's model axis and its collectives
# ---------------------------------------------------------------------------

# torch 2.13 renames the two tensor collectives (the old names warn)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _mesh_dim(mesh, model_axis: str) -> int:
    return 1 if mesh is None else int(mesh.shape.get(model_axis, 1))


def _index(mesh, model_axis: str) -> int:
    """This rank's position along the model axis (JAX's ``axis_index``)."""
    return int(mesh.coords[model_axis])


def _all_gather(mesh, ax: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Tiled all-gather of ``t`` along ``dim``, rank order."""
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((_mesh_dim(mesh, ax) * src.shape[0],
                         *src.shape[1:]))
    _ALL_GATHER(out, src, group=mesh.groups[ax])
    mesh.count_wire("all_gather", out.numel() * out.element_size())
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(mesh, ax: str, t: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Sum over ranks, each keeping its slice of ``dim`` (rank order)."""
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // _mesh_dim(mesh, ax),
                         *src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=mesh.groups[ax])
    mesh.count_wire("reduce_scatter", src.numel() * src.element_size())
    return out.movedim(0, dim).contiguous()


def _all_reduce(mesh, ax: str, t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, in place on ``t`` (a tensor of the caller's)."""
    dist.all_reduce(t, group=mesh.groups[ax])
    mesh.count_wire("all_reduce", 2 * t.numel() * t.element_size())
    return t


# ---------------------------------------------------------------------------
# Placement: shard_deployed / shard_paged_state
# ---------------------------------------------------------------------------

_PLAN_ATTR = "tp_plan"


def placed_plan(w_codes: torch.Tensor) -> LayerPlan | None:
    """The ``LayerPlan`` placement gave a rank's code tensor, or None for
    a whole bank that was never placed."""
    return getattr(w_codes, _PLAN_ATTR, None)


def _k_span(plan: LayerPlan, idx: int) -> tuple:
    """(lo, hi) of rank ``idx``'s K span under a "k" plan: even spans
    (W8A8), or ``n_p/D`` whole PSUM tiles of ``ceil(K/n_p)`` rows over K
    zero-padded to ``n_p`` tiles (PSQ)."""
    if plan.mode == "w8a8":
        kl = plan.k // plan.d
        return idx * kl, (idx + 1) * kl
    kt = -(-plan.k // plan.n_p)
    span = plan.n_p // plan.d * kt
    return idx * span, (idx + 1) * span


def _pad_k(t: torch.Tensor, plan: LayerPlan, dim: int) -> torch.Tensor:
    """Zero-pad K (``dim`` of ``t``) to whole PSUM tiles under PSQ."""
    if plan.mode != "psq":
        return t
    pad = (-plan.k) % plan.n_p
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def shard_codes(w_codes: torch.Tensor, plan: LayerPlan,
                idx: int) -> torch.Tensor:
    """Rank ``idx``'s slice of a whole code bank under ``plan``: columns
    ("n"), a K span ("k", PSQ's zero pad in the last span), expert rows
    ("expert"), or the whole bank ("replicate")."""
    if plan.axis == "replicate" or plan.d <= 1:
        return w_codes
    if plan.axis == "n":
        nl = plan.n // plan.d
        return w_codes[..., idx * nl:(idx + 1) * nl]
    if plan.axis == "expert":
        el = plan.experts // plan.d
        return w_codes[idx * el:(idx + 1) * el]
    lo, hi = _k_span(plan, idx)
    return _pad_k(w_codes, plan, w_codes.dim() - 2)[..., lo:hi, :]


def _place_dq(dq: DeployedQuantState, kind: str, mesh, ax: str,
              plans: dict) -> DeployedQuantState:
    d = _mesh_dim(mesh, ax)
    k, n, n_p, gs, lead, units, experts = _dq_geometry(dq, kind)
    per_col = dq.psum_exps is not None and dq.psum_exps.ndim - lead == 2
    if kind == "expert":
        plan_axis = "expert" if (d > 1 and experts % d == 0) else "replicate"
        mode = gemm_mode(n_p, gs)
    else:
        plan = plan_gemm(k=k, n=n, n_p=n_p, gs=gs, d=d)
        plan_axis, mode = plan.axis, plan.mode
    name = dq.name or f"dq{len(plans)}"
    lp = LayerPlan(name=name, kind=kind, mode=mode, axis=plan_axis, d=d,
                   k=k, n=n, n_p=n_p, gs=gs, units=units, experts=experts,
                   per_col=per_col)
    prev = plans.get(name)
    if prev is None:
        plans[name] = dataclasses.replace(lp)
    elif dataclasses.replace(prev, units=lp.units) == lp:
        # the port unstacks units: the same layer of the next unit counts
        # one more unit, as a scan-stacked tree's plan does
        prev.units += lp.units
    else:
        raise ValueError(f"two layers named {name!r} differ: {prev} vs "
                         f"{lp}")
    idx = _index(mesh, ax) if d > 1 else 0
    w = shard_codes(dq.w_codes, lp, idx).to(mesh.device).contiguous()
    setattr(w, _PLAN_ATTR, lp)

    def put(t):
        return None if t is None else t.to(mesh.device)

    return dataclasses.replace(dq, w_codes=w, ax_exp=put(dq.ax_exp),
                               aw_exp=put(dq.aw_exp),
                               psum_exps=put(dq.psum_exps))


def shard_deployed(tree, mesh, *, model_axis: str = "model"):
    """This rank's part of an exported param tree over ``mesh``'s model
    axis, on ``mesh.device``.

    Every ``DeployedQuantState`` is placed per ``plan_gemm`` (PSQ -> K by
    whole PSUM tiles, APSQ -> N, W8A8 -> K, MoE expert banks -> expert
    axis); float leaves (norms, router, embedding table) stay whole.
    Returns ``(tree, plans)``: the rank's tree plus the ``{name:
    LayerPlan}`` report ``wire_report`` prices.
    """
    plans: dict = {}

    def walk(node):
        if isinstance(node, DeployedQuantState):
            return _place_dq(node, "linear", mesh, model_axis, plans)
        if isinstance(node, dict):
            is_moe = "router" in node
            out = {}
            for key, v in node.items():
                if isinstance(v, DeployedQuantState):
                    kind = ("head" if key == "qp_head" else
                            "expert" if is_moe and key != "qp" else "linear")
                    out[key] = _place_dq(v, kind, mesh, model_axis, plans)
                else:
                    out[key] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        return node.to(mesh.device)

    return walk(tree), plans


def head_shards(mesh, n_heads: int, n_kv_heads: int, *,
                model_axis: str = "model") -> int:
    """D where attention splits heads over the model axis (both head
    counts divide), else 1."""
    d = _mesh_dim(mesh, model_axis)
    return d if (d > 1 and n_heads % d == 0 and n_kv_heads % d == 0) else 1


def _heads(t: torch.Tensor, d: int, idx: int, dim: int) -> torch.Tensor:
    h = t.shape[dim] // d
    return t.narrow(dim, idx * h, h).contiguous()


def shard_paged_state(state, cfg, mesh, *, model_axis: str = "model"):
    """This rank's part of a paged decode state: KV pools ``[n_pages, P,
    Hkv, hd]`` and running exponents ``[B, Hkv]`` keep the rank's
    kv-heads, everything else stays whole.

    Heads split only where the axis divides BOTH head counts (attention
    splits q over Hq and the pools over Hkv); otherwise the state stays
    whole and attention runs the one-device path.  Returns ``(state,
    plans)`` with one "attn" ``LayerPlan`` per attention layer, for the
    float32 head gather's bytes.
    """
    from repro_torch.models.model import tree_map
    d = head_shards(mesh, cfg.n_heads, cfg.n_kv_heads, model_axis=model_axis)
    idx = _index(mesh, model_axis) if d > 1 else 0
    plans: dict = {}

    def place(path, leaf):
        key = path[-1] if path else ""
        if d > 1 and key in ("k_pages", "v_pages"):
            if key == "k_pages":
                i = len(plans)
                plans[f"attn.{i}"] = LayerPlan(
                    name=f"attn.{i}", kind="attn", mode="-", axis="heads",
                    d=d, n=cfg.n_heads * cfg.hd)
            leaf = _heads(leaf, d, idx, leaf.dim() - 2)
        elif d > 1 and key in ("k_exp", "v_exp"):
            leaf = _heads(leaf, d, idx, leaf.dim() - 1)
        return leaf.to(mesh.device)

    return tree_map(place, state), plans


def gather_paged_state(state, cfg, mesh, *, model_axis: str = "model"):
    """The whole paged state from every rank's part (the inverse of
    ``shard_paged_state``): KV pools and running exponents gathered over
    heads, every other leaf as this rank holds it."""
    from repro_torch.models.model import tree_map
    d = head_shards(mesh, cfg.n_heads, cfg.n_kv_heads, model_axis=model_axis)

    def gather(path, leaf):
        key = path[-1] if path else ""
        if d > 1 and key in ("k_pages", "v_pages", "k_exp", "v_exp"):
            dim = leaf.dim() - (2 if key.endswith("pages") else 1)
            return _all_gather(mesh, model_axis, leaf, dim)
        return leaf

    return tree_map(gather, state)


# ---------------------------------------------------------------------------
# Collective bodies (called by repro_torch.exec.ShardedBackend)
# ---------------------------------------------------------------------------


def _gather_codes(mesh, ax: str, y_local: torch.Tensor,
                  e_local: torch.Tensor, e_full: torch.Tensor,
                  e_is_col: bool, dim: int) -> torch.Tensor:
    """Lossless INT8 gather of a PSUM-mode output along ``dim``.

    ``y_local`` is ``code << e_last`` by Algorithm-1 construction (code in
    [-128, 127]), so the arithmetic right shift (int32) recovers the code
    exactly; only 1-byte codes cross the wire, and the left shift by the
    whole ``e_full`` row after the gather is exact.
    """
    eb = e_local.unsqueeze(-2) if e_is_col else e_local
    codes = shift_right(y_local, eb).to(torch.int8)
    codes = _all_gather(mesh, ax, codes, dim)
    ebf = e_full.unsqueeze(-2) if e_is_col else e_full
    return shift_left(codes.to(torch.int32), ebf)


def sharded_int_gemm(mesh, inner, x_codes, w_codes, psum_exps, *, gs: int,
                     model_axis: str = "model", wire: str = "int8"):
    """Mesh-parallel ``int_gemm``: x_codes [M, K] whole on every rank,
    ``w_codes`` this rank's placed slice (or a whole bank, cut here);
    returns the whole [M, N] INT32 output on every rank.

    Bit-exact to ``inner.int_gemm`` on one rank by construction: K
    shards only move full-precision INT32 partials (or finished PO2-grid
    codes), N shards only finished codes.  ``wire="fp32"`` keeps the
    same arithmetic but gathers 4-byte words.
    """
    d = _mesh_dim(mesh, model_axis)
    plan = placed_plan(w_codes)
    if plan is None:
        n_p = None if psum_exps is None else int(psum_exps.shape[0])
        gp = plan_gemm(k=int(w_codes.shape[0]), n=int(w_codes.shape[1]),
                       n_p=n_p, gs=gs, d=d)
        plan = LayerPlan(name="", kind="linear", mode=gp.mode, axis=gp.axis,
                         d=d, k=int(w_codes.shape[0]),
                         n=int(w_codes.shape[1]), n_p=n_p, gs=gs)
        if d > 1:
            w_codes = shard_codes(w_codes, plan, _index(mesh, model_axis))
    if plan.axis == "replicate" or d <= 1:
        return inner.int_gemm(x_codes, w_codes, psum_exps, gs=gs)
    if plan.d != d:
        raise ValueError(f"{plan.name}: placed for {plan.d} ranks, the "
                         f"mesh has {d}")
    ax = model_axis
    idx = _index(mesh, ax)
    m, n = int(x_codes.shape[0]), plan.n
    per_col = psum_exps is not None and psum_exps.dim() == 2

    if plan.axis == "n":
        nloc = n // d
        e_loc = psum_exps
        if per_col:
            e_loc = psum_exps[:, idx * nloc:(idx + 1) * nloc].contiguous()
        y = inner.int_gemm(x_codes, w_codes, e_loc, gs=gs)
        if psum_exps is None or wire == "fp32":
            return _all_gather(mesh, ax, y, 1)
        return _gather_codes(mesh, ax, y, e_loc[-1], psum_exps[-1], per_col,
                             dim=1)

    lo, hi = _k_span(plan, idx)
    x_loc = _pad_k(x_codes, plan, 1)[:, lo:hi].contiguous()
    if plan.mode == "w8a8":
        part = inner.int_gemm(x_loc, w_codes, None, gs=1)
        return _all_reduce(mesh, ax, part)

    # PSQ: this rank's n_p/D whole PSUM tiles as a stacked W8A8 GEMM (the
    # tiles ride the expert axis), quantized and dequantized locally
    n_p = plan.n_p
    kt = -(-plan.k // n_p)
    tpd = n_p // d
    xt = x_loc.reshape(m, tpd, kt).transpose(0, 1).contiguous()
    wt = w_codes.reshape(tpd, kt, n)
    tiles = inner.int_expert_gemm(xt, wt, None, gs=1)       # [tpd, M, N]
    e_loc = psum_exps[idx * tpd:(idx + 1) * tpd]
    eb = e_loc[:, None, :] if per_col else e_loc[:, None, None]
    q = dequantize_psum(quantize_psum(tiles, eb), eb)
    # The globally final tile stays raw INT32 (Algorithm 1 quantizes it
    # only once, after the full accumulation).
    tail = tiles[-1] if idx == d - 1 else q[-1]
    partial = tail + (q[:-1].sum(dim=0, dtype=torch.int32) if tpd > 1
                      else 0)
    e_last = psum_exps[-1]
    if wire == "int8" and n % d == 0:
        part = _reduce_scatter(mesh, ax, partial, 1)
        nloc = n // d
        e_sl = e_last[idx * nloc:(idx + 1) * nloc] if per_col else e_last
        codes = _all_gather(mesh, ax, quantize_psum(part, e_sl), 1)
        return dequantize_psum(codes, e_last)
    total = _all_reduce(mesh, ax, partial.contiguous())
    return dequantize_psum(quantize_psum(total, e_last), e_last)


def sharded_int_expert_gemm(mesh, inner, x_codes, w_codes, psum_exps, *,
                            gs: int, model_axis: str = "model",
                            wire: str = "int8"):
    """Expert-parallel stacked GEMM: [E, C, K] @ [E, K, N] over ``model``.

    ``x_codes`` and the exponent bank are whole on every rank, so
    "dispatch" is a slice of the rank's expert rows; ``w_codes`` holds
    the rank's E/D experts (or all E, cut here).  The combine gathers the
    per-expert outputs as INT8 codes (each expert's ``e_last`` is
    static), the int8 all-to-all equivalent; W8A8 banks gather INT32.
    The plan comes from x's full expert count, never from the codes'.
    """
    d = _mesh_dim(mesh, model_axis)
    n_exp = int(x_codes.shape[0])
    if d <= 1 or n_exp % d:
        return inner.int_expert_gemm(x_codes, w_codes, psum_exps, gs=gs)
    ax = model_axis
    epd = n_exp // d
    lo = _index(mesh, ax) * epd
    if int(w_codes.shape[0]) == n_exp:
        w_codes = w_codes[lo:lo + epd]
    elif int(w_codes.shape[0]) != epd:
        raise ValueError(f"expert codes {tuple(w_codes.shape)} are neither "
                         f"all {n_exp} experts nor {epd} of them")
    e_loc = None if psum_exps is None else psum_exps[lo:lo + epd]
    y = inner.int_expert_gemm(x_codes[lo:lo + epd], w_codes, e_loc, gs=gs)
    if psum_exps is None or wire == "fp32":
        return _all_gather(mesh, ax, y, 0)
    per_col = psum_exps.dim() == 3
    e_last, ef = e_loc[:, -1], psum_exps[:, -1]   # [E(_loc)] or [.., N]
    eb = e_last[:, None, :] if per_col else e_last[:, None, None]
    codes = _all_gather(mesh, ax, shift_right(y, eb).to(torch.int8), 0)
    ebf = ef[:, None, :] if per_col else ef[:, None, None]
    return shift_left(codes.to(torch.int32), ebf)


def split_heads(mesh, q, k, v, *, model_axis: str = "model"):
    """This rank's heads of q [..., Hq, hd] and the new K/V rows
    [B, C, Hkv, hd], where ``head_shards`` splits them (else as given)."""
    d = head_shards(mesh, q.shape[-2], k.shape[-2], model_axis=model_axis)
    if d == 1:
        return q, k, v
    idx = _index(mesh, model_axis)
    return tuple(_heads(t, d, idx, t.dim() - 2) for t in (q, k, v))


def gather_heads(mesh, out: torch.Tensor, n_heads: int, *,
                 model_axis: str = "model") -> torch.Tensor:
    """Attention output [..., H, hd] of this rank's heads -> all
    ``n_heads`` heads, gathered in float32 (as the reference prices it);
    a whole output passes through."""
    if out.shape[-2] == n_heads:
        return out
    full = _all_gather(mesh, model_axis, out.float(), out.dim() - 2)
    return full.to(out.dtype)


def sharded_kv_attention(mesh, inner, q, k_codes, v_codes, k_exp, v_exp,
                         length, *, model_axis: str = "model"):
    """Head-parallel attention over whole tensors (the reference's API):
    q [B, Hq, hd] or [B, C, Hq, hd], codes [B, S, Hkv, hd], exponents
    [B, Hkv].  Each rank attends its head slice against its slice of the
    INT8 cache, then the float32 head gather.  The engine runs the same
    pieces with its pools already split (``split_heads`` on the new rows,
    ``gather_heads`` before the out-projection)."""
    hq = int(q.shape[-2])
    d = head_shards(mesh, hq, int(k_codes.shape[2]), model_axis=model_axis)
    if d == 1:
        return inner.kv_attention(q, k_codes, v_codes, k_exp, v_exp, length)
    idx = _index(mesh, model_axis)
    out = inner.kv_attention(
        _heads(q, d, idx, q.dim() - 2), _heads(k_codes, d, idx, 2),
        _heads(v_codes, d, idx, 2), _heads(k_exp, d, idx, 1),
        _heads(v_exp, d, idx, 1), length)
    return gather_heads(mesh, out, hq, model_axis=model_axis)
