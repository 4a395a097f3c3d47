"""One-device dry run: count every (arch x shape cell) without allocating
it (port of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch all --cell all

For each cell the step (the train step for ``train_4k``, the prefill
forward for ``prefill_32k``, one decode step against a full cache for
``decode_32k`` and ``long_500k``) is built and run on meta tensors
(shapes and dtypes, no memory; the params' init runs under a
``FakeTensorMode``, since its ``torch.Generator`` has no meta device).
It records

  * ``flops``, ``bytes``, collectives: the aten ops the step dispatches
    (``repro_torch.roofline.op_cost``; aten does not fuse, so ``bytes``
    is an upper bound of a fused program's);
  * the three roofline terms at ``roofline.H100``, the dominant one and
    ``bound_s``;
  * ``peak_bytes``: the peak of live tensor storage (parameters, inputs,
    optimizer state and every temporary; ``op_cost.LiveBytes``), and
    ``fits``: whether it is within the card's 80 GB.  A cell that does
    not fit is a result, not an error.

The steps run on meta tensors rather than under ``FakeTensorMode``: a
fake op goes through the fake mode's dispatch and cache before its meta
kernel, where a meta tensor goes to the meta kernel directly, and the
port's steps are Python loops of many small ops (row blocks, WKV
chunks).  Both give the same counts (``tests/test_torch_dryrun.py``).  The float and fake-quant
programs do not branch on the device, so the counts are those of the
step on the card (``chip_smoke.py``'s ``dryrun`` phase holds the FLOPs
of a real step to them).  A model's units are identical: a model of
more than 3 units is counted at 2 and 3 units and extrapolated in a
serving cell (``count_cell``), as the reference multiplies a scanned
unit by its trip count.

The reference lowers and compiles each cell for 256 or 512 TPU chips;
the port runs on one device, so ``--mesh`` takes ``single`` only and
``--compress`` (the multi-pod gradient compression) raises.  The train
step is counted one microbatch at a time, in the trainer's own parts
(``train.trainer``): one microbatch's forward and backward and its
gradient accumulation is run once and counted ``microbatches`` times,
the accumulators' set-up and the AdamW update once (the report's
``parts``); the parts add up to ``make_train_step``'s count.  The steps are the float and fake-quant
programs, as the reference's are; no meta or fake tensor reaches a
kernel (a kernel's wrapper refuses one).  ``--backend-parity`` runs the
deployed GEMM probe (``search.backend_parity_report``) on real tensors
on ``--device`` and folds its measured time into ``backend_roofline``.
Reports land in ``experiments/dryrun/<arch>__<cell>__<mesh>__<quant>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, cells_for, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import SINGLE
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.roofline import (H100, attribute,
                                  backend_corrected_terms, cost_terms,
                                  model_flops)
from repro_torch.roofline.op_cost import LiveBytes, OpCost, tensor_bytes


# ---------------------------------------------------------------------------
# Per-arch defaults
# ---------------------------------------------------------------------------

def default_microbatches(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Microbatches of a train cell: 8 for d_model >= 2048, else 4 (the
    reference's choice; 1 for a serving cell)."""
    if cell.kind != "train":
        return 1
    return 8 if cfg.d_model >= 2048 else 4


def active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: only top_k experts count),
    counted on ``init_lm``'s params on meta tensors."""
    from repro_torch.models.model import tree_leaves
    total = sum(math.prod(t.shape)
                for _, t in tree_leaves(init_params(cfg, "meta")))
    if cfg.mlp == "moe":
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        active = expert * cfg.top_k // cfg.n_experts
        total = total - expert + active
    return int(total)


# ---------------------------------------------------------------------------
# input_specs: meta tensors (shape and dtype, no data) for every input
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The step's inputs as meta tensors, as the reference's
    ``ShapeDtypeStruct``s: tokens (and labels) [B, S] int32, a vision
    stub's ``embeds``, an encoder-decoder's ``enc_embeds`` (``enc_out``
    for decode); decode: one token [B, 1], ``pos`` and the dense decode
    state of a cache of S (units unstacked)."""
    from repro_torch.models.model import init_decode_state
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _spec((B, S), i32)}
        if cell.kind == "train":
            batch["labels"] = _spec((B, S), i32)
        if cfg.frontend == "vision":
            batch["embeds"] = _spec((B, cfg.n_frontend_tokens, cfg.d_model),
                                    torch.float32)
        if cfg.encdec:
            batch["enc_embeds"] = _spec((B, S, cfg.d_model), torch.float32)
        return batch
    batch = {"token": _spec((B, 1), i32), "pos": _spec((), i32),
             "state": init_decode_state(cfg, B, S, device="meta")}
    if cfg.encdec:
        batch["enc_out"] = _spec((B, S, cfg.d_model), cfg.torch_dtype)
    return batch


def _materialize(specs, device):
    """Zeros of each spec's shape and dtype on ``device`` (on ``meta``:
    shapes without data)."""
    from repro_torch.models.model import tree_map
    return tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=device), specs)


def init_params(cfg: ModelConfig, device):
    """``init_lm``'s params on ``device``.  On ``meta`` (shapes and
    dtypes, no data) the init runs under a ``FakeTensorMode`` (its
    ``torch.Generator`` has no meta device) and each leaf becomes a meta
    tensor of the same shape and dtype."""
    from repro_torch.models.model import init_lm, tree_map
    device = torch.device(device)
    if device.type != "meta":
        return init_lm(cfg, device=device)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_lm(cfg, device="cpu")
    return tree_map(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), fake)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """A cell's step: its inputs and its parts, ``[(name, fn, times)]``,
    run in order; ``fn()`` is counted ``times`` times and the last part
    returns the step's outputs."""
    args: dict
    parts: list
    info: dict = dataclasses.field(default_factory=dict)


def build_train(cfg: ModelConfig, cell: ShapeCell, *, device,
                microbatches: int | None = None) -> Step:
    """The trainer's step (``train.make_train_step``) in its own parts:
    the accumulators (``grad_carry``), one microbatch's forward, backward
    and accumulation (``microbatch_step``, counted ``microbatches``
    times), then the average and the AdamW update (``finish_grads``,
    ``update_step``)."""
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train.trainer import (_split_micro, finish_grads,
                                           grad_carry, make_loss_fn,
                                           microbatch_step, update_step)
    n = microbatches or default_microbatches(cfg, cell)
    ocfg = OptimConfig()
    params = init_params(cfg, device)
    opt_state = init_opt_state(params, ocfg)
    batch = _materialize(input_specs(cfg, cell), device)
    mb = _split_micro(batch, n)[0]
    loss_fn = make_loss_fn(cfg)
    carry = {}

    def accumulators():
        carry["c"] = grad_carry(params, n)

    def microbatch():
        carry["c"] = microbatch_step(carry.get("c"), loss_fn, params, mb)

    def update():
        loss, grads = finish_grads(carry.pop("c"), n)
        return update_step(params, opt_state, loss, grads, ocfg)

    parts = ([("accumulators", accumulators, 1)] if n > 1 else []) + [
        ("microbatch", microbatch, n), ("update", update, 1)]
    return Step(args={"params": params, "opt_state": opt_state,
                      "batch": batch}, parts=parts,
                info={"microbatches": n})


def build_prefill(cfg: ModelConfig, cell: ShapeCell, *, device) -> Step:
    """``forward`` over the prompt; the last position's logits."""
    from repro_torch.models.model import forward
    params = init_params(cfg, device)
    batch = _materialize(input_specs(cfg, cell), device)

    @torch.no_grad()
    def step():
        logits = forward(params, cfg, batch["tokens"],
                         embeds=batch.get("embeds"),
                         enc_embeds=batch.get("enc_embeds"))
        return logits[:, -1:, :]

    return Step(args={"params": params, "batch": batch},
                parts=[("step", step, 1)])


def build_decode(cfg: ModelConfig, cell: ShapeCell, *, device) -> Step:
    """One ``decode_step`` at the cache's last position (``pos`` = S - 1)
    against a dense decode state of S."""
    from repro_torch.models.model import decode_step
    params = init_params(cfg, device)
    specs = input_specs(cfg, cell)
    pos = cell.seq_len - 1
    batch = _materialize({k: v for k, v in specs.items() if k != "pos"},
                         device)

    @torch.no_grad()
    def step():
        return decode_step(params, cfg, batch["state"], batch["token"], pos,
                           enc_out=batch.get("enc_out"))

    return Step(args={"params": params, "batch": batch},
                parts=[("step", step, 1)], info={"pos": pos})


def build_cell(cfg: ModelConfig, cell: ShapeCell, *, device,
               microbatches: int | None = None) -> Step:
    if cell.kind == "train":
        return build_train(cfg, cell, device=device,
                           microbatches=microbatches)
    if cell.kind == "prefill":
        return build_prefill(cfg, cell, device=device)
    return build_decode(cfg, cell, device=device)


# ---------------------------------------------------------------------------
# Count one step
# ---------------------------------------------------------------------------

def count_step(step: Step) -> dict:
    """Run ``step``'s parts under ``OpCost`` and ``LiveBytes`` (on meta
    or on real tensors): FLOPs, bytes and collectives, each part's count
    times its ``times``; the arguments', outputs' and temporaries' bytes
    and the peak of live storage."""
    live = LiveBytes()
    live.track(step.args)
    arg_bytes = live.live
    totals = {"flops": 0.0, "bytes": 0.0, "collectives": None,
              "collective_counts": None, "warnings": [], "ops": {}}
    parts, out = {}, None
    with live:
        for name, fn, times in step.parts:
            with OpCost() as cost:
                out = fn()
            r = cost.report()
            parts[name] = {"flops": r["flops"], "bytes": r["bytes"],
                           "times": times}
            totals["flops"] += times * r["flops"]
            totals["bytes"] += times * r["bytes"]
            for key in ("collectives", "collective_counts"):
                totals[key] = {k: (totals[key] or {}).get(k, 0) + times * v
                               for k, v in r[key].items()}
            totals["warnings"] += [w for w in r["warnings"]
                                   if w not in totals["warnings"]]
            for op, v in r["ops"].items():
                row = totals["ops"].setdefault(op, {"flops": 0, "bytes": 0,
                                                    "calls": 0})
                for k in row:
                    row[k] += times * v[k]
    out_bytes = tensor_bytes(out)
    return {**totals, "parts": parts,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(live.peak - arg_bytes - out_bytes, 0),
            "peak_bytes": live.peak}


def _count_meta(cfg: ModelConfig, cell: ShapeCell,
                microbatches: int | None = None) -> dict:
    step = build_cell(cfg, cell, device="meta", microbatches=microbatches)
    counts = count_step(step)
    counts.update(step.info)
    return counts


def with_units(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` repeats of its block pattern (the remainder
    layers kept; an encoder-decoder's encoder cut alike)."""
    n = len(cfg.block_pattern)
    return cfg.scaled(n_layers=k * n + cfg.n_rem,
                      n_enc_layers=k * n if cfg.encdec else 0)


def _depth_scalable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    return cell.is_serving and cfg.n_units > 3 and (
        not cfg.encdec
        or cfg.n_enc_layers == cfg.n_units * len(cfg.block_pattern))


def _extrapolate(c2, c3, n: int):
    """``c2 + (n - 2) (c3 - c2)`` on every number of two counts at 2 and
    3 units (dicts nest); what is not a number is taken from ``c3``."""
    if isinstance(c2, dict):
        return {k: _extrapolate(c2.get(k, 0), v, n) for k, v in c3.items()}
    if isinstance(c3, bool) or not isinstance(c3, (int, float)):
        return c3
    return c2 + (n - 2) * (c3 - c2)


def count_cell(cfg: ModelConfig, cell: ShapeCell,
               microbatches: int | None = None) -> dict:
    """``build_cell`` and ``count_step`` on meta tensors: nothing is
    allocated.  A serving cell of a model of more than 3 units is counted
    at 2 and at 3 units and extrapolated linearly to all of them, as the
    reference multiplies a scanned unit by its trip count: its units are
    identical and keep nothing for a backward pass, so every count and
    the peak grow by the same amount per unit from the second on
    (``tests/test_torch_dryrun.py`` holds it against direct counts).  A
    train cell is counted at full depth: its peak, where the backward
    holds saved inputs and gradients of several units, does not grow
    linearly with the depth."""
    if not _depth_scalable(cfg, cell):
        return {**_count_meta(cfg, cell, microbatches), "depth": "counted"}
    c2 = _count_meta(with_units(cfg, 2), cell)
    c3 = _count_meta(with_units(cfg, 3), cell)
    counts = _extrapolate(c2, c3, cfg.n_units)
    counts["warnings"] = sorted(set(c2["warnings"]) | set(c3["warnings"]))
    counts["depth"] = f"extrapolated from 2 and 3 of {cfg.n_units} units"
    return counts


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _config(arch: str, quant, smoke: bool) -> ModelConfig:
    cfg = get_config(arch, quant=quant)
    if not smoke:
        return cfg
    q = cfg.quant_policy if cfg.quant_policy is not None else cfg.quant
    return get_smoke(arch).with_quant(q)


def run_cell(arch: str, cell_name: str, *, quant="none",
             verbose: bool = True, overrides: dict | None = None,
             backend_parity: bool = False, quant_name: str | None = None,
             smoke: bool = False, shape: ShapeCell | None = None,
             device=None, microbatches: int | None = None) -> dict:
    """Count one cell on meta tensors.  ``quant`` is a preset string, a
    ``QuantConfig`` or a per-layer ``QuantPolicy``; ``smoke`` takes the
    arch's smoke config; ``shape`` replaces the cell's shape (B, S);
    ``backend_parity`` attaches the deployed-GEMM probe, run on real
    tensors on ``device`` (None: the card); ``microbatches`` splits a
    train cell (None: ``default_microbatches``).  Failures are reported
    (``ok`` False, ``error``), not raised."""
    from repro_torch.search.evaluate import (backend_parity_report,
                                             describe_policy)
    cfg = _config(arch, quant, smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = shape or cells_for(arch)[cell_name]
    quant_label = quant_name or (
        quant if isinstance(quant, str) else type(quant).__name__)
    report = {"arch": arch, "cell": cell_name, "mesh": SINGLE.name,
              "quant": quant_label, "ok": False,
              "config": cfg.name, "hw": H100.name,
              "shape": [cell.global_batch, cell.seq_len],
              "overrides": {k: str(v) for k, v in (overrides or {}).items()}}
    if not isinstance(quant, str):
        report["quant_policy"] = describe_policy(quant)
    if backend_parity:
        report["backend_parity"] = backend_parity_report(
            cfg, device=resolve_device(device))
    t0 = time.perf_counter()
    try:
        counts = count_cell(cfg, cell, microbatches)
        report["count_s"] = round(time.perf_counter() - t0, 1)
        terms = cost_terms({"flops": counts["flops"],
                            "bytes accessed": counts["bytes"]},
                           counts["collectives"], SINGLE.n_chips)
        report.update(terms)
        if report.get("backend_parity"):
            corr = backend_corrected_terms(terms, report["backend_parity"])
            if corr:
                report["backend_roofline"] = corr
        for k in ("collectives", "collective_counts", "parts", "depth",
                  "argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "peak_bytes", "microbatches"):
            if k in counts:
                report[k] = counts[k]
        report["op_warnings"] = counts["warnings"][:10]
        report["fits"] = counts["peak_bytes"] <= H100.hbm_bytes
        if "microbatch" in counts["parts"]:
            report["flops_per_microbatch"] = \
                counts["parts"]["microbatch"]["flops"]
        top = {"ops": counts["ops"]}
        report["top_ops_by_flops"] = attribute(top, 5, key="flops")
        report["top_ops_by_bytes"] = attribute(top, 5, key="bytes")
        n_act = active_params(cfg)
        tokens = (cell.global_batch * cell.seq_len
                  if cell.kind in ("train", "prefill")
                  else cell.global_batch)
        mf = model_flops(n_act, tokens, training=(cell.kind == "train"))
        report["active_params"] = n_act
        report["model_flops_global"] = mf
        report["model_flops_per_chip"] = mf / SINGLE.n_chips
        if terms["flops"]:
            report["useful_flops_fraction"] = mf / SINGLE.n_chips \
                / terms["flops"]
        report["ok"] = True
    except Exception as e:  # noqa: BLE001 - every failure is reported
        report["error"] = f"{type(e).__name__}: {e}"
        report["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        status = "OK " if report["ok"] else "FAIL"
        extra = (f"dom={report.get('dominant', '?'):>10s} "
                 f"bound={report.get('bound_s', 0):.3e}s "
                 f"peak={report.get('peak_bytes', 0) / 1e9:.1f}GB "
                 f"fits={report.get('fits')}"
                 if report["ok"] else report.get("error", ""))
        print(f"[dryrun] {status} {arch:24s} {cell_name:12s} "
              f"{SINGLE.name:8s} {report.get('count_s', 0):6.1f}s  {extra}",
              flush=True)
    return report


def save_report(report: dict, out_dir: str = "experiments/dryrun") -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{report['arch']}__{report['cell']}__{report['mesh']}"
            f"__{report.get('quant', 'none')}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump({k: v for k, v in report.items() if k != "traceback"},
                  f, indent=1, default=str)
    return path


def main(argv=None) -> int:
    from repro_torch.search.evaluate import policy_sweep
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--cell", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="single", choices=("single",),
                    help="one device (the meshes wait for the dist "
                         "training slice)")
    ap.add_argument("--quant", default="none",
                    choices=("none", "w8a8", "psq", "apsq"))
    ap.add_argument("--quant-policy", default=None,
                    help="named heterogeneous per-layer policy "
                         "(repro_torch.quant.policy_presets; overrides "
                         "--quant) or 'all' to sweep every preset")
    ap.add_argument("--backend-parity", action="store_true",
                    help="attach the oracle-vs-cuda deployed GEMM parity "
                         "and timing probe to each quantized cell report")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--compress", action="store_true",
                    help="INT8 DCN gradient compression (multi-pod train; "
                         "raises: not ported)")
    ap.add_argument("--device", default=None,
                    help="where --backend-parity runs (default: the card; "
                         "'cpu' runs the torch oracle alone)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.compress:
        raise NotImplementedError(
            "--compress is the multi-pod INT8 gradient compression of "
            "repro.dist, which waits for the port's dist training slice "
            "(ROADMAP queue 1)")

    quants = [(args.quant, args.quant)]
    if args.quant_policy is not None:
        try:
            quants = policy_sweep(args.quant_policy)
        except KeyError as e:
            raise SystemExit(e.args[0])

    archs = ARCH_NAMES if args.arch == "all" else (args.arch,)
    failures = 0
    for arch in archs:
        cell_names = (cells_for(arch) if args.cell == "all"
                      else (args.cell,))
        for cell_name in cell_names:
            if cell_name not in cells_for(arch):
                print(f"[dryrun] SKIP {arch} {cell_name} (inapplicable)")
                continue
            for qname, quant in quants:
                rep = run_cell(arch, cell_name, quant=quant, quant_name=qname,
                               backend_parity=args.backend_parity,
                               device=args.device,
                               microbatches=args.microbatches)
                save_report(rep, args.out)
                failures += 0 if rep["ok"] else 1
    print(f"[dryrun] done; {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
