"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``
(port of ``repro/launch/serve.py`` on one device).

Builds a model from the config registry (the full published config, or
``--smoke`` for the reduced one) with random weights from ``--seed`` and
drives a synthetic request stream through a continuous-batching engine,
printing per-request outputs and throughput.  The default ``dense``
engine (``ServingEngine``) keeps float KV caches and serves every layer
kind, sliding-window attention included; ``--engine paged`` serves
through the paged INT8 KV cache (``PagedServingEngine``).
``--exported`` calibrates and exports to INT8 codes first, so the
projections run on the APSQ kernels.  Runs on the card unless
``--device cpu``.  For example::

    python -m repro_torch.launch.serve --arch recurrentgemma-2b --exported

``--mesh SHAPE`` (``1xD``, data x model, or ``PxDxM``) serves across D
ranks of the model axis (``repro_torch.dist.tp``) and implies
``--engine paged --exported``; ``--wire`` picks the collectives' payload.
Start one process per rank::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch tinyllama-1.1b --mesh 1x2

Rank r runs on ``cuda:(LOCAL_RANK % device_count)`` (ranks may share a
card; the collectives then go over gloo), builds and exports the whole
model from ``--seed`` and keeps its slices.  Only rank 0 prints results,
after checking that every rank generated the same tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--engine", choices=("dense", "paged"), default="dense",
                    help="dense float KV slots, or the paged INT8 KV "
                         "cache with the continuous-batching scheduler")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="fused decode steps per engine heartbeat (pow2); "
                         "paged engine only")
    ap.add_argument("--backend", default="auto",
                    help="exec backend for integer ops: auto|oracle|cuda")
    ap.add_argument("--mesh", default=None, metavar="SHAPE",
                    help="serve across a mesh of torch.distributed ranks, "
                         "e.g. '1x2' (data x model) or '2x1x2' (pod x "
                         "data x model); implies --engine paged "
                         "--exported; the model axis shards INT8 code "
                         "banks and KV head pools")
    ap.add_argument("--wire", choices=("int8", "fp32"), default="int8",
                    help="collective payload for sharded serving: int8 "
                         "codes (default) or 4-byte words (same results)")
    ap.add_argument("--exported", action="store_true",
                    help="calibrate + export to INT8 codes and serve "
                         "through the integer kernel path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap


def _quiet(*args, **kw) -> None:
    """``print`` of the ranks past 0: only rank 0 reports."""


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core import QuantConfig
    from repro_torch.models import init_lm
    from repro_torch.serving import PagedServingEngine, Request, \
        ServingEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encdec:
        raise SystemExit("enc-dec serving requires encoder inputs: decode "
                         "through repro_torch.models.decode_step(enc_out="
                         "encode(...)) for seamless")
    mesh, device, say = None, args.device, print
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_smoke_mesh
        owns_world = not dist.is_initialized()
        shape = tuple(int(s) for s in args.mesh.lower().split("x"))
        axes = (("pod", "data", "model") if len(shape) == 3
                else ("data", "model"))
        mesh = make_smoke_mesh(shape, axes, device=args.device)
        device = mesh.device
        say = print if mesh.rank == 0 else _quiet
        args.engine, args.exported = "paged", True
        say(f"[serve] mesh {mesh.shape} wire={args.wire} transport="
            f"{mesh.backend} on {device}"
            + (" (the ranks share this GPU)" if mesh.shared_device else ""))
    if args.exported and cfg.policy is None:
        # integer serving needs quantizer state: the paper's APSQ preset
        cfg = cfg.with_quant(QuantConfig.apsq(gs=2, n_p=4))
        say(f"[serve] {args.arch} has quant disabled -> "
            f"applying apsq(gs=2, n_p=4) for --exported")
    params = init_lm(cfg, seed=args.seed, device=device)
    if args.exported:
        from repro_torch.quant import calibrate_model
        tok = np.random.default_rng(args.seed).integers(0, cfg.vocab,
                                                        size=(2, 32))
        params = calibrate_model(params, cfg, {"tokens": tok})

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        size=rng.integers(4, 32)),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]

    if args.engine == "paged":
        n_pages = args.cache_len // args.page_size * args.max_batch + 1
        kw = dict(max_batch=args.max_batch, page_size=args.page_size,
                  n_pages=n_pages, backend=args.backend,
                  decode_horizon=args.decode_horizon, mesh=mesh,
                  wire=args.wire)
        cls = PagedServingEngine
    else:
        kw = dict(max_batch=args.max_batch, cache_len=args.cache_len,
                  backend=args.backend)
        cls = ServingEngine
    engine = (cls.from_exported(params, cfg, **kw) if args.exported
              else cls(params, cfg, **kw))
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    if mesh is not None:
        outs = sorted((r.uid, r.out) for r in done)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, outs)
        if any(o != outs for o in every):
            raise RuntimeError("the ranks generated different tokens")
        if owns_world:
            dist.destroy_process_group()
    toks = sum(len(r.out) for r in done)
    rate = ("" if mesh is not None and mesh.shared_device   # time-sliced
            else f" ({toks / dt:.1f} tok/s)")
    say(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s{rate}")
    for r in done[:4]:
        say(f"  req {r.uid}: prompt[{len(r.tokens)}] -> {r.out}")
    return done


if __name__ == "__main__":
    main()
