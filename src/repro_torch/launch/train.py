"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``
(port of ``repro/launch/train.py`` on one device).

  config registry -> (optionally reduced) model -> Trainer (microbatching,
  remat, straggler watchdog) -> deterministic data -> async checkpoints
  with resume.

The paper's technique rides on ``--quant apsq --gs 2 --np 8``: APSQ on
every projection GEMM.  Runs on the card unless ``--device cpu``; the
JAX launcher's ``--mesh`` and ``--compress-dcn`` are multi-device and
not ported.  For example::

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --quant apsq --gs 2 --np 8 --steps 20 --microbatches 2 \\
        --ckpt-dir ckpt/tinyllama
"""
from __future__ import annotations

import argparse


def build(args):
    """(ModelConfig, OptimConfig, TrainConfig, DataConfig) of ``args``."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core import QuantConfig
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig

    if args.smoke:
        cfg = get_smoke(args.arch)
        if args.quant != "none":
            q = {"apsq": QuantConfig.apsq(gs=args.gs, n_p=args.n_p),
                 "psq": QuantConfig.psq(n_p=args.n_p),
                 "w8a8": QuantConfig.w8a8()}[args.quant]
            cfg = cfg.with_quant(q)
    else:
        cfg = get_config(args.arch, quant=args.quant, gs=args.gs,
                         n_p=args.n_p)
    ocfg = OptimConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5))
    tcfg = TrainConfig(microbatches=args.microbatches, steps=args.steps,
                       save_every=args.save_every, ckpt_dir=args.ckpt_dir)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, frontend=cfg.frontend,
                      d_model=cfg.d_model,
                      n_frontend_tokens=cfg.n_frontend_tokens
                      or args.seq_len)
    return cfg, ocfg, tcfg, data


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--quant", default="none",
                    choices=("none", "w8a8", "psq", "apsq"))
    ap.add_argument("--gs", type=int, default=2)
    ap.add_argument("--np", dest="n_p", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from repro_torch.train import Trainer

    cfg, ocfg, tcfg, data = build(args)
    trainer = Trainer(cfg, ocfg, tcfg, device=args.device)
    trainer.fit(data)
    print(f"[train] finished {args.steps} steps; "
          f"checkpoints in {args.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
