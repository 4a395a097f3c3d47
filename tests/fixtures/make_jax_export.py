"""Write the JAX export that ``chip_smoke.py``'s ``load`` phase and
``tests/test_torch_checkpoint.py`` serve with the PyTorch port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_jax_export.py [OUT]

It needs JAX (it runs the JAX package).  The model is the JAX package's
``starcoder2-smoke`` (LayerNorm, GELU MLP) with a tied head and stacked
units (``scan_layers``), random weights from ``PRNGKey(SEED)``,
calibrated on seeded tokens and exported under the ``mix2_ffn4`` rules
(attention APSQ gs=2 n_p=4, FFN APSQ gs=4 n_p=8, the tied head W8A8).
The JAX package's own ``checkpoint.save`` writes it to
``OUT/step-000000000`` (default: ``jax_export_starcoder2_smoke`` beside
this file).  The manifest's ``extra`` holds the request prompts, the
engine settings and the greedy tokens of the JAX
``PagedServingEngine(backend="oracle")`` on them.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "jax_export_starcoder2_smoke")
ARCH = "starcoder2-15b"
SEED = 5
ENGINE = dict(max_batch=3, page_size=4, n_pages=40, prefill_chunk=8,
              decode_horizon=4)
PROMPTS = ((11, 7), (5, 6), (17, 8), (1, 6))   # (prompt length, new tokens)


def make(out_dir: str = DEFAULT_OUT) -> str:
    """Build, calibrate, export, serve and save; returns the step path."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import save
    from repro.configs import get_smoke
    from repro.models.model import init_lm
    from repro.quant import calibrate_model, export_quantized
    from repro.quant.qat import policy_presets
    from repro.serving import PagedServingEngine, Request

    cfg = dataclasses.replace(get_smoke(ARCH), tie_embeddings=True,
                              scan_layers=True).with_quant(
        policy_presets()["mix2_ffn4"])
    rng = np.random.default_rng(SEED)
    calib = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    params = init_lm(jax.random.PRNGKey(SEED), cfg)
    deploy, _ = export_quantized(calibrate_model(
        params, cfg, {"tokens": jnp.asarray(calib)}))
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n, _ in PROMPTS]
    engine = PagedServingEngine(deploy, cfg, backend="oracle", **ENGINE)
    done = engine.run([Request(uid=i, tokens=p, max_new_tokens=m)
                       for i, (p, (_, m)) in enumerate(zip(prompts,
                                                           PROMPTS))])
    out = {r.uid: [int(t) for t in r.out] for r in done}
    extra = {
        "arch": ARCH, "smoke": True, "tie_embeddings": True,
        "scan_layers": True, "policy": "mix2_ffn4", "seed": SEED,
        "engine": dict(ENGINE, backend="oracle"),
        "requests": [{"uid": i, "tokens": [int(t) for t in p],
                      "max_new_tokens": m, "out": out[i]}
                     for i, (p, (_, m)) in enumerate(zip(prompts, PROMPTS))],
    }
    return save(out_dir, 0, deploy, extra=extra)


if __name__ == "__main__":
    print(make(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT))
