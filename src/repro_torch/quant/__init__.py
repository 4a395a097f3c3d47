"""Quantization workflow of the port: policies, calibration, QAT
objectives, export."""
from .export import export_quantized, snap_params_po2
from .policy import QuantPolicy, QuantRule, resolve_quant
from .qat import (SweepResult, calibrate_model, distill_loss,
                  make_distill_loss_fn, policy_presets, quant_variants)

__all__ = ["QuantPolicy", "QuantRule", "SweepResult", "calibrate_model",
           "distill_loss", "export_quantized", "make_distill_loss_fn",
           "policy_presets", "quant_variants", "resolve_quant",
           "snap_params_po2"]
