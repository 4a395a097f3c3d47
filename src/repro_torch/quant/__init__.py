"""Quantization workflow of the port: policies, calibration, export."""
from .export import export_quantized
from .policy import QuantPolicy, QuantRule, resolve_quant
from .qat import calibrate_model, policy_presets

__all__ = ["QuantPolicy", "QuantRule", "calibrate_model", "export_quantized",
           "policy_presets", "resolve_quant"]
