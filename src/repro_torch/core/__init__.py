"""Core quantization (port of ``repro.core``): fake quant with
straight-through gradients, APSQ accumulation, quantized linears."""
from .apsq import (apsq_accumulate, apsq_accumulate_reference, apsq_matmul,
                   psq_accumulate)
from .layers import (DeployedQuantState, PsumQuantConfig, QuantConfig,
                     QuantState, TapRecord, calibrate_dense, deployed_dense,
                     effective_n_p, psum_group_size, quant_dense,
                     quant_params_init, tied_head_weight)
from .po2 import ceil_log2, floor_log2, pow2
from .quantizers import (QuantSpec, floor_ste, grad_scale, init_alpha_from,
                         init_log2_alpha_from, lsq_gradient_scale,
                         lsq_quantize, po2_quantize, po2_quantize_codes,
                         po2_scale, qrange, round_half_up_ste, round_ste)

__all__ = [
    "DeployedQuantState", "PsumQuantConfig", "QuantConfig", "QuantSpec",
    "QuantState", "TapRecord", "apsq_accumulate", "apsq_accumulate_reference",
    "apsq_matmul", "calibrate_dense", "ceil_log2", "deployed_dense",
    "effective_n_p", "floor_log2", "floor_ste", "grad_scale",
    "init_alpha_from", "init_log2_alpha_from", "lsq_gradient_scale",
    "lsq_quantize", "po2_quantize", "po2_quantize_codes", "po2_scale",
    "pow2", "psq_accumulate", "psum_group_size", "qrange", "quant_dense",
    "quant_params_init", "round_half_up_ste", "round_ste",
    "tied_head_weight",
]
