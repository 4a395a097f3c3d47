"""Core quantization (port of ``repro.core``, forward only)."""
from .apsq import apsq_matmul
from .layers import (DeployedQuantState, PsumQuantConfig, QuantConfig,
                     QuantState, TapRecord, calibrate_dense, deployed_dense,
                     effective_n_p, psum_group_size, quant_dense,
                     quant_params_init, tied_head_weight)
from .po2 import ceil_log2, floor_log2, pow2
from .quantizers import (init_alpha_from, lsq_quantize, po2_quantize,
                         po2_quantize_codes, qrange)

__all__ = [
    "DeployedQuantState", "PsumQuantConfig", "QuantConfig", "QuantState",
    "TapRecord", "apsq_matmul", "calibrate_dense", "ceil_log2",
    "deployed_dense", "effective_n_p", "floor_log2", "init_alpha_from",
    "lsq_quantize", "po2_quantize", "po2_quantize_codes", "pow2",
    "psum_group_size", "qrange", "quant_dense", "quant_params_init",
    "tied_head_weight",
]
