"""APSQ integer GEMM: torch oracle (``ref``) and CUDA kernels (``ops``)."""
from .ops import (apsq_expert_matmul_int8, apsq_matmul_f32,
                  apsq_matmul_int8, baseline_expert_matmul_int8,
                  baseline_matmul_int8, calibrate_exps, quantize_operands)
from .ref import (apsq_expert_matmul_ref, apsq_matmul_ref,
                  baseline_expert_matmul_ref, baseline_matmul_ref,
                  choose_exps, dequantize_psum, pad_ragged_k, psum_tiles,
                  quantize_psum, rshift_round)

__all__ = ["apsq_expert_matmul_int8", "apsq_expert_matmul_ref",
           "apsq_matmul_f32", "apsq_matmul_int8", "apsq_matmul_ref",
           "baseline_expert_matmul_int8", "baseline_expert_matmul_ref",
           "baseline_matmul_int8", "baseline_matmul_ref", "calibrate_exps",
           "choose_exps", "dequantize_psum", "pad_ragged_k", "psum_tiles",
           "quantize_operands", "quantize_psum", "rshift_round"]
