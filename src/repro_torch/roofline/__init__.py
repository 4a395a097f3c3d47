"""Roofline: the three-term model of one step on one device (H100 by
default), from the aten ops the step dispatches."""
from .analysis import (
    COLLECTIVE_OPS,
    H100,
    HwSpec,
    V5E,
    backend_corrected_terms,
    cost_terms,
    gemm_analytic_us,
    model_flops,
    useful_fraction,
)
from .op_cost import LiveBytes, OpCost, analyze, attribute

__all__ = ["COLLECTIVE_OPS", "H100", "HwSpec", "LiveBytes", "OpCost", "V5E",
           "analyze", "attribute", "backend_corrected_terms", "cost_terms",
           "gemm_analytic_us", "model_flops", "useful_fraction"]
