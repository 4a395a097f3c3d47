"""Analytical accelerator energy model (paper eqs 1-6) + layer walks (port
of ``repro.energy``: pure Python, copied)."""
from .model import (
    HORO,
    AcceleratorConfig,
    EnergyConstants,
    LayerEnergySpec,
    LayerShape,
    access_counts,
    energy_summary,
    layer_energy,
    model_energy,
    savings,
)
from .workloads import (
    arch_layers,
    bert_base,
    efficientvit_b1,
    llama2_7b,
    llama2_7b_autoregressive,
    llama2_7b_combined,
    segformer_b0,
)

__all__ = [
    "HORO", "AcceleratorConfig", "EnergyConstants", "LayerEnergySpec",
    "LayerShape",
    "access_counts", "energy_summary", "layer_energy", "model_energy",
    "savings", "arch_layers", "bert_base", "efficientvit_b1", "llama2_7b",
    "llama2_7b_autoregressive", "llama2_7b_combined", "segformer_b0",
]
