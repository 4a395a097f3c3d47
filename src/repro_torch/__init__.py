"""APSQ port to PyTorch + hand-written CUDA kernels for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the same subpackage
and function names (``core``, ``kernels``, ``exec``, ``models``,
``serving``, ``quant``, ``configs``, ``checkpoint``, ``data``,
``optim``, ``train``, ``launch``), so every ported module has a
reference of the same name.  It imports ``torch`` and numpy only.

The integer hot path — the APSQ GEMM (generic grid, m=1 decode form,
fused MoE expert bank), the INT32-accumulator W8A8 GEMMs (plain and
expert bank) and flash-decode attention over the paged INT8 KV cache —
runs on CUDA C++ kernels under
``repro_torch/kernels/*/csrc``, built with ``nvcc`` at first use and
bound through ``ctypes``.  Each kernel keeps a plain PyTorch version in
the same module, which its wrapper uses only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).

The port covers the production path of dense and MoE decoders:
``init_lm`` -> ``calibrate_model`` -> ``export_quantized`` ->
``PagedServingEngine.from_exported`` -> ``run``, and serves an export
the JAX package saved: ``checkpoint.restore`` -> ``PagedServingEngine``.
It trains dense decoders with APSQ quantization-aware training
(``train.Trainer``, ``python -m repro_torch.launch.train``): fake quant
with straight-through gradients, plain PyTorch on the card (the training
step reaches no kernel), checkpoints in the JAX package's format.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
