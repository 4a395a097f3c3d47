"""Hand-written CUDA kernels of the port, one per Pallas kernel of
``repro.kernels`` on the ported path, each with its plain PyTorch
version (``ref``) and a launch counter (``_build.launch_counts``)."""
from ._build import build_all, launch_counts, reset_launch_counts

__all__ = ["build_all", "launch_counts", "reset_launch_counts"]
