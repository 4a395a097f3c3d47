"""Execution backends for deployed integer ops (port of ``repro.exec``)."""
from .backends import (AutoBackend, CudaBackend, ExecBackend, OracleBackend,
                       ShardedBackend, available_backends,
                       backend_parity_check, execute_expert_gemm,
                       execute_gemm, execute_kv_attention, get_backend,
                       kv_block_size, quantize_activations,
                       register_backend)

__all__ = [
    "AutoBackend", "CudaBackend", "ExecBackend", "OracleBackend",
    "ShardedBackend", "available_backends", "backend_parity_check",
    "execute_expert_gemm", "execute_gemm", "execute_kv_attention",
    "get_backend", "kv_block_size", "quantize_activations",
    "register_backend",
]
