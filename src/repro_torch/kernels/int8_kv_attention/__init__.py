"""INT8-KV attention: torch oracle (``ref``) and CUDA kernel (``ops``)."""
from .ops import cache_bytes, int8_kv_attention, int8_kv_attention_f32
from .ref import (NEG_INF, dequantize_kv_po2, int8_kv_attention_ref,
                  quantize_kv_po2)

__all__ = ["NEG_INF", "cache_bytes", "dequantize_kv_po2",
           "int8_kv_attention", "int8_kv_attention_f32",
           "int8_kv_attention_ref", "quantize_kv_po2"]
