"""Serving engines, dense and over the paged INT8 KV cache (port of
``repro.serving``)."""
from .engine import (PagedServingEngine, Request, ServingEngine,
                     dequantize_kv, quantize_kv)
from .paged_cache import page_span
from .scheduler import PageAllocator, Scheduler

__all__ = ["PageAllocator", "PagedServingEngine", "Request", "Scheduler",
           "ServingEngine", "dequantize_kv", "page_span", "quantize_kv"]
