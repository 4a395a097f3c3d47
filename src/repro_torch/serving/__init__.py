"""Serving over the paged INT8 KV cache (port of ``repro.serving``)."""
from .engine import PagedServingEngine, Request
from .paged_cache import page_span
from .scheduler import PageAllocator, Scheduler

__all__ = ["PageAllocator", "PagedServingEngine", "Request", "Scheduler",
           "page_span"]
