"""Deterministic synthetic data pipeline (port of ``repro.data``)."""
from .pipeline import (DataConfig, PrefetchIterator, SyntheticCorpus,
                       device_put_batch)

__all__ = ["DataConfig", "PrefetchIterator", "SyntheticCorpus",
           "device_put_batch"]
