"""Carrying weights across from the JAX package (``convert``)."""
from .convert import convert_params, to_device, unstack_units

__all__ = ["convert_params", "to_device", "unstack_units"]
