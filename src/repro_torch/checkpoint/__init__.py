"""Carrying weights across from the JAX package: in memory (``convert``)
and from a checkpoint directory the JAX package wrote (``store``)."""
from .convert import convert_params, to_device, unstack_units
from .store import latest_step, list_steps, restore

__all__ = ["convert_params", "latest_step", "list_steps", "restore",
           "to_device", "unstack_units"]
