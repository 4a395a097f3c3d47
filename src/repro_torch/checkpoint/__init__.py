"""Carrying weights across from the JAX package: in memory (``convert``),
and checkpoint directories in its format, read and written (``store``)."""
from .convert import convert_params, to_device, unstack_units
from .store import (AsyncCheckpointer, install_signal_handler, latest_step,
                    list_steps, restore, save)

__all__ = ["AsyncCheckpointer", "convert_params", "install_signal_handler",
           "latest_step", "list_steps", "restore", "save", "to_device",
           "unstack_units"]
