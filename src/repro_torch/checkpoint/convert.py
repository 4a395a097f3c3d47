"""Carry a JAX-side params tree across to the port, without JAX.

``convert_params`` takes the tree as the JAX package builds it — nested
dicts whose leaves are arrays (numpy, or anything ``np.asarray``
accepts), quantizer states and deployed states — and returns the port's
tree of torch tensors with ``repro_torch.core`` states.

Nothing of the JAX package is imported: states are recognised by their
attribute names (``w_codes``/``ax_exp``/``aw_exp``/``psum_exps`` for a
deployed state, ``aw``/``ax``/``ap`` for a quantizer state; ``spec``,
``name``, ``out_dims`` ride along), and a ``spec`` is rebuilt from its
fields.  Scan-stacked units (a ``units`` subtree keyed by pattern
position with a leading unit axis: the decoder's ``params["units"]``
under ``scan_layers``, and an encoder-decoder's
``params["encoder"]["units"]``, which the JAX package stacks always) are
unstacked into the port's ``{"u0": ..., "u1": ...}`` layout; a MoE
layer's stacked expert states (``[U, E, ...]`` leaves) come out as one
``[E, ...]`` state per unit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (DeployedQuantState, PsumQuantConfig,
                              QuantConfig, QuantState)
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _spec(spec):
    if spec is None:
        return None
    ps = spec.psum
    return QuantConfig(enabled=bool(spec.enabled), w_bits=int(spec.w_bits),
                       a_bits=int(spec.a_bits),
                       per_channel_w=bool(spec.per_channel_w),
                       psum=PsumQuantConfig(mode=str(ps.mode), gs=int(ps.gs),
                                            n_p=int(ps.n_p),
                                            bits=int(ps.bits)))


def _opt(a, device):
    return None if a is None else _tensor(a, device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if hasattr(node, "w_codes") and hasattr(node, "psum_exps"):
        return DeployedQuantState(
            w_codes=_tensor(node.w_codes, device),
            ax_exp=_tensor(node.ax_exp, device),
            aw_exp=_tensor(node.aw_exp, device),
            psum_exps=_opt(node.psum_exps, device), spec=_spec(node.spec),
            name=str(node.name), out_dims=tuple(node.out_dims))
    if hasattr(node, "aw") and hasattr(node, "ax") and hasattr(node, "ap"):
        return QuantState(aw=_tensor(node.aw, device),
                          ax=_tensor(node.ax, device),
                          ap=_opt(node.ap, device), spec=_spec(node.spec),
                          name=str(node.name))
    if node is None:
        return None
    return _tensor(node, device)


def _index(node, i):
    """Unit ``i`` of a scan-stacked subtree."""
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    if isinstance(node, DeployedQuantState):
        return DeployedQuantState(
            w_codes=node.w_codes[i], ax_exp=node.ax_exp[i],
            aw_exp=node.aw_exp[i],
            psum_exps=None if node.psum_exps is None else node.psum_exps[i],
            spec=node.spec, name=node.name, out_dims=node.out_dims)
    if isinstance(node, QuantState):
        return QuantState(aw=node.aw[i], ax=node.ax[i],
                          ap=None if node.ap is None else node.ap[i],
                          spec=node.spec, name=node.name)
    return node[i]


def _n_units(node) -> int:
    if isinstance(node, dict):
        return _n_units(next(iter(node.values())))
    if isinstance(node, DeployedQuantState):
        return node.w_codes.shape[0]
    if isinstance(node, QuantState):
        return node.ax.shape[0]
    return node.shape[0]


def unstack_units(units: dict) -> dict:
    """{pattern position: stacked layer} -> {"u<i>": {position: layer}};
    an already unstacked dict is returned as is."""
    if all(k.startswith("u") for k in units):
        return units
    n = _n_units(units)
    return {f"u{i}": _index(units, i) for i in range(n)}


def unstack_all_units(tree):
    """Unstack every ``units`` subtree of ``tree`` (``unstack_units``):
    the decoder's and an encoder's, and a trainer checkpoint's
    ``params``, ``opt/m`` and ``opt/v`` copies of them."""
    if not isinstance(tree, dict):
        return tree
    out = {k: unstack_all_units(v) for k, v in tree.items()}
    if isinstance(out.get("units"), dict):
        out["units"] = unstack_units(out["units"])
    return out


def convert_params(tree: dict, *, device=None) -> dict:
    """JAX-side params tree -> the port's tree on ``device``."""
    return unstack_all_units(_convert(tree, resolve_device(device)))


def to_device(tree, device):
    """Move a port params tree (tensors and quantizer states) to
    ``device``."""
    import dataclasses
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (DeployedQuantState, QuantState)):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
