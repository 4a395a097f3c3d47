"""Load a checkpoint written by the JAX package, without JAX (port of the
read side of ``repro/checkpoint/store.py``).

The layout is the JAX package's: a step directory ``step-<9 digits>``
holding one ``.npy`` per leaf, named by its ``/``-joined tree path with
``/`` spelled ``__``, and ``manifest.json`` with each leaf's shape and
dtype, the step, the caller's ``extra`` and ``quant_states``: the
``spec``, ``name`` (and, for a deployed state, ``out_dims``) of every
quantizer node, keyed by its tree path.

``restore`` reads it with numpy, json and torch only.  A leaf whose
manifest dtype numpy cannot name without ``ml_dtypes`` (``bfloat16``
loads as raw ``|V2`` records) is reinterpreted by its bits.  Quantizer
nodes come back as the port's ``QuantState`` / ``DeployedQuantState``,
and scan-stacked units are unstacked (``convert.unstack_units``), so the
tree is the one ``convert_params`` gives for the same export.  Checkpoints
from before the JAX package's quantizer metadata (its
``_upgrade_legacy_quant``) are not read.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core import (DeployedQuantState, PsumQuantConfig,
                              QuantConfig, QuantState)
from repro_torch.device import resolve_device
from .convert import unstack_units

_SEP = "/"

# manifest dtype -> (numpy dtype of the same bits, torch dtype)
_BY_BITS = {"bfloat16": (np.int16, torch.bfloat16)}


def _key_to_fname(key: str) -> str:
    return key.replace(_SEP, "__") + ".npy"


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _spec_from_json(d) -> QuantConfig | None:
    if d is None:
        return None
    rest = {k: v for k, v in d.items() if k != "psum"}
    return QuantConfig(psum=PsumQuantConfig(**d["psum"]), **rest)


def _tree_get(tree, parts):
    for p in parts:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _tree_set(tree, parts, value):
    node = tree
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def _reify_quant_states(tree: dict, quant_meta: dict) -> dict:
    """Rebuild the typed quantizer nodes the manifest records (in place)."""
    for path, meta in quant_meta.items():
        parts = path.split(_SEP)
        node = _tree_get(tree, parts)
        if not isinstance(node, dict):
            continue
        spec = _spec_from_json(meta["spec"])
        name = meta.get("name", "")
        if meta.get("kind", "QuantState") == "DeployedQuantState" \
                and "w_codes" in node:
            _tree_set(tree, parts, DeployedQuantState(
                w_codes=node["w_codes"], ax_exp=node["ax_exp"],
                aw_exp=node["aw_exp"], psum_exps=node.get("psum_exps"),
                spec=spec, name=name,
                out_dims=tuple(meta.get("out_dims", ()))))
        elif "aw" in node and "ax" in node:
            _tree_set(tree, parts, QuantState(
                aw=node["aw"], ax=node["ax"], ap=node.get("ap"), spec=spec,
                name=name))
    return tree


def list_steps(ckpt_dir: str) -> list:
    """Steps with a finished ``step-*`` directory (``tmp-*``, a save in
    flight, is not one)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name.split("-")[1]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step-"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaf(path: str, meta: dict, device) -> torch.Tensor:
    arr = np.load(path)
    dtype = meta["dtype"]
    if dtype in _BY_BITS:
        bits, tdtype = _BY_BITS[dtype]
        t = torch.from_numpy(arr.view(bits)).view(tdtype)
    elif str(arr.dtype) != dtype:
        raise ValueError(f"{path}: manifest dtype {dtype!r}, file "
                         f"{arr.dtype}; the port reads {sorted(_BY_BITS)} "
                         "by their bits and no other extended dtype")
    else:
        t = torch.from_numpy(arr)
    if list(t.shape) != list(meta["shape"]):
        raise ValueError(f"{path}: shape {list(t.shape)} != manifest "
                         f"{meta['shape']}")
    return t.to(device)


def restore(ckpt_dir: str, step: int | None = None, *,
            device=None) -> tuple:
    """Load a checkpoint onto ``device`` (``None``: the card); returns
    ``(tree, manifest)`` with ``step=None`` meaning the latest step."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree = _unflatten({
        key: _load_leaf(os.path.join(path, _key_to_fname(key)), meta, device)
        for key, meta in manifest["leaves"].items()})
    tree = _reify_quant_states(tree, manifest.get("quant_states") or {})
    if isinstance(tree.get("units"), dict):
        tree["units"] = unstack_units(tree["units"])
    return tree, manifest
