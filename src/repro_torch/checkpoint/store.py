"""Checkpoints in the JAX package's format, without JAX (port of
``repro/checkpoint/store.py``): ``restore`` reads one the JAX package
wrote, ``save`` / ``AsyncCheckpointer`` write one its ``restore`` reads.

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
and scan-stacked units are unstacked (``convert.unstack_units``) wherever
a ``units`` subtree sits (an export's top, a trainer checkpoint's
params and moments), so the tree is the one ``convert_params`` gives for
the same export.  A checkpoint from before the quantizer metadata is
upgraded when the caller passes its ``quant_policy``, as the JAX
package's ``restore`` does.

``save`` writes the same layout: leaves from ``models.model.tree_leaves``
(the walker the optimizer uses), ``quant_states`` from the states it
meets (a trainer's optimizer moments carry their params' states, so
``opt/m/...`` paths get the metadata too), bfloat16 leaves by their bits
(an int16 ``.npy`` under the manifest dtype ``"bfloat16"``, which the
JAX package's ``restore`` views back).  A save goes to ``tmp-<step>``
and is renamed to ``step-<9 digits>`` when complete, so a crash
mid-save never leaves a torn latest checkpoint.  ``AsyncCheckpointer``
copies to host memory synchronously and writes on a thread, keeping the
last ``keep`` steps; ``install_signal_handler`` saves on SIGTERM
(preemption) before re-raising.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import threading

import numpy as np
import torch

from repro_torch.core import (DeployedQuantState, PsumQuantConfig,
                              QuantConfig, QuantState)
from repro_torch.device import resolve_device
from repro_torch.models.model import tree_leaves, tree_map
from .convert import unstack_all_units

_SEP = "/"

# manifest dtype -> (numpy dtype of the same bits, torch dtype)
_BY_BITS = {"bfloat16": (np.int16, torch.bfloat16)}


def _key_to_fname(key: str) -> str:
    return key.replace(_SEP, "__") + ".npy"


def _spec_to_json(spec: QuantConfig | None):
    return None if spec is None else dataclasses.asdict(spec)


def _flatten(tree, quant_meta: dict | None = None) -> dict:
    """``{"a/b/c": tensor}`` over dicts and quantizer states; with
    ``quant_meta``, record each state's kind, spec and name (and a
    deployed state's ``out_dims``) under its path."""
    nodes: dict = {}
    flat = {_SEP.join(path): leaf
            for path, leaf in tree_leaves(tree, nodes=nodes)}
    if quant_meta is not None:
        for path, node in nodes.items():
            meta = {"kind": type(node).__name__,
                    "spec": _spec_to_json(node.spec), "name": node.name}
            if isinstance(node, DeployedQuantState):
                meta["out_dims"] = list(node.out_dims)
            quant_meta[_SEP.join(path)] = meta
    return flat


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array to write, manifest dtype): bfloat16 by its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic checkpoint save; returns the final path."""
    quant_meta: dict = {}
    flat = _flatten(tree, quant_meta)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {},
                "quant_states": quant_meta}
    for key, val in flat.items():
        arr, dtype = _to_numpy(val)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        np.save(os.path.join(tmp, _key_to_fname(key)), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _to_host(tree):
    """A copy of ``tree`` in host memory (blocks on the device only)."""
    return tree_map(lambda _, t: t.detach().to("cpu", copy=True), tree)


class AsyncCheckpointer:
    """Device->host copy synchronously; filesystem write on a thread, one
    in flight at a time.  ``wait`` joins it and raises what it raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        host_tree = _to_host(tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in list_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step-{s:09d}"),
                          ignore_errors=True)


def install_signal_handler(checkpointer: AsyncCheckpointer, get_state):
    """Emergency checkpoint on SIGTERM (preemption notice), then re-raise:
    ``get_state()`` returns ``(step, tree)``."""
    def handler(signum, frame):
        step, tree = get_state()
        save(checkpointer.ckpt_dir, step, _to_host(tree),
             {"emergency": True})
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    signal.signal(signal.SIGTERM, handler)


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
            _tree_set(tree, parts, QuantState.from_dict(node, spec=spec,
                                                        name=name))
    return tree


_MODEL_ROOTS = ("units", "rem", "encoder", "head", "frontend_proj")

# Legacy layer names whose quantizer state was vestigial: the JAX
# package's old init_rwkv_channel_mix made one for the sigmoid gate
# ``wr``, which its forward never quantized.  Upgrading it would start
# quantizing the gate and give the tree another structure than a fresh
# init's, so it is dropped.
_LEGACY_VESTIGIAL_SUFFIXES = (".ffn.wr",)

_DROP = object()


def _legacy_layer_name(parts) -> str:
    """A pre-metadata checkpoint path -> the stable layer name:
    ``params/units/u0/1/mix/wq/qp`` -> ``unit.1.mix.wq``, ``opt/m/rem/0/
    ffn/wi/qp`` -> ``rem.0.ffn.wi``.  Containers before the first model
    root (``params``, ``opt/m``, ...) are stripped, so an optimizer
    moment's quantizer gets its param's name; a per-unit index (``u<i>``)
    is dropped, names being per pattern position."""
    parts = [p for p in parts if p != "qp"]
    for i, p in enumerate(parts):
        if p in _MODEL_ROOTS:
            parts = parts[i:]
            break
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "units":
            out.append("unit")
            nxt = parts[i + 1] if i + 1 < len(parts) else ""
            if nxt.startswith("u") and nxt[1:].isdigit():
                i += 1
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def _upgrade_legacy_quant(tree, quant_policy):
    """Wrap raw ``{"aw", "ax"[, "ap"]}`` dicts under a ``qp`` / ``qp_<w>``
    key into ``QuantState``s named by their path, each spec resolved from
    ``quant_policy`` (a ``QuantPolicy`` or one ``QuantConfig``)."""
    def resolve(name):
        if hasattr(quant_policy, "resolve"):
            return quant_policy.resolve(name)
        return quant_policy

    def walk(node, parts):
        if not isinstance(node, dict):
            return node
        if (set(node) <= {"aw", "ax", "ap"} and "aw" in node and "ax" in node
                and parts and parts[-1].startswith("qp")):
            name = _legacy_layer_name(list(parts[:-1])
                                      + ([parts[-1][3:]]
                                         if parts[-1].startswith("qp_")
                                         else []))
            if name.endswith(_LEGACY_VESTIGIAL_SUFFIXES):
                return _DROP
            return QuantState.from_dict(node, spec=resolve(name), name=name)
        out = {}
        for k, v in node.items():
            r = walk(v, parts + (k,))
            if r is not _DROP:
                out[k] = r
        return out

    return walk(tree, ())


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


def restore(ckpt_dir: str, step: int | None = None, *, device=None,
            quant_policy=None) -> tuple:
    """Load a checkpoint onto ``device`` (``None``: the card); returns
    ``(tree, manifest)`` with ``step=None`` meaning the latest step.

    ``quant_policy`` upgrades a checkpoint written before the quantizer
    metadata (no ``quant_states`` in its manifest): its raw ``{"aw",
    "ax", "ap"}`` dicts become ``QuantState``s, each named by its path and
    given its spec from the policy (a ``QuantPolicy`` or a
    ``QuantConfig``); a vestigial ``.ffn.wr`` quantizer is dropped.
    Without it such dicts come back as they are."""
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
    quant_meta = manifest.get("quant_states") or {}
    if quant_meta:
        tree = _reify_quant_states(tree, quant_meta)
    elif quant_policy is not None:
        tree = _upgrade_legacy_quant(tree, quant_policy)
    return unstack_all_units(tree), manifest
