"""Op-level cost of a step: FLOPs, bytes and collective bytes (the port's
counterpart of ``repro/roofline/hlo_cost.py``).

The reference parses XLA's optimized HLO text.  The port has no HLO: it
runs the step (on real, fake or meta tensors) under a dispatch mode
(``OpCost``) and counts the aten ops it dispatches, after autograd, so a
backward pass and the recomputation of a checkpointed block are counted
as they run:

  * ``flops``: the formulas of ``torch.utils.flop_counter`` (matrix
    products, convolutions, attention kernels; elementwise work counts
    0, as in the reference, which counts ``dot`` and ``convolution``);
  * ``bytes``: operands + results of every aten op.  Views, ``detach``
    and metadata ops count 0, as the reference's ``_SKIP_BYTES`` drops
    bitcasts.  A gather (``index``, ``index_select``, ``gather``,
    ``embedding``) counts the bytes it moves (its result, read and
    written, and its indices), not its source; an in-place scatter
    (``index_put_``, ``scatter_``, ``index_add_`` ...) the update it
    writes, read and written, and its indices; ``copy_`` reads its source
    and writes its destination; a fill writes its result only;
  * ``collectives``: operand bytes of each ``torch.distributed``
    collective the step dispatches, by kind (0 on one device).

aten does not fuse: every intermediate of an elementwise chain is
written and read again, where XLA's fusions keep it in registers.  So
``bytes`` here is an upper bound of what a fused program moves, and the
reference's count of a fused program is not.

``LiveBytes`` tracks the bytes of live tensor storage (of any device)
while it is entered: every op's new storages are added, and a storage's
finalizer takes it off when the last tensor on it dies.  Its ``peak`` is
the dry run's ``peak_bytes``.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .analysis import COLLECTIVE_OPS

aten = torch.ops.aten

# ops that move no data of their own (metadata, allocation, aliasing)
_SKIP = {aten.detach, aten.alias, aten.lift_fresh, aten.lift_fresh_copy,
         aten._unsafe_view,          # a view its schema does not declare
         aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten._local_scalar_dense, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.size, aten.stride, aten.dim, aten.numel, aten.is_contiguous,
         aten.is_same_size, aten.set_, aten.resize_}
# gathers -> the position of their indices
_GATHER = {aten.index: 1, aten.index_select: 2, aten.gather: 2,
           aten.embedding: 1, aten.take: 1, aten.take_along_dim: 1}
# in-place scatters -> the position of the update they write
_SCATTER = {aten.index_put_: 2, aten._index_put_impl_: 2, aten.scatter_: 3,
            aten.scatter_add_: 3, aten.scatter_reduce_: 3,
            aten.index_add_: 3, aten.index_copy_: 3, aten.masked_scatter_: 2}
# write their result only (a ``*_like`` or ``new_*`` reads its input's
# shape, not its data)
_WRITE_ONLY = {aten.fill_, aten.zero_, aten.normal_, aten.uniform_,
               aten.random_, aten.bernoulli_, aten.exponential_,
               aten.full_like, aten.zeros_like, aten.ones_like,
               aten.rand_like, aten.randn_like, aten.new_zeros,
               aten.new_ones, aten.new_full}
# matrix work that FlopCounterMode has no formula for
_UNCOUNTED = {aten.mv, aten.dot, aten.vdot, aten.addmv, aten.addr,
              aten._int_mm}
_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def collective_kind(func) -> str | None:
    """The reference's collective kind of a ``torch.distributed`` op
    (``c10d`` and ``_c10d_functional`` namespaces), None for any other."""
    packet = getattr(func, "_overloadpacket", func)
    if getattr(packet, "_qualified_op_name", "").split("::")[0] not in (
            "c10d", "_c10d_functional", "_c10d_functional_autograd"):
        return None
    name = packet.__name__
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in tree):
        return list(tree)
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a nested structure (their elements, not
    their storages)."""
    return _nbytes(_tensors(tree))


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves (module docstring)."""
    packet = func._overloadpacket
    if packet in _SKIP or func.is_view or not _tensors(out):
        return 0          # metadata (a device or size query), a view
    if packet in _GATHER:
        return 2 * _nbytes(_tensors(out)) + _nbytes(
            _tensors(args[_GATHER[packet]]))
    if packet in _SCATTER:
        pos = _SCATTER[packet]
        upd = _tensors(args[pos]) if len(args) > pos else _tensors(out)
        idx = _tensors(args[1:pos])
        return 2 * _nbytes(upd) + _nbytes(idx)
    if packet is aten.copy_:
        return _nbytes(_tensors(args[:2]))
    if packet in _WRITE_ONLY:
        return _nbytes(_tensors(out))
    return _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))


class OpCost(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of the aten ops dispatched
    while entered; ``report()`` gives what ``analyze`` returns.  FLOPs
    come from ``torch.utils.flop_counter``'s formulas (``flop_registry``,
    the table ``FlopCounterMode`` reads), applied in this one mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.ops: dict = {}        # "aten.mm" -> {"flops", "bytes", "calls"}
        self.collectives = {k: 0.0 for k in COLLECTIVE_OPS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.uncounted: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        packet = func._overloadpacket
        row = self.ops.get(packet)
        if row is None:
            row = self.ops[packet] = {"flops": 0, "bytes": 0, "calls": 0}
        row["bytes"] += op_bytes(func, args, kwargs, out)
        row["calls"] += 1
        formula = self._formulas.get(packet)
        if formula is not None:
            row["flops"] += formula(*args, **kwargs, out_val=out)
        elif packet in _UNCOUNTED:
            self.uncounted.add(str(packet))
        kind = collective_kind(func)
        if kind is not None:
            self.collectives[kind] += _nbytes(_tensors((args, kwargs)))
            self.collective_counts[kind] += 1
        return out

    def report(self) -> dict:
        ops = {str(k): dict(v) for k, v in self.ops.items()}
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {
            "flops": float(sum(v["flops"] for v in ops.values())),
            "bytes": float(sum(v["bytes"] for v in ops.values())),
            "collectives": coll,
            "collective_counts": dict(self.collective_counts),
            "warnings": [f"no FLOP formula for {n}: its FLOPs count 0"
                         for n in sorted(self.uncounted)],
            "ops": ops,
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count what it dispatches: the
    reference ``analyze_hlo``'s keys (``flops``, ``bytes``,
    ``collectives`` with its ``total``, ``collective_counts``,
    ``warnings``) plus ``ops``, the per-op tallies ``attribute`` ranks."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost.report()


def attribute(report: dict, top: int = 12, key: str = "bytes") -> list:
    """The ``top`` aten ops of an ``analyze`` report by ``key`` ("bytes"
    or "flops"): ``[(bytes, flops, calls, op name)]``, largest first.
    The rows of all ops sum to the report's totals."""
    rows = [(v["bytes"], v["flops"], v["calls"], name)
            for name, v in report["ops"].items()]
    rows.sort(key=lambda r: (r[0] if key == "bytes" else r[1]), reverse=True)
    return rows[:top]


class LiveBytes(TorchDispatchMode):
    """Bytes of live tensor storage, and their peak, while entered.

    Each op's results are registered by storage (a view adds nothing);
    a weak finalizer on the storage takes its bytes off when it is
    freed.  ``track`` registers tensors made before the mode was entered.
    Works on meta and fake tensors, whose storages have sizes but no
    memory."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: dict = {}      # storage key -> bytes

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key).atexit = False
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out
