"""The device layout of a run (port of ``repro/launch/mesh.py``, the one
part the one-device dry run calls).

The port runs on one H100: ``SINGLE`` names that layout.  The
reference's production meshes (16x16 and 2x16x16 TPU chips) and its
smoke meshes over CPU host devices shard a step across devices, which
waits for the port of ``repro.dist``; until then they raise rather
than return a mesh that shards nothing.
"""
from __future__ import annotations

import dataclasses

_DIST = ("multi-device meshes wait for the port of repro.dist "
         "(ROADMAP queue 1, dist); the port runs on one device")


@dataclasses.dataclass(frozen=True)
class Layout:
    name: str
    n_chips: int


SINGLE = Layout(name="1xH100", n_chips=1)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(f"make_production_mesh: {_DIST}")


def make_smoke_mesh(shape=None, axes=("data", "model")):
    raise NotImplementedError(f"make_smoke_mesh: {_DIST}")
