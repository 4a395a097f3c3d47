"""Device layouts and meshes (port of ``repro/launch/mesh.py``).

The port runs on H100s: ``SINGLE`` names the one-card layout the dry run
assumes.  ``make_smoke_mesh`` lays a mesh with the reference's axis
names over the processes of the current ``torch.distributed`` world, one
rank per mesh position (``torchrun --nproc-per-node D``, or ranks a test
spawns), each on its own device.  The collectives' transport follows the
ranks' devices: NCCL when every rank owns its own GPU, gloo when the
ranks are CPU processes or share a GPU (NCCL refuses two ranks on one
GPU).  It is chosen once and never switched after an error.  NCCL over
more than one rank has not run yet: the card machine has one GPU.

The reference's production meshes (16x16 and 2x16x16 TPU chips) shard a
training step, which waits for the port of the dist training slice.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket

import torch

_TRAINING = ("the production meshes shard a training step (16x16 and "
             "2x16x16 TPU chips, no H100 layout here); they wait for the "
             "port of the dist training slice (ROADMAP queue 1)")


@dataclasses.dataclass(frozen=True)
class Layout:
    name: str
    n_chips: int


SINGLE = Layout(name="1xH100", n_chips=1)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a mesh of ``torch.distributed`` processes.

    ``shape`` maps each axis name to its size (axis order kept);
    ``coords`` gives this rank's position along each axis and ``groups``
    the process group of the ranks that differ from it along that axis
    only (None for an axis of size 1).  ``backend`` is the collectives'
    transport, ``device`` the rank's device and ``shared_device`` whether
    several ranks of the mesh share one GPU.  ``wire_bytes`` adds up the
    payload bytes this rank's collectives moved, by op
    (``dist.tp``); clear it to start a count."""

    shape: dict
    rank: int
    coords: dict
    groups: dict
    backend: str
    device: torch.device
    shared_device: bool = False
    wire_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def count_wire(self, op: str, n: int) -> None:
        self.wire_bytes[op] = self.wire_bytes.get(op, 0) + n


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(f"make_production_mesh: {_TRAINING}")


def rank_device(device=None) -> torch.device:
    """The device of this process: ``None`` -> the card
    ``cuda:(LOCAL_RANK % device_count)`` (raises without one), else
    ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh rank runs on a CUDA device by default "
                           "and none is available; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _init_world() -> None:
    """The default process group (gloo, for host-side exchange): from
    torchrun's environment, or a world of this process alone."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "RANK" in os.environ:
        dist.init_process_group("gloo")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def make_smoke_mesh(shape=None, axes=("data", "model"), *, device=None):
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    current ``torch.distributed`` world (initialized from torchrun's
    environment if it is not yet).  ``make_smoke_mesh()`` is ``(1, n)``
    over every rank, as the reference's is over every device.  ``device``
    is this rank's (``rank_device``).  Every rank of the world calls it
    with the same arguments: it creates process groups."""
    import torch.distributed as dist
    world = _world_size()
    if shape is None:
        shape = (1, world)
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} / axes {axes} rank mismatch")
    need = math.prod(shape)
    if need > world:
        raise ValueError(f"mesh {shape} needs {need} devices (ranks), have "
                         f"{world} (start them with torchrun "
                         f"--nproc-per-node {need})")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_world()
    rank = dist.get_rank()
    where = [None] * world
    dist.all_gather_object(where, (socket.gethostname(), dev.type,
                                   dev.index))
    where = where[:need]
    cuda = all(t == "cuda" for _, t, _ in where)
    own = len(set(where)) == need
    backend = "nccl" if cuda and own else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("every rank owns a GPU but this torch has no "
                           "NCCL")
    grid = torch.arange(need).reshape(shape)
    coords, groups = {}, {}
    for i, (ax, size) in enumerate(zip(axes, shape)):
        groups[ax] = None
        for line in grid.movedim(i, -1).reshape(-1, size).tolist():
            # every rank creates every group, in the same order
            g = dist.new_group(line, backend=backend) if size > 1 else None
            if rank in line:
                coords[ax], groups[ax] = line.index(rank), g
    if rank >= need:
        raise ValueError(f"rank {rank} lies outside the mesh {shape}")
    return Mesh(shape=dict(zip(axes, shape)), rank=rank, coords=coords,
                groups=groups, backend=backend, device=dev,
                shared_device=cuda and not own)
