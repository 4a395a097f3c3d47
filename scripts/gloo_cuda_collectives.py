"""Which collectives ``dist.tp`` uses does torch's gloo take on CUDA
tensors, and a one-rank NCCL group's.

    python3 scripts/gloo_cuda_collectives.py          # on a GPU machine

Spawns two gloo ranks on the first GPU (the way ``chip_smoke.py``'s
``tp_serve`` phase shares one card; on a machine without a GPU, on the
CPU) and calls ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_reduce`` on [8, 64] int8, int32 and float32 tensors, each after a
barrier; prints per collective and dtype whether it ran, whether the
result is right and its host-clock seconds (the first call includes the
transport's setup).  Then, with a GPU, the three collectives on a
one-rank NCCL group (NCCL refuses two ranks on one GPU).  Imports torch
only.
"""
from __future__ import annotations

import datetime
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
DTYPES = (torch.int8, torch.int32, torch.float32)


def _calls(dev, rank: int, world: int, group=None) -> dict:
    """{collective/dtype: {"ok", "right", "s"} or {"error"}}."""
    out = {}
    for dtype in DTYPES:
        x = torch.full((8, 64), rank + 1, dtype=dtype, device=dev)
        total = world * (world + 1) // 2
        calls = {
            "all_gather_into_tensor": (
                lambda: _ALL_GATHER(o, x, group=group),
                lambda: torch.empty((8 * world, 64), dtype=dtype,
                                    device=dev),
                lambda o: o.reshape(world, 8, 64)[:, 0, 0].tolist()
                == list(range(1, world + 1))),
            "reduce_scatter_tensor": (
                lambda: _REDUCE_SCATTER(o, x, group=group),
                lambda: torch.empty((8 // world, 64), dtype=dtype,
                                    device=dev),
                lambda o: bool((o == total).all())),
            "all_reduce": (
                lambda: dist.all_reduce(o, group=group),
                lambda: x.clone(),
                lambda o: bool((o == total).all())),
        }
        for name, (call, make, right) in calls.items():
            o = make()
            dist.barrier(group=group)
            try:
                t0 = time.perf_counter()
                call()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out[f"{name}/{str(dtype)[6:]}"] = {
                    "ok": True, "right": right(o),
                    "s": time.perf_counter() - t0}
            except RuntimeError as e:
                out[f"{name}/{str(dtype)[6:]}"] = {"error": str(e)[:200]}
    return out


def _rank(rank: int, world: int, init: str, out_dir: str) -> None:
    dev = (torch.device("cuda", 0) if torch.cuda.is_available()
           else torch.device("cpu"))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    res = _calls(dev, rank, world)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(2, f"file://{d}/rdv", d), nprocs=2,
                           start_method="spawn")
        with open(os.path.join(d, "rank0.json")) as f:
            gloo = json.load(f)
    where = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
             else "cpu")
    print(json.dumps({"torch": torch.__version__, "transport": "gloo",
                      "ranks": 2, "device": where, "calls": gloo}))
    if torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
        try:
            nccl = _calls(dev, 0, 1)
        finally:
            dist.destroy_process_group()
        print(json.dumps({"transport": "nccl", "ranks": 1, "device": where,
                          "calls": nccl}))


if __name__ == "__main__":
    main()
