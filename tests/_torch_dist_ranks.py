"""The rank program of ``tests/test_torch_dist.py``: one process of a
``torch.distributed`` world over gloo on the CPU.

It imports torch and ``repro_torch`` only (the test module imports JAX,
so the ranks are spawned, not forked, and run this module's ``run``).
Every rank reads one job file and runs its cases on two meshes of the
world: ``(world/2, 2)`` for the D=2 cases (a two-rank model axis; only
the first data replica runs them) and ``(1, world)``.  It writes what it
computed to ``rank<r>.pt`` for the test process to hold against JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _engine_case(case: dict, mesh, wire: str) -> dict:
    from repro_torch.dist import tp
    from repro_torch.models import decode_step_paged
    from repro_torch.serving import PagedServingEngine, Request
    cfg = case["cfg"]
    eng = PagedServingEngine(case["deploy"], cfg, backend="oracle",
                             mesh=mesh, wire=wire, **case["kw"])
    done = eng.run([Request(uid=i, tokens=p, max_new_tokens=case["new"])
                    for i, p in enumerate(case["prompts"])])
    out = {"tokens": {r.uid: list(r.out) for r in done},
           "state": tp.gather_paged_state(eng.state, cfg, mesh),
           "plans": eng.shard_plan}
    # one decode step at B rows moves what wire_report prices at m = B
    b = case["kw"]["max_batch"]
    mesh.wire_bytes.clear()
    with torch.no_grad():
        decode_step_paged(eng.params, cfg, eng.state,
                          torch.zeros((b, 1), dtype=torch.int32),
                          torch.zeros(b, dtype=torch.int32),
                          torch.ones((b, 1), dtype=torch.int32),
                          backend=eng.backend)
    out["step_wire"] = sum(mesh.wire_bytes.values())
    out["step_report"] = tp.wire_report(eng.shard_plan, m=b)["total"][wire]
    return out


def run(rank: int, world: int, init: str, job_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.dist import tp
    from repro_torch.exec import ShardedBackend, get_backend
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_smoke_mesh

    job = torch.load(job_path, weights_only=False)
    meshes = {2: make_smoke_mesh((world // 2, 2), device="cpu"),
              world: make_smoke_mesh((1, world), device="cpu")}
    out = {"mesh": {d: (m.backend, m.shared_device, m.shape, m.coords)
                    for d, m in meshes.items()}}
    # the second data replica of the D=2 mesh would repeat the first
    first = meshes[2].coords["data"] == 0
    with torch.no_grad():
        for c in job["gemm"]:
            if c["d"] == 2 and not first:
                continue
            be = ShardedBackend(mesh=meshes[c["d"]], inner="oracle",
                                wire=c["wire"])
            if c.get("experts"):
                y = be.int_expert_gemm(c["x"], c["w"], c["exps"], gs=c["gs"])
            else:
                y = be.int_gemm(c["x"], c["w"], c["exps"], gs=c["gs"])
            out[c["key"]] = y
        oracle = get_backend("oracle")
        for key, args in job["attention"].items() if first else ():
            out[key] = (tp.sharded_kv_attention(meshes[2], oracle, *args),
                        oracle.kv_attention(*args))
        for key, case in job["engines"].items() if first else ():
            for wire in ("int8", "fp32"):
                out[(key, wire)] = _engine_case(case, meshes[2], wire)
    done = serve.main(job["serve_argv"])
    out["serve"] = sorted((r.uid, list(r.out)) for r in done)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn(world: int, job: dict, tmp: str, meanwhile=None) -> list:
    """Run ``job`` on ``world`` spawned ranks, and ``meanwhile()`` in this
    process while they run; every rank's results.  A rank that fails
    raises here."""
    import torch.multiprocessing as mp
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.start_processes(run, args=(world, init, job_path, tmp),
                             nprocs=world, join=False, start_method="spawn")
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        while not ctx.join():
            pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def prompts(vocab: int) -> list:
    """The reference's engine-test prompts at lengths 8 and 16: whole
    8-token chunks, so JAX's engine compiles one prefill chunk."""
    return [((np.arange(n) * 7 + s * 13) % vocab).astype(np.int32)
            for n, s in ((8, 0), (16, 1))]
