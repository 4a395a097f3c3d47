"""Distribution (port of ``repro.dist``): tensor- and expert-parallel
integer serving over ``torch.distributed``.

``tp``
    ``shard_deployed`` places exported ``DeployedQuantState`` code banks
    over the mesh's "model" axis by Algorithm-1 mode (K by whole PSUM
    tiles for PSQ/W8A8, N for APSQ's sequential chain, the expert axis
    for MoE banks), keeping each rank's slice; the ``sharded_*``
    executors combine per-rank integer partials with INT8-on-the-wire
    collectives (``wire="fp32"`` gathers 4-byte words, same results).
    ``ShardedBackend`` in ``repro_torch.exec`` is the entry point;
    ``wire_report`` prices the collectives from the static plans.

The reference's training half (``sharding``'s logical-axis rules,
``compress``'s low-bit gradient path) is not ported yet.
"""
from .tp import (GemmPlan, LayerPlan, plan_gemm, shard_deployed,
                 shard_paged_state, wire_report)

__all__ = ["GemmPlan", "LayerPlan", "plan_gemm", "shard_deployed",
           "shard_paged_state", "wire_report"]
