"""Three-term roofline of one step on one device (port of
``repro/roofline/analysis.py``; the H100 is the default target).

  compute term    = FLOPs      / (peak FLOP/s)
  memory term     = bytes      / (device-memory bandwidth)
  collective term = coll_bytes / (link bandwidth)

The counts come from ``repro_torch.roofline.op_cost`` (the aten ops a
step dispatches), not from compiled HLO.  The reference's
``collective_bytes`` parses XLA's HLO text for collective operand
sizes; the port never has HLO, so it is not ported: ``op_cost`` counts
the ``torch.distributed`` collectives a step dispatches instead (none on
one device).

Hardware constants of one H100 SXM (NVIDIA's data sheet, dense rates):
989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s from 80 GB of HBM3,
NVLink 450 GB/s each way.  ``V5E`` keeps the reference's constants so
the port's functions can be held to the reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str = "h100-sxm"
    peak_flops: float = 989e12      # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12         # device-memory bytes/s
    link_bw: float = 450e9          # NVLink bytes/s, one direction
    dcn_bw: float = 50e9            # one 400 Gb/s InfiniBand port
    int8_ops: float | None = 1979e12  # None: the int8 GEMM runs at peak_flops
    hbm_bytes: float | None = 80e9  # device memory; None: not modelled


H100 = HwSpec()
V5E = HwSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
             dcn_bw=25e9, int8_ops=None, hbm_bytes=None)


def cost_terms(cost: dict, coll: dict, n_chips: int,
               hw: HwSpec = H100, dcn_bytes: int = 0) -> dict:
    """The three roofline terms, in seconds.

    ``cost`` holds ``flops`` and ``bytes accessed`` of the step on one
    device (``op_cost.analyze``'s ``flops`` and ``bytes``)."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll_b = float(coll.get("total", 0))
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_coll = coll_b / hw.link_bw
    t_dcn = dcn_bytes / hw.dcn_bw if dcn_bytes else 0.0
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "dcn_s": t_dcn}
    dominant = max(terms, key=lambda k: terms[k])
    bound = max(t_compute, t_memory, t_coll, t_dcn)
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound,
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
        "flops": flops,
        "bytes": bytes_accessed,
        "collective_bytes": coll_b,
        "n_chips": n_chips,
    }


def model_flops(n_params_active: int, n_tokens: int,
                training: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference."""
    per_tok = 6 if training else 2
    return float(per_tok) * n_params_active * n_tokens


def useful_fraction(mf: float, hlo_flops: float) -> float:
    """MODEL_FLOPS / counted FLOPs: catches remat and redundant work
    (both per device)."""
    return mf / hlo_flops if hlo_flops else 0.0


# ---------------------------------------------------------------------------
# Backend-aware correction: measured kernel timings vs the analytic model
# ---------------------------------------------------------------------------

def gemm_analytic_us(m: int, k: int, n: int, hw: HwSpec = H100) -> float:
    """Analytic roofline time (us) of one INT8 GEMM [m,k]x[k,n]: INT8
    operands in, INT32 result out, at the card's int8 rate."""
    flops = 2.0 * m * k * n
    bytes_ = m * k + k * n + 4.0 * m * n
    rate = hw.int8_ops or hw.peak_flops
    return max(flops / rate, bytes_ / hw.hbm_bw) * 1e6


def backend_corrected_terms(terms: dict, parity: dict,
                            hw: HwSpec = H100) -> dict:
    """Fold a measured ``backend_parity`` timing into the roofline.

    The parity probe (``search.backend_parity_report``) times the
    integer GEMM of one deployed layer: the CUDA kernel's device time
    (``cuda_us``) on the card, else the torch oracle (``oracle_us``).
    ``correction = measured / analytic`` on the probe shape scales the
    compute term, so a quantized cell reports what the kernel delivers
    rather than the data sheet's rate.  At the probe's small shape the
    kernel's time is mostly its fixed cost (launch, one wave of tiles),
    so the correction overstates what a cell's large GEMMs lose.
    Returns {} when the report has no usable timing."""
    shape = parity.get("shape")
    measured = parity.get("cuda_us", parity.get("oracle_us"))
    if not shape or not measured:
        return {}
    analytic = gemm_analytic_us(*shape, hw=hw)
    correction = measured / analytic if analytic else 0.0
    corrected_compute = terms.get("compute_s", 0.0) * correction
    corrected_bound = max(corrected_compute, terms.get("memory_s", 0.0),
                          terms.get("collective_s", 0.0),
                          terms.get("dcn_s", 0.0))
    return {
        "probe_shape": list(shape),
        "probe_backend": "cuda" if "cuda_us" in parity else "oracle",
        "probe_measured_us": round(measured, 1),
        "probe_analytic_us": analytic,
        "correction": correction,
        "corrected_compute_s": corrected_compute,
        "corrected_bound_s": corrected_bound,
    }
