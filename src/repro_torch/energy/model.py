"""The paper's PSUM-precision-aware analytical accelerator model (§II-A)
(a copy of ``repro/energy/model.py``, which the port does not import:
pure Python, no framework code).

Implements eqs (1)-(6) exactly: per-dataflow (IS / WS / OS) SRAM and DRAM
access counts for ifmap / weight / PSUM / ofmap as a function of layer
geometry, MAC-array parallelism (P_o, P_ci, P_co), buffer capacities
(B_i, B_w, B_o) and the PSUM precision factor beta = psum_bits / 8.

Energy constants follow Horowitz ISSCC'14 [21] as the paper does:
INT8 MAC 0.23 pJ; on-chip SRAM ~2.5 pJ/byte (32-256 KB class); off-chip
DDR3 ~160 pJ/byte.  Absolute joules depend on these constants; every paper
figure is *normalized*, which this module reproduces.

Grouping (Algorithm 1) interacts with the model in exactly one place: the
PSUM buffer-capacity conditions scale by ``gs`` (gs INT8 PSUM tiles are
live at once), while total access counts are unchanged — the paper states
this explicitly (§III-B) and Fig. 6's energy cliffs for Segformer /
EfficientViT at gs >= 3 fall out of it.
"""
from __future__ import annotations

import dataclasses
import math


# ---------------------------------------------------------------------------
# Constants (Horowitz [21])
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    e_mac_int8: float = 0.23e-12     # pJ: 0.2 (8b mult) + 0.03 (add)
    e_sram_byte: float = 2.5e-12     # ~10 pJ / 32-bit word, 128 KB class
    e_dram_byte: float = 160e-12     # ~640 pJ / 32-bit word, DDR3


HORO = EnergyConstants()


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """The analytical DNN accelerator of Fig. 2 (paper §IV-A defaults)."""
    P_o: int = 16          # ofmap parallelism (tokens/pixels per tile)
    P_ci: int = 8          # input-channel parallelism
    P_co: int = 8          # output-channel parallelism
    B_i: int = 256 * 1024  # ifmap buffer bytes
    B_w: int = 128 * 1024  # weight buffer bytes
    B_o: int = 256 * 1024  # ofmap/PSUM buffer bytes

    @staticmethod
    def llm_decode() -> "AcceleratorConfig":
        """LLM setting (§IV-D): P_o=1 (vector ifmap), P_ci=P_co=32."""
        return AcceleratorConfig(P_o=1, P_ci=32, P_co=32)


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One GEMM layer: [tokens, C_i] @ [C_i, C_o] (1x1-conv view).

    ``tokens`` is H_o * W_o for CV models and the token count for NLP.
    """
    name: str
    tokens: int
    c_i: int
    c_o: int
    repeat: int = 1        # e.g. per-head attention GEMMs


DATAFLOWS = ("IS", "WS", "OS")


@dataclasses.dataclass(frozen=True)
class LayerEnergySpec:
    """One layer's *resolved* energy knobs (heterogeneous per-layer model).

    The paper's Table IV uses one global beta; the RAE's reconfigurability
    (§III-C) makes ``(gs, psum_bits)`` — and even the dataflow — per-layer
    choices.  ``repro_torch.search`` resolves a ``QuantPolicy`` against a model's
    GEMM inventory into a list of these; ``model_energy`` consumes them
    directly (a plain ``LayerShape`` is shorthand for the uniform knobs
    passed as keyword arguments).

    ``n_p`` overrides the accelerator-derived tile count
    ``ceil(C_i / P_ci)`` — a policy's K-tiling choice maps onto the
    hardware as a different effective input-channel parallelism, scaling
    the PSUM read-modify-write traffic (eqs 3-6 count ``2(n_p - 1)``
    buffer accesses per output).
    """

    layer: LayerShape
    psum_bits: int = 32
    gs: int = 1
    dataflow: str | None = None   # None -> the model-level dataflow
    n_p: int | None = None        # None -> ceil(C_i / P_ci)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def access_counts(layer: LayerShape, acc: AcceleratorConfig, dataflow: str,
                  *, beta: float, gs: int = 1,
                  n_p: int | None = None) -> dict:
    """Eqs (3)-(6): access *multipliers* N^{i,w,p,o} for SRAM and DRAM.

    beta: PSUM precision ratio (psum_bits / 8); enters the capacity
    conditions via the live tile size S~_p = beta * P_o * P_co and eq (2)
    via the beta * S_o * N^p term (handled in ``layer_energy``).
    gs: number of live PSUM tiles (Algorithm 1 grouping) — scales only the
    capacity conditions.
    n_p: PSUM tile count along K; defaults to the accelerator-derived
    ``ceil(C_i / P_ci)`` (a per-layer policy override models a different
    effective P_ci for this layer).
    """
    T, Ci, Co = layer.tokens, layer.c_i, layer.c_o
    S_i, S_w, S_o = T * Ci, Ci * Co, T * Co  # bytes at INT8
    if n_p is None:
        n_p = _ceil(Ci, acc.P_ci)
    n_p = max(1, min(n_p, Ci))

    if dataflow == "IS":
        # ifmap tile = P_o tokens held in the array; weights stream.
        n_tiles = _ceil(T, acc.P_o)
        if S_w < acc.B_w:
            ns_w, nd_w = 1 + n_tiles, 1
        else:
            ns_w, nd_w = 2 * n_tiles, n_tiles
        ns_i, nd_i = 2, 1
        # Live PSUM: all Co/P_co output-channel tiles of the current ifmap
        # tile: (Co/P_co) * S~_p, S~_p = beta * gs * P_i * P_co.
        live = _ceil(Co, acc.P_co) * beta * gs * acc.P_o * acc.P_co
        if live <= acc.B_o:
            ns_p, nd_p = 2 * (n_p - 1), 0
        else:
            ns_p, nd_p = 4 * (n_p - 1), 2 * (n_p - 1)
        ns_o, nd_o = 2, 1
    elif dataflow == "WS":
        # P_ci x P_co weights held; ifmap tiles stream per Co tile.  The
        # capacity condition uses the *enlarged ifmap tile* S~_i = P_o * C_i
        # (paper: "the input tile size S~i is enlarged based on output
        # tiles, kernels, and strides"), not the full ifmap.
        n_co = _ceil(Co, acc.P_co)
        tile_i = acc.P_o * Ci
        if tile_i < acc.B_i:
            ns_i, nd_i = 1 + n_co, 1
        else:
            ns_i, nd_i = 2 * n_co, n_co
        ns_w, nd_w = 2, 1
        # Live PSUM: every ofmap-row tile in flight: (T/P_o) * S~_p.
        live = _ceil(T, acc.P_o) * beta * gs * acc.P_o * acc.P_co
        if live <= acc.B_o:
            ns_p, nd_p = 2 * (n_p - 1), 0
        else:
            ns_p, nd_p = 4 * (n_p - 1), 2 * (n_p - 1)
        ns_o, nd_o = 2, 1
    elif dataflow == "OS":
        # PSUMs pinned in PE registers: no PSUM buffer traffic at all, but
        # ifmap and weight stream repeatedly (classic OS trade-off).
        ns_i, nd_i = 1 + _ceil(Co, acc.P_co), 1
        ns_w, nd_w = 1 + _ceil(T, acc.P_o), 1
        ns_p = nd_p = 0
        ns_o, nd_o = 2, 1
    else:
        raise ValueError(dataflow)

    return {
        "sram": {"i": ns_i, "w": ns_w, "p": ns_p, "o": ns_o},
        "dram": {"i": nd_i, "w": nd_w, "p": nd_p, "o": nd_o},
        "sizes": {"i": S_i, "w": S_w, "o": S_o},
        "n_p": n_p,
    }


def layer_energy(layer: LayerShape, acc: AcceleratorConfig, dataflow: str,
                 *, psum_bits: int = 32, gs: int = 1, n_p: int | None = None,
                 consts: EnergyConstants = HORO) -> dict:
    """Eq (1)+(2): energy breakdown {ifmap, weight, psum, ofmap, op} in J."""
    beta = psum_bits / 8.0
    cnt = access_counts(layer, acc, dataflow, beta=beta, gs=gs, n_p=n_p)
    S = cnt["sizes"]
    r = layer.repeat

    def traffic(level: str) -> dict:
        n = cnt[level]
        return {
            "ifmap": S["i"] * n["i"],
            "weight": S["w"] * n["w"],
            "psum": beta * S["o"] * n["p"],
            "ofmap": S["o"] * n["o"],
        }

    sram_b = traffic("sram")
    dram_b = traffic("dram")
    macs = layer.tokens * layer.c_i * layer.c_o
    out = {}
    for k in ("ifmap", "weight", "psum", "ofmap"):
        out[k] = r * (sram_b[k] * consts.e_sram_byte
                      + dram_b[k] * consts.e_dram_byte)
    out["op"] = r * macs * consts.e_mac_int8
    out["total"] = sum(out.values())
    out["sram_bytes"] = r * sum(sram_b.values())
    out["dram_bytes"] = r * sum(dram_b.values())
    out["macs"] = r * macs
    return out


def model_energy(layers: list, acc: AcceleratorConfig, dataflow: str,
                 *, psum_bits: int = 32, gs: int = 1,
                 consts: EnergyConstants = HORO) -> dict:
    """Sum of ``layer_energy`` over a model's layer walk.

    ``layers`` mixes plain ``LayerShape`` entries (which take the uniform
    ``psum_bits``/``gs``/``dataflow`` given here — the paper's global-beta
    setting) and ``LayerEnergySpec`` entries carrying their own per-layer
    knobs (the heterogeneous model ``repro_torch.search`` scores policies with).
    """
    total = {k: 0.0 for k in ("ifmap", "weight", "psum", "ofmap", "op",
                              "total", "sram_bytes", "dram_bytes", "macs")}
    for layer in layers:
        if isinstance(layer, LayerEnergySpec):
            e = layer_energy(layer.layer, acc, layer.dataflow or dataflow,
                             psum_bits=layer.psum_bits, gs=layer.gs,
                             n_p=layer.n_p, consts=consts)
        else:
            e = layer_energy(layer, acc, dataflow, psum_bits=psum_bits,
                             gs=gs, consts=consts)
        for k in total:
            total[k] += e[k]
    return total


def energy_summary(layers: list, acc: AcceleratorConfig,
                   *, dataflows=("IS", "WS"), psum_bits_list=(32, 8),
                   gs_list=(1, 2, 3, 4)) -> dict:
    """Grid of normalized energies: the engine behind Figs 1/5/6, Table IV.

    Returns {dataflow: {"baseline": E(int32), ("gs", g): E(int8, g)}}.
    """
    out: dict = {}
    for df in dataflows:
        row = {"baseline": model_energy(layers, acc, df, psum_bits=32)}
        for g in gs_list:
            row[("gs", g)] = model_energy(layers, acc, df, psum_bits=8, gs=g)
        out[df] = row
    return out


def savings(baseline: dict, apsq: dict) -> float:
    """Fractional energy saving (paper's 'energy costs saved by 28-87%')."""
    return 1.0 - apsq["total"] / baseline["total"]
