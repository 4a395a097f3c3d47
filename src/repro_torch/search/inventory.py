"""GEMM inventory: one layer namespace shared by quant and energy (a copy
of ``repro/search/inventory.py`` over the port's ``ModelConfig``).

The model zoo assigns every quantized linear a stable name
(``unit.0.mix.wq``, ``rem.1.ffn.wo``, ``encoder.unit.0.xattn.wk``,
``head`` — see ``models.model.init_layer``); ``QuantPolicy`` rules match
those names.  The analytical energy model, meanwhile, consumes anonymous
``LayerShape`` walks (``energy.workloads``).  This module closes the gap:
``model_inventory(cfg, seq_len)`` walks a ``ModelConfig`` exactly as
``init_lm`` does — dense / attention / MoE / RWKV / RG-LRU blocks,
repeated units, remainder layers, the encoder stack, the tied head —
and emits one ``GemmEntry`` per GEMM whose ``shape.name`` IS the quant
layer name.  A policy therefore resolves against the inventory with the
same ``fnmatch`` rules that drive parameter init, and the energy model
scores the exact GEMMs the forward executes.

Non-policy GEMMs (attention score/value GEMMs, the MoE router, gates,
the untied head) carry ``policy_name=None``: they contribute energy at
the INT32-PSUM baseline but are outside the quantizer namespace.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import effective_n_p
from repro_torch.energy.model import LayerEnergySpec, LayerShape
from repro_torch.models.config import ModelConfig
from repro_torch.quant.policy import resolve_quant


@dataclasses.dataclass(frozen=True)
class GemmEntry:
    """One GEMM of a model: its energy shape + quant-namespace identity.

    ``shape.name`` equals ``policy_name`` for quantizable projections so
    the two subsystems literally share one namespace; score GEMMs and
    other unquantized projections keep a descriptive name with
    ``policy_name=None``.
    """

    shape: LayerShape
    policy_name: str | None = None

    @property
    def quantizable(self) -> bool:
        return self.policy_name is not None


def _layer_entries(cfg: ModelConfig, kind: str, name: str, T: int, Tkv: int,
                   repeat: int, *, cross: bool = False) -> list:
    """GEMMs of one block named ``{name}.mix.* / {name}.ffn.*``.

    ``repeat`` folds identical layers (the units ``u0``, ``u1``, ... share
    names per pattern position, exactly as ``init_lm`` names them), so
    the inventory stays O(pattern), not O(n_layers).
    """
    d, hd = cfg.d_model, cfg.hd
    out: list = []

    def q(n: str, tokens: int, c_i: int, c_o: int, rep: int = 1):
        out.append(GemmEntry(LayerShape(n, tokens, c_i, c_o,
                                        repeat=rep * repeat), n))

    def anon(n: str, tokens: int, c_i: int, c_o: int, rep: int = 1):
        out.append(GemmEntry(LayerShape(n, tokens, c_i, c_o,
                                        repeat=rep * repeat), None))

    if kind in ("attn", "local"):
        q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
        kv_t = Tkv if kind == "attn" else min(cfg.local_window, Tkv)
        q(f"{name}.mix.wq", T, d, q_dim)
        q(f"{name}.mix.wk", T, d, kv_dim)
        q(f"{name}.mix.wv", T, d, kv_dim)
        q(f"{name}.mix.wo", T, q_dim, d)
        anon(f"{name}.mix.scores", T, hd, kv_t, rep=cfg.n_heads)
        anon(f"{name}.mix.values", T, kv_t, hd, rep=cfg.n_heads)
    elif kind == "rwkv":
        a = cfg.n_heads * hd
        for w in ("wr", "wk", "wv", "wg"):
            q(f"{name}.mix.{w}", T, d, a)
        q(f"{name}.mix.wo", T, a, d)
    elif kind == "rglru":
        r = cfg.d_rnn
        q(f"{name}.mix.wx", T, d, r)
        q(f"{name}.mix.wy", T, d, r)
        q(f"{name}.mix.wo", T, r, d)
        anon(f"{name}.mix.gates", T, r, 2 * r)
    if cross:
        q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q(f"{name}.xattn.wq", T, d, q_dim)
        q(f"{name}.xattn.wk", Tkv, d, kv_dim)
        q(f"{name}.xattn.wv", Tkv, d, kv_dim)
        q(f"{name}.xattn.wo", T, q_dim, d)
        anon(f"{name}.xattn.scores", T, hd, Tkv, rep=cfg.n_heads)
        anon(f"{name}.xattn.values", T, Tkv, hd, rep=cfg.n_heads)
    # channel mix
    if cfg.mlp == "moe":
        anon(f"{name}.ffn.router", T, d, cfg.n_experts)
        q(f"{name}.ffn.wi", T, d, cfg.d_ff, rep=cfg.top_k)
        q(f"{name}.ffn.wg", T, d, cfg.d_ff, rep=cfg.top_k)
        q(f"{name}.ffn.wo", T, cfg.d_ff, d, rep=cfg.top_k)
    elif cfg.mlp == "rwkv_cm":
        anon(f"{name}.ffn.wr", T, d, d)
        q(f"{name}.ffn.wk", T, d, cfg.d_ff)
        q(f"{name}.ffn.wv", T, cfg.d_ff, d)
    elif cfg.mlp == "swiglu":
        q(f"{name}.ffn.wi", T, d, cfg.d_ff)
        q(f"{name}.ffn.wg", T, d, cfg.d_ff)
        q(f"{name}.ffn.wo", T, cfg.d_ff, d)
    else:  # gelu
        q(f"{name}.ffn.wi", T, d, cfg.d_ff)
        q(f"{name}.ffn.wo", T, cfg.d_ff, d)
    return out


def _unit_entries(cfg: ModelConfig, prefix: str, T: int, Tkv: int,
                  repeat: int, *, cross: bool = False) -> list:
    out: list = []
    for i, kind in enumerate(cfg.block_pattern):
        out += _layer_entries(cfg, kind, f"{prefix}.{i}", T, Tkv, repeat,
                              cross=cross)
    return out


def model_inventory(cfg: ModelConfig, seq_len: int,
                    stage: str = "prefill") -> list:
    """Named ``GemmEntry`` walk of everything ``init_lm(cfg)`` builds.

    stage='prefill': full-sequence pass (T = seq_len).
    stage='decode' : one token against a seq_len KV history (T = 1).
    """
    if stage not in ("prefill", "decode"):
        raise ValueError(f"stage must be prefill|decode, got {stage!r}")
    T = 1 if stage == "decode" else seq_len
    entries: list = []
    if cfg.encdec and cfg.n_enc_layers:
        n_enc_units = cfg.n_enc_layers // len(cfg.block_pattern)
        entries += _unit_entries(cfg, "encoder.unit", seq_len, seq_len,
                                 n_enc_units)
    entries += _unit_entries(cfg, "unit", T, seq_len, cfg.n_units,
                             cross=cfg.encdec)
    for i in range(cfg.n_rem):
        entries += _layer_entries(cfg, cfg.block_pattern[i], f"rem.{i}",
                                  T, seq_len, 1, cross=cfg.encdec)
    # Head: the tied-embedding logits GEMM is in the quant namespace
    # ("head", calibrated by calibrate_model); the untied head is a plain
    # float projection.
    head = GemmEntry(LayerShape("head", T, cfg.d_model, cfg.vocab),
                     "head" if cfg.tie_embeddings else None)
    entries.append(head)
    return entries


def quantizable_names(inventory: list) -> list:
    """Stable layer names a policy can address, in walk order."""
    return [e.policy_name for e in inventory if e.quantizable]


def layer_classes(inventory: list) -> dict:
    """Group quantizable names into the glob classes candidates tune.

    Returns ``{glob_pattern: [names]}`` for the classes present in this
    architecture — the knobs of the (gs, n_p) search space.  Order matters
    (first match wins in ``QuantPolicy``): more specific classes first.
    """
    classes = (
        ("encoder.*", lambda n: n.startswith("encoder.")),
        ("rem.*", lambda n: n.startswith("rem.")),
        ("*.xattn.*", lambda n: ".xattn." in n),
        ("*.mix.*", lambda n: ".mix." in n),
        ("*.ffn.*", lambda n: ".ffn." in n),
        ("head", lambda n: n == "head"),
    )
    # Dict order == the classes-tuple order (NOT inventory walk order):
    # callers turn this straight into QuantPolicy rules, where the first
    # match wins — a generic '*.mix.*' rule listed before 'rem.*' would
    # silently shadow the remainder-layer knob.
    out: dict = {pattern: [] for pattern, _ in classes}
    for name in quantizable_names(inventory):
        for pattern, match in classes:
            if match(name):
                out[pattern].append(name)
                break
    return {p: names for p, names in out.items() if names}


def energy_specs(inventory: list, policy, acc) -> list:
    """Resolve a ``QuantPolicy`` against the inventory -> LayerEnergySpec.

    Quantized layers with PSUM handling run at ``psum.bits`` with their
    policy's ``gs`` (PSQ keeps every tile live: gs = n_p); W8A8-only and
    unquantized layers accumulate at the INT32 baseline.  The energy-side
    tile count is ``max(ceil(C_i / P_ci), policy n_p)``: the MAC array's
    physical input-channel parallelism floors how coarsely K can be tiled
    (a quantizer spanning several hardware tiles still pays every
    buffer read-modify-write), while a policy tiling K *finer* than the
    array genuinely adds PSUM traffic.  The policy's n_p is first clamped
    to a divisor of C_i exactly as ``quant_params_init`` clamps it.
    ``policy`` may be None (the all-float model).
    """
    specs: list = []
    for e in inventory:
        resolved = (resolve_quant(policy, e.policy_name)
                    if e.quantizable else None)
        if resolved is None or resolved.psum.mode == "none":
            specs.append(LayerEnergySpec(e.shape))
            continue
        n_hw = -(-e.shape.c_i // acc.P_ci)
        n_p = max(n_hw, effective_n_p(e.shape.c_i, resolved.psum.n_p))
        gs = n_p if resolved.psum.mode == "psq" else min(resolved.psum.gs,
                                                         n_p)
        specs.append(LayerEnergySpec(e.shape, psum_bits=resolved.psum.bits,
                                     gs=gs, n_p=n_p))
    return specs
