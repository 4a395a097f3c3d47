"""Per-layer quantization policies (a copy of ``repro/quant/policy.py``,
which the port does not import).

The paper's central observation is that PSUM quantization is a *per-layer,
hardware-aware* property of every GEMM: ``n_p = ceil(C_i / P_ci)`` differs
per layer and the reconfigurable RAE switches ``gs`` per layer (§III-C).
``QuantPolicy`` makes that first-class: an ordered list of
``(layer-name glob -> QuantConfig)`` rules, resolved against the stable
layer names the model zoo assigns to every quantized linear
(``unit.<i>.mix.wq``, ``unit.<i>.ffn.wi``, ``rem.<i>...``,
``encoder.unit.<i>...``).

First matching rule wins; ``default`` handles the fallthrough.  A global
``QuantConfig`` is the trivial one-rule policy (``QuantPolicy.uniform``).
Policies are frozen/hashable so they can live inside ``ModelConfig``.

    policy = QuantPolicy.of(
        ("*.mix.*", QuantConfig.apsq(gs=2, n_p=4)),
        ("*.ffn.*", QuantConfig.apsq(gs=4, n_p=8)),
        default=QuantConfig.w8a8(),
    )
    cfg = CONFIG.with_quant(policy)
"""
from __future__ import annotations

import dataclasses
import fnmatch

from repro_torch.core import QuantConfig


@dataclasses.dataclass(frozen=True)
class QuantRule:
    """One ``glob -> config`` entry of a policy (first match wins)."""

    pattern: str
    config: QuantConfig


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered per-layer quantizer rules with a default fallthrough.

    ``resolve(name)`` returns the ``QuantConfig`` for a layer name, or
    None when no rule matches and there is no default (layer stays float).
    """

    rules: tuple = ()
    default: QuantConfig | None = None

    def __post_init__(self):
        for r in self.rules:
            if not isinstance(r, QuantRule):
                raise TypeError(f"rules must be QuantRule, got {type(r)}")

    def resolve(self, name: str) -> QuantConfig | None:
        for rule in self.rules:
            if fnmatch.fnmatchcase(name, rule.pattern):
                return rule.config
        return self.default

    @staticmethod
    def uniform(config: QuantConfig) -> "QuantPolicy":
        """The trivial policy: one config for every layer."""
        return QuantPolicy(default=config)

    @staticmethod
    def of(*pairs, default: QuantConfig | None = None) -> "QuantPolicy":
        """Build from ``(pattern, config)`` pairs, in precedence order."""
        return QuantPolicy(
            rules=tuple(QuantRule(p, c) for p, c in pairs), default=default)

    def describe(self, names) -> dict:
        """Resolved config per name (debugging / export reports)."""
        return {n: self.resolve(n) for n in names}


def resolve_quant(quant, name: str) -> QuantConfig | None:
    """Normalize a ``QuantConfig | QuantPolicy | None`` to a per-layer
    config (None when the layer stays unquantized)."""
    if quant is None:
        return None
    if isinstance(quant, QuantConfig):
        return quant if quant.enabled else None
    cfg = quant.resolve(name)
    return cfg if (cfg is not None and cfg.enabled) else None
