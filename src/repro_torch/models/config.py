"""ModelConfig (port of ``repro/models/config.py``, the fields the port
reads).

The JAX dataclass's field names and defaults, for the fields the served
and trained models read (a ``block_pattern`` of attention, sliding-window
``local`` attention, RWKV-6 and RG-LRU layers, a score ``softcap``,
RMSNorm or LayerNorm, a SwiGLU, GELU, MoE or RWKV
channel mix, partial RoPE, a tied or untied head; an encoder stack of
``n_enc_layers`` with cross-attention in the decoder when ``encdec``; a
modality stub ``frontend``: ``"audio"`` frames feed the encoder,
``"vision"`` patches are projected and prepended to the tokens;
``remat`` / ``remat_policy`` and ``z_loss`` for training), and the
assigned input-shape cells ``SHAPE_CELLS``.  ``n_layers``
is ``n_units`` repeats of the pattern plus ``n_rem`` remainder layers
(the pattern's first ``n_rem`` kinds).  The JAX package's
``scan_layers`` has no counterpart: the port always holds units as
``{"u0": ..., "u1": ...}`` and loops over them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import QuantConfig

BLOCK_KINDS = ("attn", "local", "rwkv", "rglru")
WKV_IMPLS = ("scan", "chunked")
REMAT_POLICIES = ("none", "dots")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    mlp: str = "swiglu"               # swiglu | gelu | moe | rwkv_cm
    block_pattern: tuple = ("attn",)
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    local_window: int = 2048
    softcap: float | None = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # RWKV
    wkv_impl: str = "scan"            # scan | chunked
    wkv_chunk: int = 32               # chunk length for the chunked WKV
    # RG-LRU
    d_rnn: int | None = None
    # encoder-decoder (seamless)
    encdec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: precomputed embeddings are model inputs
    frontend: str | None = None       # audio | vision
    n_frontend_tokens: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    quant_policy: object | None = None
    remat: bool = True
    remat_policy: str = "none"        # none | dots  ("none" = save nothing)
    # loss
    z_loss: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pattern_kinds(self) -> tuple:
        return tuple(self.block_pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no full-attention layer exists (long_500k eligibility)."""
        return all(k in ("rwkv", "rglru", "local") for k in self.block_pattern)

    @property
    def recurrent(self) -> bool:
        """True when a layer carries a recurrent state (rwkv, rglru)."""
        return any(k in ("rwkv", "rglru") for k in self.block_pattern)

    @property
    def policy(self):
        """The per-layer quantization policy driving param init."""
        if self.quant_policy is not None:
            return self.quant_policy
        if self.quant.enabled:
            from repro_torch.quant.policy import QuantPolicy
            return QuantPolicy.uniform(self.quant)
        return None

    def with_quant(self, quant) -> "ModelConfig":
        """Set a global ``QuantConfig`` or a per-layer ``QuantPolicy``."""
        if isinstance(quant, QuantConfig):
            return dataclasses.replace(self, quant=quant, quant_policy=None)
        return dataclasses.replace(self, quant_policy=quant)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self):
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        for k in self.block_pattern:
            assert k in BLOCK_KINDS, k
        if self.mlp == "moe":
            assert 1 <= self.top_k <= self.n_experts, (self.top_k,
                                                       self.n_experts)
        if "rglru" in self.block_pattern and self.d_rnn is None:
            raise ValueError(f"{self.name}: rglru layers need d_rnn")
        if self.wkv_impl not in WKV_IMPLS:
            raise ValueError(f"wkv_impl {self.wkv_impl!r} is not one of "
                             f"{WKV_IMPLS}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not "
                             f"one of {REMAT_POLICIES}")
        return self

    def check_ported(self):
        """Raise for what this slice of the port does not serve yet."""
        if (self.family not in FAMILIES
                or not set(self.block_pattern) <= set(BLOCK_KINDS)
                or self.mlp not in ("swiglu", "gelu", "moe", "rwkv_cm")
                or self.norm not in ("rmsnorm", "layernorm")
                or self.frontend not in (None, "audio", "vision")):
            raise NotImplementedError(
                f"{self.name}: the port runs stacks of attention, local "
                "attention, RWKV-6 and RG-LRU layers (RMSNorm or "
                "LayerNorm; SwiGLU, GELU, MoE or RWKV channel mix; an "
                "audio or vision frontend stub) of the families "
                f"{FAMILIES} only")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell: a sequence length, a global batch
    and what runs at it."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
