"""seamless-m4t-large-v2 — SeamlessM4T v2 large [arXiv:2308.11596; hf].

Enc-dec transformer backbone only: 24 encoder + 24 decoder layers,
d_model=1024, 16 heads (GQA kv=16), d_ff=8192, vocab=256206.  The audio
frontend is a stub: precomputed frame embeddings [B, S, d_model] feed
the encoder directly (``models.model.encode``).  As in the JAX package,
RoPE replaces learned positions; LayerNorm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    norm="layernorm",
    mlp="gelu",
    encdec=True,
    n_enc_layers=24,
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, norm="layernorm",
        mlp="gelu", encdec=True, n_enc_layers=2, frontend="audio",
        dtype="float32")
