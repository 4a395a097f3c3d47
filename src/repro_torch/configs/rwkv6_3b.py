"""rwkv6-3b — RWKV-6 "Finch" 3B [arXiv:2404.05892; hf].

32L d_model=2560 (attention-free), d_ff=8960, vocab=65536.
Data-dependent decay WKV recurrence; head_dim 64 => 40 heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    norm="layernorm",
    mlp="rwkv_cm",
    block_pattern=("rwkv",),
    wkv_impl="chunked",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab=256,
        norm="layernorm", mlp="rwkv_cm", block_pattern=("rwkv",),
        wkv_impl="chunked", dtype="float32")
