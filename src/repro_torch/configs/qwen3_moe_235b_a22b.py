"""qwen3-moe-235b-a22b — Qwen3 MoE 235B total / 22B active
[hf:Qwen/Qwen3-30B-A3B family scaling; hf].

94L d_model=4096 64H (GQA kv=4, head_dim=128) expert d_ff=1536
vocab=151936, MoE 128 experts top-8.  The attention is wider than the
model (64 * 128 = 8192 against d_model 4096).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    norm="rmsnorm",
    mlp="moe",
    n_experts=128,
    top_k=8,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab=256,
        mlp="moe", n_experts=8, top_k=2, dtype="float32")
