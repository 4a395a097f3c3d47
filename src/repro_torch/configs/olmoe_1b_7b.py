"""olmoe-1b-7b — OLMoE 1B active / 7B total [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304,
MoE 64 experts top-8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    norm="rmsnorm",
    mlp="moe",
    n_experts=64,
    top_k=8,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=256, mlp="moe",
        n_experts=8, top_k=2, dtype="float32")
