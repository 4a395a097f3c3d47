"""recurrentgemma-2b — RecurrentGemma / Griffin 2B [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Pattern: (RG-LRU, RG-LRU, local-attention) — recurrent:attention 2:1,
local window 2048.  Served by the dense ``ServingEngine`` (the paged
engine refuses local attention, as in the reference).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    norm="rmsnorm",
    mlp="gelu",
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    d_rnn=2560,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", n_layers=3,
        d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
        vocab=256, mlp="gelu",
        block_pattern=("rglru", "rglru", "local"), local_window=16,
        d_rnn=64, dtype="float32")
