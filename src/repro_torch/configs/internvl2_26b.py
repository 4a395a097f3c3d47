"""internvl2-26b — InternVL2 26B [arXiv:2404.16821; hf].

LM backbone (InternLM2-20B) only: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553.  The InternViT frontend is a stub: precomputed
patch embeddings [B, 256, d_model] are projected (``frontend_proj``, a
float linear) and prepended to the text tokens
(``models.model.embed_inputs``).
"""
from repro_torch.models.config import ModelConfig

N_IMAGE_TOKENS = 256  # 448px / 14 patch / 2x2 pixel-shuffle = 16x16

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    norm="rmsnorm",
    mlp="swiglu",
    frontend="vision",
    n_frontend_tokens=N_IMAGE_TOKENS,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, frontend="vision",
        n_frontend_tokens=4, dtype="float32")
