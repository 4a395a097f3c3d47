"""Model assembly (port of ``repro.models``: dense, MoE, RWKV-6, RG-LRU and
sliding-window attention decoders, the encoder-decoder and the modality
stubs)."""
from .config import ModelConfig
from .model import (apply_layer, apply_unit, batch_state_axes,
                    decode_horizon, decode_horizon_paged, decode_step,
                    decode_step_paged, embed_inputs, encode, forward,
                    forward_paged_chunk, init_decode_state, init_lm,
                    init_paged_decode_state, lm_loss, logits_from_hidden,
                    paged_state_axes, sample_tokens, tree_leaves, tree_map)
from .moe import init_moe, moe_ffn

__all__ = [
    "ModelConfig", "apply_layer", "apply_unit", "batch_state_axes",
    "decode_horizon", "decode_horizon_paged", "decode_step",
    "decode_step_paged", "embed_inputs", "encode", "forward",
    "forward_paged_chunk",
    "init_decode_state", "init_lm", "init_moe", "init_paged_decode_state",
    "lm_loss", "logits_from_hidden", "moe_ffn", "paged_state_axes",
    "sample_tokens", "tree_leaves", "tree_map",
]
