"""Layer walks (GEMM inventories) for the paper's evaluation models (a
copy of ``repro/energy/workloads.py``; ``arch_layers`` reads the port's
``ModelConfig``, which has the same fields).

Every workload is a list of ``LayerShape`` — the exact GEMMs an IS/WS
accelerator executes, with ``repeat`` folding identical layers.  Attention
score GEMMs (QK^T, PV) are included as per-head layers with C_i = head_dim;
their PSUM working set is small (n_p = head_dim / P_ci tiles) which is why
the paper's energy story is dominated by projection / FFN GEMMs.

Also provides ``arch_layers(cfg, seq_len)`` mapping ANY ModelConfig
(the 10 assigned architectures) onto the analytical model — the paper's
framework extended to the assignment's model zoo (used by the energy
benchmarks beyond the paper's own four models).
"""
from __future__ import annotations

from .model import LayerShape


def bert_base(seq: int = 128) -> list:
    """BERT-Base: 12 L, d=768, ffn=3072, 12 heads (paper Fig. 1 / Table I)."""
    d, ff, L, H = 768, 3072, 12, 12
    hd = d // H
    return [
        LayerShape("qkv", seq, d, 3 * d, repeat=L),
        LayerShape("attn_scores", seq, hd, seq, repeat=L * H),
        LayerShape("attn_values", seq, seq, hd, repeat=L * H),
        LayerShape("attn_out", seq, d, d, repeat=L),
        LayerShape("ffn_in", seq, d, ff, repeat=L),
        LayerShape("ffn_out", seq, ff, d, repeat=L),
    ]


def segformer_b0(res: int = 512) -> list:
    """Segformer-B0 @ res^2: 4 stages, dims [32,64,160,256], depths
    [2,2,2,2], efficient attn reduction [8,4,2,1], MLP ratio [8,8,4,4]."""
    dims = (32, 64, 160, 256)
    depths = (2, 2, 2, 2)
    sr = (8, 4, 2, 1)          # spatial reduction of K/V
    mlp = (8, 8, 4, 4)
    heads = (1, 2, 5, 8)
    layers: list = []
    tok = (res // 4) ** 2      # stage-1 tokens (stride-4 patch embed)
    for s, (d, dep, r, m, h) in enumerate(zip(dims, depths, sr, mlp, heads)):
        t = tok // (4 ** s)
        tk = t // (r * r)      # reduced kv tokens
        hd = d // h
        layers += [
            LayerShape(f"s{s}_q", t, d, d, repeat=dep),
            LayerShape(f"s{s}_kv", tk, d, 2 * d, repeat=dep),
            LayerShape(f"s{s}_scores", t, hd, tk, repeat=dep * h),
            LayerShape(f"s{s}_values", t, tk, hd, repeat=dep * h),
            LayerShape(f"s{s}_proj", t, d, d, repeat=dep),
            LayerShape(f"s{s}_mlp_in", t, d, m * d, repeat=dep),
            LayerShape(f"s{s}_mlp_out", t, m * d, d, repeat=dep),
        ]
    return layers


def efficientvit_b1(res: int = 512) -> list:
    """EfficientViT-B1 @ res^2: widths [16,32,64,128,256], ReLU linear
    attention in stages 3-5, MBConv expand 4 (conv as 1x1 GEMM view)."""
    widths = (16, 32, 64, 128, 256)
    depths = (1, 2, 3, 3, 4)
    layers: list = []
    for s, (w, dep) in enumerate(zip(widths, depths)):
        t = (res // (2 ** (s + 1))) ** 2
        # MBConv: expand 1x1, project 1x1 (depthwise omitted: not a GEMM)
        layers += [
            LayerShape(f"s{s}_mb_in", t, w, 4 * w, repeat=dep),
            LayerShape(f"s{s}_mb_out", t, 4 * w, w, repeat=dep),
        ]
        if s >= 2:  # EfficientViT module: linear attention qkv + proj
            layers += [
                LayerShape(f"s{s}_qkv", t, w, 3 * w, repeat=dep),
                # ReLU linear attention: (k^T v) then q (k^T v) — two
                # GEMMs with C_i = t and C_i = head_dim respectively;
                # aggregate heads (dim 16) into one shape.
                LayerShape(f"s{s}_ktv", 16, t, w, repeat=dep),
                LayerShape(f"s{s}_qktv", t, 16, w, repeat=dep),
                LayerShape(f"s{s}_proj", t, w, w, repeat=dep),
            ]
    return layers


def llama2_7b(seq: int = 4096, stage: str = "prefill") -> list:
    """LLaMA2-7B: 32 L, d=4096, ffn=11008, 32 heads.

    stage='prefill': the full-sequence pass (T = seq).
    stage='decode' : one token (T = 1) attending to a seq-long KV cache —
    per generated token; the paper's Table IV combines both at seq 4096.
    """
    d, ff, L, H = 4096, 11008, 32, 32
    hd = d // H
    if stage == "prefill":
        T, Tkv = seq, seq
    else:
        T, Tkv = 1, seq
    return [
        LayerShape("qkv", T, d, 3 * d, repeat=L),
        LayerShape("attn_scores", T, hd, Tkv, repeat=L * H),
        LayerShape("attn_values", T, Tkv, hd, repeat=L * H),
        LayerShape("attn_out", T, d, d, repeat=L),
        LayerShape("ffn_gate", T, d, ff, repeat=L),
        LayerShape("ffn_up", T, d, ff, repeat=L),
        LayerShape("ffn_down", T, ff, d, repeat=L),
    ]


def llama2_7b_combined(seq: int = 4096) -> list:
    """Table IV workload: the paper simulates the decoding stage by keeping
    the total MAC count unchanged (T = seq) and moving the parallelism to
    P_o=1, P_ci=P_co=32 (§IV-D) — i.e. the full-sequence layer walk run
    under ``AcceleratorConfig.llm_decode()``.  'Considering both prefilling
    and decoding stages' is that same walk: prefill and MAC-preserving
    decode share the shapes, only the accelerator config differs."""
    return llama2_7b(seq, "prefill")


def llama2_7b_autoregressive(seq: int = 4096) -> list:
    """Physical per-token decode walk (T=1, repeated seq times) — the
    weight-streaming-bound reality check reported next to Table IV."""
    dec = llama2_7b(seq, "decode")
    return [LayerShape(l.name + "_dec", l.tokens, l.c_i, l.c_o,
                       repeat=l.repeat * seq) for l in dec]


# ---------------------------------------------------------------------------
# Assigned-architecture walks (beyond the paper's own four models)
# ---------------------------------------------------------------------------

def arch_layers(cfg, seq_len: int, stage: str = "prefill") -> list:
    """Map a ``ModelConfig`` onto the analytical accelerator model.

    Walks the same GEMMs the model executes: per-block projections,
    FFN / MoE-active-expert GEMMs, attention score GEMMs for attn blocks.
    """
    T = 1 if stage == "decode" else seq_len
    Tkv = seq_len
    hd = cfg.hd
    d = cfg.d_model
    layers: list = []
    pat = cfg.block_pattern
    n_units = cfg.n_layers // len(pat)
    counts = {k: sum(1 for kk in pat if kk == k) * n_units for k in set(pat)}
    for i in range(cfg.n_layers % len(pat)):
        counts[pat[i]] = counts.get(pat[i], 0) + 1

    n_attn = counts.get("attn", 0) + counts.get("local", 0)
    if n_attn:
        q_dim = cfg.n_heads * hd
        kv_dim = cfg.n_kv_heads * hd
        win = min(cfg.local_window, Tkv)
        layers += [
            LayerShape("wq", T, d, q_dim, repeat=n_attn),
            LayerShape("wk", T, d, kv_dim, repeat=n_attn),
            LayerShape("wv", T, d, kv_dim, repeat=n_attn),
            LayerShape("wo", T, q_dim, d, repeat=n_attn),
        ]
        for kind, cnt in (("attn", counts.get("attn", 0)),
                          ("local", counts.get("local", 0))):
            if not cnt:
                continue
            kv_t = Tkv if kind == "attn" else win
            layers += [
                LayerShape(f"{kind}_scores", T, hd, kv_t,
                           repeat=cnt * cfg.n_heads),
                LayerShape(f"{kind}_values", T, kv_t, hd,
                           repeat=cnt * cfg.n_heads),
            ]
    if counts.get("rwkv", 0):
        n = counts["rwkv"]
        a = cfg.n_heads * hd
        layers += [LayerShape(f"rwkv_{nm}", T, d, a, repeat=n)
                   for nm in ("wr", "wk", "wv", "wg")]
        layers += [LayerShape("rwkv_wo", T, a, d, repeat=n)]
    if counts.get("rglru", 0):
        n = counts["rglru"]
        r = cfg.d_rnn
        layers += [
            LayerShape("rglru_wx", T, d, r, repeat=n),
            LayerShape("rglru_wy", T, d, r, repeat=n),
            LayerShape("rglru_gates", T, r, 2 * r, repeat=n),
            LayerShape("rglru_wo", T, r, d, repeat=n),
        ]

    L = cfg.n_layers
    if cfg.mlp == "moe":
        # top_k active experts per token; expert GEMMs at C_i = d / d_ff.
        k = cfg.top_k
        layers += [
            LayerShape("moe_router", T, d, cfg.n_experts, repeat=L),
            LayerShape("moe_wi", T, d, cfg.d_ff, repeat=L * k),
            LayerShape("moe_wg", T, d, cfg.d_ff, repeat=L * k),
            LayerShape("moe_wo", T, cfg.d_ff, d, repeat=L * k),
        ]
    elif cfg.mlp == "rwkv_cm":
        layers += [
            LayerShape("cm_wr", T, d, d, repeat=L),
            LayerShape("cm_wk", T, d, cfg.d_ff, repeat=L),
            LayerShape("cm_wv", T, cfg.d_ff, d, repeat=L),
        ]
    elif cfg.mlp == "swiglu":
        layers += [
            LayerShape("ffn_gate", T, d, cfg.d_ff, repeat=L),
            LayerShape("ffn_up", T, d, cfg.d_ff, repeat=L),
            LayerShape("ffn_down", T, cfg.d_ff, d, repeat=L),
        ]
    else:  # gelu
        layers += [
            LayerShape("ffn_in", T, d, cfg.d_ff, repeat=L),
            LayerShape("ffn_out", T, cfg.d_ff, d, repeat=L),
        ]
    if cfg.encdec and cfg.n_enc_layers:
        enc = [LayerShape("enc_" + l.name, Tkv, l.c_i, l.c_o,
                          repeat=l.repeat * cfg.n_enc_layers // max(L, 1))
               for l in layers if not l.name.startswith(("moe", "cm"))]
        layers += enc
    return layers
