"""Wrapper of the INT8-KV attention kernel (port of
``kernels/int8_kv_attention/ops.py``).

A tensor on the CPU goes to the plain version (``ref``); a CUDA tensor
goes to the kernel in ``csrc/int8_kv_attention.cu`` or raises.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from . import ref

# compiled instances: the tests, smoke configs, TinyLlama, OLMoE
HEAD_DIMS = (8, 16, 64, 128)


def int8_kv_attention(q: torch.Tensor, k_codes: torch.Tensor,
                      v_codes: torch.Tensor, k_exp: torch.Tensor,
                      v_exp: torch.Tensor, length) -> torch.Tensor:
    """Attention over an INT8 cache, matching q's rank (3-D decode row,
    4-D causal prefill chunk ending at ``length - 1``); output in q's
    dtype."""
    B, S, Hkv, hd = k_codes.shape
    length = torch.as_tensor(length, device=q.device).to(torch.int32)
    length = length.reshape(-1).expand(B).contiguous()
    if q.device.type == "cpu":
        return ref.int8_kv_attention_ref(q, k_codes, v_codes, k_exp, v_exp,
                                         length)
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError("KV codes must be int8")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    C, Hq = q4.shape[1], q4.shape[2]
    if (Hq % Hkv or q4.shape[0] != B or q4.shape[3] != hd
            or v_codes.shape != k_codes.shape
            or tuple(k_exp.shape) != (B, Hkv)
            or tuple(v_exp.shape) != (B, Hkv)):
        raise ValueError(f"q {tuple(q.shape)}, exps {tuple(k_exp.shape)} "
                         f"do not match cache {tuple(k_codes.shape)}")
    if not all(t.device == q.device for t in (k_codes, v_codes, k_exp,
                                                v_exp)):
        raise ValueError("attention operands on different devices")
    qf = q4.float().contiguous()
    out = torch.empty_like(qf)
    # the kernel reads codes 4 at a time: rows must start 4-byte aligned
    kc, vc = (t if t.is_contiguous() and t.data_ptr() % 4 == 0
              else t.clone(memory_format=torch.contiguous_format)
              for t in (k_codes, v_codes))
    ke = k_exp.to(torch.int32).contiguous()
    ve = v_exp.to(torch.int32).contiguous()
    err = _build.entry("int8_kv_attention")(
        qf.data_ptr(), kc.data_ptr(), vc.data_ptr(), ke.data_ptr(),
        ve.data_ptr(), length.data_ptr(), out.data_ptr(), B, C, Hq, S, Hkv,
        hd, 1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(err, "int8_kv_attention")
    out = out.to(q.dtype)
    return out[:, 0] if squeeze else out
