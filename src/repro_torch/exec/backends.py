"""Execution backends for deployed integer ops (port of
``repro/exec/backends.py``).

Two op families behind three backends:

  * ``int_gemm``: INT8 activation codes [M, K] x a deployed layer's
    weight codes [K, N] with PSUM shift exponents ([n_p] or [n_p, N];
    None for plain W8A8) -> INT32 in product-scale units, and its
    stacked MoE form ``int_expert_gemm``: [E, M, K] x [E, K, N] with
    exponent banks [E, n_p] or [E, n_p, N] -> [E, M, N] in one op;
  * ``kv_attention``: a float query against an INT8 KV cache with PO2
    exponents per (batch, kv-head), decode (3-D q) or prefill chunk (4-D).

Backends:

  * ``oracle`` — the torch integer/float references
    (``kernels/*/ref.py``), on any device;
  * ``cuda``   — the hand-written kernels (``kernels/*/ops.py``); takes
    CUDA tensors only and raises for others;
  * ``auto``   — ``cuda`` for CUDA tensors, ``oracle`` for CPU tensors
    (the default).  There is no fallback: a CUDA tensor whose kernel
    fails to build or launch raises;
  * ``sharded`` — ``ShardedBackend``: a leaf backend on each rank of a
    mesh, combined by ``repro_torch.dist.tp``'s collectives (meshless,
    as registered, it delegates).

``execute_gemm`` routes ``psum_exps is None`` to the baseline W8A8 kernel
and M == 1 to the m=1 decode kernel, as the JAX ops do;
``execute_expert_gemm`` routes an expert bank to the fused expert
kernels (APSQ or W8A8) in one launch for all experts.  Backends live in
a registry (``register_backend``, ``available_backends``,
``get_backend``); ``backend_parity_check`` runs one deployed GEMM
through several of them side by side.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import (DeployedQuantState, QuantConfig, pow2,
                              psum_group_size, qrange)


class ExecBackend:
    name = "base"

    def int_gemm(self, x_codes, w_codes, psum_exps, *, gs: int):
        raise NotImplementedError

    def int_expert_gemm(self, x_codes, w_codes, psum_exps, *, gs: int):
        raise NotImplementedError

    def kv_attention(self, q, k_codes, v_codes, k_exp, v_exp, length):
        raise NotImplementedError

    def local_heads(self, q, k, v):
        """The heads of q [..., Hq, hd] and of the new K/V rows this
        process attends and caches: all of them, but on a mesh."""
        return q, k, v

    def gather_heads(self, out, n_heads: int):
        """Attention output of ``local_heads``' heads -> all ``n_heads``."""
        return out

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class OracleBackend(ExecBackend):
    """Torch references (``apsq_matmul.ref`` / ``int8_kv_attention.ref``)."""

    name = "oracle"

    def int_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        from repro_torch.kernels.apsq_matmul import ref
        if psum_exps is None:
            return ref.baseline_matmul_ref(x_codes, w_codes)
        return ref.apsq_matmul_ref(x_codes, w_codes, psum_exps,
                                   n_p=int(psum_exps.shape[0]), gs=gs)

    def int_expert_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        """Vectorised over E (one batched product per PSUM tile),
        bit-identical to the JAX oracle's E unrolled ``int_gemm`` calls."""
        from repro_torch.kernels.apsq_matmul import ref
        if psum_exps is None:
            return ref.baseline_expert_matmul_ref(x_codes, w_codes)
        return ref.apsq_expert_matmul_ref(x_codes, w_codes, psum_exps,
                                          gs=gs)

    def kv_attention(self, q, k_codes, v_codes, k_exp, v_exp, length):
        from repro_torch.kernels.int8_kv_attention import int8_kv_attention_ref
        return int8_kv_attention_ref(q, k_codes, v_codes, k_exp, v_exp,
                                     length)


class CudaBackend(ExecBackend):
    """The hand-written CUDA kernels; CUDA tensors only."""

    name = "cuda"

    @staticmethod
    def _require_cuda(t):
        if t.device.type != "cuda":
            raise ValueError(f"backend 'cuda' got a tensor on {t.device}; "
                             "use backend 'oracle' or 'auto' on the CPU")

    def int_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        from repro_torch.kernels.apsq_matmul import (apsq_matmul_int8,
                                                     baseline_matmul_int8)
        self._require_cuda(x_codes)
        if psum_exps is None:
            return baseline_matmul_int8(x_codes, w_codes)
        return apsq_matmul_int8(x_codes, w_codes, psum_exps, gs=gs)

    def int_expert_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        from repro_torch.kernels.apsq_matmul import (
            apsq_expert_matmul_int8, baseline_expert_matmul_int8)
        self._require_cuda(x_codes)
        if psum_exps is None:
            return baseline_expert_matmul_int8(x_codes, w_codes)
        return apsq_expert_matmul_int8(x_codes, w_codes, psum_exps, gs=gs)

    def kv_attention(self, q, k_codes, v_codes, k_exp, v_exp, length):
        from repro_torch.kernels.int8_kv_attention import int8_kv_attention
        self._require_cuda(q)
        return int8_kv_attention(q, k_codes, v_codes, k_exp, v_exp, length)


class AutoBackend(ExecBackend):
    """``cuda`` for CUDA tensors, ``oracle`` for CPU tensors."""

    name = "auto"

    @staticmethod
    def _pick(t) -> ExecBackend:
        return _REGISTRY["cuda" if t.device.type == "cuda" else "oracle"]

    def int_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        return self._pick(x_codes).int_gemm(x_codes, w_codes, psum_exps,
                                            gs=gs)

    def int_expert_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        return self._pick(x_codes).int_expert_gemm(x_codes, w_codes,
                                                   psum_exps, gs=gs)

    def kv_attention(self, q, k_codes, v_codes, k_exp, v_exp, length):
        return self._pick(q).kv_attention(q, k_codes, v_codes, k_exp, v_exp,
                                          length)


class ShardedBackend(ExecBackend):
    """Mesh-parallel integer execution: the ``inner`` leaf backend on
    each rank's shard, INT8-on-the-wire combines between ranks (port of
    the reference's ``ShardedBackend``).

    The shard axis of each GEMM is the plan ``dist.tp.shard_deployed``
    placed its codes with: PSQ layers K-shard by whole PSUM tiles (int32
    reduce-scatter + int8 code gather), APSQ layers shard N (int8 code
    gather: the output is a code times the static ``2^e_last``), W8A8
    K-shards with an int32 all-reduce, MoE expert banks run expert-
    parallel with an int8 code gather, and attention splits heads
    (``local_heads`` / ``gather_heads``; the attention itself then needs
    no collective, so ``kv_attention`` runs ``inner`` on the rank's
    heads).  Every path is bit-exact to ``inner`` on one rank;
    ``wire="fp32"`` swaps the int8 collectives for 4-byte gathers.

    The registered ``backend="sharded"`` instance has no mesh and
    delegates to ``auto``; pass ``mesh=`` to ``PagedServingEngine``
    (which wraps its backend) for multi-rank serving.
    """

    name = "sharded"

    def __init__(self, mesh=None, inner="auto", *,
                 model_axis: str = "model", wire: str = "int8"):
        if wire not in ("int8", "fp32"):
            raise ValueError(f"wire must be 'int8' or 'fp32', got {wire!r}")
        self.mesh = mesh
        self.inner = inner
        self.model_axis = model_axis
        self.wire = wire

    def _leaf(self) -> ExecBackend:
        return get_backend(self.inner)

    def int_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        if self.mesh is None:
            return self._leaf().int_gemm(x_codes, w_codes, psum_exps, gs=gs)
        from repro_torch.dist.tp import sharded_int_gemm  # lazy: dist
        return sharded_int_gemm(self.mesh, self._leaf(), x_codes, w_codes,
                                psum_exps, gs=gs, model_axis=self.model_axis,
                                wire=self.wire)

    def int_expert_gemm(self, x_codes, w_codes, psum_exps, *, gs):
        if self.mesh is None:
            return self._leaf().int_expert_gemm(x_codes, w_codes, psum_exps,
                                                gs=gs)
        from repro_torch.dist.tp import sharded_int_expert_gemm
        return sharded_int_expert_gemm(
            self.mesh, self._leaf(), x_codes, w_codes, psum_exps, gs=gs,
            model_axis=self.model_axis, wire=self.wire)

    def kv_attention(self, q, k_codes, v_codes, k_exp, v_exp, length):
        return self._leaf().kv_attention(q, k_codes, v_codes, k_exp, v_exp,
                                         length)

    def local_heads(self, q, k, v):
        if self.mesh is None:
            return q, k, v
        from repro_torch.dist.tp import split_heads
        return split_heads(self.mesh, q, k, v, model_axis=self.model_axis)

    def gather_heads(self, out, n_heads: int):
        if self.mesh is None:
            return out
        from repro_torch.dist.tp import gather_heads
        return gather_heads(self.mesh, out, n_heads,
                            model_axis=self.model_axis)


_REGISTRY: dict = {}


def register_backend(name: str, backend: ExecBackend) -> None:
    _REGISTRY[name] = backend


register_backend("oracle", OracleBackend())
register_backend("cuda", CudaBackend())
register_backend("auto", AutoBackend())
register_backend("sharded", ShardedBackend())

DEFAULT_BACKEND = "auto"


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_backend(backend=None) -> ExecBackend:
    """Resolve a backend name / instance / None (-> ``auto``)."""
    if backend is None:
        backend = DEFAULT_BACKEND
    if isinstance(backend, ExecBackend):
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(f"unknown exec backend {backend!r}; "
                       f"known: {available_backends()}") from None


def quantize_activations(x2d: torch.Tensor, ax_exp: torch.Tensor,
                         a_bits: int = 8) -> torch.Tensor:
    """Float activations [M, K] -> INT8 codes at the PO2 scale 2^ax_exp
    (``ax_exp`` broadcasts: [E, 1, 1] quantizes [E, M, K] per expert)."""
    qn, qp = qrange(a_bits, True)
    inv = pow2(-torch.as_tensor(ax_exp).to(torch.int32)).to(x2d.device)
    return torch.clamp(torch.round(x2d.float() * inv), qn, qp).to(torch.int8)


def execute_gemm(dq: DeployedQuantState, x: torch.Tensor, *,
                 backend=None) -> torch.Tensor:
    """Run one deployed linear: quantize -> integer GEMM -> rescale.

    ``x`` is [..., K] float; leading dims flatten to M.  The INT32 output
    is rescaled by ``2^(ax_exp + aw_exp)``; result [..., *out_dims] in
    x.dtype.
    """
    backend = get_backend(backend)
    spec = dq.spec or QuantConfig.w8a8()
    k = x.shape[-1]            # a K-sharded rank's codes hold a K span
    out_shape = tuple(x.shape[:-1]) + tuple(dq.out_dims)
    xc = quantize_activations(x.reshape(-1, k), dq.ax_exp, spec.a_bits)
    gs = 1
    if dq.psum_exps is not None:
        gs = psum_group_size(spec, int(dq.psum_exps.shape[0]))
    y = backend.int_gemm(xc, dq.w_codes, dq.psum_exps, gs=gs)
    scale = pow2(dq.ax_exp + dq.aw_exp).to(y.device)
    return (y.float() * scale).to(x.dtype).reshape(out_shape)


def backend_parity_check(dq: DeployedQuantState, x: torch.Tensor, *,
                         backends=("oracle", "cuda"), reps: int = 1,
                         warmup: int = 1):
    """Run one deployed GEMM through several backends, side by side.

    Returns ``(outs, times_us, bit_equal)``: per-backend outputs, keyed by
    the backend's name; per-backend wall-clock in microseconds (eager,
    after ``warmup`` calls, the mean of ``reps``; on the card each timed
    span starts and ends with ``torch.cuda.synchronize``); and whether
    every output is bit-identical to the first, or None when fewer than
    two backends ran (no parity is claimed that was not run).  A backend
    that cannot take ``x``'s device raises (``cuda`` on a CPU tensor).
    """
    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    outs, times = {}, {}
    with torch.no_grad():
        for be in backends:
            resolved = get_backend(be)
            for _ in range(warmup):
                execute_gemm(dq, x, backend=resolved)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = execute_gemm(dq, x, backend=resolved)
            sync()
            times[resolved.name] = (time.perf_counter() - t0) / reps * 1e6
            outs[resolved.name] = out
    vals = list(outs.values())
    bit_equal = (all(torch.equal(vals[0], v) for v in vals[1:])
                 if len(vals) > 1 else None)
    return outs, times, bit_equal


def execute_expert_gemm(dq: DeployedQuantState, x: torch.Tensor, *,
                        backend=None) -> torch.Tensor:
    """Run a deployed MoE expert bank: x [E, C, K] against per-expert
    codes, all E experts as ONE backend op.

    ``dq`` carries a leading expert axis on every data leaf (w_codes
    [E, K, N], ax_exp [E], aw_exp [E, N] or [E], psum_exps [E, n_p, N]
    or [E, n_p]).  Activations quantize per expert, ``int_expert_gemm``
    runs the stacked integer GEMM and the INT32 outputs rescale per
    expert by ``2^(ax_exp[e] + aw_exp[e])``.  Bit-identical to
    ``execute_gemm`` on each expert's slice of ``dq``.
    """
    backend = get_backend(backend)
    spec = dq.spec or QuantConfig.w8a8()
    n_exp = int(dq.ax_exp.shape[0])   # an expert-parallel rank's codes
    k = x.shape[-1]                    # hold E/D experts
    out_shape = tuple(x.shape[:-1]) + tuple(dq.out_dims)
    ax = dq.ax_exp.reshape(n_exp, 1, 1)
    xc = quantize_activations(x.reshape(n_exp, -1, k), ax, spec.a_bits)
    gs = 1
    if dq.psum_exps is not None:
        gs = psum_group_size(spec, int(dq.psum_exps.shape[1]))
    y = backend.int_expert_gemm(xc, dq.w_codes, dq.psum_exps, gs=gs)
    aw = dq.aw_exp.reshape(n_exp, 1, -1)
    scale = pow2(ax + aw).to(y.device)
    return (y.float() * scale).to(x.dtype).reshape(out_shape)


def kv_block_size(seq_len: int, requested: int = 512) -> int:
    """Largest divisor of ``seq_len`` that is <= ``requested``.

    Kept for parity with ``repro.exec``: the port's attention kernel tiles
    S itself, so nothing in the port calls it."""
    b = max(1, min(requested, seq_len))
    while seq_len % b:
        b -= 1
    return b


def execute_kv_attention(q, k_codes, v_codes, k_exp, v_exp, length, *,
                         backend=None):
    """Attention over an INT8 KV cache through the backend registry.

    q: [B, Hq, hd] (decode row) or [B, C, Hq, hd] (prefill chunk ending
    at ``length - 1``); codes [B, S, Hkv, hd] int8; exponents [B, Hkv];
    ``length`` [B] or scalar.  Unlike the JAX entry point it takes no
    ``block_s``: the CUDA kernel tiles S itself.  Output matches q's rank
    and dtype.
    """
    backend = get_backend(backend)
    length = torch.as_tensor(length, device=q.device).to(torch.int32)
    length = length.reshape(-1).expand(k_codes.shape[0]).contiguous()
    return backend.kv_attention(q, k_codes, v_codes,
                                k_exp.to(torch.int32), v_exp.to(torch.int32),
                                length)
