"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode): each carries the ``cuda`` marker and skips without a card.  The
file imports only torch, numpy and ``repro_torch``, so it runs on a
machine without JAX:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

* APSQ GEMMs (generic and m=1) and the W8A8 baseline: bit-exact; both
  tensor-core designs over M, K, N (TinyLlama's projections at M 1-128
  for APSQ, StarCoder2-15B's and ChatGLM3-6B's at M 1, 8 and 16, a tied
  head's W8A8 GEMM up to K=6144 N=49152; ragged tiles, misaligned
  operands, extreme codes at K=5632, APSQ shift counts past 31) too,
  bit-identical on repeat, one launch count per call.
* The fused MoE expert GEMMs (APSQ and W8A8, all experts in one
  launch): bit-exact over E, M (rows past M masked, two row blocks at
  M=17), ragged K, gs (past 16 too) and both exponent layouts; banks
  with empty experts and experts with one live row, a routed OLMoE
  bank, operands 4-byte but not 16-byte aligned, Qwen3-MoE's banks
  (E=128 at K=4096 N=1536 and K=1536 N=4096); bit-identical on repeat,
  one launch count per call.
* INT8-KV attention, decode and chunk forms (hd 8, 16, 64 and 128; GQA
  groups of 12 and 16 at hd 128): rtol 2e-5 / atol 2e-6, with S split
  across blocks (S up to 4096),
  rows whose limit is <= 0 and a cache view that is 4-byte but not
  16-byte aligned; bit-identical on repeat, one launch count per call.
* A CUDA tensor never takes the plain path: the launch counters move.
* A deployed ``moe_ffn`` on the card makes no host round trip.
* The paged-cache scatter leaves the same pool on the card as the
  CPU's sequential scatter, though table rows repeat the null page.
* Quantization-aware training (fake quant, plain PyTorch, TF32 off):
  ``apsq_matmul`` and ``quant_dense`` gradients on the card equal the
  CPU's on the PO2 grid (x and w bit-equal, scales within their sums'
  order), the MoE bank form of ``quant_dense`` too, and one 2-layer
  train step on the card (``tinyllama-smoke`` and ``olmoe-smoke``)
  agrees with the CPU's within the bound its docstring states; the MoE
  FFN's backward at a full-width OLMoE microbatch repeats bit for bit.
* Recurrent blocks: the hybrid attn / rwkv / rglru stack (one remainder
  layer) served on the card, the ``cuda`` engine giving the ``oracle``
  engine's tokens, a prefill chunk bit-equal to per-token decode; the
  chunked WKV on the card within the CPU's bound of the CPU's.
* The dense ``ServingEngine``: sliding-window and softcap attention, the
  ring's decode and the cache writes on the card against the CPU's;
  ``recurrentgemma-smoke`` exported and served on the card (batched ==
  single-stream, ``cuda`` engine == ``oracle`` engine, float32 engine ==
  ``forward`` greedy), sampling repeatable by seed and across horizons
  in both engines, and the serve launcher on both engines.
* The encoder-decoder stack and the vision stub: ``apsq_matmul`` at the
  encoder's M = 2048 (SeamlessM4T-v2-large's widths under
  ``enc_heavy``) bit-exact; exported ``seamless-smoke`` through
  ``encode`` and 8 ``decode_step(enc_out=)`` steps and
  ``internvl2-smoke`` through ``forward(embeds=)`` bit-equal on the
  ``cuda`` and ``oracle`` backends.
* The search's small APIs: ``backend_parity_check`` (oracle vs cuda)
  bit-equal for kernels 1, 2 and 4; ``apsq_matmul_f32`` bit-equal and
  ``int8_kv_attention_f32`` within rtol 2e-5 / atol 2e-6 of their CPU
  versions; ``roundtrip_report`` on ``tinyllama-smoke`` ``ok`` under
  W8A8 and ``mix2_ffn4``.
* The dry run: the meta-tensor counts of ``tinyllama-smoke``'s prefill,
  decode and train steps equal the counts of the same steps on the
  card; ``--backend-parity`` under ``apsq`` corrects the roofline from
  kernel 1's ``cuda_us``; the search's round trip on ``seamless-smoke``
  (``encode`` + ``decode_step(enc_out=)``) ``ok`` on the card.
* Tensor- and expert-parallel GEMMs (``dist.tp``): two spawned ranks on
  the one card over gloo give the unsharded kernel's output bit for bit
  at TinyLlama's FFN shapes (APSQ column-parallel, PSQ K-shards through
  the W8A8 expert kernel, W8A8 K-shards with an int32 all-reduce) and
  at OLMoE's expert banks (APSQ and W8A8, expert-parallel), on both
  wires; the three collectives on a one-rank NCCL group with int8 and
  int32 CUDA tensors (NCCL over several ranks needs several GPUs).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.apsq_matmul import ops, ref
from repro_torch.kernels.int8_kv_attention import ops as kv_ops
from repro_torch.kernels.int8_kv_attention import ref as kv_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


GEMM_CASES = [  # (m, k, n, n_p, gs, exps): "auto" | "cols" | explicit [n_p]
    (8, 64, 32, 4, 2, "auto"), (1, 64, 48, 4, 2, "auto"),
    (5, 128, 24, 8, 1, "auto"), (5, 128, 24, 8, 3, "auto"),
    (5, 128, 24, 8, 4, "auto"), (7, 96, 20, 1, 1, "auto"),
    (6, 45, 16, 4, 2, "auto"), (3, 37, 9, 3, 2, "auto"),
    (1, 45, 16, 4, 3, "cols"), (9, 64, 40, 4, 2, "cols"),
    (4, 128, 16, 8, 8, "cols"), (19, 1100, 300, 8, 4, "cols"),
    (4, 64, 16, 4, 2, [20, 20, 20, 20]), (4, 64, 16, 4, 1, [31, 32, 40, 0]),
    (4, 64, 16, 4, 2, [-1, 3, -2, 5]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,n_p,gs,exps", GEMM_CASES)
def test_apsq_and_baseline_kernels_bit_exact(cuda, m, k, n, n_p, gs, exps):
    rng = np.random.default_rng(2000 + m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    if isinstance(exps, list):
        e = torch.tensor(exps, dtype=torch.int32)
    else:
        e = ref.choose_exps(x, w, n_p=n_p, gs=gs)
        if exps == "cols":
            e = (e[:, None] + torch.arange(n)[None] % 3).to(torch.int32)
    before = dict(_build.launch_counts)
    got = ops.apsq_matmul_int8(x.to(cuda), w.to(cuda), e.to(cuda), gs=gs)
    got_b = ops.baseline_matmul_int8(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.apsq_matmul_ref(x, w, e, n_p=n_p,
                                                      gs=gs))
    assert torch.equal(got_b.cpu(), ref.baseline_matmul_ref(x, w))
    name = "apsq_matmul_m1" if m == 1 else "apsq_matmul"
    assert _build.launch_counts[name] == before[name] + 1
    assert (_build.launch_counts["baseline_matmul"]
            == before["baseline_matmul"] + 1)


def _apsq_bit_exact_once_and_again(x, w, e, gs):
    """The APSQ kernel on card operands: bit-exact against the plain
    version, bit-identical on a second launch, one count per call."""
    n_p = int(e.shape[0])
    name = "apsq_matmul_m1" if x.shape[0] == 1 else "apsq_matmul"
    before = _build.launch_counts[name]
    got = ops.apsq_matmul_int8(x, w, e, gs=gs)
    again = ops.apsq_matmul_int8(x, w, e, gs=gs)
    want = ref.apsq_matmul_ref(x, w, e, n_p=n_p, gs=gs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert _build.launch_counts[name] == before + 2


def _serving_exps(x, w, n_p, gs):
    """Per-column exponents around the calibrated ones, as chip_smoke's."""
    base = ref.choose_exps(x, w, n_p=n_p, gs=gs)
    n = w.shape[1]
    return (base[:, None] + torch.arange(n, device=w.device)[None] % 3
            ).to(torch.int32).contiguous()


def _mix2_ffn4(k, n):
    """(n_p, gs) of a TinyLlama projection under mix2_ffn4."""
    return (4, 2) if k == 2048 and n != 5632 else (8, 4)


APSQ_CASES = [  # (m, k, n, n_p, gs, exps): "cols" | "0..47" | [n_p] list
    # TinyLlama's projections at decode (M = slots) and prefill-chunk
    # (M = C) rows, and the 32-row block form
    *[(m, k, n, *_mix2_ffn4(k, n), "cols")
      for m in (1, 2, 4, 8, 16, 17, 32, 128)
      for k, n in ((2048, 256), (2048, 2048), (2048, 5632), (5632, 2048))],
    # ragged PSUM tiles
    (8, 96, 64, 8, 2, "cols"),        # bk = 12
    (1, 104, 72, 8, 3, "cols"),       # bk = 13
    (3, 37, 9, 1, 1, "cols"),         # bk = 37, one tile
    (17, 1100, 300, 8, 4, "cols"),    # bk = 138 after the ragged pad
    (8, 384, 130, 8, 4, "cols"),      # bk = 48: 16-byte loads, not 32
    (1, 2000, 2048, 8, 4, "cols"),    # bk = 250
    (16, 2000, 5632, 8, 4, "cols"),
    (8, 5600, 2048, 8, 8, "cols"),    # bk = 700, gs = n_p
    (8, 2048, 256, 32, 20, "cols"),   # gs past the expert kernels' 16 banks
    # shift counts past 31 (and negative) at a serving shape
    *[(m, 2048, 2048, 4, 2, e) for m in (1, 8)
      for e in ([31, 32, 40, 0], [-1, 3, -2, 5], [33, 1, 40, 2], "0..47")],
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,n_p,gs,exps", APSQ_CASES)
def test_apsq_kernels_bit_exact_and_repeatable(cuda, m, k, n, n_p, gs,
                                               exps):
    g = torch.Generator(device=cuda).manual_seed(m * 17 + k + n + n_p)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    if exps == "cols":
        e = _serving_exps(x, w, n_p, gs)
    elif exps == "0..47":     # per column, every count 0 .. 47
        e = (torch.arange(n_p * n, device=cuda).view(n_p, n) % 48
             ).to(torch.int32)
    else:
        e = torch.tensor(exps, dtype=torch.int32, device=cuda)
    _apsq_bit_exact_once_and_again(x, w, e, gs)


# the dense decoders of the later slice under mix2_ffn4: (K, N, n_p, gs)
# of StarCoder2-15B (d 6144, 4 KV heads of 128, GELU d_ff 24576) and
# ChatGLM3-6B (d 4096, 2 KV heads of 128, SwiGLU d_ff 13696)
DENSE_KN = [(6144, 6144, 4, 2), (6144, 512, 4, 2), (6144, 24576, 8, 4),
            (24576, 6144, 8, 4), (4096, 4096, 4, 2), (4096, 256, 4, 2),
            (4096, 13696, 8, 4), (13696, 4096, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n,n_p,gs", DENSE_KN)
def test_apsq_kernels_at_dense_decoder_shapes(cuda, k, n, n_p, gs, m):
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    _apsq_bit_exact_once_and_again(x, w, _serving_exps(x, w, n_p, gs), gs)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bm", [
    (1, 5632, 2048, 1), (1, 5632, 2048, 16), (1, 104, 72, 1),
    (1, 104, 72, 16), (1, 2048, 256, 16), (1, 2048, 256, 1)])
def test_apsq_m1_both_partial_bodies(cuda, monkeypatch, m, k, n, bm):
    """At M = 1 the one-row dp4a body and the tensor-core body, whatever
    the plan picks."""
    planned = ops.apsq_plan
    monkeypatch.setattr(ops, "apsq_plan",
                        lambda *a: planned(*a)._replace(bm=bm))
    g = torch.Generator(device=cuda).manual_seed(m + k + n + bm)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    _apsq_bit_exact_once_and_again(x, w, _serving_exps(x, w, 8, 4), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127), (-128, 127)])
@pytest.mark.parametrize("m,layout", [(1, "vec"), (8, "cols"), (16, "vec")])
def test_apsq_kernels_extreme_codes_at_k5632(cuda, xv, wv, m, layout):
    """Each tile's partial sums 704 products of magnitude up to 2^14
    (|partial| up to 1.15e7): codes at or near the clip bounds."""
    k, n, n_p, gs = 5632, 2048, 8, 4
    x = torch.full((m, k), xv, dtype=torch.int8, device=cuda)
    w = torch.full((k, n), wv, dtype=torch.int8, device=cuda)
    w[:, 1::2] = -w[:, 1::2].clamp(min=-127)
    e = ref.choose_exps(x, w, n_p=n_p, gs=gs)
    if layout == "cols":
        e = _serving_exps(x, w, n_p, gs)
    _apsq_bit_exact_once_and_again(x, w, e, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 5632, 2048), (8, 2048, 5632),
                                   (16, 2048, 2048), (3, 100, 40)])
def test_apsq_kernels_4_byte_aligned_operands(cuda, m, k, n):
    """Operands 4-byte but not 16-byte aligned take the byte loads."""
    n_p, gs = 8, 4
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    views = []
    for shape in ((m, k), (k, n)):
        buf = torch.randint(-128, 128, (shape[0] * shape[1] + 16,),
                            generator=g, device=cuda, dtype=torch.int8)
        off = (4 - buf.data_ptr()) % 16
        views.append(buf[off:off + shape[0] * shape[1]].view(shape))
    x, w = views
    assert x.data_ptr() % 16 == 4 and w.data_ptr() % 16 == 4
    _apsq_bit_exact_once_and_again(x, w, _serving_exps(x, w, n_p, gs), gs)


EXPERT_CASES = [  # (e, m, k, n, n_p, gs, layout)
    (1, 1, 64, 32, 4, 2, "vec"), (4, 2, 64, 40, 4, 2, "cols"),
    (4, 3, 45, 24, 4, 1, "cols"), (4, 3, 45, 24, 4, 4, "vec"),
    (8, 5, 128, 33, 8, 4, "cols"), (3, 16, 96, 20, 8, 3, "vec"),
    (64, 2, 256, 64, 8, 4, "cols"), (2, 9, 1100, 70, 8, 16, "cols"),
    (2, 3, 480, 24, 24, 17, "cols"), (3, 2, 640, 130, 20, 20, "vec"),
    (4, 17, 256, 40, 8, 4, "vec"), (2, 17, 1100, 200, 8, 3, "cols"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n,n_p,gs,layout", EXPERT_CASES)
def test_expert_kernels_bit_exact(cuda, e, m, k, n, n_p, gs, layout):
    rng = np.random.default_rng(3000 + e + m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (e, m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (e, k, n)).astype(np.int8))
    shape = (e, n_p) if layout == "vec" else (e, n_p, n)
    ex = torch.from_numpy(rng.integers(-2, 20, shape).astype(np.int32))
    before = dict(_build.launch_counts)
    got = ops.apsq_expert_matmul_int8(x.to(cuda), w.to(cuda), ex.to(cuda),
                                      gs=gs)
    got_b = ops.baseline_expert_matmul_int8(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.apsq_expert_matmul_ref(x, w, ex,
                                                             gs=gs))
    assert torch.equal(got_b.cpu(), ref.baseline_expert_matmul_ref(x, w))
    # the plain version on the card agrees with the CPU's
    assert torch.equal(ref.apsq_expert_matmul_ref(
        x.to(cuda), w.to(cuda), ex.to(cuda), gs=gs).cpu(), got.cpu())
    for name in ("apsq_expert_matmul", "baseline_expert_matmul"):
        assert _build.launch_counts[name] == before[name] + 1
    _expert_bit_exact_once_and_again(x.to(cuda), w.to(cuda), ex.to(cuda), gs)


def _expert_bit_exact_once_and_again(x, w, ex, gs):
    """Both expert kernels on card tensors: bit-exact against their plain
    versions on the card, bit-identical on a second call, one launch
    count per call."""
    before = dict(_build.launch_counts)
    got = ops.apsq_expert_matmul_int8(x, w, ex, gs=gs)
    again = ops.apsq_expert_matmul_int8(x, w, ex, gs=gs)
    got_b = ops.baseline_expert_matmul_int8(x, w)
    again_b = ops.baseline_expert_matmul_int8(x, w)
    want = ref.apsq_expert_matmul_ref(x, w, ex, gs=gs)
    want_b = ref.baseline_expert_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got_b, want_b) and torch.equal(got_b, again_b)
    for name in ("apsq_expert_matmul", "baseline_expert_matmul"):
        assert _build.launch_counts[name] == before[name] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n,n_p,gs,empty,one_live", [
    (8, 2, 256, 64, 8, 4, (1, 2, 5), (3,)), (4, 3, 45, 24, 4, 2, (0,), (2,)),
    (3, 17, 256, 40, 8, 4, (1,), (2,)), (2, 1, 128, 16, 4, 2, (0, 1), ()),
    (64, 2, 2048, 1024, 8, 4, tuple(range(0, 64, 3)), tuple(range(1, 64, 5))),
])
def test_expert_kernels_empty_and_one_live_experts(cuda, e, m, k, n, n_p, gs,
                                                   empty, one_live):
    """Experts whose rows are all zero (their blocks store zeros and read
    no weights) beside experts with one live row, both layouts."""
    g = torch.Generator(device=cuda).manual_seed(e * m + k + n)
    x = torch.randint(-128, 128, (e, m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    x[list(empty)] = 0
    for i in one_live:
        x[i, :-1] = 0
    for shape in ((e, n_p), (e, n_p, n)):
        ex = torch.randint(-2, 20, shape, generator=g, device=cuda,
                           dtype=torch.int32)
        ex[list(empty)] = 32        # the one exponent whose zero code is -1
        _expert_bit_exact_once_and_again(x, w, ex, gs)
        assert not ops.apsq_expert_matmul_int8(x, w, ex, gs=gs)[
            list(empty)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", [(64, 2, 2048, 1024), (4, 3, 100, 40),
                                     (2, 17, 256, 64)])
def test_expert_kernels_4_byte_aligned_operands(cuda, e, m, k, n):
    """Operands 4-byte but not 16-byte aligned take the byte loads."""
    n_p, gs = 8, 4
    g = torch.Generator(device=cuda).manual_seed(e * k + n)
    views = []
    for shape in ((e, m, k), (e, k, n)):
        size = shape[0] * shape[1] * shape[2]
        buf = torch.randint(-128, 128, (size + 16,), generator=g,
                            device=cuda, dtype=torch.int8)
        off = (4 - buf.data_ptr()) % 16
        views.append(buf[off:off + size].view(shape))
    x, w = views
    assert x.data_ptr() % 16 == 4 and w.data_ptr() % 16 == 4
    ex = torch.randint(0, 14, (e, n_p, n), generator=g, device=cuda,
                       dtype=torch.int32)
    _expert_bit_exact_once_and_again(x, w, ex, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths", [
    (2, 0, 32, 4, 2, 16, [17, 32]), (3, 0, 48, 8, 2, 8, [1, 20, 48]),
    (2, 4, 32, 4, 2, 16, [9, 32]), (1, 8, 64, 8, 4, 16, [30]),
    (8, 0, 96, 32, 4, 64, [5, 17, 33, 50, 64, 80, 95, 96]),
    (1, 16, 96, 32, 4, 64, [40]),
    (2, 8, 64, 8, 2, 16, [3, 40]),   # rows of batch 0 that see nothing
    (8, 0, 96, 16, 16, 128, [5, 17, 33, 50, 64, 80, 95, 96]),  # OLMoE
    (1, 16, 96, 16, 16, 128, [40]), (2, 16, 64, 16, 16, 128, [10, 64]),
])
def test_kv_attention_kernel_matches_plain(cuda, B, C, S, Hq, Hkv, hd,
                                           lengths):
    g = torch.Generator(device=cuda).manual_seed(B + C + S)
    qshape = (B, Hq, hd) if C == 0 else (B, C, Hq, hd)
    q = torch.randn(qshape, generator=g, device=cuda)
    kc, ke = kv_ref.quantize_kv_po2(
        torch.randn((B, S, Hkv, hd), generator=g, device=cuda) * 2)
    vc, ve = kv_ref.quantize_kv_po2(
        torch.randn((B, S, Hkv, hd), generator=g, device=cuda))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = kv_ops.int8_kv_attention(q, kc, vc, ke, ve, length)
    want = kv_ref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


SPLIT_CASES = [  # (B, C, S, Hq, Hkv, hd, lengths): S split, serving chunks
    (1, 0, 1024, 32, 4, 64, [1000]), (1, 0, 4096, 32, 4, 64, [4096]),
    (1, 0, 1024, 16, 16, 128, [17]), (1, 0, 4096, 16, 16, 128, [3000]),
    (1, 16, 1024, 32, 4, 64, [900]), (1, 16, 4096, 16, 16, 128, [4096]),
    (1, 16, 96, 32, 4, 64, [40]), (8, 16, 96, 32, 4, 64,
                                   [16, 20, 33, 50, 64, 80, 95, 96]),
    (1, 16, 96, 32, 4, 64, [5]),         # rows whose limit is <= 0
    (2, 16, 96, 16, 16, 128, [3, 96]),   # same, hd=128
    (8, 16, 96, 16, 16, 128, [16, 17, 30, 41, 64, 80, 95, 96]),
    (1, 8, 256, 8, 2, 8, [4]), (2, 4, 1024, 4, 2, 16, [30, 1024]),
    (1, 0, 4096, 4, 1, 8, [1]),          # splits no row sees
    # batches whose one-row-per-warp grid would pass 4 blocks per SM:
    # 2 rows per warp
    (32, 16, 96, 32, 4, 64, [16 + (3 * i) % 81 for i in range(32)]),
    (32, 16, 96, 16, 16, 128, [16 + (5 * i) % 81 for i in range(32)]),
    (16, 16, 96, 16, 16, 128, [16 + (7 * i) % 81 for i in range(16)]),
]


def _kv_case(cuda, B, C, S, Hq, Hkv, hd, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qshape = (B, Hq, hd) if C == 0 else (B, C, Hq, hd)
    q = torch.randn(qshape, generator=g, device=cuda)
    kc, ke = kv_ref.quantize_kv_po2(
        torch.randn((B, S, Hkv, hd), generator=g, device=cuda) * 2)
    vc, ve = kv_ref.quantize_kv_po2(
        torch.randn((B, S, Hkv, hd), generator=g, device=cuda))
    return q, kc, vc, ke, ve


# GQA groups of 12 (StarCoder2-15B: 48 query heads over 4 KV heads) and
# 16 (ChatGLM3-6B: 32 over 2) at hd=128: rows = C * G leave the last
# row block partial
GQA_CASES = [(B, C, S, Hq, Hkv, 128, lengths)
             for Hq, Hkv in ((48, 4), (32, 2))
             for B, C, S, lengths in (
                 (8, 0, 96, [5, 17, 33, 50, 64, 80, 95, 96]),
                 (1, 0, 1024, [1000]),
                 (2, 1, 96, [1, 70]), (2, 5, 96, [5, 96]),
                 (2, 16, 96, [3, 96]),
                 (8, 16, 96, [16, 17, 30, 41, 64, 80, 95, 96]))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths", GQA_CASES)
def test_kv_attention_gqa_groups_at_hd128(cuda, B, C, S, Hq, Hkv, hd,
                                          lengths):
    q, kc, vc, ke, ve = _kv_case(cuda, B, C, S, Hq, Hkv, hd, Hq + S + C)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = kv_ops.int8_kv_attention(q, kc, vc, ke, ve, length)
    again = kv_ops.int8_kv_attention(q, kc, vc, ke, ve, length)
    want = kv_ref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths", SPLIT_CASES)
def test_kv_attention_split_s_matches_plain(cuda, B, C, S, Hq, Hkv, hd,
                                            lengths):
    q, kc, vc, ke, ve = _kv_case(cuda, B, C, S, Hq, Hkv, hd, S + hd + C)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = _build.launch_counts["int8_kv_attention"]
    got = kv_ops.int8_kv_attention(q, kc, vc, ke, ve, length)
    again = kv_ops.int8_kv_attention(q, kc, vc, ke, ve, length)
    want = kv_ref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    assert torch.equal(got, again)                 # repeats bit for bit
    # a call that also merges splits still counts one launch
    assert _build.launch_counts["int8_kv_attention"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("C,S,Hq,Hkv,hd", [
    (0, 96, 32, 4, 64), (16, 1024, 32, 4, 64), (16, 96, 16, 16, 128),
    (0, 4096, 16, 16, 128), (4, 64, 4, 2, 16)])
def test_kv_attention_4_byte_aligned_cache_view(cuda, C, S, Hq, Hkv, hd):
    """Rows 4-byte but not 16-byte aligned take the 4-byte copies."""
    B = 2
    q, kc, vc, ke, ve = _kv_case(cuda, B, C, S, Hq, Hkv, hd, 7 + S + hd)
    views = []
    for t in (kc, vc):
        buf = torch.empty(t.numel() + 16, dtype=torch.int8, device=cuda)
        off = (4 - buf.data_ptr()) % 16
        view = buf[off:off + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        views.append(view)
    length = torch.tensor([S // 3, S], dtype=torch.int32, device=cuda)
    got = kv_ops.int8_kv_attention(q, views[0], views[1], ke, ve, length)
    want = kv_ref.int8_kv_attention_ref(q, kc, vc, ke, ve, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


W8A8_CASES = [(m, k, n) for m in (1, 8, 16, 17, 32, 33, 64)
              for k in (45, 2048, 5632) for n in (16, 2048, 5632)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8A8_CASES)
def test_w8a8_kernel_bit_exact_and_repeatable(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * 131 + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    before = _build.launch_counts["baseline_matmul"]
    got = ops.baseline_matmul_int8(x, w)
    again = ops.baseline_matmul_int8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.baseline_matmul_ref(x, w))
    assert torch.equal(got, again)
    assert _build.launch_counts["baseline_matmul"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 256), (3, 64, 256), (8, 64, 256), (16, 64, 256),
    (1, 6144, 49152), (8, 6144, 49152), (16, 6144, 49152)])
def test_w8a8_kernel_at_tied_head_shapes(cuda, m, k, n):
    """A tied head's W8A8 GEMM: the smoke export's (K=64, N=256) and
    StarCoder2-15B's width (K=6144, N=49152)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    got = ops.baseline_matmul_int8(x, w)
    again = ops.baseline_matmul_int8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.baseline_matmul_ref(x, w))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127), (-128, 127),
                                   (-127, -128)])
@pytest.mark.parametrize("m", [8, 33])
def test_w8a8_kernel_extreme_codes_at_k5632(cuda, xv, wv, m):
    """|sum| reaches 5632 * 16384 = 9.2e7: no wrap, no saturation."""
    k, n = 5632, 2048
    x = torch.full((m, k), xv, dtype=torch.int8, device=cuda)
    w = torch.full((k, n), wv, dtype=torch.int8, device=cuda)
    got = ops.baseline_matmul_int8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.baseline_matmul_ref(x, w))
    assert int(got[0, 0]) == k * xv * wv


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (17, 48, 40),
                                   (33, 2048, 5632)])
def test_w8a8_kernel_misaligned_operands(cuda, m, k, n):
    """Operands whose rows are not 16/8-byte aligned take byte loads."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    ops_in = []
    for shape in ((m, k), (k, n)):
        buf = torch.randint(-128, 128, (shape[0] * shape[1] + 8,),
                            generator=g, device=cuda, dtype=torch.int8)
        ops_in.append(buf[3:3 + shape[0] * shape[1]].view(shape))
    x, w = ops_in
    assert x.data_ptr() % 8 and w.data_ptr() % 8
    got = ops.baseline_matmul_int8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.baseline_matmul_ref(x, w))


@pytest.mark.cuda
def test_cuda_backend_refuses_cpu_tensors(cuda):
    from repro_torch.exec import get_backend
    x = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        get_backend("cuda").int_gemm(x, torch.zeros((8, 4), dtype=torch.int8),
                                     None, gs=1)


@pytest.mark.cuda
def test_deployed_moe_ffn_makes_no_host_sync(cuda):
    """The serving MoE path (router, top-k, dispatch, expert kernels,
    combine) runs without a host round trip."""
    from repro_torch.checkpoint import to_device
    from repro_torch.configs.olmoe_1b_7b import smoke_config
    from repro_torch.models import init_lm, moe_ffn
    from repro_torch.quant import (calibrate_model, export_quantized,
                                   policy_presets)
    cfg = smoke_config().with_quant(policy_presets()["mix2_ffn4"])
    params = init_lm(cfg, seed=0, device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    deploy, _ = export_quantized(calibrate_model(params, cfg,
                                                 {"tokens": tok}))
    ffn = to_device(deploy["units"]["u0"]["0"]["ffn"], cuda)
    x = torch.randn((3, 4, cfg.d_model), device=cuda)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k)
    want = moe_ffn(ffn, x, **kw, backend="oracle")
    before = _build.launch_counts["apsq_expert_matmul"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_ffn(ffn, x, **kw, backend="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.launch_counts["apsq_expert_matmul"] == before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_scatter_pages_on_card_equals_sequential_cpu(cuda):
    from repro_torch.serving.paged_cache import _scatter_pages
    rng = np.random.default_rng(10)
    pages = torch.from_numpy(rng.integers(-127, 128, (40, 16, 16, 128))
                             .astype(np.int8))
    table = np.zeros((8, 4), np.int32)          # idle slots: all null
    table[0, :2], table[3, :3], table[5, :1] = [1, 2], [3, 4, 5], [6]
    table = torch.from_numpy(table)
    gathered = torch.from_numpy(rng.integers(-127, 128, (8, 4, 16, 16, 128))
                                .astype(np.int8))
    want = _scatter_pages(pages, table, gathered)
    for _ in range(3):
        got = _scatter_pages(pages.to(cuda), table.to(cuda),
                             gathered.to(cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 16])
@pytest.mark.parametrize("k,n", [(4096, 1536), (1536, 4096)])
def test_expert_kernels_at_qwen3_moe_shapes(cuda, k, n, m):
    """Qwen3-MoE's expert banks (E=128; wi/wg [4096, 1536], wo [1536,
    4096]) under mix2_ffn4 (n_p=8, gs=4: PSUM tiles of 512 and 192 K
    rows), both exponent layouts."""
    e, n_p, gs = 128, 8, 4
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    x = torch.randint(-128, 128, (e, m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    for shape in ((e, n_p), (e, n_p, n)):
        ex = torch.randint(0, 16, shape, generator=g, device=cuda,
                           dtype=torch.int32)
        _expert_bit_exact_once_and_again(x, w, ex, gs)

# ---------------------------------------------------------------------------
# Quantization-aware training on the card (fake quant: plain PyTorch)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32(cuda):
    """Float32 products in full precision (fake quant needs exact tile
    sums); the flags are restored after the test."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _grads(fn, args, dev, ct):
    leaves = [torch.tensor(a, device=dev, requires_grad=True) for a in args]
    y = fn(*leaves)
    (y * torch.tensor(ct, device=dev)).sum().backward()
    return y.detach().cpu(), [t.grad.cpu() for t in leaves]


def _scale_close(got, want):
    """A scale's gradient is a sum over the tensor: the card adds it in
    another order than the CPU.  Within 1e-5 of the leaf's largest."""
    top = float(want.abs().max()) + 1e-12
    assert float((got - want).abs().max()) <= 1e-5 * top


@pytest.mark.cuda
@pytest.mark.parametrize("n_p,gs", [(8, 1), (8, 3), (8, 8), (6, 4)])
def test_apsq_matmul_grads_on_card_equal_cpu_on_po2_grid(no_tf32, n_p, gs):
    """Integer-valued x, w and cotangents at integer log2 scales: every
    product and sum of the forward and of the x/w gradients is exact in
    float32, so those are bit-equal on the card and the CPU."""
    from repro_torch.core import apsq_matmul
    rng = np.random.default_rng(n_p * 10 + gs)
    x = rng.integers(-8, 9, (3, 5, 96)).astype(np.float32)
    w = rng.integers(-8, 9, (96, 40)).astype(np.float32)
    la = rng.integers(2, 7, n_p).astype(np.float32)
    ct = rng.integers(-3, 4, (3, 5, 40)).astype(np.float32)

    def fn(x, w, la):
        return apsq_matmul(x, w, la, n_p=n_p, gs=gs)

    y_cpu, g_cpu = _grads(fn, (x, w, la), "cpu", ct)
    y_gpu, g_gpu = _grads(fn, (x, w, la), no_tf32, ct)
    assert torch.equal(y_gpu, y_cpu)
    assert torch.equal(g_gpu[0], g_cpu[0])
    assert torch.equal(g_gpu[1], g_cpu[1])
    _scale_close(g_gpu[2], g_cpu[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apsq", "psq", "none"])
def test_quant_dense_grads_on_card_equal_cpu_on_po2_grid(no_tf32, mode):
    """Per-channel power-of-two ``aw``, ``ax`` a power of two, integer
    ``ap``, integer cotangents: x and w gradients bit-equal, the scales'
    within their sums' order."""
    from repro_torch.core import QuantConfig, QuantState, quant_dense
    spec = {"apsq": QuantConfig.apsq(gs=3, n_p=8),
            "psq": QuantConfig.psq(n_p=8),
            "none": QuantConfig.w8a8()}[mode]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 7, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((64, 24)) * 0.2).astype(np.float32)
    aw = (2.0 ** rng.integers(-9, -6, 24)).astype(np.float32)
    ax = np.float32(2.0 ** -5)
    ap = rng.integers(-4, 0, 8).astype(np.float32)
    ct = rng.integers(-3, 4, (2, 7, 24)).astype(np.float32)
    args = (x, w, aw, ax) + ((ap,) if mode != "none" else ())

    def fn(x, w, aw, ax, ap=None):
        return quant_dense(x, w, QuantState(aw=aw, ax=ax, ap=ap, spec=spec,
                                            name="l"))

    y_cpu, g_cpu = _grads(fn, args, "cpu", ct)
    y_gpu, g_gpu = _grads(fn, args, no_tf32, ct)
    assert torch.equal(y_gpu, y_cpu)
    assert torch.equal(g_gpu[0], g_cpu[0])
    assert torch.equal(g_gpu[1], g_cpu[1])
    for got, want in zip(g_gpu[2:], g_cpu[2:]):
        _scale_close(got, want)


@pytest.mark.cuda
def test_two_layer_train_step_on_card_against_cpu(no_tf32):
    """``tinyllama-smoke`` (2 layers, float32) under APSQ gs=2 n_p=8,
    calibrated on the CPU and put on the PO2 grid (``snap_params_po2``,
    PSUM scales floored), one train step with two microbatches on the
    card and on the CPU from the same params and batch.  Norms, RoPE,
    softmax and SiLU round differently on the two devices, so an
    activation code can flip; held at: loss within 1e-5 (relative),
    gradient norm within 1e-4, the gradient tree (``m``) within 1% of
    its norm in L2."""
    import dataclasses
    import math
    from repro_torch.checkpoint import to_device
    from repro_torch.configs import get_smoke
    from repro_torch.core import QuantConfig, QuantState
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import init_lm, tree_leaves
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.quant import calibrate_model, snap_params_po2
    from repro_torch.train import TrainConfig, make_train_step

    def floor_ap(t):
        if isinstance(t, QuantState):
            return dataclasses.replace(t, ap=torch.floor(t.ap))
        if isinstance(t, dict):
            return {k: floor_ap(v) for k, v in t.items()}
        return t

    cfg = get_smoke("tinyllama-1.1b").with_quant(QuantConfig.apsq(gs=2,
                                                                  n_p=8))
    batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=4)).batch_at(0)
    params = calibrate_model(init_lm(cfg, seed=0, device="cpu"), cfg,
                             {"tokens": batch["tokens"]})
    params = floor_ap(snap_params_po2(params))
    ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, ocfg, TrainConfig(microbatches=2))
    out = {}
    for dev in ("cpu", no_tf32):
        p = to_device(params, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, st, stats = step(p, init_opt_state(p, ocfg), b)
        out[str(dev)] = (stats, {k: t.cpu() for k, t in
                                 tree_leaves(st["m"])})
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out[str(no_tf32)]
    loss, gn = float(s_gpu["loss"]), float(s_gpu["grad_norm"])
    assert abs(loss - float(s_cpu["loss"])) <= 1e-5 * abs(loss), loss
    assert abs(gn - float(s_cpu["grad_norm"])) <= 1e-4 * gn, gn
    diff = math.sqrt(sum(float(((m_gpu[k] - v) ** 2).sum())
                         for k, v in m_cpu.items()))
    norm = math.sqrt(sum(float((v ** 2).sum()) for v in m_cpu.values()))
    assert diff <= 1e-2 * norm, diff / norm


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["apsq", "psq", "none"])
def test_quant_dense_bank_grads_on_card_equal_cpu_on_po2_grid(no_tf32, mode):
    """The MoE bank form ``[E, C, K] @ [E, K, N]`` with one shared state
    (per-expert LSQ gradient scales): on the PO2 grid x and w gradients
    bit-equal, the scales' within their sums' order."""
    from repro_torch.core import QuantConfig, QuantState, quant_dense
    spec = {"apsq": QuantConfig.apsq(gs=3, n_p=8),
            "psq": QuantConfig.psq(n_p=8),
            "none": QuantConfig.w8a8()}[mode]
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((4, 7, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((4, 64, 24)) * 0.2).astype(np.float32)
    aw = (2.0 ** rng.integers(-9, -6, 24)).astype(np.float32)
    ax = np.float32(2.0 ** -5)
    ap = rng.integers(-4, 0, 8).astype(np.float32)
    ct = rng.integers(-3, 4, (4, 7, 24)).astype(np.float32)
    args = (x, w, aw, ax) + ((ap,) if mode != "none" else ())

    def fn(x, w, aw, ax, ap=None):
        return quant_dense(x, w, QuantState(aw=aw, ax=ax, ap=ap, spec=spec,
                                            name="e"))

    y_cpu, g_cpu = _grads(fn, args, "cpu", ct)
    y_gpu, g_gpu = _grads(fn, args, no_tf32, ct)
    assert torch.equal(y_gpu, y_cpu)
    assert torch.equal(g_gpu[0], g_cpu[0])
    assert torch.equal(g_gpu[1], g_cpu[1])
    for got, want in zip(g_gpu[2:], g_cpu[2:]):
        _scale_close(got, want)


@pytest.mark.cuda
def test_two_layer_moe_train_step_on_card_against_cpu(no_tf32):
    """``olmoe-smoke`` (2 layers, d_model 64, 8 experts top-2, float32)
    under APSQ gs=2 n_p=8 on the PO2 grid, one train step with two
    microbatches on the card and on the CPU, as the dense case above and
    held to its bounds: loss within 1e-5 (relative), gradient norm
    within 1e-4, the gradient tree (``m``) within 1% of its norm in L2.
    The card's step twice gives the same params bit for bit."""
    import dataclasses
    import math
    from repro_torch.checkpoint import to_device
    from repro_torch.configs import get_smoke
    from repro_torch.core import QuantConfig, QuantState
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import init_lm, tree_leaves
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.quant import calibrate_model, snap_params_po2
    from repro_torch.train import TrainConfig, make_train_step

    def floor_ap(t):
        if isinstance(t, QuantState):
            return dataclasses.replace(t, ap=torch.floor(t.ap))
        if isinstance(t, dict):
            return {k: floor_ap(v) for k, v in t.items()}
        return t

    cfg = get_smoke("olmoe-1b-7b").with_quant(QuantConfig.apsq(gs=2, n_p=8))
    batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=4)).batch_at(0)
    params = calibrate_model(init_lm(cfg, seed=0, device="cpu"), cfg,
                             {"tokens": batch["tokens"]})
    params = floor_ap(snap_params_po2(params))
    ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, ocfg, TrainConfig(microbatches=2))
    out = {}
    for dev in ("cpu", no_tf32, no_tf32):
        p = to_device(params, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        new, st, stats = step(p, init_opt_state(p, ocfg), b)
        out.setdefault(str(dev), []).append(
            (stats, {k: t.cpu() for k, t in tree_leaves(st["m"])},
             {k: t.cpu() for k, t in tree_leaves(new)}))
    (s_cpu, m_cpu, _), = out["cpu"]
    (s_gpu, m_gpu, p_gpu), (_, _, p_again) = out[str(no_tf32)]
    loss, gn = float(s_gpu["loss"]), float(s_gpu["grad_norm"])
    assert abs(loss - float(s_cpu["loss"])) <= 1e-5 * abs(loss), loss
    assert abs(gn - float(s_cpu["grad_norm"])) <= 1e-4 * gn, gn
    diff = math.sqrt(sum(float(((m_gpu[k] - v) ** 2).sum())
                         for k, v in m_cpu.items()))
    norm = math.sqrt(sum(float((v ** 2).sum()) for v in m_cpu.values()))
    assert diff <= 1e-2 * norm, diff / norm
    for k, v in p_gpu.items():
        assert torch.equal(v, p_again[k]), k


@pytest.mark.cuda
def test_moe_ffn_backward_repeats_on_card_at_olmoe_width(no_tf32):
    """``moe_ffn``'s backward at a ``moe_train`` microbatch (1024 tokens,
    d_model 2048, 64 experts top-8, bf16; expert d_ff cut to 128): each
    token's 8 gathered copies sum in the gather's backward, and two
    backward passes give the same gradients bit for bit."""
    from repro_torch.models import tree_leaves
    from repro_torch.models.moe import init_moe, moe_ffn

    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        return t.detach().requires_grad_(True)

    gen = torch.Generator(device=no_tf32).manual_seed(5)
    p = init_moe(gen, 2048, 128, 64, 8, torch.bfloat16, device=no_tf32)
    x = torch.randn((2, 512, 2048), generator=gen, device=no_tf32,
                    dtype=torch.float32).to(torch.bfloat16)
    ct = torch.randn_like(x)
    grads = []
    for _ in range(2):
        xs = x.detach().requires_grad_(True)
        ps = leaves(p)
        y = moe_ffn(ps, xs, n_experts=64, top_k=8)
        (y.float() * ct.float()).sum().backward()
        grads.append([xs.grad] + [t.grad for _, t in tree_leaves(ps)])
    assert len(grads[0]) == 5
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Recurrent blocks (RWKV-6, RG-LRU) on the paged serving path
# ---------------------------------------------------------------------------

HYBRID = dict(name="m", family="dense", n_layers=4, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
              block_pattern=("attn", "rwkv", "rglru"), d_rnn=32,
              wkv_impl="chunked", wkv_chunk=4)


def _hybrid_export(dev):
    """The hybrid attn / rwkv / rglru stack with one remainder layer,
    calibrated and exported (mix2_ffn4) on the CPU, moved to ``dev``."""
    from repro_torch.checkpoint import to_device
    from repro_torch.models import init_lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.quant import (calibrate_model, export_quantized,
                                   policy_presets)
    cfg = ModelConfig(**HYBRID).with_quant(policy_presets()["mix2_ffn4"])
    params = init_lm(cfg, seed=1, device="cpu")
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    deploy, _ = export_quantized(calibrate_model(params, cfg,
                                                 {"tokens": tok}))
    return to_device(deploy, dev), cfg


@pytest.mark.cuda
def test_hybrid_stack_cuda_engine_equals_oracle_engine(no_tf32):
    """The hybrid stack on the card: the ``cuda`` engine (APSQ GEMMs,
    their m=1 form and the attention kernel) gives the ``oracle``
    engine's greedy tokens, and launches each of those kernels."""
    from repro_torch.serving import PagedServingEngine, Request
    deploy, cfg = _hybrid_export(no_tf32)
    rng = np.random.default_rng(3)
    spec = [(i, rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 6), (9, 7), (1, 5), (13, 6)])]
    outs = {}
    for backend in ("cuda", "oracle"):
        _build.reset_launch_counts()
        eng = PagedServingEngine(deploy, cfg, backend=backend, max_batch=3,
                                 page_size=4, n_pages=40, prefill_chunk=8,
                                 decode_horizon=4)
        done = eng.run([Request(uid=u, tokens=t, max_new_tokens=m)
                        for u, t, m in spec])
        outs[backend] = {r.uid: r.out for r in done}
        if backend == "cuda":
            counts = dict(_build.launch_counts)
    assert outs["cuda"] == outs["oracle"]
    for k in ("apsq_matmul", "apsq_matmul_m1", "int8_kv_attention"):
        assert counts.get(k, 0) > 0, (k, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [(8, 4, 1), (13,)])
def test_hybrid_stack_chunked_prefill_equals_per_token_on_card(no_tf32,
                                                               chunks):
    """13 prompt tokens in chunks against one per call, on the card with
    the CUDA kernels: the recurrent states and the RG-LRU conv window
    bit-equal, the K/V pages and exponents too."""
    from repro_torch.models import (forward_paged_chunk,
                                    init_paged_decode_state, tree_leaves)
    deploy, cfg = _hybrid_export(no_tf32)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 13))).to(no_tf32)

    def run(chs):
        st = init_paged_decode_state(cfg, 1, page_size=4, n_pages=8,
                                     device=no_tf32)
        table = torch.arange(1, 5, dtype=torch.int32, device=no_tf32)[None]
        s0 = 0
        for c in chs:
            lg, st = forward_paged_chunk(
                deploy, cfg, st, tokens[:, s0:s0 + c],
                torch.tensor([s0], dtype=torch.int32, device=no_tf32), table)
            s0 += c
        return lg, st

    lg1, st1 = run([1] * 13)
    lg2, st2 = run(chunks)
    want = dict(tree_leaves(st1))
    for path, leaf in tree_leaves(st2):
        assert torch.equal(leaf, want[path]), path
    assert torch.equal(lg1, lg2)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 8])
def test_chunked_wkv_on_card_equals_cpu_within_bound(no_tf32, chunk):
    """The chunk-parallel WKV on the card against the CPU's on the same
    inputs (45 tokens from a random state, ``log_w`` over its clip range
    [-2, -1e-4], TF32 off), and against the card's scan: relative error
    (max |diff| / max |CPU|) within 5e-6, the CPU bound against JAX
    (``tests/test_torch_rwkv.py``)."""
    from repro_torch.models.rwkv import _wkv_chunked, _wkv_scan
    rng = np.random.default_rng(9)
    B, S, H, hd = 2, 45, 3, 64
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    log_w = np.clip(-np.exp(rng.uniform(-9, 1.5, (B, S, H, hd))), -2.0,
                    -1e-4).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (r, k, v, log_w, u, s0)]
    gpu = [a.to(no_tf32) for a in cpu]
    with torch.no_grad():
        y_c, s_c = _wkv_chunked(*cpu, chunk=chunk)
        y_g, s_g = _wkv_chunked(*gpu, chunk=chunk)
        y_s, s_s = _wkv_scan(*gpu)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    assert rel(y_g, y_c) <= 5e-6 and rel(s_g, s_c) <= 5e-6
    assert rel(y_g, y_s.cpu()) <= 5e-6 and rel(s_g, s_s.cpu()) <= 5e-6


# ---------------------------------------------------------------------------
# The dense ServingEngine: local / softcap attention, recurrentgemma
# ---------------------------------------------------------------------------

def _qkv(seed, B, Sq, Sk, Hq, Hkv, hd=16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                                   (B, Sk, Hkv, hd)))


def _close(got, want):
    """The CPU tests' bound against JAX: rtol 1e-5 / atol 1e-6."""
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 2.0])
@pytest.mark.parametrize("S", [7, 8, 29])
def test_local_attention_on_card_equals_cpu(no_tf32, S, softcap):
    """Window 8, MQA 4/1, queries in chunks of 5 and in one."""
    from repro_torch.models.attention import local_attention
    cpu = _qkv(S, 2, S, S, 4, 1)
    for chunk_q in (5, 512):
        kw = dict(window=8, softcap=softcap, chunk_q=chunk_q)
        _close(local_attention(*(a.to(no_tf32) for a in cpu), **kw),
               local_attention(*cpu, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_and_cache_writes_on_card_equal_cpu(no_tf32, ring):
    """Per-slot positions (the ring's wrapped past its 12 slots), window 6
    and softcap 2.0, and neither; ``update_kv_cache`` bit-equal."""
    from repro_torch.models.attention import (decode_attention,
                                              update_kv_cache)
    q, k, v = _qkv(4, 3, 1, 12, 4, 1)
    pos = torch.tensor([3, 17, 30] if ring else [0, 7, 11])
    for kw in (dict(window=6, softcap=2.0), dict(window=None, softcap=None)):
        _close(decode_attention(q.to(no_tf32), k.to(no_tf32), v.to(no_tf32),
                                pos.to(no_tf32), ring=ring, **kw),
               decode_attention(q, k, v, pos, ring=ring, **kw))
    kn, vn = (t[:, :1] for t in _qkv(5, 3, 1, 1, 1, 1)[1:])
    want = update_kv_cache(k, v, kn, vn, pos, ring=ring)
    got = update_kv_cache(k.to(no_tf32), v.to(no_tf32), kn.to(no_tf32),
                          vn.to(no_tf32), pos.to(no_tf32), ring=ring)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _recurrentgemma_export(dev):
    """``recurrentgemma-smoke`` calibrated and exported (mix2_ffn4) on
    the CPU, moved to ``dev``."""
    from repro_torch.checkpoint import to_device
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.quant import (calibrate_model, export_quantized,
                                   policy_presets)
    cfg = get_smoke("recurrentgemma-2b").with_quant(
        policy_presets()["mix2_ffn4"])
    params = init_lm(cfg, seed=1, device="cpu")
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24))
    deploy, _ = export_quantized(calibrate_model(params, cfg,
                                                 {"tokens": tok}))
    return to_device(deploy, dev), cfg


def _dense_run(eng, spec):
    from repro_torch.serving import Request
    return {r.uid: r.out for r in eng.run(
        [Request(uid=u, tokens=t, max_new_tokens=m) for u, t, m in spec])}


def _rg_spec(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 9), (21, 7), (12, 8)])]


@pytest.mark.cuda
def test_recurrentgemma_dense_engine_on_card(no_tf32):
    """Exported ``recurrentgemma-smoke`` (window 16; prompts up to 21
    tokens, so decode wraps the ring) on the card: 3 requests batched on
    3 slots give each request's tokens served alone (the fixed blocks
    make a slot's float values independent of the batch), the ``cuda``
    engine gives the ``oracle`` engine's tokens, and the kernels
    ``apsq_matmul`` (decode, M = 3) and ``apsq_matmul_m1`` (prefill,
    M = 1) launch."""
    from repro_torch.serving import ServingEngine
    deploy, cfg = _recurrentgemma_export(no_tf32)
    spec = _rg_spec(cfg.vocab)
    kw = dict(cache_len=40, decode_horizon=4)
    _build.reset_launch_counts()
    batched = _dense_run(ServingEngine(deploy, cfg, max_batch=3,
                                       backend="cuda", **kw), spec)
    counts = dict(_build.launch_counts)
    for k in ("apsq_matmul", "apsq_matmul_m1"):
        assert counts.get(k, 0) > 0, (k, counts)
    assert counts.get("int8_kv_attention", 0) == 0
    single = {u: _dense_run(ServingEngine(deploy, cfg, max_batch=1,
                                          backend="cuda", **kw),
                            [(u, t, m)])[u] for u, t, m in spec}
    assert batched == single
    assert _dense_run(ServingEngine(deploy, cfg, max_batch=3,
                                    backend="oracle", **kw), spec) == batched


@pytest.mark.cuda
def test_recurrentgemma_float_engine_matches_forward_on_card(no_tf32):
    """Float32 ``recurrentgemma-smoke`` on the card: the engine's greedy
    tokens equal ``forward``'s, token by token over the whole sequence."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import forward, init_lm
    from repro_torch.serving import ServingEngine
    cfg = get_smoke("recurrentgemma-2b")
    params = init_lm(cfg, seed=0, device=no_tf32)
    for u, prompt, n in _rg_spec(cfg.vocab, seed=4):
        out = _dense_run(ServingEngine(params, cfg, max_batch=2,
                                       cache_len=64), [(u, prompt, n)])[u]
        seq = [int(t) for t in prompt]
        for _ in range(n):
            lg = forward(params, cfg, torch.tensor([seq], device=no_tf32))
            seq.append(int(lg[0, -1].argmax()))
        assert out == seq[len(prompt):], u


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dense", "paged"])
def test_sampling_on_card_repeats_and_is_horizon_independent(no_tf32,
                                                             which):
    """T = 0.8 on the card (the generator lives there): one seed gives
    the same tokens twice and at horizons 1 and 4."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.serving import PagedServingEngine, ServingEngine
    arch = "recurrentgemma-2b" if which == "dense" else "tinyllama-1.1b"
    cfg = get_smoke(arch)
    params = init_lm(cfg, seed=0, device=no_tf32)
    rng = np.random.default_rng(5)
    spec = [(i, rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 9), (7, 7), (8, 5)])]

    def run(h):
        kw = dict(max_batch=3, decode_horizon=h, greedy=False,
                  temperature=0.8, seed=3)
        eng = (ServingEngine(params, cfg, cache_len=48, **kw)
               if which == "dense" else
               PagedServingEngine(params, cfg, page_size=4, n_pages=40,
                                  prefill_chunk=8, **kw))
        return _dense_run(eng, spec)

    a = run(1)
    assert run(1) == a and run(4) == a


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_serve_launcher_on_card(no_tf32, engine, capsys):
    """``python -m repro_torch.launch.serve --smoke --exported`` on the
    card (its default device)."""
    from repro_torch.launch.serve import main
    arch = "recurrentgemma-2b" if engine == "dense" else "tinyllama-1.1b"
    done = main(["--arch", arch, "--smoke", "--exported", "--engine",
                 engine, "--requests", "3", "--max-new-tokens", "4",
                 "--max-batch", "2", "--cache-len", "64"])
    assert len(done) == 3 and "[serve] 3 requests, 12 tokens" in (
        capsys.readouterr().out)


# ---------------------------------------------------------------------------
# The encoder-decoder stack and the vision stub on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k,n,n_p,gs", [(1024, 8192, 8, 1), (8192, 1024, 8, 1),
                                        (1024, 1024, 4, 4)])
def test_apsq_kernel_at_encoder_rows(cuda, k, n, n_p, gs):
    """``apsq_matmul`` at M = 2048 (the encoder's B x S_enc and the
    cross-attention's K/V rows at SeamlessM4T-v2-large's widths, under
    ``enc_heavy``: gs=1 n_p=8 in the encoder, gs=4 n_p=4 elsewhere),
    per-column exponents: bit-exact, bit-identical on repeat."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randint(-128, 128, (2048, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    _apsq_bit_exact_once_and_again(x, w, _serving_exps(x, w, n_p, gs), gs)


def _frontend_export(arch, preset, dev, **inputs):
    """A smoke model with a frontend, calibrated (tokens + ``inputs``) and
    exported on the CPU, moved to ``dev``; returns (deploy, cfg, tokens,
    inputs on ``dev``)."""
    from repro_torch.checkpoint import to_device
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_lm
    from repro_torch.quant import (calibrate_model, export_quantized,
                                   policy_presets)
    cfg = get_smoke(arch).with_quant(policy_presets()[preset])
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab, (2, 8))
    batch = {k: rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
             for k, s in inputs.items()}
    deploy, _ = export_quantized(calibrate_model(
        init_lm(cfg, seed=1, device="cpu"), cfg, {"tokens": tok, **batch}))
    return (to_device(deploy, dev), cfg, torch.from_numpy(tok).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})


@pytest.mark.cuda
def test_seamless_smoke_cuda_equals_oracle_on_card(no_tf32):
    """Exported ``seamless-smoke`` (``enc_heavy``) on the card: ``encode``
    and 8 ``decode_step(enc_out=)`` steps (4 prompt tokens, then greedy)
    give bit-equal outputs on the ``cuda`` and ``oracle`` backends, and
    the APSQ kernels launch."""
    from repro_torch.models import decode_step, encode, init_decode_state
    deploy, cfg, tok, inp = _frontend_export(
        "seamless-m4t-large-v2", "enc_heavy", no_tf32, enc_embeds=12)
    outs = {}
    for backend in ("cuda", "oracle"):
        _build.reset_launch_counts()
        with torch.no_grad():
            enc = encode(deploy, cfg, inp["enc_embeds"], backend=backend)
            st = init_decode_state(cfg, 2, 8, device=no_tf32)
            cur, lgs = tok[:, :1], []
            for t in range(8):
                lg, st = decode_step(deploy, cfg, st, cur, t, enc_out=enc,
                                     backend=backend)
                lgs.append(lg)
                cur = (tok[:, t + 1:t + 2] if t < 3
                       else lg.argmax(-1).to(tok.dtype))
        outs[backend] = (enc, torch.cat(lgs, 1))
        if backend == "cuda":
            assert _build.launch_counts.get("apsq_matmul", 0) > 0
    assert torch.equal(outs["cuda"][0], outs["oracle"][0])
    assert torch.equal(outs["cuda"][1], outs["oracle"][1])


@pytest.mark.cuda
def test_internvl2_smoke_forward_with_embeds_cuda_equals_oracle(no_tf32):
    """Exported ``internvl2-smoke`` (``mix2_ffn4``) on the card:
    ``forward(embeds=)`` logits [2, 4 + 8, V] bit-equal on the ``cuda``
    and ``oracle`` backends."""
    from repro_torch.models import forward
    deploy, cfg, tok, inp = _frontend_export(
        "internvl2-26b", "mix2_ffn4", no_tf32, embeds=4)
    with torch.no_grad():
        got = forward(deploy, cfg, tok, embeds=inp["embeds"], backend="cuda")
        want = forward(deploy, cfg, tok, embeds=inp["embeds"],
                       backend="oracle")
    assert got.shape == (2, 12, cfg.vocab)
    assert torch.equal(got, want)


def _deployed_linear_on(dev, spec, k, n, seed=0):
    from repro_torch.core import calibrate_dense, quant_params_init
    from repro_torch.quant import export_quantized
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((8, k), generator=gen)
    w = torch.randn((k, n), generator=gen) * 0.05
    qp = calibrate_dense(quant_params_init(w, spec, name="lin"), x, w)
    dep, _ = export_quantized({"lin": {"w": w.to(dev),
                                       "qp": _qp_to(qp, dev)}})
    return dep["lin"]["qp"]


def _qp_to(qp, dev):
    import dataclasses
    return dataclasses.replace(qp, **{
        f: getattr(qp, f).to(dev) for f in ("aw", "ax", "ap")
        if getattr(qp, f) is not None})


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m", [("apsq", 4), ("apsq", 1), ("w8a8", 4),
                                    ("w8a8", 1)])
def test_backend_parity_check_bit_equal_on_card(cuda, kind, m):
    """``backend_parity_check(oracle, cuda)``: kernel 1 (APSQ, M > 1),
    kernel 4 (APSQ, M = 1) and kernel 2 (W8A8) bit-equal to the torch
    oracle on one deployed linear, each launched once per call."""
    from repro_torch.core import QuantConfig
    from repro_torch.exec import backend_parity_check
    spec = (QuantConfig.apsq(gs=2, n_p=8) if kind == "apsq"
            else QuantConfig.w8a8())
    dq = _deployed_linear_on(cuda, spec, 256, 96)
    x = torch.randn((m, 256), generator=torch.Generator().manual_seed(m)
                    ).to(cuda)
    _build.reset_launch_counts()
    outs, times, bit_equal = backend_parity_check(dq, x, reps=2, warmup=1)
    name = ("baseline_matmul" if kind == "w8a8"
            else "apsq_matmul_m1" if m == 1 else "apsq_matmul")
    assert bit_equal is True and list(times) == ["oracle", "cuda"]
    assert {k: v for k, v in _build.launch_counts.items() if v} == {name: 3}
    assert outs["cuda"].shape == (m, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("per_col", [False, True])
def test_float_helpers_on_card(cuda, per_col):
    """``apsq_matmul_f32`` on the card == its plain version on the CPU,
    bit for bit (the codes and the integer GEMM are exact; the rescale
    is one float product each), through kernel 1; and
    ``int8_kv_attention_f32`` within rtol 2e-5 / atol 2e-6 of the CPU's
    (kernel 3)."""
    from repro_torch.kernels.apsq_matmul import (apsq_matmul_f32,
                                                 calibrate_exps,
                                                 quantize_operands)
    from repro_torch.kernels.int8_kv_attention import int8_kv_attention_f32
    gen = torch.Generator().manual_seed(int(per_col))
    x = torch.randn((8, 512), generator=gen)
    w = torch.randn((512, 200), generator=gen) * 0.1
    ax = torch.tensor(0.03)
    aw = (torch.rand(200, generator=gen) * 0.002 + 0.002 if per_col
          else torch.tensor(0.003))
    xq, wq = quantize_operands(x, w, ax=ax, aw=aw)
    exps = calibrate_exps(xq, wq, n_p=8, gs=4)
    want = apsq_matmul_f32(x, w, exps, gs=4, ax=ax, aw=aw)
    _build.reset_launch_counts()
    got = apsq_matmul_f32(x.to(cuda), w.to(cuda), exps.to(cuda), gs=4,
                          ax=ax.to(cuda), aw=aw.to(cuda))
    assert _build.launch_counts.get("apsq_matmul") == 1
    assert torch.equal(got.cpu(), want)
    q = torch.randn((2, 8, 64), generator=gen)
    k = torch.randn((2, 96, 4, 64), generator=gen)
    v = torch.randn((2, 96, 4, 64), generator=gen) * 0.5
    length = torch.tensor([50, 96], dtype=torch.int32)
    want = int8_kv_attention_f32(q, k, v, length)
    got = int8_kv_attention_f32(q.to(cuda), k.to(cuda), v.to(cuda),
                                length.to(cuda))
    assert _build.launch_counts.get("int8_kv_attention") == 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["w8a8", "mix2_ffn4"])
def test_roundtrip_report_on_card(no_tf32, preset):
    """The search's servability proof on ``tinyllama-smoke``: calibrate ->
    export -> GEMM parity (oracle vs cuda, bit-equal) and greedy decode
    on the dense engine pinned to each backend (equal tokens), ``ok``;
    the kernels named by the policy launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import QuantConfig
    from repro_torch.quant import QuantPolicy, policy_presets
    from repro_torch.search import make_eval_batch, roundtrip_report
    cfg = get_smoke("tinyllama-1.1b")
    policy = (QuantPolicy.uniform(QuantConfig.w8a8()) if preset == "w8a8"
              else policy_presets()[preset])
    batch = make_eval_batch(cfg, 2, 32, device=no_tf32)
    _build.reset_launch_counts()
    rt = roundtrip_report(cfg, policy, batch, device=no_tf32)
    assert rt["backends"] == ["oracle", "cuda"]
    assert rt["gemm_parity"]["bit_equal"] is True
    assert rt["gemm_parity"]["psum"] == (preset != "w8a8")
    assert rt["decode"]["oracle"] == rt["decode"]["cuda"]
    assert len(rt["decode"]["cuda"]) == 6
    assert rt["serving_parity"] is True and rt["ok"] is True
    want = (("baseline_matmul",) if preset == "w8a8"
            else ("apsq_matmul", "apsq_matmul_m1"))
    for name in want:
        assert _build.launch_counts.get(name, 0) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_meta_counts_equal_a_real_step_on_card(no_tf32, kind):
    """The dry run's count on meta tensors equals the count of the same
    step run on the card (``tinyllama-smoke``): FLOPs and bytes exactly,
    and the peak of live storage."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    cfg = get_smoke("tinyllama-1.1b")
    cell = ShapeCell(kind, 64, 4, kind)
    kw = {"microbatches": 2} if kind == "train" else {}
    meta = dryrun.count_step(dryrun.build_cell(cfg, cell, device="meta",
                                               **kw))
    real = dryrun.count_step(dryrun.build_cell(cfg, cell, device=no_tf32,
                                               **kw))
    torch.cuda.synchronize()
    for k in ("flops", "bytes", "peak_bytes", "argument_size_in_bytes"):
        assert meta[k] == real[k], k
    assert meta["flops"] > 0


@pytest.mark.cuda
def test_dryrun_backend_roofline_reads_cuda_us(no_tf32):
    """``--backend-parity`` under ``apsq`` on the card: kernel 1 and the
    oracle bit-equal at the probe shape, and the corrected terms come
    from the kernel's measured time (``cuda_us``)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import gemm_analytic_us
    _build.reset_launch_counts()
    r = dryrun.run_cell("tinyllama-1.1b", "decode_32k", quant="apsq",
                        smoke=True, backend_parity=True, device=no_tf32,
                        verbose=False)
    assert r["ok"], r.get("error")
    bp, br = r["backend_parity"], r["backend_roofline"]
    assert bp["backends"] == ["oracle", "cuda"] and bp["bit_equal"] is True
    assert br["probe_backend"] == "cuda"
    assert br["probe_measured_us"] == round(bp["cuda_us"], 1)
    assert br["correction"] == bp["cuda_us"] / gemm_analytic_us(
        *bp["shape"])
    assert _build.launch_counts.get("apsq_matmul", 0) > 0


@pytest.mark.cuda
def test_encdec_roundtrip_report_on_card(no_tf32):
    """The search's round trip on ``seamless-smoke`` (an encoder-decoder:
    ``encode`` + ``decode_step(enc_out=)`` on each backend): GEMM parity
    bit-equal, the ``oracle`` and ``cuda`` tokens equal, ``ok``."""
    from repro_torch.configs import get_smoke
    from repro_torch.quant import policy_presets
    from repro_torch.search import make_eval_batch, roundtrip_report
    cfg = get_smoke("seamless-m4t-large-v2")
    batch = make_eval_batch(cfg, 2, 32, device=no_tf32)
    _build.reset_launch_counts()
    rt = roundtrip_report(cfg, policy_presets()["enc_heavy"], batch,
                          device=no_tf32)
    assert rt["backends"] == ["oracle", "cuda"]
    assert rt["gemm_parity"]["bit_equal"] is True
    assert len(rt["decode"]["cuda"]) == 6
    assert rt["decode"]["oracle"] == rt["decode"]["cuda"]
    assert rt["serving_parity"] is True and rt["ok"] is True
    assert _build.launch_counts.get("apsq_matmul_m1", 0) > 0


# ---------------------------------------------------------------------------
# Tensor- and expert-parallel GEMMs (repro_torch.dist.tp) on the card
# ---------------------------------------------------------------------------

def _tp_cases(dev):
    """TinyLlama's FFN ``wi`` (M=8, K=2048, N=5632) under APSQ (gs=2,
    n_p=8, per-column exponents), PSQ (gs = n_p = 8) and W8A8, and OLMoE's
    expert bank (E=64, M=2, K=2048, N=1024) under APSQ and W8A8."""
    gen = torch.Generator(device="cpu").manual_seed(27)
    x = torch.randint(-128, 128, (8, 2048), generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (2048, 5632), generator=gen,
                      dtype=torch.int8)
    xe = torch.randint(-128, 128, (64, 2, 2048), generator=gen,
                       dtype=torch.int8)
    we = torch.randint(-128, 128, (64, 2048, 1024), generator=gen,
                       dtype=torch.int8)
    cases = {}
    for name, n_p, gs in (("apsq", 8, 2), ("psq", 8, 8)):
        e = ref.choose_exps(x, w, n_p=n_p, gs=gs)
        cases[name] = (False, x, w, e[:, None].expand(n_p, 5632).contiguous(),
                       gs)
    cases["w8a8"] = (False, x, w, None, 1)
    ee = torch.stack([ref.choose_exps(xe[i], we[i], n_p=8, gs=2)
                      for i in range(64)])
    cases["expert_apsq"] = (True, xe, we, ee, 2)
    cases["expert_w8a8"] = (True, xe, we, None, 1)
    return {k: (ex, *(None if t is None else t.to(dev) for t in ts), gs)
            for k, (ex, *ts, gs) in cases.items()}


def _tp_rank(rank, world, init, out_dir):
    """One of two ranks on the card: every case through
    ``ShardedBackend`` on a (1, 2) mesh, on both wires."""
    import os

    import torch.distributed as dist
    from repro_torch.exec import ShardedBackend
    from repro_torch.launch.mesh import make_smoke_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_smoke_mesh((1, world))
    out = {"transport": (mesh.backend, mesh.shared_device)}
    for name, (expert, x, w, e, gs) in _tp_cases(mesh.device).items():
        for wire in ("int8", "fp32"):
            be = ShardedBackend(mesh=mesh, inner="cuda", wire=wire)
            y = (be.int_expert_gemm if expert else be.int_gemm)(x, w, e,
                                                               gs=gs)
            out[(name, wire)] = y.cpu()
    out["launches"] = dict(_build.launch_counts)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_gemms_two_ranks_on_one_card_bit_exact(cuda, tmp_path):
    import torch.multiprocessing as mp
    from repro_torch.exec import get_backend
    mp.start_processes(_tp_rank, args=(2, f"file://{tmp_path}/rdv",
                                       str(tmp_path)),
                       nprocs=2, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = get_backend("cuda")
    for r in ranks:
        assert r["transport"] == ("gloo", True)     # two ranks, one card
        for k in ("apsq_matmul", "baseline_matmul", "apsq_expert_matmul",
                  "baseline_expert_matmul"):
            assert r["launches"][k] > 0, k
    for name, (expert, x, w, e, gs) in _tp_cases(cuda).items():
        want = (one.int_expert_gemm if expert else one.int_gemm)(
            x, w, e, gs=gs).cpu()
        for wire in ("int8", "fp32"):
            for r in ranks:
                assert torch.equal(r[(name, wire)], want), (name, wire)


@pytest.mark.cuda
def test_nccl_collectives_one_rank(cuda):
    """The tp collectives on a one-rank NCCL group, int8 and int32 CUDA
    tensors: the call forms and dtypes NCCL takes (over several ranks
    NCCL needs a GPU each, which the card machine does not have)."""
    import torch.distributed as dist
    from repro_torch.dist import tp
    from repro_torch.launch.mesh import Mesh, make_smoke_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    mesh = make_smoke_mesh((1, 1))
    try:
        assert (mesh.backend, mesh.shared_device) == ("nccl", False)
        group = dist.new_group([0], backend="nccl")
        one = Mesh(shape={"model": 1}, rank=0, coords={"model": 0},
                   groups={"model": group}, backend="nccl", device=cuda)
        for dtype in (torch.int8, torch.int32):
            t = torch.arange(-6, 6, device=cuda).to(dtype).reshape(3, 4)
            assert torch.equal(tp._all_gather(one, "model", t, 1), t)
            assert torch.equal(tp._reduce_scatter(one, "model", t, 1), t)
            assert torch.equal(tp._all_reduce(one, "model", t.clone()), t)
    finally:
        dist.destroy_process_group()
