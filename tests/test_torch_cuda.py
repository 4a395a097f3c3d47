"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode): each carries the ``cuda`` marker and skips without a card.  The
file imports only torch, numpy and ``repro_torch``, so it runs on a
machine without JAX:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

* APSQ GEMMs (generic and m=1) and the W8A8 baseline: bit-exact.
* The fused MoE expert GEMMs (APSQ and W8A8, all experts in one
  launch): bit-exact over E, M (rows past M masked), ragged K, gs and
  both exponent layouts.
* INT8-KV attention, decode and chunk forms (hd 8, 16, 64 and 128):
  rtol 2e-5 / atol 2e-6.
* A CUDA tensor never takes the plain path: the launch counters move.
* A deployed ``moe_ffn`` on the card makes no host round trip.
* The paged-cache scatter leaves the same pool on the card as the
  CPU's sequential scatter, though table rows repeat the null page.
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


EXPERT_CASES = [  # (e, m, k, n, n_p, gs, layout)
    (1, 1, 64, 32, 4, 2, "vec"), (4, 2, 64, 40, 4, 2, "cols"),
    (4, 3, 45, 24, 4, 1, "cols"), (4, 3, 45, 24, 4, 4, "vec"),
    (8, 5, 128, 33, 8, 4, "cols"), (3, 16, 96, 20, 8, 3, "vec"),
    (64, 2, 256, 64, 8, 4, "cols"), (2, 9, 1100, 70, 8, 16, "cols"),
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
