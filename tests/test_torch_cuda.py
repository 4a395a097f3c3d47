"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode): each carries the ``cuda`` marker and skips without a card.  The
file imports only torch, numpy and ``repro_torch``, so it runs on a
machine without JAX:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

* APSQ GEMMs (generic and m=1) and the W8A8 baseline: bit-exact.
* INT8-KV attention, decode and chunk forms: rtol 2e-5 / atol 2e-6.
* A CUDA tensor never takes the plain path: the launch counters move.
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,S,Hq,Hkv,hd,lengths", [
    (2, 0, 32, 4, 2, 16, [17, 32]), (3, 0, 48, 8, 2, 8, [1, 20, 48]),
    (2, 4, 32, 4, 2, 16, [9, 32]), (1, 8, 64, 8, 4, 16, [30]),
    (8, 0, 96, 32, 4, 64, [5, 17, 33, 50, 64, 80, 95, 96]),
    (1, 16, 96, 32, 4, 64, [40]),
    (2, 8, 64, 8, 2, 16, [3, 40]),   # rows of batch 0 that see nothing
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
