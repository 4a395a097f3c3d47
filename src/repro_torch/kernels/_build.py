"""Build and load the CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Each ``csrc/*.cu`` file under ``repro_torch/kernels`` compiles on its own
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, all sources started
together, into ``repro_torch/kernels/_build/`` (git-ignored); a library
is named after the hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc``.

``launch_counts`` is the one launch counter per kernel.  A wrapper adds
one where it launches its kernel, and nowhere else; ``chip_smoke.py``
zeroes the counts before driving the main path and reads them after.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NUM_SMS = 132      # streaming multiprocessors of an H100 SXM: the kernels'
                   # plans size their grids by it

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source relative to this package, C entry point, argtypes)
KERNELS = {
    "apsq_matmul": ("apsq_matmul/csrc/apsq_matmul.cu", "apsq_matmul_launch",
                    [_P] * 5 + [_I] * 9 + [_P]),
    "apsq_matmul_m1": ("apsq_matmul/csrc/apsq_matmul.cu",
                       "apsq_matmul_m1_launch", [_P] * 5 + [_I] * 8 + [_P]),
    "baseline_matmul": ("apsq_matmul/csrc/apsq_matmul.cu",
                        "baseline_matmul_launch", [_P] * 3 + [_I] * 6 + [_P]),
    "apsq_expert_matmul": ("apsq_matmul/csrc/apsq_matmul.cu",
                           "apsq_expert_matmul_launch",
                           [_P] * 4 + [_I] * 10 + [_P]),
    "baseline_expert_matmul": ("apsq_matmul/csrc/apsq_matmul.cu",
                               "baseline_expert_matmul_launch",
                               [_P] * 3 + [_I] * 7 + [_P]),
    "int8_kv_attention": ("int8_kv_attention/csrc/int8_kv_attention.cu",
                          "int8_kv_attention_launch",
                          [_P] * 8 + [_I] * 6 + [_F] + [_I] * 4 + [_P]),
}

launch_counts: dict = {name: 0 for name in KERNELS}
build_log: dict = {}          # source -> ptxas report of the last build
_libs: dict = {}              # source -> ctypes.CDLL


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every kernel source (in parallel) and load it.

    Returns {source: seconds-or-"cached"}.  Raises with the compiler's
    output if any build fails.
    """
    srcs = sorted({_PKG / s for s, _, _ in KERNELS.values()})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for src in srcs:
        out = _target(src)
        if str(src) in _libs:
            continue
        if out.exists():
            report[src.name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[src.name] = round(time.perf_counter() - t0, 3)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for src in srcs:
        if str(src) not in _libs:
            _libs[str(src)] = ctypes.CDLL(str(_target(src)))
    return report


def entry(name: str):
    """The ctypes function of kernel ``name`` (builds on first use), with
    its argument and result types declared.  Pointers and the stream are
    passed as Python ints; every entry point returns
    ``cudaGetLastError()`` after its launch."""
    src, fn_name, argtypes = KERNELS[name]
    key = str(_PKG / src)
    if key not in _libs:
        build_all()
    fn = getattr(_libs[key], fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def require_data(name: str, *tensors) -> None:
    """Raise unless every tensor is a CUDA tensor with device memory: a
    meta or fake tensor (shapes without data, as the dry run makes) never
    reaches a launch."""
    import torch
    from torch._subclasses.fake_tensor import is_fake
    for t in tensors:
        fake = type(t) is not torch.Tensor and is_fake(t)
        if fake or t.device.type != "cuda":
            kind = "fake" if fake else t.device.type
            raise TypeError(f"kernel {name} launches on CUDA tensors with "
                            f"data; got a {kind} tensor")


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launch_counts[name] += 1


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
