"""The port's one-device dry run (``repro_torch.launch.dryrun``) held to
the JAX package's on the CPU.

* ``active_params`` equals ``repro.launch.dryrun.active_params`` for the
  ten full configs; ``input_specs`` has the reference's shapes and
  dtypes at every arch x cell (the decode state compared by total bytes
  per leaf kind: the port holds units unstacked).
* Every arch at every applicable cell of its smoke config runs
  ``run_cell`` (cut to small shapes; ``tinyllama-smoke`` also at the
  cells' own shapes) with ``ok`` true.
* Counting: meta tensors give the counts real CPU tensors give (FLOPs,
  bytes and peak); a serving cell extrapolated from 2 and 3 units equals
  the direct count at 6 units.
* The CLI writes its report; a cell that raises leaves no mode pushed
  and real tensors real; kernel wrappers refuse meta and fake tensors;
  the meshes and ``--compress`` raise (dist is not ported).
* The search's CLI on ``seamless-m4t-large-v2`` at ``--budget-smoke
  --iterations 1 --device cpu`` reaches its gate (exit 1 by design on
  the CPU: no kernel ran) through the encoder-decoder round trip.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro.configs import cells_for as j_cells_for
from repro.configs import get_config as j_get_config
from repro.launch import dryrun as jdry
from repro_torch.configs import ARCH_NAMES, cells_for, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SINGLE, make_production_mesh, \
    make_smoke_mesh
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import tree_leaves

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its tests run many small ops,
    which OpenMP's thread teams slow down many times over when the
    suite's workers share the cores (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


def _small(cell: ShapeCell) -> ShapeCell:
    return ShapeCell(cell.name, min(cell.seq_len, 128),
                     min(cell.global_batch, 4), cell.kind)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_params_equal_jax(arch):
    assert dryrun.active_params(get_config(arch)) == \
        jdry.active_params(j_get_config(arch))


def _kind_bytes(leaves) -> dict:
    out = {}
    for path, shape, dtype in leaves:
        out[path[-1]] = out.get(path[-1], 0) + math.prod(shape) * dtype
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert list(cells_for(arch)) == list(j_cells_for(arch))
    for name, cell in cells_for(arch).items():
        want = jdry.input_specs(jcfg, j_cells_for(arch)[name])
        got = dryrun.input_specs(cfg, cell)
        assert set(got) == set(want), name
        for k, v in want.items():
            if k == "state":
                continue
            assert tuple(got[k].shape) == tuple(v.shape), (name, k)
            assert got[k].dtype == _DT[str(v.dtype)], (name, k)
        if "state" in want:
            j_leaves = [(tuple(str(getattr(p, "key", p)) for p in path),
                         leaf.shape, leaf.dtype.itemsize) for path, leaf
                        in jax.tree_util.tree_flatten_with_path(
                            want["state"])[0]]
            t_leaves = [(path, t.shape, t.element_size())
                        for path, t in tree_leaves(got["state"])]
            assert _kind_bytes(t_leaves) == _kind_bytes(j_leaves), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_smoke_cell_runs(arch):
    for name, cell in cells_for(arch).items():
        r = dryrun.run_cell(arch, name, smoke=True, shape=_small(cell),
                            verbose=False)
        assert r["ok"], (name, r.get("error"), r.get("traceback"))
        assert r["flops"] > 0 and r["bytes"] > 0 and r["peak_bytes"] > 0
        assert r["fits"] is True and r["mesh"] == "1xH100"
        assert r["peak_bytes"] >= r["argument_size_in_bytes"]
        assert r["bound_s"] == max(r["compute_s"], r["memory_s"])
        assert 0 < r["useful_flops_fraction"]


def test_tinyllama_smoke_at_the_cells_shapes():
    cfg = get_smoke("tinyllama-1.1b")
    r = dryrun.run_cell("tinyllama-1.1b", "train_4k", smoke=True,
                        verbose=False)
    assert r["ok"] and r["microbatches"] == 4 == \
        dryrun.default_microbatches(cfg, cells_for("tinyllama-1.1b")[
            "train_4k"])
    parts = r["parts"]
    assert parts["microbatch"]["times"] == 4
    assert r["flops"] == sum(p["flops"] * p["times"] for p in parts.values())
    assert r["flops_per_microbatch"] == parts["microbatch"]["flops"]
    r = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", smoke=True,
                        verbose=False)
    # the float attention holds [B, H, S, S] float32 scores: 512 GiB
    assert r["ok"] and r["fits"] is False
    assert r["peak_bytes"] > 32 * 4 * 32768 ** 2 * 4
    r = dryrun.run_cell("tinyllama-1.1b", "decode_32k", smoke=True,
                        verbose=False)
    assert r["ok"] and r["fits"] is True and r["depth"] == "counted"


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_counts_equal_real_cpu_counts(kind):
    cfg = get_smoke("tinyllama-1.1b")
    cell = ShapeCell(kind, 16, 4, kind)
    kw = {"microbatches": 2} if kind == "train" else {}
    got = dryrun.count_step(dryrun.build_cell(cfg, cell, device="meta",
                                              **kw))
    want = dryrun.count_step(dryrun.build_cell(cfg, cell, device="cpu",
                                               **kw))
    for k in ("flops", "bytes", "peak_bytes", "argument_size_in_bytes",
              "output_size_in_bytes", "parts"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_parts_add_up_to_the_train_step(microbatches):
    """The train cell's parts, each counted ``times`` times, count what
    the trainer's whole ``make_train_step`` counts on the same inputs."""
    from repro_torch.optim import OptimConfig
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = get_smoke("tinyllama-1.1b")
    cell = ShapeCell("train", 16, 4, "train")
    step = dryrun.build_cell(cfg, cell, device="meta",
                             microbatches=microbatches)
    parts = dryrun.count_step(step)
    train_step = make_train_step(cfg, OptimConfig(),
                                 TrainConfig(microbatches=microbatches))
    a = step.args
    whole = dryrun.count_step(dryrun.Step(args=a, parts=[(
        "train_step", lambda: train_step(a["params"], a["opt_state"],
                                         a["batch"]), 1)]))
    assert parts["flops"] == whole["flops"] > 0
    assert parts["bytes"] == whole["bytes"]

    def per_op(c):          # calls differ by the split's views alone
        return {op: (v["flops"], v["bytes"]) for op, v in c["ops"].items()}
    assert per_op(parts) == per_op(whole)


def test_meta_counts_equal_fake_counts():
    """A step on meta tensors counts what the same step counts under
    ``FakeTensorMode`` (the dry run steps on meta tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_smoke("seamless-m4t-large-v2")
    cell = ShapeCell("decode", 64, 4, "decode")
    meta = dryrun.count_step(dryrun.build_cell(cfg, cell, device="meta"))
    with FakeTensorMode():
        fake = dryrun.count_step(dryrun.build_cell(cfg, cell, device="cpu"))
    for k in ("flops", "bytes", "peak_bytes", "argument_size_in_bytes",
              "output_size_in_bytes"):
        assert meta[k] == fake[k], k
    _no_mode_leaked()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "rwkv6-3b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2", "internvl2-26b"])
def test_serving_depth_extrapolation_exact(arch):
    cfg = dryrun.with_units(get_smoke(arch), 6)
    for name, cell in cells_for(arch).items():
        if not cell.is_serving:
            continue
        cell = _small(cell)
        got = dryrun.count_cell(cfg, cell)
        assert got["depth"].startswith("extrapolated")
        want = dryrun._count_meta(cfg, cell)
        for k in ("flops", "bytes", "peak_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "temp_size_in_bytes"):
            assert got[k] == want[k], (name, k)


def test_cli_writes_its_report(tmp_path):
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--cell", "prefill_32k",
                        "--out", str(tmp_path)]) == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [
        "tinyllama-1.1b__prefill_32k__1xH100__none.json"]
    rep = json.loads(files[0].read_text())
    assert rep["ok"] and rep["n_chips"] == SINGLE.n_chips == 1
    assert rep["depth"] == "extrapolated from 2 and 3 of 22 units"
    assert rep["dominant"] in ("compute_s", "memory_s")
    assert rep["fits"] is False
    assert rep["model_flops_global"] == 2 * rep["active_params"] * 32 * 32768


def _no_mode_leaked():
    assert _get_current_dispatch_mode() is None
    t = torch.randn(3)
    assert type(t) is torch.Tensor and t.device.type == "cpu"
    assert torch.get_default_dtype() == torch.float32
    assert float(t.sum() * 0) == 0.0         # has data


def test_a_failing_cell_leaks_no_mode():
    r = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", smoke=True,
                        overrides={"block_pattern": ("bogus",)},
                        verbose=False)
    assert r["ok"] is False and "AssertionError" in r["error"]
    _no_mode_leaked()

    def boom():
        torch.zeros(2, device="meta")
        raise RuntimeError("inside the counting modes")

    with pytest.raises(RuntimeError):
        dryrun.count_step(dryrun.Step(args={}, parts=[("boom", boom, 1)]))
    _no_mode_leaked()


def test_kernel_wrappers_refuse_tensors_without_data():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.apsq_matmul import ops
    x = torch.zeros(4, 64, dtype=torch.int8, device="meta")
    w = torch.zeros(64, 8, dtype=torch.int8, device="meta")
    with pytest.raises(TypeError, match="meta tensor"):
        ops.baseline_matmul_int8(x, w)
    with FakeTensorMode():
        x = torch.zeros(4, 64, dtype=torch.int8, device="cuda")
        w = torch.zeros(64, 8, dtype=torch.int8, device="cuda")
        e = torch.zeros(2, dtype=torch.int32, device="cuda")
        with pytest.raises(TypeError, match="fake tensor"):
            ops.apsq_matmul_int8(x, w, e, gs=2)
    _no_mode_leaked()


def test_one_device_only():
    with pytest.raises(NotImplementedError, match="dist"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_smoke_mesh((1, 2), device="cpu")     # this process alone
    with pytest.raises(NotImplementedError, match="dist"):
        dryrun.main(["--arch", "tinyllama-1.1b", "--compress"])
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "multi"])


def test_encdec_search_cli_reaches_its_gate(tmp_path):
    from repro_torch.search.cli import main as search_cli
    rc = search_cli(["--arch", "seamless-m4t-large-v2", "--budget-smoke",
                     "--iterations", "1", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert rc == 1          # by design on the CPU: no kernel parity ran
    rep = json.loads((tmp_path / "seamless-m4t-large-v2__pareto.json")
                     .read_text())
    for rt in (rep["roundtrip"], rep["roundtrip_psum"]):
        if rt.get("same_as_best_accuracy"):
            continue
        assert rt["backends"] == ["oracle"] and rt["ok"] is None
        assert rt["serving_parity"] is None
        toks = rt["decode"]["oracle"]
        assert len(toks) == 6 and all(
            0 <= t < get_smoke("seamless-m4t-large-v2").vocab for t in toks)
    assert np.isfinite([p["error"] for p in rep["front"]]).all()
