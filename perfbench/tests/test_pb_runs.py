"""Whole runs of the harness on the CPU at a small size: the numbers the
comparison reads, each planted fault caught, the control caught, no JAX
on the path, and no result without a card."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import bench, faults
from perfbench import run as R
from perfbench.tests.conftest import small_cell
from perfbench.tools import readings

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "esn_tpu", "esn_tpu_torch"}


def drive(cell, fault=None, trace=0, seed=2**31 + 11):
    """One run of ``cell`` on the CPU: (exit code, the result's line)."""
    lines = []
    args = types.SimpleNamespace(workload=cell.name, seed=seed, seconds=0.2,
                                 trace=trace)
    real_print = print

    def capture(*a, **k):
        if k.get("file") is None:
            lines.append(" ".join(map(str, a)))
        else:
            real_print(*a, **k)
    R.print = capture
    try:
        rc = R.run(args, device=torch.device("cpu"), fault=fault, cell=cell)
    finally:
        del R.print
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_reads_its_numbers(name):
    """An unbroken f32 run at a small size: a result line with the cell's
    end-to-end metrics and every number compared beside its limit, in
    the order the contract asks (``checks`` last). A prediction's maps
    lie within the limits; a training step's later steps do not at this
    size (two images: Adam's first updates follow the signs of gradients
    that round-off flips), so they are read, not held."""
    cell = small_cell(name)
    rc, out = drive(cell)
    assert rc == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.limits)
    assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])
    assert out["device"]["platform"] == "cpu"
    if cell.route == "predict":
        assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_no_device_number_on_the_cpu(name):
    """A traced run on the CPU finds no device operation: the kernels'
    roofline and the idle share are left out, never read as 0."""
    rc, out = drive(small_cell(name), trace=1)
    assert rc == 0
    names = set(out["metrics"])
    assert not any(n.startswith(("kernel_roofline", "idle_share"))
                   for n in names)
    assert any(n.startswith("host_ms") for n in names)


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS
    for f in faults.BY_ROUTE[bench.find_cell(c).route]])
def test_planted_fault_is_caught(name, fault):
    cell = small_cell(name)
    rc, out = drive(cell, fault=faults.BY_ROUTE[cell.route][fault])
    assert rc == 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_a_limit(name):
    """The reference in float8 in the program's place, at a small size in
    bf16's stead: at least one number over its limit."""
    cell = small_cell(name)
    fn = (readings.control_predict if cell.route == "predict"
          else readings.control_train)
    got = fn(cell, 2**31 + 5, torch.device("cpu"))
    assert any(got[k] > v["limit"] for k, v in cell.limits.items()), got


def test_reference_imports_neither_program_nor_jax():
    """Whole top-level names: ``esn_tpu_torch`` is the program, not a JAX
    package, and the reference may import neither."""
    for path in (bench.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path.name, tops)


CHILD = """
import sys, types, torch
from perfbench import bench, run as R
from perfbench.tests.conftest import small_cell
for name in [w["name"] for w in bench.load_benchmark()["workloads"]]:
    args = types.SimpleNamespace(workload=name, seed=7, seconds=0.1, trace=1)
    assert R.run(args, device=torch.device("cpu"), cell=small_cell(name)) == 0
print("TOP", sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_no_jax_on_the_path():
    """A fresh interpreter that drives every cell's route loads neither
    ``jax``, ``jaxlib``, ``flax`` nor ``esn_tpu`` (compared whole; the
    program's own ``esn_tpu_torch`` is loaded)."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=bench.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("TOP"))
    tops = set(ast.literal_eval(line[4:]))
    assert "esn_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "esn_tpu"}
    assert R.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(R.FORBIDDEN))


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(bench.ROOT)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    shutil.copy(bench.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_nan_reads_as_no_bound():
    """A NaN on either side fails the comparison: the loss, a leaf's gap
    and the widest logit gap read infinite."""
    from perfbench.drivers import train as D
    from perfbench.reference import step as RS
    from perfbench.reference.fastscnn import build
    nan = float("nan")
    ref = {"losses": [1.0], "grad": {"a": 1.0, "b": 1.0},
           "grad_raw": {"a": 1.0, "b": 1.0}, "change": {"a": 1.0, "b": 1.0}}
    prog = {"losses": [nan], "grad": {"a": nan, "b": 1.0},
            "change": {"a": 1.0, "b": nan}}
    g = D.gaps(prog, ref)
    assert g["loss_gap"] == g["grad_gap"] == g["change_gap"] == float("inf")
    model = build(19)
    for p in model.parameters():
        torch.nn.init.constant_(p, nan)
    x = torch.zeros(1, 3, 64, 128)
    got = RS.predict_gaps(model, x, torch.zeros(1, 64, 128, dtype=torch.int32),
                          chunk=1)
    assert got["widest"] == float("inf")
