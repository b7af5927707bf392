"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every piece it names."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import bench

B = bench.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ROUTE_NUMBERS = {"predict": {"map_gap_max", "map_mismatch"},
                 "train": {"loss_gap", "loss_gap_first", "grad_gap",
                           "grad_gap_median", "change_gap",
                           "change_gap_median"}}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"]
    assert 1 <= len(B["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])
    assert len(bench.BENCHMARK.read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert ((2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        texts = [e[k] for k in ("why", "layer") if k in e]
        if kind == "configs":
            texts.append(e["source"])
        for v in texts:
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_configs_found_and_whole():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((bench.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        bench.reference_module(cfg["reference"])
        assert any(w["config"] == c["name"] for w in B["workloads"])
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_found(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cell = bench.find_cell(w["name"])
    driver = bench.driver_module(cell.route)
    assert callable(driver.run)
    assert cell.limits and set(cell.limits) <= ROUTE_NUMBERS[cell.route]
    for v in cell.limits.values():
        assert v["lower"] < v["limit"] < v["upper"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    pairs = [(x["config"], x["traffic"]) for x in B["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_end_to_end_bounds():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    """Its reader found by name, and every cell it lists reports the
    end-to-end metric it moves and takes the route the name's part says."""
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    reader, part = bench.metric_reader(m["name"])
    assert callable(reader.read)
    moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert bench.applies(moved, w), (m["name"], w)
        assert bench.find_cell(w).route == part


def test_layers_named_alike():
    """Metrics of one layer give it letter for letter."""
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers == {"entry: train/step.py", "kernels: ops/kernels/ + csrc/",
                      "model: nn/core.py SegModel", "device"}


def test_work_files():
    mods = bench.work_modules()
    assert {m.MODE for m in mods} == {"predict", "train"}
    for m in mods:
        assert m.PATTERNS and callable(m.launches)
        for p in m.PATTERNS:
            re.compile(p)


def test_file_names_under_paths():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in (bench.HERE).rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(bench.ROOT).as_posix()
        assert allowed.match(rel) and len(rel) <= 200, rel
