"""What the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, which names its driver in ``drivers/``), its
comparison's limits (``limits/<workload>.json``), the per-layer metrics'
readers (``metrics/<quantity>.py`` for a metric named ``<quantity>`` or
``<quantity>.<part>``), the kernels' work (``work/*.py``) and the
reference models (``reference/<model>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark() -> Dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_file_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module of the package (a name
    may hold dots and dashes)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = f"perfbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Tuple[ModuleType, Optional[str]]:
    """The reader of the per-layer metric ``name`` and the part of the
    name it is given: ``metrics/<quantity>.py`` for ``<quantity>.<part>``."""
    quantity, _, part = name.partition(".")
    return load_file_module("metrics", quantity), (part or None)


def work_modules() -> List[ModuleType]:
    return [load_file_module("work", p.stem)
            for p in sorted((HERE / "work").glob("*.py"))
            if p.stem != "__init__"]


def reference_module(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{name}")


def driver_module(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{name}")


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    # set by the driver from the inputs it makes
    valid_pixels: int = 0

    @property
    def route(self) -> str:
        return self.traffic["driver"]

    @property
    def itemsize(self) -> int:
        return {"bfloat16": 2, "float16": 2, "float32": 4}[
            self.config["compute_dtype"]]


def find_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench or load_benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json("traffic", w["traffic"]),
                limits=_json("limits", name),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])
