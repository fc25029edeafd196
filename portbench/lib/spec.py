"""Find a cell's configuration, traffic, driver, metric readers and limits by name.

Everything a cell needs is a file of its own, named after the entry of
``BENCHMARK.json`` that asks for it, so that a new configuration, traffic
mix or per-layer metric is a new file and a new entry, never an edit.
``root`` is the folder that holds ``BENCHMARK.json`` and ``portbench/``
(the checkout); tests point it at a folder laid out the same way.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = "portbench"


@dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    driver: ModuleType
    readers: dict[str, ModuleType] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module of its own (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_dyn.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str, reported: set[str]) -> bool:
    """A metric is reported in a cell that its ``workloads`` list names, or,
    without the list, in every cell that reports what it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json(root / conf_entry["file"])
    base = root / BENCH_DIR
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, workload, reported)]
    driver = load_module(base / "drivers" / f"{traffic['kind']}.py", f"driver.{traffic['kind']}")
    readers = {m["name"]: load_module(base / "metrics" / f"{m['name']}.py", f"metric.{m['name']}")
               for m in per_layer}
    return Cell(root=root, workload=w, config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer, driver=driver, readers=readers)
