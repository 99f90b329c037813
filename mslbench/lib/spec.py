"""Find what a cell names: its configuration, its traffic mix, its client
and its per-layer metric readers, all by the names in ``BENCHMARK.json``.

Every configuration is ``configs/<config>.json``, every traffic mix
``traffic/<traffic>.json`` and every per-layer metric
``metrics/<metric>.py`` under this package; a mix names the general client
that drives it (``clients/<client>.py``).  A later cell adds files and
entries here and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict               # configs/<config>.json
    traffic: dict              # traffic/<traffic>.json
    end_to_end: list[dict]     # the end-to-end metrics this cell reports
    per_layer: list[dict]      # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(BENCH_DIR)}")
    return json.loads(path.read_text())


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    w = found[0]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)])


def client(name: str):
    """The general client module ``clients/<name>.py``."""
    return importlib.import_module(f"mslbench.clients.{name}")


def metric_reader(name: str):
    """``read(trace) -> float | None`` of ``metrics/<name>.py`` (a metric's
    name may hold dots, so the file is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mslbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no metric reader metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
