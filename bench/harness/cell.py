"""A cell of ``BENCHMARK.json``, with its configuration, traffic mix,
limits and metrics, each found by name under ``bench/``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # bench/configs/<config>.json
    traffic: dict         # bench/traffic/<mix>.json
    limits: dict          # bench/limits/<workload>.json
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported_in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, *, benchmark: pathlib.Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named ``workload``; ``KeyError`` if the benchmark has none."""
    spec = load_json(benchmark)
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=load_json(ROOT / config["file"]),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reported_in(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reported_in(m, workload)],
    )


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (a file name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"bench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(metric_name: str):
    """The reader of a per-layer metric: ``bench/metrics/<base>.py``, where
    ``base`` is the name before its first dot (``b4_roofline.train`` ->
    ``b4_roofline``); its ``read(ctx)`` returns a number or None."""
    return load_module("metrics", metric_name.split(".")[0]).read
