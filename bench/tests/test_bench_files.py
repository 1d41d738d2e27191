"""Every file a cell is made of parses and is found by name, and what it
states agrees with the program it measures."""

import dataclasses
import json
import re

import pytest

from bench.harness.cell import BENCH, ROOT, load_cell, load_module, metric_reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_has_the_contracts_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    cell = load_cell(workload)
    assert cell.traffic["kind"] in ("train", "closed_waves")
    load_module("drivers", cell.traffic["kind"])
    load_module("families", cell.model["family"])
    load_module("reference", cell.model["family"])
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("config", sorted(p.name for p in (BENCH / "configs").glob("*.json")))
def test_config_file_is_what_the_port_runs(config):
    from repro_torch.configs import get_config

    from bench.harness.program import port_config

    data = json.loads((BENCH / "configs" / config).read_text())
    entry = next((c for c in SPEC["configs"] if c["file"] == f"bench/configs/{config}"), None)
    if entry is not None:
        assert data["reduced"] == entry["reduced"] and data["source"] == entry["source"]
    assert data["source"].startswith("https://")
    assert set(data.get("reduced_why", {})) == set(data["reduced"])
    base = get_config(data["port_arch"])
    cfg = port_config(data)
    fields = {f.name for f in dataclasses.fields(base)}
    # the port runs every size the file states, and the registry's own
    # values for the rest
    assert all(getattr(cfg, k) == v for k, v in data["model"].items() if k in fields)
    assert {f for f in fields if getattr(cfg, f) != getattr(base, f)} <= set(data["model"])
    extra = set(data["model"]) - fields
    assert extra <= {"attn_window"}
    if "attn_window" in data["model"]:
        from repro_torch.models.transformer import ZAMBA_WINDOW

        assert data["model"]["attn_window"] == ZAMBA_WINDOW
    if cfg.shared_attn_every:
        # the port builds n_layers // every groups: the file's depth is whole
        assert cfg.n_layers % cfg.shared_attn_every == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_kernel_the_family_launches_has_its_formulas(workload):
    cell = load_cell(workload)
    fam = load_module("families", cell.model["family"])
    t = cell.traffic
    if t["kind"] == "train":
        launches = fam.train_launches(cell.model, t["batch"], t["seq_len"])
    else:
        launches = fam.prefill_launches(cell.model, t["max_batch"], max(t["prompt_lengths"]))
    assert launches
    for kernel, shapes in launches.items():
        mod = load_module("kernels", kernel)
        for shape, count in shapes:
            assert count > 0 and mod.ops(shape) > 0 and mod.nbytes(shape) > 0


def test_traffic_files_parse():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        assert t["kind"] in ("train", "closed_waves")
        if t["kind"] == "closed_waves":
            assert len(t["prompt_lengths"]) == t["max_batch"]
