"""Cells of the benchmark at a size a CPU test can hold: the cells' own
configs and traffic with the widths, depths and lengths cut, and the same
code paths (the port's plain versions stand in for its kernels on the
CPU)."""

from __future__ import annotations

import copy

from bench.harness.cell import BENCH, ROOT, Cell, load_cell, load_json

SMALL = {
    "hybrid": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                   vocab_size=256, ssm_state=16, ssm_chunk=16, mamba_headdim=16,
                   shared_attn_every=2),
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256),
}


# The limits at this size, from its own readings on the CPU (seeds 1-7 and
# 2 400 000 017): the training cell's large_sign_flips read 0.0016-0.022
# (the float8 control 0.21-0.24, half the batch 0.13-0.22),
# change_median_leaf up to 0.021 (a state left unchanged: 1); the served
# tokens' widest gap up to 0.06.  The cells' own limits are set at their
# size on the card (PERF.md).
LIMITS = {
    "train": {"large_sign_flips": 0.06, "change_median_leaf": 0.15},
    "closed_waves": {"logit_gap": 0.3},
}


# Pairs of a configuration and a mix that the benchmark has no cell for yet,
# held at this size so that their paths stay sound.
UNLISTED = {"zamba2-1.2b.train-8k": ("zamba2-1.2b", "train-8k"),
            "zamba2-1.2b.docqa-8k": ("zamba2-1.2b", "docqa-8k")}


def _cell(workload: str) -> Cell:
    if workload not in UNLISTED:
        return load_cell(workload)
    config, mix = UNLISTED[workload]
    every_cell = [m for m in load_json(ROOT / "BENCHMARK.json")["end_to_end"]
                  if "workloads" not in m]
    return Cell(name=workload, chips=1, config=load_json(BENCH / "configs" / f"{config}.json"),
                traffic=load_json(BENCH / "traffic" / f"{mix}.json"), limits={},
                end_to_end=every_cell, per_layer=[])


def tiny_cell(workload: str, **traffic) -> Cell:
    """``workload`` with its model cut to ``SMALL``, its traffic's values
    replaced by ``traffic`` (short prompts and sequences unless given) and
    the limits of this size."""
    cell = copy.deepcopy(_cell(workload))
    cell.config["model"].update(SMALL[cell.model["family"]])
    t = cell.traffic
    if t["kind"] == "train":
        t.update(batch=2, seq_len=64, check_steps=3)
    else:
        t.update(max_batch=4, prompt_lengths=[24, 32, 40, 48], new_tokens=4, check_requests=3)
    t.update(traffic)
    cell.limits = dict(LIMITS[t["kind"]])
    return cell
