"""The dry run's fits (``repro_torch.launch.dryrun``) against full traces
of the same cell, on fake worlds on the CPU: the reference's depth fit
(``depth_corrected_terms``) and the fit of a token-loop family's cells
(``token_loop_terms``).  Each fake process group is made and destroyed in
the test."""

import pytest
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_config, reduce_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh


def test_the_depth_fit_reproduces_a_full_depth_count():
    """Reduced qwen2-7b at 12 layers: the fit through 4 and 8 layers gives
    the 12-layer trace's FLOPs, bytes and collective bytes (a prefill)."""
    cfg = reduce_config(get_config("qwen2-7b"), n_layers=12)
    shape = ShapeConfig("prefill", "prefill", 64, 2)   # a batch no depth equals
    with dryrun.fake_world(8):
        mesh = make_local_mesh(data=2, model=4, device="cpu")
        assert dryrun._probe_depths(cfg) == (4, 8)
        fit = dryrun.depth_corrected_terms(cfg, shape, mesh, device="cpu")
        full = dryrun.measure_cell(cfg, shape, mesh, device="cpu")
    for k in ("flops", "bytes", "coll"):
        assert fit[k] == pytest.approx(full[k], rel=1e-12), k
    assert not dist.is_initialized()


def test_the_token_loop_fit_reproduces_a_full_trace():
    """Reduced xLSTM (groups of 4 layers, one of them sLSTM) at 12 layers
    and 12 tokens, a prefill on (data 2, model 4): the fit through 4 and 8
    layers by 4, 8 and 16 tokens gives the full trace's FLOPs, collectives
    by kind, bytes and memory (the peak to 1 %)."""
    cfg = reduce_config(get_config("xlstm-1.3b"), n_layers=12)
    shape = ShapeConfig("prefill", "prefill", 12, 4)
    with dryrun.fake_world(8):
        mesh = make_local_mesh(data=2, model=4, device="cpu")
        fit = dryrun.token_loop_terms(cfg, shape, mesh, lengths=(4, 8, 16), device="cpu")
        full = dryrun.measure_cell(cfg, shape, mesh, device="cpu")
    assert fit["fit"] == {"depths": [4, 8], "lengths": [4, 8, 16]}
    for k in ("flops", "bytes", "coll", "coll_by_kind", "collective_calls"):
        assert fit[k] == pytest.approx(full[k], rel=1e-12), k
    for k in ("argument_bytes", "output_bytes"):
        assert fit["memory"][k] == full["memory"][k]
    assert fit["memory"]["peak_bytes"] == pytest.approx(full["memory"]["peak_bytes"], rel=1e-2)
    assert not dist.is_initialized()
