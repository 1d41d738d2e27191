"""The dry run (``repro_torch.launch.dryrun``) on fake worlds, on the CPU.

Every fake process group is made and destroyed inside a module-scoped
fixture or a test's own ``fake_world``: the files that run after this one
in the same worker expect no process group.  The JAX package's numbers
(``model_flops`` of every cell, ``collective_bytes`` of the sample HLO
of ``tests/test_system.py``) come from one subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices for the
process that imports it first.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ShapeConfig, get_config, get_shape, reduce_config, valid_cells
from repro_torch.kernels import flash_attention, mamba_scan, traced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the reduced cells: each kind's shape at a length the CPU traces quickly
# (the batch a multiple of both meshes' 16 and 32 data ranks); DTensor's
# sharding rules, not the shapes, take the time (a 2 x 16 x 16 mesh's
# most), so qwen2-7b runs one layer
SMALL_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 64, 32),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 256, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 256, 32),
}
SMALL_LAYERS = {"qwen2-7b": dict(n_layers=1), "zamba2-1.2b": {}}
RESULT_KEYS = {"arch", "shape", "multi_pod", "mesh", "chips", "kind", "lower_s", "compile_s",
               "memory", "flops_per_device", "bytes_per_device", "collectives", "roofline",
               "roofline_raw", "analytic", "model_flops_global", "hlo_flops_global",
               "useful_flops_ratio", "kernels", "launches", "collective_calls", "rank"}

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests!r})
from repro.configs import get_config, get_shape, valid_cells
from repro.launch.dryrun import collective_bytes, model_flops
from test_system import SAMPLE_HLO
print(json.dumps({{"model_flops": {{f"{{a}}/{{s}}": model_flops(get_config(a), get_shape(s))
                                    for a, s in valid_cells()}},
                  "collective_bytes": collective_bytes(SAMPLE_HLO)}}))
"""


@pytest.fixture(scope="module")
def reference():
    """The JAX package's numbers, from one subprocess."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE.format(tests=HERE)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_cells():
    """Reduced qwen2-7b and zamba2-1.2b, a cell of each kind, on both
    production meshes (fake worlds of 256 and 512 made and destroyed by
    ``run_cell``)."""
    out = {}
    for arch, layers in SMALL_LAYERS.items():
        cfg = reduce_config(get_config(arch), **layers)
        for name, shape in SMALL_SHAPES.items():
            for multi_pod in (False, True):
                out[arch, name, multi_pod] = dryrun.run_cell(
                    arch, name, multi_pod=multi_pod, cfg=cfg, shape=shape, device="cpu",
                    verbose=False)
    assert not dist.is_initialized()
    return out


def _fake_dtensor(shape, placements, mesh, dtype=torch.float32):
    return dryrun._fake_leaf(torch.empty(shape, dtype=dtype, device="meta"), placements, mesh,
                             "cpu")


def test_flops_are_the_ranks_local_ones():
    """x (16, 64) split over "data" times w (64, 64) split by columns over
    "model", on (2, 2): rank 0 multiplies (8, 64) by (64, 32), 32 768 FLOPs,
    where DTensor's global product is 131 072."""
    with dryrun.fake_world(4):
        mesh = make_local_mesh(data=2, model=2, device="cpu")
        mode = FakeTensorMode()
        with mode:
            x = _fake_dtensor((16, 64), (Shard(0), Replicate()), mesh)
            w = _fake_dtensor((64, 64), (Replicate(), Shard(1)), mesh)
        count = dryrun.DryRunCount()
        with mode, count:
            y = x @ w
        assert isinstance(y, DTensor) and y.to_local().shape == (8, 32)
        assert count.flops == 2 * 8 * 64 * 32 == 32_768
        # read x's and w's shards, write y's: f32
        assert count.bytes_accessed == 4 * (8 * 64 + 64 * 32 + 8 * 32)
        assert count.calls == {}
    assert not dist.is_initialized()


def test_collective_bytes_follow_the_reference(reference):
    """The collectives of ``tests/test_system.py``'s sample HLO, each
    handed an f32[128, 256] on a fake world (the all-gather twice, as the
    HLO's synchronous op and its async start), count as the reference's
    ``collective_bytes`` does: ``==`` its dict."""
    with dryrun.fake_world(2):
        group = dist.group.WORLD
        mode = FakeTensorMode()
        with mode, dryrun.DryRunCount() as count:
            x = torch.empty(128, 256)
            funcol.all_gather_tensor(x, 0, group)
            gathered = torch.empty(256, 256)
            dist.all_gather_into_tensor(gathered, x)
            funcol.all_reduce(x, "sum", group)
            funcol.reduce_scatter_tensor(x, "sum", 0, group)
            dist.send(x, 1)   # collective-permute: what the rank sends
            funcol.all_to_all_single(x, None, None, group)
    assert count.reference() == reference["collective_bytes"]
    assert not dist.is_initialized()


def test_model_flops_equal_the_references_on_every_cell(reference):
    cells = valid_cells()
    assert len(cells) == 32
    for arch, shape in cells:
        got = dryrun.model_flops(get_config(arch), get_shape(shape))
        assert got == reference["model_flops"][f"{arch}/{shape}"], (arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL_SHAPES))
@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b"])
def test_reduced_cells_complete_on_both_meshes(small_cells, arch, name, multi_pod):
    r = small_cells[arch, name, multi_pod]
    assert RESULT_KEYS <= set(r), RESULT_KEYS - set(r)
    assert r["chips"] == (512 if multi_pod else 256)
    assert r["mesh"] == ([2, 16, 16] if multi_pod else [16, 16])
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    coll = r["collectives"]
    assert coll["num_ops"] == sum(r["collective_calls"].values()) > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k not in ("total", "num_ops"))
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["useful_flops_ratio"] > 0
    # the CPU traces the kernels' plain versions: no traced call, no launch
    assert all(k["calls"] == 0 for k in r["kernels"].values())
    assert not any(r["launches"].values())


def test_a_bigger_mesh_halves_a_ranks_share(small_cells):
    """Twice the data ranks: a training step's shard of the batch, and so
    its FLOPs, halve on the two-pod mesh."""
    for arch in ("qwen2-7b", "zamba2-1.2b"):
        one, two = (small_cells[arch, "train_4k", mp]["flops_per_device"] for mp in (False, True))
        assert two == pytest.approx(one / 2, rel=0.02)


def _fake_cuda(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b4_and_b4_bwd_are_traced_by_shape_on_fake_cuda_tensors(dtype):
    """B4 (MLA's (192, 128) heads, a window) and B4-bwd on fake CUDA
    tensors: the kernels' output shapes, dtypes and strides, the FLOPs of
    PERF.md's bound, and no launch."""
    b, h, hkv, s, hd, hd_v, window = 2, 4, 2, 96, 192, 128, 40
    before = {**flash_attention.LAUNCHES, **flash_attention.BWD_LAUNCHES}
    with FakeTensorMode():
        q, k = _fake_cuda(b, h, s, hd, dtype=dtype), _fake_cuda(b, hkv, s, hd, dtype=dtype)
        v = _fake_cuda(b, hkv, s, hd_v, dtype=dtype)
        count = dryrun.DryRunCount()
        with count:
            out, lse = flash_attention.flash_attention_kernel(q, k, v, window=window,
                                                              return_lse=True)
            dq, dk, dv = flash_attention.flash_attention_bwd_kernel(q, k, v, out, out, lse,
                                                                    window=window)
    assert (out.shape, out.dtype, out.device.type) == ((b, h, s, hd_v), dtype, "cuda")
    assert (lse.shape, lse.dtype) == ((b, h, s), torch.float32)
    for g, t in ((dq, q), (dk, k), (dv, v)):
        assert (g.shape, g.dtype, g.stride()) == (t.shape, t.dtype, t.stride())
    pairs = traced.attention_pairs(s, s, True, window)
    assert pairs == sum(min(i + 1, window) for i in range(s))
    fwd = count.kernels["flash_attention_kernel"]
    bwd = count.kernels["flash_attention_bwd_kernel"]
    assert fwd["calls"] == bwd["calls"] == 1
    assert fwd["flops"] == 2 * (hd + hd_v) * pairs * b * h
    assert bwd["flops"] == 2 * (3 * hd + 2 * hd_v) * pairs * b * h
    assert count.flops == fwd["flops"] + bwd["flops"]
    assert {**flash_attention.LAUNCHES, **flash_attention.BWD_LAUNCHES} == before


def test_b5_and_b5_bwd_are_traced_by_shape_on_fake_cuda_tensors():
    b, h, nc, q, p, n = 2, 3, 4, 64, 16, 8
    before = {**mamba_scan.LAUNCHES, **mamba_scan.BWD_LAUNCHES}
    with FakeTensorMode():
        x, dt = _fake_cuda(b, h, nc, q, p), _fake_cuda(b, h, nc, q)
        bm, h0 = _fake_cuda(b, nc, q, n), _fake_cuda(b, h, p, n)
        count = dryrun.DryRunCount()
        with count:
            y, h_out, states = mamba_scan._scan(x, dt, dt, bm, bm, h0)
            grads = mamba_scan.mamba_chunk_scan_bwd_kernel(x, dt, dt, bm, bm, states, y, h_out)
    assert (y.shape, h_out.shape, states.shape) == (x.shape, h0.shape, (b, h, nc, p, n))
    assert [g.shape for g in grads] == [x.shape, dt.shape, dt.shape, bm.shape, bm.shape,
                                        h0.shape]
    assert all(g.dtype == torch.float32 and g.is_contiguous() for g in grads)
    pairs = q * (q + 1) // 2
    assert count.kernels["mamba_chunk_scan_kernel"]["flops"] == (
        2 * b * nc * pairs * n + 2 * b * h * nc * (pairs * p + 2 * q * p * n))
    assert count.kernels["mamba_chunk_scan_bwd_kernel"]["flops"] == (
        2 * b * nc * pairs * n + 2 * b * h * nc * (pairs * (2 * p + 2 * n) + 5 * q * p * n))
    assert {**mamba_scan.LAUNCHES, **mamba_scan.BWD_LAUNCHES} == before


def test_a_cpu_tensor_still_takes_the_plain_versions():
    """A fake CPU tensor runs B4's and B5's plain versions (their products
    counted, no traced op); a real tensor never reaches a traced op."""
    with FakeTensorMode():
        q = torch.empty(1, 2, 32, 16)
        count = dryrun.DryRunCount()
        with count:
            out = flash_attention.flash_attention_kernel(q, q, q)
            y, _ = mamba_scan.mamba_chunk_scan_kernel(torch.empty(1, 2, 2, 16, 8),
                                                      torch.empty(1, 2, 2, 16),
                                                      torch.empty(1, 2, 2, 16),
                                                      torch.empty(1, 2, 16, 4),
                                                      torch.empty(1, 2, 16, 4),
                                                      torch.empty(1, 2, 8, 4))
    assert out.shape == q.shape and y.shape == (1, 2, 2, 16, 8)
    assert all(k["calls"] == 0 for k in count.kernels.values())
    assert count.flops > 0
    real = torch.zeros(1, 1, 4, 8)
    out = flash_attention.flash_attention_kernel(real, real, real)
    assert torch.equal(out, flash_attention.flash_attention_plain(real, real, real))
    with pytest.raises(Exception, match="traced by shape only"):
        torch.ops.repro_torch.flash_attention(real, real, real, True, None, 1.0)
    assert torch.ops.repro_torch.flash_attention.default._overloadpacket in flop_registry


def test_a_fake_world_leaves_no_group_and_refuses_a_second():
    with dryrun.fake_world(8):
        assert dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="exists already"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


def test_the_table_has_a_row_a_cell(small_cells):
    """Both meshes' runs of a cell side by side; a failed run shows why."""
    runs = list(small_cells.values()) + [
        {"arch": "qwen2-7b", "shape": "long_500k", "multi_pod": True, "error": "RuntimeError()"}]
    rows = dryrun.table(runs).splitlines()
    assert len(rows) == 2 + len({(r["arch"], r["shape"]) for r in runs}) == 2 + 7
    assert rows[2].startswith("| qwen2-7b | train_4k | 16x16 / 2x16x16 | ")
    assert rows[-1].startswith("| qwen2-7b | long_500k | 2x16x16 | RuntimeError() | ")
