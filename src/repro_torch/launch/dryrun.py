"""Multi-pod dry run: trace every (arch × shape × mesh) cell on a fake world.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for 256 or 512 virtual devices.  Per cell this driver:

  1. makes a fake process group of 256 ranks (the 16 × 16 ("data",
     "model") mesh of ``make_production_mesh()``) or 512 (2 × 16 × 16 with
     ``multi_pod``), and destroys it afterwards (:func:`fake_world`); no
     rank but this process exists, and a collective moves nothing;
  2. builds the cell (``launch.specs.build_cell``, arguments on ``meta``)
     and places every argument as its ``in_shardings`` say, as DTensors
     whose local shards are ``FakeTensorMode`` tensors on ``device`` at
     this rank's local shapes: nothing is allocated;
  3. runs the cell's ``step_fn`` under ``FakeTensorMode`` and
     :class:`DryRunCount`, which sees the rank's local ops and collectives
     one by one; the kernels (B4, B4-bwd, B5, B5-bwd) are traced by shape
     on a fake CUDA tensor (``kernels.traced``) and launch nothing;
  4. derives the three roofline terms (compute / HBM / interconnect) from
     the rank's counts.

An exception in 2-3 is a fault of the system, as a failed compile is there.

Conventions.  The rank measured is rank 0, mesh coordinate 0 on every
axis.  DTensor splits a dimension as ``torch.chunk`` does, the first ranks
taking the larger pieces, so rank 0 holds the largest shard of every
tensor: 2 of qwen2-7b's 28 query heads over ``model = 16``, where ranks 14
and 15 of each model group hold none.

* FLOPs are those of the rank's local ops, not DTensor's global ones: a
  product of a (16, 64) batch split two ways by a (64, 64) weight whose
  columns are split two ways counts 32 768 on a rank, not the 131 072 of
  the whole product.  Each op counts by ``torch.utils.flop_counter``'s
  formulas (the products, convolutions and attention; an elementwise op
  counts none, where XLA's ``cost_analysis`` counts its arithmetic too);
  the kernels' ops by the formulas of PERF.md's bounds.
* Bytes are each local op's tensor inputs plus its outputs (a mutated
  argument once, as written); views and allocations move none.  Eager
  PyTorch does not fuse, so this is an upper bound on what XLA's "bytes
  accessed" counts for the same program.
* Collective bytes follow the reference: the bytes a rank hands each
  collective, by kind, with their ``total`` and ``num_ops``
  (``obs.collectives.CollectiveCount``, the counter of the measured runs).
  A ``"cpu"`` mesh has no all-to-all (DTensor falls back to an all-gather
  and a chunk, and so counts an all-gather); a ``"cuda"`` mesh counts
  what NCCL would move.
* Memory: ``argument_bytes`` and ``output_bytes`` are the sums of the
  local shards' bytes of the step's arguments and outputs (an output that
  is an argument updated in place counts in both, as XLA's sizes do);
  ``peak_bytes`` is the most bytes of fake storage alive at once through
  the step, the arguments included: the tensors eager PyTorch holds live,
  with autograd's saved tensors and remat as the cell sets it, and no
  allocator rounding, fragmentation or library workspace.
  ``temp_bytes`` is the peak less the arguments.
* An eager trace runs every layer, so nothing is counted once for a loop
  body, as a scan's while body is in the reference's HLO.  A family whose
  sequence mixing is a loop over the tokens (xLSTM) would run ~10^8 fake
  ops at 4 096 or 32 768 tokens: its training and prefill cells are traced
  at two depths by three lengths and fit (:func:`token_loop_terms`; the
  result says so under ``"fit"``).
  :func:`depth_corrected_terms` keeps the reference's fit: its use here is
  to trace the deepest cells (deepseek-v2's 60 layers, qwen2-vl's 80) at
  two shallow depths and extrapolate.

The roofline divides by the rates of one NVIDIA H100 80GB HBM3 (SXM5) at
700 W, from NVIDIA's datasheet (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out build/dryrun_torch.json
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all --shard 0/4 --device cpu
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k --mesh 2x2
  python -m repro_torch.launch.dryrun --table build/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.models.common import local_shape_offset
from repro_torch.obs.collectives import CollectiveCount

# NVIDIA H100 80GB HBM3 (SXM5) at 700 W, datasheet rates (per GPU)
PEAK_FLOPS = 989e12   # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12      # HBM3 bytes/s
# the slowest link a production mesh crosses: 256 GPUs span 32 nodes of
# 8, joined by one 400 Gb/s NDR InfiniBand port a GPU (NVLink gives 450
# GB/s each way inside a node)
LINK_BW = 50e9        # bytes/s

__all__ = [
    "DryRunCount",
    "HBM_BW",
    "LINK_BW",
    "PEAK_FLOPS",
    "depth_corrected_terms",
    "fake_world",
    "main",
    "measure_cell",
    "model_flops",
    "run_cell",
    "table",
    "token_loop_terms",
]


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the body; destroyed on the way out (no group is left behind).
    Collectives on it move nothing.  Raises if a group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _views_and_allocations(func) -> bool:
    name = func._opname
    return func.is_view or name.startswith(("empty", "new_empty")) or name in (
        "detach", "alias", "lift_fresh", "_local_scalar_dense")


class DryRunCount(CollectiveCount):
    """The rank's collectives (``CollectiveCount``) and, of its other local
    ops: FLOPs, bytes (module docstring), the kernels' traced calls by
    shape, and the live fake storage and its peak.

    DTensor works out an op's global output shape by running the op on
    fake tensors of the global shapes; those runs pass through this mode
    too and are not the rank's work, so they are not counted
    (:meth:`__enter__` marks them)."""

    def __init__(self):
        from repro_torch.kernels.traced import KERNEL_OPS

        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.kernels = {name: {"calls": 0, "flops": 0, "shapes": {}} for name in KERNEL_OPS}
        self._kernel_of = {op: name for name, op in KERNEL_OPS.items()}
        self._live, self.live_bytes, self.peak_bytes = {}, 0, 0
        self._global_meta = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or st.nbytes() == 0:
            return
        nbytes = st.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= nbytes

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def local_op(self, func, args, kwargs, out) -> None:
        if self._global_meta:
            return
        from torch.utils.flop_counter import flop_registry

        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if not outs or _views_and_allocations(func):
            return   # metadata (a device, a size), views and allocations
        packet = func._overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        self.flops += flops
        name = self._kernel_of.get(func)
        if name is not None:
            k = self.kernels[name]
            shape = str([list(t.shape) for t in args if isinstance(t, torch.Tensor)])
            k["calls"] += 1
            k["flops"] += flops
            k["shapes"][shape] = k["shapes"].get(shape, 0) + 1
        written = set()
        read = 0
        for i, arg in enumerate(func._schema.arguments):
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            tensors = [t for t in tree_leaves(val) if isinstance(t, torch.Tensor)]
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.update(id(t) for t in tensors)
                self.bytes_accessed += sum(t.nbytes for t in tensors)
            else:
                read += sum(t.nbytes for t in tensors)
        self.bytes_accessed += read + sum(t.nbytes for t in outs if id(t) not in written)

    @contextlib.contextmanager
    def _marking_global_meta(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        orig = getattr(ShardingPropagator, name)
        counter = self

        def marked(*args, **kwargs):
            counter._global_meta += 1
            try:
                return orig(*args, **kwargs)
            finally:
                counter._global_meta -= 1

        setattr(ShardingPropagator, name, marked)
        try:
            yield
        finally:
            setattr(ShardingPropagator, name, orig)

    def __enter__(self):
        self._marks = self._marking_global_meta()
        self._marks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.__exit__(*exc)


def _locals(tree) -> list[torch.Tensor]:
    """The local shards of every DTensor (and every plain tensor) of a tree
    of arguments or outputs: modules' parameters, dicts, lists, tuples."""
    if isinstance(tree, nn.Module):
        return [t for p in tree.parameters() for t in _locals(p)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _fake_leaf(t: torch.Tensor, placements, mesh, device) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype in ``placements`` whose
    local shard (this rank's shape) is a fake tensor on ``device``."""
    shape, _ = local_shape_offset(t.shape, mesh, placements)
    local = torch.empty(shape, dtype=t.dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def _fake_tree(tree, shardings, mesh, device):
    """``tree`` (``build_cell``'s ``meta`` arguments: a parameter module,
    nested dicts, host integers) with every tensor a fake-shard DTensor
    placed by ``shardings``; a module is changed in place."""
    if isinstance(tree, nn.Module):
        for mod_name, mod in tree.named_modules():
            for pname, p in list(mod.named_parameters(recurse=False)):
                full = f"{mod_name}.{pname}" if mod_name else pname
                d = _fake_leaf(p, shardings[full], mesh, device)
                setattr(mod, pname, nn.Parameter(d, requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: _fake_tree(v, shardings[k], mesh, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _fake_leaf(tree, shardings, mesh, device)
    return tree


def _nbytes(tensors) -> int:
    """Bytes of distinct storages' tensors (a leaf passed twice counts once)."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.nbytes
    return total


def measure_cell(cfg, shape, mesh, *, device: str = "cuda", **build_kw) -> dict:
    """Trace one cell of ``cfg`` at ``shape`` on ``mesh`` (over a fake
    world) and return rank 0's counts: ``flops``, ``bytes``, ``coll`` (the
    total collective bytes), ``coll_by_kind`` (the reference's dict),
    ``collective_calls`` by kind, ``memory``, ``kernels`` (the traced
    kernel calls by shape) and ``launches`` (the kernels' launch counters'
    increments: zero)."""
    from repro_torch.kernels import flash_attention, mamba_scan
    from repro_torch.launch.specs import build_cell

    counters = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES, mamba_scan.LAUNCHES,
                mamba_scan.BWD_LAUNCHES)
    before = {k: v for c in counters for k, v in c.items()}
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, **build_kw)
    mode = FakeTensorMode()
    with mode:
        args = tuple(_fake_tree(a, s, mesh, device)
                     for a, s in zip(cell.arg_shapes, cell.in_shardings))
    arg_locals = _locals(args)
    count = DryRunCount()
    for t in arg_locals:
        count.track(t)
    t_build = time.perf_counter() - t0
    with mode, count:
        out = cell.step_fn(*args)
    t_step = time.perf_counter() - t0 - t_build
    output_bytes = _nbytes(_locals(out))
    del out, args
    arg_bytes = _nbytes(arg_locals)
    return {
        "flops": float(count.flops),
        "bytes": float(count.bytes_accessed),
        "coll": count.reference()["total"],
        "coll_by_kind": count.reference(),
        "collective_calls": dict(sorted(count.calls.items())),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": output_bytes,
                   "temp_bytes": count.peak_bytes - arg_bytes,
                   "peak_bytes": count.peak_bytes},
        "kernels": count.kernels,
        "launches": {k: v - before[k] for c in counters for k, v in c.items()},
        "build_s": t_build,
        "step_s": t_step,
    }


def model_flops(cfg, shape) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (global)."""
    n_act = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * shape.tokens


def _depth_variant(cfg, n_layers: int):
    """Same architecture at a reduced layer count (divisibility-aware)."""
    kw = {"n_layers": n_layers}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _probe_depths(cfg, *, scale: int = 4) -> tuple[int, int]:
    """Two reduced depths compatible with the arch's grouping constraints."""
    step = 1
    if cfg.shared_attn_every:
        step = max(step, cfg.shared_attn_every)
    if cfg.slstm_every:
        step = max(step, cfg.slstm_every)
    base = cfg.moe.first_dense_layers if (cfg.moe and cfg.moe.first_dense_layers) else 0
    return base + scale * step, base + 2 * scale * step


def depth_corrected_terms(cfg, shape, mesh, *, probe_scale: int = 4, **build_kw) -> dict:
    """Rank 0's FLOPs, bytes and collective bytes at two reduced depths,
    fit term(L) = a + b·L and extrapolated to the full layer count (the
    reference's fit).  An eager trace counts every layer, so the fit here
    is not a correction of a loop body counted once: it stands in for a
    full-depth trace of the deepest cells, and is exact where every layer
    of the probes' kinds repeats the same work."""
    lo, hi = _probe_depths(cfg, scale=probe_scale)
    lo = min(lo, cfg.n_layers)
    hi = min(hi, cfg.n_layers)
    m_lo = measure_cell(_depth_variant(cfg, lo), shape, mesh, **build_kw)
    if hi == lo:
        return {k: m_lo[k] for k in ("flops", "bytes", "coll")}
    m_hi = measure_cell(_depth_variant(cfg, hi), shape, mesh, **build_kw)
    out = {}
    for k in ("flops", "bytes", "coll"):
        b = (m_hi[k] - m_lo[k]) / (hi - lo)
        a = m_lo[k] - b * lo
        out[k] = max(a + b * cfg.n_layers, m_hi[k])
    return out


# families whose sequence mixing is a loop over the tokens (xLSTM's
# recurrences, one step at a time as in the reference): an eager trace of
# 4 096 or 32 768 steps a layer is ~10^8 fake ops, so their longer cells are
# traced at two depths and three lengths and fit (token_loop_terms)
TOKEN_LOOP_FAMILIES = ("ssm",)
TOKEN_PROBES = (16, 32, 48)


def _lagrange(x: float, nodes) -> list[float]:
    """The weights of the polynomial through ``nodes`` evaluated at ``x``."""
    return [math.prod((x - b) / (a - b) for b in nodes if b != a) for a in nodes]


def _combine(parts):
    """``Σ w·r`` over ``parts = [(w, r), ...]``, results' trees of the same
    keys (a missing number is 0; an int stays an int); anything that is not
    a number is the last result's."""
    last = parts[-1][1]
    if isinstance(last, dict):
        return {k: _combine([(w, r.get(k) if isinstance(r, dict) else None)
                             for w, r in parts]) for k in last}
    if isinstance(last, (int, float)) and not isinstance(last, bool):
        v = sum(w * (r or 0) for w, r in parts)
        return round(v) if isinstance(last, int) else v
    return last


def token_loop_terms(cfg, shape, mesh, *, depth_scale: int = 1,
                     lengths: tuple[int, ...] = TOKEN_PROBES, **build_kw) -> dict:
    """:func:`measure_cell`'s dict for a cell of a token-loop family, from
    traces at two depths (:func:`_probe_depths` at ``depth_scale``: whole
    groups of the arch's layers) by three sequence lengths ``lengths``,
    every count fit as linear in the depth L and in the length S (the two
    longest lengths) and taken at the cell's L and S; the bytes quadratic in
    S (all three lengths): eager autograd of a loop that reads ``x[:, t]``
    writes a zero tensor of the whole sequence for each step's gradient,
    bytes that grow as S².  FLOPs and collectives are exact where every
    group of layers repeats the same work a token and the lengths split
    over the mesh as the cell's does (multiples of its axes' sizes); bytes
    and the peak come near (0.02 % and 1 % at 12 tokens from 4, 8 and 16 in
    the tests).  ``build_s`` and ``step_s`` are the traces' sums."""
    depths = tuple(sorted({min(d, cfg.n_layers) for d in _probe_depths(cfg, scale=depth_scale)}))
    m = {(d, n): measure_cell(_depth_variant(cfg, d), dataclasses.replace(shape, seq_len=n),
                              mesh, **build_kw) for d in depths for n in lengths}
    w_l = _lagrange(cfg.n_layers, depths) if len(depths) > 1 else [1.0]

    def fit(at):
        w_s = _lagrange(shape.seq_len, at)
        return _combine([(a * b, m[d, n]) for a, d in zip(w_l, depths)
                         for b, n in zip(w_s, at)])

    out = fit(lengths[-2:])
    out["bytes"] = fit(lengths)["bytes"]
    for k in ("build_s", "step_s"):
        out[k] = sum(r[k] for r in m.values())
    out["fit"] = {"depths": list(depths), "lengths": list(lengths)}
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, n_micro: int = 1,
             fsdp: bool = True, remat: bool = True, vocab_chunk: int = 0,
             cache_prefer: str = "largest", depth_correct: bool = False,
             expert_mode: str = "ep_model", device: str = "cuda",
             mesh_shape: tuple[int, int] | None = None, cfg=None, shape=None,
             verbose: bool = True) -> dict:
    """One cell on a fake world of 256 ranks (512 with ``multi_pod``): the
    reference's result dict, with rank 0's counts.  ``lower_s`` is the time
    to build the cell and its fake arguments, ``compile_s`` the traced
    step's.  ``mesh_shape=(data, model)`` runs a local mesh of that shape
    on a fake world of ``data·model`` ranks instead of a production one;
    ``cfg`` and ``shape`` stand in for ``arch``'s config and
    ``shape_name``'s shape (a reduced config, a shorter shape)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.profilers.program import stage_specs

    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": "full-attention arch: long_500k needs sub-quadratic mixing"}

    build_kw = dict(n_micro=n_micro, fsdp=fsdp, remat=remat, vocab_chunk=vocab_chunk,
                    cache_prefer=cache_prefer, expert_mode=expert_mode, device=device)
    world = math.prod(mesh_shape) if mesh_shape else 512 if multi_pod else 256
    with fake_world(world):
        if mesh_shape:
            mesh = make_local_mesh(data=mesh_shape[0], model=mesh_shape[1], device=device)
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        loop_fit = (cfg.family in TOKEN_LOOP_FAMILIES and shape.kind != "decode"
                    and shape.seq_len > TOKEN_PROBES[-1])
        if loop_fit:
            m = token_loop_terms(cfg, shape, mesh, **build_kw)
        else:
            m = measure_cell(cfg, shape, mesh, **build_kw)
        corr = (depth_corrected_terms(cfg, shape, mesh, probe_scale=4, **build_kw)
                if depth_correct and cfg.n_layers > 2 and not loop_fit else None)
        mesh_shape = list(mesh.shape)
        n_chips = mesh.size()

    raw_terms = {
        "compute_s": m["flops"] / PEAK_FLOPS,
        "memory_s": m["bytes"] / HBM_BW,
        "collective_s": m["coll"] / LINK_BW,
    }
    if corr is not None:
        terms = {"compute_s": corr["flops"] / PEAK_FLOPS, "memory_s": corr["bytes"] / HBM_BW,
                 "collective_s": corr["coll"] / LINK_BW}
        flops_dev_corr = corr["flops"]
    else:
        terms, flops_dev_corr = dict(raw_terms), m["flops"]
    dominant = max(terms, key=terms.get)

    stages = stage_specs(cfg, shape, group=1)
    analytic = {
        "compute_s": sum(s_.flops for s_ in stages) / (n_chips * PEAK_FLOPS),
        "memory_s": sum(s_.bytes_hbm for s_ in stages) / (n_chips * HBM_BW),
    }
    mf = model_flops(cfg, shape)
    hlo_flops_global = flops_dev_corr * n_chips
    result = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "mesh": mesh_shape,
        "chips": n_chips,
        "kind": shape.kind,
        "device": device,
        "rank": 0,
        "lower_s": round(m["build_s"], 1),
        "compile_s": round(m["step_s"], 1),
        "memory": m["memory"],
        "flops_per_device": m["flops"],
        "bytes_per_device": m["bytes"],
        "collectives": m["coll_by_kind"],
        "collective_calls": m["collective_calls"],
        "kernels": m["kernels"],
        "launches": m["launches"],
        "roofline": {**terms, "dominant": dominant, "step_time_s": max(terms.values())},
        "roofline_raw": raw_terms,
        "analytic": analytic,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": mf / hlo_flops_global if hlo_flops_global else None,
    }
    if "fit" in m:
        result["fit"] = m["fit"]
    if verbose:
        print(f"[dryrun] {arch:>24s} × {shape_name:<12s} mesh={mesh_shape} "
              f"build={m['build_s']:.1f}s step={m['step_s']:.1f}s "
              f"peak={m['memory']['peak_bytes'] / 1e9:.2f}GB/rank "
              f"flops/rank={m['flops']:.3e} coll={m['coll']:.3e}B dominant={dominant}",
              flush=True)
    return result


def table(results: list[dict]) -> str:
    """A Markdown table of dry-run results, a row a cell, its runs on each
    mesh side by side (``a / b``): a rank's peak GB (marked where above the
    card's 80 GB), collective GB by each kind that occurs, the calls, the
    dominant roofline term and its seconds, ``useful_flops_ratio``.  A run
    that failed or was skipped shows its reason."""
    kinds = [k for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "broadcast")
             if any(k in r.get("collectives", {}) for r in results)]
    cells: dict = {}
    for r in results:
        cells.setdefault((r["arch"], r["shape"]), []).append(r)

    def column(runs, fn):
        return " / ".join(r.get("error", r.get("skipped", ""))[:60] or fn(r) for r in runs)

    def peak(r):
        gb = r["memory"]["peak_bytes"] / 1e9
        return f"{gb:.2f}" + (" (> 80)" if gb > 80 else "")

    def dominant(r):
        term = r["roofline"]["dominant"]
        return f"{term[:-2]} {r['roofline'][term]:.3g}"

    rows = ["| arch | shape | meshes | peak GB | " + " | ".join(f"{k} GB" for k in kinds)
            + " | calls | dominant (s) | useful |",
            "|---|---|---|---|" + "---|" * len(kinds) + "---|---|---|"]
    for (arch, shape), runs in cells.items():
        meshes = " / ".join("x".join(map(str, r["mesh"])) if "mesh" in r
                            else "2x16x16" if r["multi_pod"] else "16x16" for r in runs)
        rows.append(f"| {arch} | {shape} | {meshes} | {column(runs, peak)} | "
                    + " | ".join(column(runs, lambda r, k=k: f"{r['collectives'].get(k, 0) / 1e9:.3g}")
                                 for k in kinds)
                    + f" | {column(runs, lambda r: str(r['collectives']['num_ops']))} | "
                    f"{column(runs, dominant)} | "
                    f"{column(runs, lambda r: format(r['useful_flops_ratio'], '.3g'))} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    from repro_torch.configs import valid_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--shard", help="K/N — run the K-th of N slices of --all")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--vocab-chunk", type=int, default=0)
    ap.add_argument("--cache-prefer", default="largest", choices=["largest", "last"])
    ap.add_argument("--depth-correct", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake shards' device: 'cuda' traces the kernels by shape "
                         "(needs a GPU and PyTorch built for CUDA), 'cpu' their plain versions")
    ap.add_argument("--mesh", help="DATAxMODEL: a local mesh on a fake world of DATA·MODEL "
                                   "ranks instead of the production meshes")
    ap.add_argument("--out")
    ap.add_argument("--table", metavar="JSON", help="print the Markdown table of a results "
                                                    "file written by --out, and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        with open(args.table) as f:
            print(table(json.load(f)))
        return 0
    mesh_shape = tuple(map(int, args.mesh.split("x"))) if args.mesh else None
    # DTensor's notes on sequential all-reduces over two mesh dimensions
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    if args.all:
        cells = valid_cells()
        if args.shard:
            k, n = map(int, args.shard.split("/"))
            cells = [c for i, c in enumerate(cells) if i % n == k]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) and not mesh_shape \
        else [args.multi_pod]
    results = []
    failures = 0

    def flush_out():
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    for arch, shape in cells:
        for mp in meshes:
            try:
                results.append(
                    run_cell(arch, shape, multi_pod=mp, n_micro=args.n_micro,
                             fsdp=not args.no_fsdp, remat=not args.no_remat,
                             vocab_chunk=args.vocab_chunk, cache_prefer=args.cache_prefer,
                             depth_correct=args.depth_correct, device=args.device,
                             mesh_shape=mesh_shape))
            except Exception as e:  # noqa: BLE001 — report, continue, fail at exit
                failures += 1
                print(f"[dryrun] FAIL {arch} × {shape} multi_pod={mp}: {e!r}", flush=True)
                results.append({"arch": arch, "shape": shape, "multi_pod": mp,
                                "error": repr(e)})
            flush_out()  # incremental — a crash loses at most one cell
    if args.out:
        print(f"[dryrun] wrote {len(results)} cells → {args.out}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
