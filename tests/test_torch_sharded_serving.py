"""Every family's sharded serving cells against the unsharded port and
``repro``, in one gloo world of eight CPU ranks on (data 2, model 4).

The world (``tests/_torch_dist_serving.py``) runs once per module in
processes of its own, over a ``file://`` rendezvous in a temporary
directory, while this process computes the references.  Each case is a
reduced config in float32 whose parameters are carried over from the JAX
package.  ``launch.specs.build_cell``'s prefill step fills a cache placed as
the prefill cell's ``in_shardings[2]`` says, then three greedy decode steps
run through the decode cell (a ``long_500k``-shaped case starts from a
cache of seeded values instead; a second-chunk case prefills into one).  Held to

* the port's unsharded prefill and decode: the logits of every step and
  every cache leaf (after the prefill and after the last step) within 1e-5
  of the largest reference value, the greedy tokens ``==``.  xLSTM's
  within 1e-4, the bound against ``repro``: its exponential gates carry the
  float32 rounding of the tensor-parallel products through eight layers and
  every step (on the CPU: up to 2.3e-5 of a cache leaf's largest value
  after the last step), and float32 in other orders moves it as far with
  nothing sharded (``test_xlstm_moves_this_far_unsharded``);
* ``repro``'s prefill and decode: logits within 1e-4, greedy tokens
  ``==``, where the reference runs (not at 4160 tokens: its chunked MLA
  raises above 4096, and its attention over a 4224-slot cache is slow on
  the CPU).

The cases: every family at a full-context prefill (16-32 tokens, global
batch 4, ``max_len`` 64: each KV cache's sequence axis is its largest that
"model" divides, so it is split over "model"); phi3 at 6 / 2 heads and
deepseek-v2's MLA in one layer at 4160 prompt tokens (batch 2), where the
prefill takes B4's DTensor route and writes the sequence-sharded cache;
``cache_prefer="last"`` (the head width split); zamba2 and xLSTM
prefilling a second chunk of 16 tokens into a cache of seeded values at
length 24 (the sharded Mamba2 forward's ``h0`` and conv tail, and the
xLSTM forward's state, taken from the cache's layout, none of them zero);
zamba2 at batch 2, where the Mamba2 states' stacked ``every`` axis is the
one split over "data"; and ``long_500k``'s shape at batch 1 (which the
data axis does not divide): zamba2 with a ring of 4096 slots over "model"
and xLSTM, each decoding from ``length`` 4200, past the window.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from _torch_parity import model_pair

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_serving as W  # noqa: E402

RTOL = 1e-5
RTOL_XLSTM = 1e-4
RTOL_REPRO = 1e-4
LONG_LEN = 4200   # a long_500k-shaped case's cache length: past zamba2's 4096-slot ring

# name: (arch, widths over the reduced config, run: prompt tokens (or None
#        for a seeded cache), global batch, max_len, held to repro, and
#        options of the cells; "seeded_len": the prompt goes into a cache
#        of seeded values at that length, as a second chunk of a prompt)
CASES = {
    "gqa_4_2": ("phi3-medium-14b", dict(n_heads=4, n_kv_heads=2), (16, 4, 64, True),
                {"count_comms": True}),
    "gqa_4_2_len256": ("phi3-medium-14b", dict(n_heads=4, n_kv_heads=2), (16, 4, 256, True),
                       {"count_comms": True}),
    "gqa_head_width": ("phi3-medium-14b", dict(n_heads=4, n_kv_heads=2), (16, 4, 64, True),
                       {"cache_prefer": "last"}),
    "dense_qk_norm": ("qwen3-32b", {}, (16, 4, 64, True), {}),
    "dense_mqa": ("granite-34b", {}, (16, 4, 64, True), {}),
    "moe_gqa": ("llama4-scout-17b-a16e", {}, (16, 4, 64, True), {}),
    "moe_gqa_ep_data": ("llama4-scout-17b-a16e", {}, (16, 4, 64, True),
                        {"expert_mode": "ep_data_tp_model"}),
    "moe_mla": ("deepseek-v2-236b", {}, (16, 4, 64, True), {}),
    "vlm": ("qwen2-vl-72b", {}, (16, 4, 64, True), {}),
    "encdec": ("seamless-m4t-large-v2", {}, (16, 4, 64, True), {}),
    "hybrid": ("zamba2-1.2b", {}, (32, 4, 64, True), {}),
    "hybrid_batch2": ("zamba2-1.2b", {}, (32, 2, 64, True), {}),
    "ssm": ("xlstm-1.3b", {}, (16, 4, 64, True), {}),
    "hybrid_second_chunk": ("zamba2-1.2b", {}, (16, 4, 64, True), {"seeded_len": 24}),
    "ssm_second_chunk": ("xlstm-1.3b", {}, (16, 4, 64, True), {"seeded_len": 24}),
    "gqa_6_2_long": ("phi3-medium-14b", dict(n_heads=6, n_kv_heads=2, n_layers=1),
                     (4160, 2, 4224, False), {}),
    "mla_long": ("deepseek-v2-236b", {}, (4160, 2, 4224, False), {}),
    "hybrid_long500k": ("zamba2-1.2b", {}, (None, 1, 8192, True), {}),
    "ssm_long500k": ("xlstm-1.3b", dict(n_layers=4), (None, 1, 8192, True), {}),
}
STEPS = 3

# cache leaves each case must hold split over "model" (mesh dimension 1),
# and on which axis: the sequence, the ring's slots, Mamba's N, a state's
# last axis, the head width
SPLIT = {
    "gqa_4_2": {"main/k": 2, "main/v": 2},
    "gqa_4_2_len256": {"main/k": 2},
    "gqa_head_width": {"main/k": 4, "main/v": 4},
    "dense_qk_norm": {"main/k": 2},
    "dense_mqa": {"main/k": 2},
    "moe_gqa": {"main/k": 2},
    "moe_gqa_ep_data": {"main/k": 2},
    "moe_mla": {"main/c_kv": 2, "main/k_rope": 2, "dense0/c_kv": 2},
    "vlm": {"main/k": 2},
    "encdec": {"self_k": 2, "self_v": 2, "cross_k": 4, "cross_v": 4},
    "hybrid": {"attn_k": 2, "mamba/h": 5, "mamba/conv": 4},
    "hybrid_batch2": {"attn_k": 2, "mamba/h": 5},
    "ssm": {"mlstm/c": 5, "slstm/c": 3},
    "hybrid_second_chunk": {"attn_k": 2, "mamba/h": 5, "mamba/conv": 4},
    "ssm_second_chunk": {"mlstm/c": 5, "mlstm/n": 4, "slstm/c": 3, "slstm/h": 3},
    "gqa_6_2_long": {"main/k": 2},
    "mla_long": {"dense0/c_kv": 2, "main/c_kv": 2},
    "hybrid_long500k": {"attn_k": 2, "attn_v": 2, "mamba/h": 5, "mamba/conv": 4},
    "ssm_long500k": {"mlstm/c": 5, "mlstm/n": 4, "slstm/h": 3},
}


def _prompt(cfg, rng, plen: int, bsz: int) -> dict:
    """The prompt batch as the prefill cell's arguments: tokens and the
    frontends' embeddings (numpy, for both packages)."""
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(bsz, plen))}
    n = cfg.frontend_seq or 16
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.normal(size=(bsz, n, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_frames":
        batch["frame_embeds"] = rng.normal(size=(bsz, n, cfg.d_model)).astype(np.float32)
    return batch


def _extras(cfg, plen: int, bsz: int) -> list:
    """Each decode step's extras: M-RoPE's three position streams, distinct."""
    if cfg.rope_variant != "mrope":
        return [{} for _ in range(STEPS)]
    return [{"positions": np.array([[[plen + i, 2 + i, (5 * i) % 3]]] * bsz)}
            for i in range(STEPS)]


def _seeded_cache(t_model, rng, bsz: int, max_len: int, length: int) -> dict:
    """A cache of seeded values at ``length`` (numpy leaves)."""
    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return length
        return (0.5 * rng.normal(size=tuple(tree.shape))).astype(np.float32)
    return fill(t_model.init_cache(bsz, max_len))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):   # a copy: the port's caches are written in place
        return torch.tensor(tree, dtype=torch.int64 if tree.dtype.kind == "i" else torch.float32)
    return tree


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, int):
        return jnp.int32(tree)
    return jnp.asarray(tree, jnp.int32 if tree.dtype.kind == "i" else jnp.float32)


def _port_run(t_model, t_params, case) -> dict:
    """The port's unsharded prefill (or the seeded cache) and greedy decode."""
    out = {"logits": [], "tokens": []}
    if "batch" in case:
        bsz = case["batch"]["tokens"].shape[0]
        cache = (_torch(case["cache_np"]) if "cache_np" in case
                 else t_model.init_cache(bsz, case["max_len"]))
        logits, cache = t_model.prefill(t_params, case["batch"], cache)
        out["prefill_cache"] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                                for k, v in W.flat(cache).items()}
        out["logits"].append(logits)
        tokens = logits.argmax(-1, keepdim=True)
    else:
        cache, tokens = _torch(case["cache_np"]), case["tokens"]
    for i in range(STEPS):
        out["tokens"].append(tokens)
        logits, cache = t_model.decode_step(t_params, tokens, cache, case["extras"][i] or None)
        out["logits"].append(logits)
        tokens = logits.argmax(-1, keepdim=True)
    out["cache"] = W.flat(cache)
    return out


def _repro_run(j_model, j_params, case) -> dict:
    """``repro``'s prefill (or the seeded cache) and greedy decode, each
    jitted (a few times faster than op by op on the CPU)."""
    prefill, decode = jax.jit(j_model.prefill), jax.jit(j_model.decode_step)
    out = {"logits": [], "tokens": []}
    if "batch" in case:
        batch = {k: _jax(v) for k, v in case["batch_np"].items()}
        bsz = case["batch_np"]["tokens"].shape[0]
        cache = (_jax(case["cache_np"]) if "cache_np" in case
                 else j_model.init_cache(bsz, case["max_len"]))
        logits, cache = prefill(j_params, batch, cache)
        out["logits"].append(torch.tensor(np.asarray(logits)))
        tokens = np.asarray(logits).argmax(-1)[:, None]
    else:
        cache, tokens = _jax(case["cache_np"]), case["tokens"].numpy()
    for i in range(STEPS):
        out["tokens"].append(torch.from_numpy(np.asarray(tokens, np.int64)))
        extras = {k: _jax(v) for k, v in case["extras_np"][i].items()} or None
        logits, cache = decode(j_params, jnp.asarray(tokens, jnp.int32), cache, extras)
        out["logits"].append(torch.tensor(np.asarray(logits)))
        tokens = np.asarray(logits).argmax(-1)[:, None]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(results of the world, references computed here)."""
    in_dir = tmp_path_factory.mktemp("serving_in")
    out_dir = tmp_path_factory.mktemp("serving_out")
    cases, pairs, built = {}, {}, {}
    for i, (name, (arch, widths, (plen, bsz, max_len, _), opts)) in enumerate(CASES.items()):
        key = (arch, tuple(sorted(widths.items())))
        pair = built[key] = built.get(key) or model_pair(arch, **widths)
        cfg, t_model, t_params = pair[0], pair[3], pair[4]
        rng = np.random.default_rng(100 + i)
        case = {"arch": arch, "widths": widths, "max_len": max_len, "steps": STEPS,
                "params": {k: v.clone() for k, v in t_params.state_dict().items()}, **opts}
        extras_np = _extras(cfg, plen or 0, bsz)
        case["extras"] = [_torch(e) for e in extras_np]
        arrays = {}
        if plen is None or "seeded_len" in opts:
            arrays["cache_np"] = _seeded_cache(t_model, rng, bsz, max_len,
                                               opts.get("seeded_len", LONG_LEN))
            case["cache"] = _torch(arrays["cache_np"])
        if plen is None:
            case["tokens"] = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(bsz, 1)))
        else:
            arrays["batch_np"] = _prompt(cfg, rng, plen, bsz)
            case["batch"] = _torch(arrays["batch_np"])
        cases[name] = case
        pairs[name] = (pair, {**case, "extras_np": extras_np, **arrays})
    torch.save(cases, in_dir / "cases.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src")}
    log = open(out_dir / "world.log", "w")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_serving.py"),
                             str(in_dir), str(out_dir), "8"],
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        refs = {}
        for name, ((cfg, j_model, j_params, t_model, t_params), case) in pairs.items():
            refs[name] = {"port": _port_run(t_model, t_params, case)}
            if CASES[name][2][3]:
                refs[name]["repro"] = _repro_run(j_model, j_params, case)
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert proc.returncode == 0, (out_dir / "world.log").read_text()[-4000:]
    return torch.load(out_dir / "results.pt", weights_only=False), refs


def near(got: dict, want: dict, rtol: float) -> float:
    """The largest difference over the tensors of ``want``, as a share of
    the largest value of ``want``; asserts it is within ``rtol``."""
    want = {k: v for k, v in want.items() if isinstance(v, torch.Tensor)}
    scale = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    assert err <= rtol * scale, (err, scale)
    return err


def _result(world, name):
    got = world[0][name]
    assert "error" not in got, got.get("error")
    return got


def _steps(run) -> dict:
    return {str(i): t for i, t in enumerate(run["logits"])}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_the_unsharded_port(world, name):
    got, want = _result(world, name), world[1][name]["port"]
    rtol = RTOL_XLSTM if CASES[name][0] == "xlstm-1.3b" else RTOL
    assert got["placed"]
    assert [t.tolist() for t in got["tokens"]] == [t.tolist() for t in want["tokens"]]
    near(_steps(got), _steps(want), rtol)
    for stage in ("prefill_cache", "cache"):
        if stage not in want:
            continue
        assert set(got[stage]) == set(want[stage])
        assert got[stage]["length"] == want[stage]["length"]
        for key, leaf in want[stage].items():
            if isinstance(leaf, torch.Tensor):
                near({key: got[stage][key]}, {key: leaf}, rtol)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2][3]])
def test_sharded_serving_matches_repro(world, name):
    got, want = _result(world, name), world[1][name]["repro"]
    assert [t.tolist() for t in got["tokens"]] == [t.tolist() for t in want["tokens"]]
    near(_steps(got), _steps(want), RTOL_REPRO)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_leaves_keep_the_cells_layout(world, name):
    """Every returned cache leaf (and the logits) in the cells'
    ``out_shardings`` placements after each step, and the leaves under test
    split over "model" along the axis the case is about."""
    got = _result(world, name)
    assert all(got["layout_ok"]) and got.get("prefill_layout_ok", True)
    for leaf, dim in SPLIT[name].items():
        assert got["cache_placements"][leaf][1] == Shard(dim), (leaf,
                                                                got["cache_placements"][leaf])


def test_long_cases_decode_past_the_ring(world):
    """The long_500k-shaped cases: batch 1 is replicated over "data" (it
    does not divide), the decode runs past zamba2's window, and its writes
    (slots ``4200 % 4096 ..``) land on the first "model" rank while the
    ring's other slots lie on the others."""
    from repro_torch.models.transformer import ZAMBA_WINDOW

    for name in ("hybrid_long500k", "ssm_long500k"):
        got = _result(world, name)
        assert all(pl[0] != Shard(0) for pl in got["cache_placements"].values()
                   if pl is not None)
        assert got["cache"]["length"] == LONG_LEN + STEPS
    assert LONG_LEN > ZAMBA_WINDOW and (LONG_LEN % ZAMBA_WINDOW) < ZAMBA_WINDOW // W.MESH[1]


def test_a_stacked_axis_of_the_batch_size_runs(world):
    """At batch 2, ``state_shardings`` (as the reference's) splits zamba2's
    Mamba2 states ``(groups, every = 2, B, ...)`` over "data" along
    ``every``, the first axis of the batch's size, and leaves the batch
    whole; the steps take such a leaf whole over "data" for the call and
    write it back (``transformer._stacks_whole``): the case above holds it
    to both references."""
    got = _result(world, "hybrid_batch2")
    assert got["cache_placements"]["mamba/h"][0] == Shard(1)
    assert got["cache_placements"]["attn_k"][0] == Shard(1)


def test_decode_never_gathers_a_cache(world):
    """Under the collective counter, a dense decode step hands its collectives as
    many bytes, in as many calls, at ``max_len`` 64 as at 256: nothing that
    crosses the ranks scales with the cache."""
    short, long = _result(world, "gqa_4_2"), _result(world, "gqa_4_2_len256")
    for a, b in zip(short["collectives"], long["collectives"]):
        assert a == b
    assert short["collectives"][0]["bytes"] > 0


def test_the_dry_run_counts_a_decode_steps_collectives(world):
    """The dry run (``launch.dryrun``) of ``gqa_4_2``'s decode cell on a
    fake world of eight ranks, (data 2, model 4), hands its collectives as
    many bytes, in as many calls, kind by kind, as rank 0 of the gloo world
    counted in each of its decode steps: the same step under the same
    counter (``repro_torch.obs.collectives``), fake tensors against real."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    arch, widths, (_, bsz, max_len, _), _ = CASES["gqa_4_2"]
    cfg = W.case_config({"arch": arch, "widths": widths})
    dry = dryrun.run_cell(arch, "decode_32k", multi_pod=False, device="cpu",
                          mesh_shape=W.MESH, cfg=cfg,
                          shape=ShapeConfig("decode_case", "decode", max_len, bsz),
                          verbose=False)
    dry_bytes = {k: v for k, v in dry["collectives"].items() if k not in ("total", "num_ops")}
    steps = _result(world, "gqa_4_2")["collectives"]
    assert len(steps) == STEPS and dry["collectives"]["num_ops"] > 0
    for step in steps:
        assert {k: v["calls"] for k, v in step["by_kind"].items()} == dry["collective_calls"]
        assert {k: float(v["bytes"]) for k, v in step["by_kind"].items()} == dry_bytes


def test_xlstm_moves_this_far_unsharded(world):
    """The ground of xLSTM's tolerance against the unsharded port: the
    port's own unsharded logits lie more than half the other families'
    1e-5 from ``repro``'s (both float32, the sums in other orders, nothing
    sharded; 1.05e-5 on the CPU)."""
    port, repro = world[1]["ssm"]["port"], world[1]["ssm"]["repro"]
    err = near(_steps(port), _steps(repro), RTOL_REPRO)
    scale = max(float(t.abs().max()) for t in repro["logits"])
    assert err >= RTOL / 2 * scale

