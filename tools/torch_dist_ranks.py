"""What a rank of a distributed run does on the GPU, shared by
``chip_smoke.py`` (phases ``train_sharded``, ``train_sharded_families`` and
``pipeline``: four ranks as threads on one card) and
``tools/torch_sharded_train.py`` (one process a GPU): the training steps
of any family with their launch and collective counts, the launches a
step of a family calls for, and the pipeline over qwen2-7b's blocks.

Nothing here starts a process group or a rank: each function runs inside a
rank whose group the caller made.  Imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.obs.collectives import CollectiveCount

DEVICE = "cuda"

# the model kernels' launch counters a rank reads, by their smoke names:
# (kernel module, counter, key); on one card each rank, a thread, keeps its
# own (RankCounts)
RANK_KEYS = {
    "flash_attention_kernel": ("flash_attention", "LAUNCHES", "flash_attention_kernel"),
    "flash_attention_kernel.tensor_cores": ("flash_attention", "VARIANT_LAUNCHES",
                                            "tensor_cores"),
    "flash_attention_kernel.cuda_cores": ("flash_attention", "VARIANT_LAUNCHES", "cuda_cores"),
    "flash_attention_bwd_kernel": ("flash_attention", "BWD_LAUNCHES",
                                   "flash_attention_bwd_kernel"),
    "flash_attention_bwd_kernel.tensor_cores": ("flash_attention", "BWD_VARIANT_LAUNCHES",
                                                "tensor_cores"),
    "flash_attention_bwd_kernel.cuda_cores": ("flash_attention", "BWD_VARIANT_LAUNCHES",
                                              "cuda_cores"),
    "mamba_chunk_scan_kernel": ("mamba_scan", "LAUNCHES", "mamba_chunk_scan_kernel"),
    "mamba_chunk_scan_bwd_kernel": ("mamba_scan", "BWD_LAUNCHES",
                                    "mamba_chunk_scan_bwd_kernel"),
}


class RankCounts(dict):
    """A kernel module's launch counter whose increments each thread keeps
    for itself: on one card the ranks are threads of one process, and
    ``COUNTER[key] += 1`` in a wrapper then lands in the calling rank's
    row."""

    def __init__(self, keys):
        super().__init__()
        import threading

        self._keys, self._local, self.by_thread = tuple(keys), threading.local(), {}

    def _mine(self) -> dict:
        import threading

        mine = getattr(self._local, "counts", None)
        if mine is None:
            mine = self._local.counts = dict.fromkeys(self._keys, 0)
            self.by_thread[threading.current_thread().name] = mine
        return mine

    def __getitem__(self, key):
        return self._mine()[key]

    def __setitem__(self, key, value):
        self._mine()[key] = value


def _kernel_module(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


def install_rank_counts() -> None:
    """Give every counter of RANK_KEYS a row per thread (ranks as threads)."""
    for mod_name, counter in {(m, c) for m, c, _ in RANK_KEYS.values()}:
        mod = _kernel_module(mod_name)
        setattr(mod, counter, RankCounts(dict.keys(getattr(mod, counter))))


def rank_launches() -> dict:
    """This rank's B4, B4-bwd, B5 and B5-bwd launches by the smoke's names."""
    return {name: getattr(_kernel_module(m), counter)[key]
            for name, (m, counter, key) in RANK_KEYS.items()}


def reset_rank_launches() -> None:
    for m, counter, key in RANK_KEYS.values():
        getattr(_kernel_module(m), counter)[key] = 0


def step_launches(cfg, seq_len: int) -> dict:
    """The kernel launches one training step of ``cfg`` at ``seq_len``
    tokens calls for on each rank, remat on (a layer body's kernels run
    again in the backward): B4 twice and B4-bwd once for each attention
    layer that takes the chunked core (above 4096 tokens: the decoder-only
    families' layers and the hybrid's shared-block invocations), B5 twice
    and B5-bwd once for each Mamba2 layer; by variant for B4 and B4-bwd
    (``flash_variant``'s table)."""
    from repro_torch.kernels.flash_attention import flash_variant
    from repro_torch.models.common import dtype_of
    from repro_torch.models.transformer import CHUNKED_ABOVE

    attn = mamba = 0
    if cfg.family in ("dense", "moe", "vlm"):
        attn = cfg.n_layers
    elif cfg.family == "hybrid":
        attn, mamba = cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    if seq_len <= CHUNKED_ABOVE:
        attn = 0
    if cfg.attn_kind == "mla":
        hd, hd_v = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim
    else:
        hd = hd_v = cfg.resolved_head_dim
    variant = flash_variant(dtype_of(cfg.dtype), hd, hd_v)
    out = {"flash_attention_kernel": 2 * attn, "flash_attention_bwd_kernel": attn,
           "mamba_chunk_scan_kernel": 2 * mamba, "mamba_chunk_scan_bwd_kernel": mamba}
    for v in ("tensor_cores", "cuda_cores"):
        out[f"flash_attention_kernel.{v}"] = 2 * attn if v == variant else 0
        out[f"flash_attention_bwd_kernel.{v}"] = attn if v == variant else 0
    return out


def depth_config(arch: str, layers: int | None = None):
    """``arch`` at its published widths, ``layers`` of its layers (all of
    them by default)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def train_batches(cfg, seq_len: int, global_batch: int, steps: int, seed: int, *,
                  device: str | None = None):
    from repro_torch.data import DataConfig, SyntheticLMDataset

    data = SyntheticLMDataset(DataConfig(seq_len, global_batch, cfg.vocab_size, seed=seed),
                              cfg, device=device or DEVICE)
    return [data.batch(i) for i in range(steps)]


def module_with(cfg, tensors: dict):
    """The model's parameter module on ``meta``, its parameters replaced by
    ``tensors`` (plain or DTensors)."""
    from repro_torch.models.transformer import Model

    params = Model(cfg, device="meta").init()
    for name, t in tensors.items():
        mod, _, leaf = name.rpartition(".")
        setattr(params.get_submodule(mod), leaf, torch.nn.Parameter(t))
    return params


def train_run(cfg, params, batches, lr: float, *, vocab_chunk: int = 0, mesh=None,
              step1: str = "", device: str | None = None, opt_state=None,
              first_step: int = 0, after_step=None) -> dict:
    """Steps of ``make_train_step`` over ``batches`` (placed on ``mesh``
    when given), each timed and its launches read, and the last one's
    collectives, on ``device`` (default the GPU).  ``step1``: "keep" the parameters after
    the first step (whole, on the host), "join" the gathers of them only (a
    rank other than 0), or "" neither.  ``opt_state``: the optimizer state
    to start from (a restored checkpoint's, ``first_step`` steps in; the
    schedule counts from the state's step); ``after_step(i, params,
    opt_state)`` is called after each step."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.transformer import Model
    from repro_torch.runtime import input_shardings
    from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step

    device = device or DEVICE
    cuda = device.startswith("cuda")
    model = Model(cfg, device=device)
    model.vocab_chunk = vocab_chunk
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, warmup_steps=1,
                                             total_steps=first_step + len(batches)))
    state = init_train_state(params, tcfg)
    if opt_state is not None:
        state.opt_state = opt_state
    step = make_train_step(model.train_loss, tcfg)
    steps, kept = [], None
    for i, batch in enumerate(batches):
        if mesh is not None:
            pl = input_shardings(batch, mesh)
            batch = {k: distribute_tensor(v, mesh, pl[k], src_data_rank=None)
                     for k, v in batch.items()}
        if cuda:
            torch.cuda.synchronize()
        reset_rank_launches()
        last = i == len(batches) - 1   # the counter's dispatch slows every op it sees
        with CollectiveCount() if last else contextlib.nullcontext() as coll:
            t0 = time.perf_counter()
            _, state.opt_state, _, m = step(params, state.opt_state, None, batch, None)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        steps.append({"loss": loss, "grad_norm": gnorm, "seconds": seconds,
                      "launches": rank_launches(),
                      "collectives": coll.summary() if last else None})
        if after_step is not None:
            after_step(i, params, state.opt_state)
        if step1 and i == 0:
            kept = {}
            for k, p in params.named_parameters():
                whole = p.full_tensor() if mesh is not None else p.detach()
                if step1 == "keep":  # on the host: the card's memory is the ranks'
                    kept[k] = whole.to("cpu", copy=True)
            kept = kept or None
    local = sum(t.to_local().numel() * t.to_local().element_size() if mesh is not None
                else t.numel() * t.element_size()
                for t in [*params.parameters(), *state.opt_state["mu"].values(),
                          *state.opt_state["nu"].values()])
    return {"steps": steps, "step1": kept, "state_bytes": local}


class BlockCall(torch.nn.Module):
    """One decoder block as a module with a forward, so that
    ``torch.func.functional_call`` runs it on one layer's slice of the
    stacked stage parameters."""

    def __init__(self, cfg, block):
        super().__init__()
        self.cfg, self.block = cfg, block

    def forward(self, x):
        from repro_torch.models.transformer import CHUNKED_ABOVE, _decoder_block

        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
        return _decoder_block(self.cfg, self.block, x, positions=pos, cache=None, length=0,
                              use_chunked=s > CHUNKED_ABOVE)[0]


def block_stage(call):
    """A stage_fn: the stage's layers in turn, each under remat."""
    def one(p, i, x):
        return torch.func.functional_call(call, {f"block.{k}": v[i] for k, v in p.items()}, (x,))

    def stage(p, x):
        for i in range(next(iter(p.values())).shape[0]):
            x = torch.utils.checkpoint.checkpoint(one, p, i, x, use_reentrant=False)
        return x
    return stage


def block_call(cfg) -> BlockCall:
    """A block to call with a layer's parameters: one for each rank, since
    ``functional_call`` swaps a module's parameters while it runs (on
    ``meta``: every parameter is swapped)."""
    from repro_torch.models.transformer import Model

    return BlockCall(cfg, Model(cfg, device="meta").init().blocks[0])


def setup_pipeline(spec: dict) -> dict:
    """``spec["blocks"]`` blocks of ``spec["arch"]`` (seeded), stacked and
    split into ``spec["mesh"][0]`` stages, and x (``batch``, ``seq_len``,
    d_model) bf16: what every rank of the pipeline shares."""
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import stack_stage_params

    cfg = depth_config(spec["arch"], spec["blocks"])
    blocks = Model(cfg, device=DEVICE).init(spec["seed"]).blocks
    gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"] + 1)
    x = torch.randn((spec["batch"], spec["seq_len"], cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    stacked = {k: v.detach() for k, v in torch.func.stack_module_state(list(blocks))[0].items()}
    n_stages = spec["mesh"][0]
    return {"cfg": cfg, "x": x, "stacked": stacked,
            "staged": stack_stage_params(stacked, n_stages)}


def rank_pipeline(rank: int, world: int, spec: dict, shared: dict, *,
                  gather: bool = True) -> dict:
    """One rank of ``pipeline_apply`` over the shared stages, for each of
    ``spec["n_micro"]``: forward and backward of the output's sum, timed,
    with launches and collectives.  ``gather``: every rank joins the
    gathers of the output and the gradients, and rank 0 keeps them."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import pipeline_apply, pipeline_spec_for, placements

    axes = ("pod", "data")[:len(spec["mesh"])]
    mesh = make_mesh(spec["mesh"], axes, device=DEVICE)
    specs = pipeline_spec_for(shared["staged"])
    stage_fn = block_stage(block_call(shared["cfg"]))
    out = {}
    for n_micro in spec["n_micro"]:
        leaves = {k: torch.nn.Parameter(distribute_tensor(
            v.clone(), mesh, placements(specs[k], mesh), src_data_rank=None))
            for k, v in shared["staged"].items()}
        x = distribute_tensor(shared["x"], mesh, placements(("data",) if "data" in axes else (),
                                                            mesh), src_data_rank=None)
        x.requires_grad_(True)
        torch.cuda.synchronize()
        reset_rank_launches()
        with CollectiveCount() as coll:
            t0 = time.perf_counter()
            y = pipeline_apply(stage_fn, leaves, x, mesh=mesh, n_micro=n_micro)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            y.sum().backward()
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        launches = rank_launches()
        res = {"forward_seconds": fwd_s, "seconds": total_s, "launches": launches,
               "collectives": coll.summary()}
        if gather:
            whole = {"out": y.full_tensor(), "x_grad": x.grad.full_tensor(),
                     "p_grads": {k: v.grad.full_tensor() for k, v in leaves.items()}}
            if rank == 0:
                res.update(whole)
            del whole
        out[n_micro] = res
        del leaves, x, y
    return out


# ----------------------------------------------------------------------
# Serving: the prefill and decode cells
# ----------------------------------------------------------------------


def serve_launches(cfg, prompt_len: int) -> dict:
    """The kernel launches one prefill of ``cfg`` at ``prompt_len`` tokens
    calls for on each rank: B4 once for each attention layer that takes the
    chunked core (above 4096 tokens: the decoder-only families' layers and
    the hybrid's shared-block invocations), B5 once for each Mamba2 layer;
    by variant for B4.  A decode step launches neither (its attention reads
    the cache as stored: ``models.attention.decode_attention``)."""
    step = step_launches(cfg, prompt_len)
    return {k: (v // 2 if "bwd" not in k else 0) for k, v in step.items()}


def serve_batch(cfg, prompt_len: int, batch: int, seed: int):
    """Seeded prompts (tokens and the frontends' embeddings)."""
    out = train_batches(cfg, prompt_len, batch, 1, seed)[0]
    out.pop("labels")
    return out


def _fill(leaf, gen):
    """``leaf`` filled in place with N(0, 1/4) drawn from ``gen``, in its own
    dtype (a card's share of a 32k cache is most of its memory)."""
    return leaf.normal_(0.0, 0.5, generator=gen)


def seeded_cache(cfg, batch: int, max_len: int, length: int, seed: int) -> dict:
    """A whole decode cache of seeded values at ``length`` (every leaf N(0,
    1/4)): a long context without its prefill."""
    from repro_torch.models.transformer import Model

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        return _fill(tree, gen) if isinstance(tree, torch.Tensor) else length
    return fill(Model(cfg, device=DEVICE).init_cache(batch, max_len))


def mesh_cache(cfg, batch: int, max_len: int, mesh, shardings, *, seed: int | None = None,
               length: int = 0) -> dict:
    """The decode cache on ``mesh`` in ``shardings``' layout, each rank
    making its own shards only (a cache of hundreds of GB exists only
    across cards): ``init_cache``'s values (each of its leaves holds one
    value), or with ``seed`` N(0, 1/4) drawn per shard (from ``seed`` and
    the shard's offset) at ``length``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.models.transformer import Model

    shapes = Model(cfg, device="meta").init_cache(batch, max_len)
    values = Model(cfg, device="cpu").init_cache(1, 1)

    def leaf(meta, pl, value):
        if not isinstance(meta, torch.Tensor):
            return length
        shape, offset = compute_local_shape_and_global_offset(meta.shape, mesh, pl)
        if seed is None:
            local = torch.full(shape, float(value.flatten()[0]), dtype=meta.dtype, device=DEVICE)
        else:
            key = seed * 1_000_003 + sum(o * 7919 ** i for i, o in enumerate(offset))
            gen = torch.Generator(device=DEVICE).manual_seed(key % (2**63))
            local = _fill(torch.empty(shape, dtype=meta.dtype, device=DEVICE), gen)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=meta.shape,
                                  stride=meta.stride())

    def walk(s, p, v):
        if isinstance(s, dict):
            return {k: walk(s[k], p[k], v[k]) for k in s}
        return leaf(s, p, v)
    return walk(shapes, shardings, values)


def cache_bytes(cache) -> int:
    """The bytes of a cache's tensors a rank holds (its shards)."""
    total = 0
    for v in cache.values():
        if isinstance(v, dict):
            total += cache_bytes(v)
        elif isinstance(v, torch.Tensor):
            t = v.to_local() if hasattr(v, "to_local") else v
            total += t.numel() * t.element_size()
    return total


def serve_run(cfg, params, *, max_len: int, steps: int, batch=None, cache=None,
              start=None, bsz: int | None = None, mesh=None, forced=None,
              keep: bool = True) -> dict:
    """A prefill of ``batch`` into an empty cache (or ``cache``, a cache
    already filled: a whole one unsharded, one ``mesh_cache`` made on a
    mesh) and the tokens ``start``, then ``steps`` decode steps, greedy or
    taking the tokens ``forced``.  On ``mesh``: ``launch.specs.build_cell``'s prefill and
    decode steps, every argument placed as the cells' ``in_shardings``
    say; else the model's own.  Each phase timed (host clock after a
    synchronise), its launches and the last decode step's collectives read;
    the logits (on the host, with ``keep``) and the tokens of every step."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import Model

    cuda = DEVICE.startswith("cuda")
    bsz = bsz or batch["tokens"].shape[0]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if mesh is not None:
        shape = ShapeConfig("decode_cell", "decode", max_len, bsz)
        cell = build_cell(cfg, shape, mesh)
        _, t_shard, c_shard, _ = cell.in_shardings
        step = cell.step_fn

        def place(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None)

        def whole(t):
            return t.full_tensor()
    else:
        model = Model(cfg, device=DEVICE)
        step = model.decode_step

        def place(t, pl):
            return t

        def whole(t):
            return t
        t_shard = None
    out = {"logits": [], "tokens": [], "decode_seconds": [], "decode_launches": [],
           "collectives": []}
    if batch is not None:
        if mesh is not None:
            pcell = build_cell(cfg, ShapeConfig("prefill_cell", "prefill", max_len, bsz), mesh)
            b_shard = pcell.in_shardings[1]
            batch = {k: place(v, b_shard[k]) for k, v in batch.items()}
            cache = mesh_cache(cfg, bsz, max_len, mesh, c_shard)
            prefill = pcell.step_fn
        else:
            cache, prefill = model.init_cache(bsz, max_len), model.prefill
        sync()
        reset_rank_launches()
        if LaunchHeads._local is not None:
            LaunchHeads.reset()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        full = whole(logits)
        sync()
        out["prefill_seconds"] = time.perf_counter() - t0
        out["prefill_launches"] = rank_launches()
        if LaunchHeads._local is not None:
            out["prefill_heads"] = {k: sorted(v) for k, v in LaunchHeads.seen().items()}
        tokens = full.argmax(-1, keepdim=True)
        if keep:
            out["logits"].append(full.float().cpu())
    else:
        tokens = start
    out["cache_bytes"] = cache_bytes(cache)
    for i in range(steps):
        if forced is not None:
            tokens = forced[i]
        out["tokens"].append(tokens.cpu())
        sync()
        reset_rank_launches()
        t0 = time.perf_counter()
        placed = place(tokens, t_shard)
        last = i == steps - 1   # the counter's dispatch slows every op it sees
        # the step's own collectives: the dry run counts the same
        with CollectiveCount() if last else contextlib.nullcontext() as coll:
            logits, cache = step(params, placed, cache, {})
        full = whole(logits)
        sync()
        out["decode_seconds"].append(time.perf_counter() - t0)
        out["decode_launches"].append(rank_launches())
        if last:
            out["collectives"].append(coll.summary())
        if keep:
            out["logits"].append(full.float().cpu())
        tokens = full.argmax(-1, keepdim=True)
    out["length"] = cache["length"]
    del cache
    return out


def collective_bytes(summary: dict) -> int:
    """The bytes of a ``CollectiveCount.summary()``, all kinds."""
    return sum(v["bytes"] for v in summary.values())


class LaunchHeads:
    """The heads each launch of B4 and B5 ran on, per thread (a rank): B4's
    (query heads, kv heads), B5's heads, as the sets seen since the last
    reset.  ``install()`` wraps the two kernels' ``autograd.Function``\\ s
    where ``kernels.ops`` calls them."""

    _local = None

    @classmethod
    def install(cls) -> None:
        import threading
        import types

        from repro_torch.kernels import ops

        if cls._local is not None:
            return
        cls._local = threading.local()
        for name, kind, heads in (("FlashAttentionFn", "flash_attention_kernel",
                                   lambda a: (a[0].shape[1], a[1].shape[1])),
                                  ("MambaScanFn", "mamba_chunk_scan_kernel",
                                   lambda a: (a[0].shape[1],))):
            orig = getattr(ops, name)

            def apply(*args, _orig=orig, _kind=kind, _heads=heads):
                cls.seen().setdefault(_kind, set()).add(_heads(args))
                return _orig.apply(*args)

            setattr(ops, name, types.SimpleNamespace(apply=apply))

    @classmethod
    def seen(cls) -> dict:
        if not hasattr(cls._local, "seen"):
            cls._local.seen = {}
        return cls._local.seen

    @classmethod
    def reset(cls) -> None:
        cls._local.seen = {}
