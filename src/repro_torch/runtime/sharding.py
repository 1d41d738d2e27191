"""Sharding rules: parameter, state and input layouts for every family,
and the solver fleet's axis helpers.

A layout is written twice.  A *spec* is the JAX package's
``PartitionSpec`` as a tuple, one entry per tensor dimension: ``None``, a
mesh axis name, or a tuple of axis names (the dimension split over several
axes, the first outermost).  :func:`param_spec` returns the reference's
spec element for element.  *Placements* are DTensor's: one ``Shard(d)`` or
``Replicate()`` per mesh dimension, in the mesh's order
(:func:`placements` turns a spec into them).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh``); the rules
read only its ``mesh_dim_names`` and ``shape``, so any object with those two
attributes stands in for a mesh the process does not have.

The rules are *path-based*, as in the JAX package: a parameter's position
in the JAX parameter tree plus its rank decides its spec.  Every JAX weight
of a layer stack carries the stacked layer axes in front, which no rule
shards; the port holds one module per layer (``blocks.{i}``,
``mamba.{g}.{i}``).
So a parameter's spec is computed on its JAX leaf — the path and the
*stacked* shape that ``convert.jax_leaf_shapes`` gives — and then stripped
of the stacked axes.  The FSDP threshold and the first unsharded axis
that divides ``"data"`` both depend on the stacked shape.

Conventions on the production mesh ((``"pod"``,) ``"data"``, ``"model"``):

* tensor parallelism over ``"model"``: attention ``wq``/``wk``/``wv``
  ``(d, H·hd)`` shard their output dim, ``wo`` its input dim; FFN
  ``w_gate``/``w_up`` the output dim, ``w_down`` the input dim; MoE experts
  ``(E, d, f)`` expert-parallel over ``"model"``; the embedding and the LM
  head shard the vocabulary; norm scales, biases and small vectors stay
  replicated;
* data parallelism over ``"data"`` (and ``"pod"`` on two pods): the batch
  axis of every input and activation;
* FSDP: a leaf of at least ``FSDP_MIN_ELEMENTS`` elements also shards its
  first unsharded trailing axis that ``"data"`` divides.

``expert_mode`` is the MoE experts' layout: ``"ep_model"`` (experts over
``"model"``, FSDP over ``"data"``) or ``"ep_data_tp_model"`` (experts over
``"data"``, d_ff over ``"model"``, no FSDP).  The JAX package sets it with
a module switch (``set_expert_sharding``); here it is a keyword.

JAX's ``use_mesh`` has no counterpart: it activates a mesh for ``jit``,
and a DTensor carries its mesh.  ``solve_batch_spec`` has none either: the
solver fleet's layout is its shard plan
(``repro_torch.core.mcop_shard.shard_plan``), whose ``perm`` puts shard
``s``'s rows in the ``s``-th contiguous block of the permuted batch, and
the dispatcher hands that block to ``mesh.devices[s]``.
"""

from __future__ import annotations

import math
import re
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.convert import jax_leaf_shapes

__all__ = [
    "FSDP_MIN_ELEMENTS",
    "EXPERT_MODES",
    "batch_axes",
    "logical_batch_spec",
    "param_spec",
    "placements",
    "param_specs",
    "param_shardings",
    "place",
    "shard_params",
    "state_shardings",
    "input_shardings",
    "SOLVE_AXIS",
    "solver_axis",
    "solver_shards",
]


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is sharded over ("pod" joins DP when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def _entry(axes: tuple[str, ...]):
    """A spec entry for a dimension split over ``axes``, as ``PartitionSpec``
    writes it: one axis by its name, none as ``None``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def logical_batch_spec(mesh) -> tuple:
    return (_entry(batch_axes(mesh)),)


# ----------------------------------------------------------------------
# Solver-fleet axis plumbing
# ----------------------------------------------------------------------

# canonical axis name of a dedicated solver mesh (launch.mesh.make_solver_mesh)
SOLVE_AXIS = "solve"


def solver_axis(mesh) -> str:
    """The mesh axis a solve batch shards over: ``"solve"`` when the mesh
    has it, else its first axis."""
    names = mesh.axis_names
    return SOLVE_AXIS if SOLVE_AXIS in names else names[0]


def solver_shards(mesh) -> int:
    """Device count along the solver axis (the fleet's shard count)."""
    return len(mesh.devices)


# ----------------------------------------------------------------------
# Parameter rules
# ----------------------------------------------------------------------

# (path regex, rank of the *unstacked* param) → spec for the trailing dims.
# Leading stack axes are padded with None.  Order matters: first match wins.
_RULES: list[tuple[str, int, tuple[Any, ...]]] = [
    # --- embeddings / heads -------------------------------------------
    (r"embed/embedding$", 2, ("model", None)),
    (r"lm_head/w$", 2, (None, "model")),
    # --- MoE (expert-parallel over "model") ------------------------------
    (r"moe/router/w$", 2, (None, None)),                    # small, replicated
    (r"moe/shared/(w_gate|w_up)/w$", 2, (None, "model")),
    (r"moe/shared/w_down/w$", 2, ("model", None)),
    (r"moe/(w_gate|w_up|w_down)$", 3, ("model", None, None)),  # (E, d, f)/(E, f, d)
    # --- MLA projections (before generic attn rules) ----------------------
    (r"attn/w_dq/w$", 2, (None, None)),          # d → q_lora (small rank)
    (r"attn/w_uq/w$", 2, (None, "model")),       # q_lora → H·qk_head
    (r"attn/w_dkv/w$", 2, (None, None)),         # d → kv_lora (+rope)
    (r"attn/w_uk/w$", 2, (None, "model")),       # kv_lora → H·nope
    (r"attn/w_uv/w$", 2, (None, "model")),       # kv_lora → H·v_head
    # --- attention ------------------------------------------------------
    (r"(attn|self_attn|cross_attn|shared_attn)/(wq|wk|wv)/w$", 2, (None, "model")),
    (r"(attn|self_attn|cross_attn|shared_attn)/(wq|wk|wv)/b$", 1, ("model",)),
    (r"(attn|self_attn|cross_attn|shared_attn)/wo/w$", 2, ("model", None)),
    # --- dense FFN --------------------------------------------------------
    (r"(ffn|shared_ffn)/(w_gate|w_up)/w$", 2, (None, "model")),
    (r"(ffn|shared_ffn)/w_down/w$", 2, ("model", None)),
    # --- mamba -----------------------------------------------------------
    (r"in_proj/w$", 2, (None, "model")),         # d → (2·d_inner + 2N + H)
    (r"out_proj/w$", 2, ("model", None)),        # d_inner → d
    (r"conv_w$", 2, (None, "model")),            # (K, conv_channels)
    (r"conv_b$", 1, ("model",)),
    # --- xlstm ------------------------------------------------------------
    (r"(wq|wk|wv|w_up|w_gatez|w_in|w_if)/w$", 2, (None, "model")),
    (r"w_down/w$", 2, ("model", None)),
]

_COMPILED = [(re.compile(pat), rank, spec) for pat, rank, spec in _RULES]
_EXPERTS = re.compile(r"moe/(w_gate|w_up|w_down)$")

# Leaves bigger than this get the FSDP ("data") axis on top of TP — ZeRO-3
# style 2-D weight sharding.  Small tables stay replicated: the all-gather
# would cost more than the memory saved.
FSDP_MIN_ELEMENTS = 1 << 20

# MoE expert-weight layouts: experts over "model" with FSDP over "data"
# (every use all-gathers the FSDP axis of every expert), or experts over
# "data" and d_ff over "model" (the same memory, tokens move instead).
EXPERT_MODES = ("ep_model", "ep_data_tp_model")


def param_spec(path: str, shape: tuple[int, ...], mesh, *, fsdp: bool = True,
               expert_mode: str = "ep_model") -> tuple:
    """The spec of one JAX leaf, given its '/'-joined tree path and shape.

    The TP rule first (the table above), then — for large leaves — the
    first still-unsharded trailing axis that divides the "data" axis is
    sharded over "data" (FSDP / ZeRO-3).  Optimizer moments inherit these
    specs leaf for leaf."""
    if expert_mode not in EXPERT_MODES:
        raise ValueError(f"unknown expert_mode {expert_mode!r}; one of {EXPERT_MODES}")
    sizes = _sizes(mesh)
    have_model = "model" in sizes
    shape = tuple(shape)

    def apply_fsdp(lead_n: int, fixed: list) -> list:
        if not fsdp or "data" not in sizes or sizes["data"] == 1:
            return fixed
        if math.prod(shape) < FSDP_MIN_ELEMENTS:
            return fixed
        for i, (dim, ax) in enumerate(zip(shape[lead_n:], fixed)):
            if ax is None and dim % sizes["data"] == 0 and dim > 1:
                fixed[i] = "data"
                break
        return fixed

    def divisible(lead_n: int, spec) -> list:
        # an axis that does not divide its dimension leaves it replicated
        return [None if ax is not None and dim % sizes.get(ax, 1) else ax
                for dim, ax in zip(shape[lead_n:], spec)]

    for pat, rank, trailing in _COMPILED:
        if pat.search(path):
            if len(shape) < rank:
                break
            lead_n = len(shape) - rank
            if expert_mode == "ep_data_tp_model" and rank == 3 and _EXPERTS.search(path):
                # (E, d, f) / (E, f, d): experts over "data", d_ff over "model"
                trailing = (("data", None, "model") if path.endswith(("w_gate", "w_up"))
                            else ("data", "model", None))
                spec = tuple(a if (a is None or a in sizes) else None for a in trailing)
                return (None,) * lead_n + tuple(divisible(lead_n, spec))  # no extra FSDP
            spec = tuple(a if (a is None or have_model) else None for a in trailing)
            return (None,) * lead_n + tuple(apply_fsdp(lead_n, divisible(lead_n, spec)))
    # unmatched: replicate small leaves, FSDP-shard anything big
    fixed = apply_fsdp(0, [None] * len(shape))
    return tuple(fixed) if any(a is not None for a in fixed) else ()


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension whose axis a spec entry ``d`` names, ``Replicate()`` on the
    others.  A dimension split over several axes shards in the mesh's order
    (the first outermost), so the entry must list them in that order."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        try:
            idx = [names.index(a) for a in axes]
        except ValueError:
            raise ValueError(f"spec {spec} names an axis the mesh {names} lacks") from None
        if idx != sorted(set(idx)):
            raise ValueError(f"spec entry {entry} of {spec} does not follow the mesh's "
                             f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} shards two dimensions over {names[i]!r}")
            out[i] = Shard(dim)
    return tuple(out)


def param_specs(params, mesh, *, fsdp: bool = True, expert_mode: str = "ep_model") -> dict:
    """``{name: spec}`` for a model's parameters (an ``nn.Module`` or a
    ``{name: tensor}`` dict): each computed on the parameter's JAX leaf and
    stripped of the leaf's stacked layer axes.

    The port holds whole layers, so it cannot shard a stacked axis.  The
    rules never do on the production meshes; on a small mesh FSDP can
    (a leaf no rule matches takes its first axis that ``"data"`` divides,
    and that may be the stack: xlstm-1.3b's ``slstm/r`` on ``data = 2``).
    The port then keeps the leaf's layers replicated along that axis: the
    same values, more memory."""
    out = {}
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    ranks = {k: p.ndim for k, p in named}
    for name, (path, stacked) in jax_leaf_shapes(params).items():
        spec = param_spec(path, stacked, mesh, fsdp=fsdp, expert_mode=expert_mode)
        spec = tuple(spec) + (None,) * (len(stacked) - len(spec))
        out[name] = spec[len(stacked) - ranks[name]:]
    return out


def param_shardings(params, mesh, *, fsdp: bool = True,
                    expert_mode: str = "ep_model") -> dict:
    """``{name: placements}`` for a model's parameters (see
    :func:`param_specs`)."""
    return {k: placements(s, mesh) for k, s in
            param_specs(params, mesh, fsdp=fsdp, expert_mode=expert_mode).items()}


def place(t: torch.Tensor, mesh, placements_: tuple) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``placements_`` whose local shard is a copy of its own: it neither
    aliases ``t`` (an in-place update of a replicated shard would write
    into the caller's tensor) nor keeps ``t``'s storage alive."""
    d = distribute_tensor(t.detach(), mesh, placements_, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, placements_, run_check=False,
                              shape=d.shape, stride=d.stride())


def shard_params(params, mesh, *, fsdp: bool = True, expert_mode: str = "ep_model"):
    """Place a model's parameters on ``mesh`` by the rules: each parameter
    of an ``nn.Module`` becomes an ``nn.Parameter`` of a DTensor (in
    place; the module is returned), or each tensor of a ``{name: tensor}``
    dict a DTensor (a new dict).  Every rank must hold the same full
    tensors (a model made from the same seed, or one checkpoint): each keeps
    a copy of its own shards (:func:`place`) and nothing is sent."""
    shardings = param_shardings(params, mesh, fsdp=fsdp, expert_mode=expert_mode)
    if not isinstance(params, nn.Module):
        return {k: place(t, mesh, shardings[k]) for k, t in params.items()}
    for mod_name, mod in params.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{pname}" if mod_name else pname
            d = place(p, mesh, shardings[full])
            setattr(mod, pname, nn.Parameter(d, requires_grad=p.requires_grad))
    return params


# ----------------------------------------------------------------------
# States and inputs
# ----------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def state_shardings(state, mesh, *, batch_size: int | None = None,
                    prefer: str = "largest"):
    """Placements for decode caches and recurrent states, leaf for leaf (a
    nested dict of tensors; a host integer such as a cache's ``length`` is
    replicated).

    Per leaf: the first axis equal to ``batch_size`` shards over the DP
    axes; then one remaining axis divisible by the "model" axis shards over
    "model": the largest (``prefer="largest"``: for a KV cache the
    sequence axis) or the right-most (``prefer="last"``: the head or
    feature axis)."""
    ba = batch_axes(mesh)
    sizes = _sizes(mesh)
    dp = math.prod(sizes[a] for a in ba)
    tp = sizes.get("model", 1)

    def leaf(x):
        shape = _shape(x)
        spec: list = [None] * len(shape)
        b_axis = None
        if batch_size is not None and dp > 1 and batch_size % dp == 0:
            for i, dim in enumerate(shape):
                if dim == batch_size:
                    spec[i] = _entry(ba)
                    b_axis = i
                    break
        if tp > 1:
            cand = [(dim, i) for i, dim in enumerate(shape)
                    if i != b_axis and spec[i] is None and dim % tp == 0 and dim > 1]
            if cand:
                i = max(i for _, i in cand) if prefer == "last" else max(cand)[1]
                spec[i] = "model"
        return placements(tuple(spec), mesh)

    return _tree_map(leaf, state)


def input_shardings(batch, mesh, *, shard_seq: bool = False):
    """Placements for batch inputs (a tensor or a nested dict of them):
    the leading batch axis over the DP axes; ``shard_seq=True`` also axis 1
    (the sequence) over "model", the sequence-parallel layout of the
    long-context cells.  A leaf whose batch the DP axes do not divide is
    replicated."""
    ba = batch_axes(mesh)
    sizes = _sizes(mesh)
    dp = math.prod(sizes[a] for a in ba)

    def leaf(x):
        shape = _shape(x)
        if not shape or shape[0] % max(dp, 1):
            return placements((), mesh)
        spec = [_entry(ba)]
        if (shard_seq and len(shape) >= 2 and "model" in sizes
                and shape[1] % sizes["model"] == 0 and shape[1] > 1):
            spec.append("model")
        return placements(tuple(spec), mesh)

    return _tree_map(leaf, batch)
