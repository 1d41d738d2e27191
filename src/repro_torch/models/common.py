"""Shared model building blocks.

Parameters live in ``nn.Module``\\ s (:class:`Dense`, :class:`RMSNorm`,
:class:`Embedding`); the layer math is plain functions that take the
module holding a layer's parameters (``p``) and tensors, with the JAX
package's signatures and layouts, so the parity tests compare like with
like.  A dense weight is stored ``(d_in, d_out)`` and applied as
``x @ w``, as there.

Initialisers draw from an explicit ``torch.Generator`` on the device the
parameters are made on, with the same distributions as the JAX package
(not the same numbers: the two generators differ).  On the ``meta``
device they allocate nothing and draw nothing.  Parameters are trainable
(``requires_grad``); serving runs under ``torch.no_grad`` (``Model.prefill``
and ``Model.decode_step``), so it builds no graph.

Compute dtype follows the config (bf16 by default); normalisation
statistics and softmax accumulate in float32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "Dense",
    "RMSNorm",
    "Embedding",
    "dtype_of",
    "param",
    "normal",
    "dense_init",
    "embed_init",
    "rmsnorm_init",
    "linear",
    "rmsnorm",
    "apply_rope",
    "apply_mrope",
    "softmax_cross_entropy",
    "softmax_cross_entropy_chunked",
    "replicated_like",
    "layout_of",
    "split_heads",
    "merge_heads",
    "embed_lookup",
    "cache_layer",
    "cache_write",
    "cache_write_ring",
    "cache_set",
    "local_range",
    "local_shape_offset",
    "SumAcross",
    "GradIf",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter (``Model.train_loss`` differentiates it)."""
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def normal(gen, shape, *, std: float = 1.0, dtype=torch.float32, device) -> torch.Tensor:
    """``N(0, std²)`` drawn in float32 from ``gen`` and cast to ``dtype``
    (as ``(jax.random.normal(k, shape) * std).astype(dtype)``).  On the
    ``meta`` device: an empty tensor, nothing drawn."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (x * std).to(dtype)


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``(d_in, d_out)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = param(w)
        self.b = None if b is None else param(b)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = param(scale)


class Embedding(nn.Module):
    def __init__(self, embedding: torch.Tensor):
        super().__init__()
        self.embedding = param(embedding)


# ----------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.bfloat16, device) -> Dense:
    w = normal(gen, (d_in, d_out), std=1.0 / math.sqrt(d_in), dtype=dtype, device=device)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w, b)


def embed_init(gen, vocab: int, d_model: int, *, dtype=torch.bfloat16, device) -> Embedding:
    return Embedding(normal(gen, (vocab, d_model), std=0.02, dtype=dtype, device=device))


def rmsnorm_init(d: int, *, dtype=torch.float32, device) -> RMSNorm:
    # norm scales stay float32: they are tiny and precision-sensitive
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


# ----------------------------------------------------------------------
# Core ops
# ----------------------------------------------------------------------


def linear(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def rmsnorm(p: RMSNorm | torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation in float32, result in ``x``'s dtype.  ``p`` is an
    :class:`RMSNorm` or its scale vector (the hybrid model keeps one
    scale row per shared-block invocation)."""
    scale = p if isinstance(p, torch.Tensor) else p.scale
    dt = x.dtype
    xf = x.to(torch.float32)
    rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf / rms) * scale).to(dt)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """(…, dim/2) rotation angles for integer positions, in float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = replicated_like(1.0 / torch.pow(theta, exps), positions)
    return positions[..., None].to(torch.float32) * inv_freq


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor of the global shape that every rank computes alike
    (positions, angles, masks), as a replicated DTensor on ``ref``'s mesh
    when ``ref`` is a DTensor (DTensor refuses plain tensors beside its
    own, 0-d ones apart); else ``t`` itself."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table takes :func:`_embed_sharded`."""
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table: DTensor, tokens) -> DTensor:
    """A vocab-parallel gather from a DTensor table (V, d).

    DTensor's rule for an index into a table split along the vocabulary
    leaves the gradient's scatter without a strategy (PyTorch 2.11 fails it
    on the card), so each rank gathers from its own rows: a dimension of
    the table split over an axis other than the vocabulary's (FSDP's d) is
    gathered first, each token outside the rank's rows reads zeros, and the
    rows' owners sum (the output ``Partial`` over the vocabulary's mesh
    dimensions).  The table's gradient is each rank's scatter of its
    tokens, summed over the batch's mesh dimensions."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    k_pl = tuple(Replicate() if tp == Shard(0) else p
                 for tp, p in zip(t_pl, tokens.placements))
    table, tokens = table.redistribute(mesh, t_pl), tokens.redistribute(mesh, k_pl)
    _, offset = local_shape_offset(table.shape, mesh, t_pl)
    # per mesh dimension: the vocabulary's rows' owners sum the output; the
    # batch's shards sum the table's gradient
    out_pl = tuple(Partial() if tp == Shard(0) else kp for tp, kp in zip(t_pl, k_pl))
    grad_pl = tuple(Partial() if kp != Replicate() else tp for tp, kp in zip(t_pl, k_pl))

    def local(tab, tok):
        idx = tok - offset[0]
        here = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return (torch.where(here[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device)),)

    return local_map(local, out_placements=(out_pl,), in_placements=(t_pl, k_pl),
                     in_grad_placements=(grad_pl, k_pl), device_mesh=mesh)(table, tokens)[0]


def layout_of(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` in the placements of the DTensor ``like``; else ``x``.

    DTensor decides each op's layout from its inputs alone, and nothing
    pins the activations as the JAX package's input shardings pin them for
    the whole program: a gather from a table split along d leaves d split
    for every layer after it, and a residual sum with a row-parallel
    product's partial sums stays partial, so that the next products run on
    every token of the batch on every rank.  The embeddings (B, S, d)
    therefore take the layout of the tokens (B, S) they embed, and each
    residual sum the residual stream's (the batch over the data axes, d
    whole): the all-reduce over "model" after a row-parallel product, as
    tensor parallelism places it."""
    if isinstance(x, DTensor) and isinstance(like, DTensor) and x.placements != like.placements:
        return x.redistribute(like.device_mesh, like.placements)
    return x


# ----------------------------------------------------------------------
# Decode caches
# ----------------------------------------------------------------------
#
# A cache leaf on a mesh is a DTensor in ``runtime.sharding.state_shardings``'
# layout: the batch over the data axes and one more axis (a KV cache's
# sequence or head width, a ring's slots, a state's last axis) over
# "model".  Every write below lands on the ranks that own the positions it
# writes, each rank into its own shard; nothing else of the leaf moves.


def cache_layer(leaf: torch.Tensor, *index: int) -> torch.Tensor:
    """``leaf[index]`` for integer indices of its stacked layer axes: a view
    that writes reach.  A DTensor sharded along one of those axes is
    refused (DTensor would gather it, and a write would land in a copy)."""
    if isinstance(leaf, DTensor) and any(isinstance(p, Shard) and p.dim < len(index)
                                         for p in leaf.placements):
        raise ValueError(f"a cache leaf {tuple(leaf.shape)} sharded along a stacked layer axis "
                         f"({leaf.placements}) has no per-layer view")
    return leaf[index]


def _slab(leaf: DTensor, values: torch.Tensor, dim: int) -> torch.Tensor:
    """The local block of ``values`` (``leaf``'s shape but along ``dim``)
    in ``leaf``'s layout with ``dim`` whole: every rank's share of the
    other dimensions, and all of ``dim``."""
    mesh = leaf.device_mesh
    pl = tuple(Replicate() if p == Shard(dim) else p for p in leaf.placements)
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return values.to(leaf.dtype).redistribute(mesh, pl).to_local()


def local_shape_offset(shape, mesh, placements) -> tuple[list[int], list[int]]:
    """The calling rank's local shard of a tensor of global ``shape`` in
    ``placements`` on ``mesh``: its shape and the global index of its first
    element along each dimension.  Host integers from the rank's mesh
    coordinate, with DTensor's split (``torch.chunk``'s: ceil-sized pieces,
    the last ones short or empty; a dimension sharded over several mesh
    dimensions is split by each in the mesh's order), so the same under
    ``FakeTensorMode`` as on real tensors."""
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d, n = p.dim % len(local), mesh.size(i)
            full = -(-local[d] // n)
            start = min(coord[i] * full, local[d])
            offset[d] += start
            local[d] = min(full, local[d] - start)
    return local, offset


def local_range(leaf: DTensor, dim: int) -> tuple[int, int]:
    """(first global index, count) of ``leaf``'s local shard along ``dim``."""
    shape, offset = local_shape_offset(leaf.shape, leaf.device_mesh, leaf.placements)
    return offset[dim], shape[dim]


def cache_write(leaf: torch.Tensor, values: torch.Tensor, start: int, *, dim: int = 1) -> None:
    """``leaf[..., start:start + n, ...] = values`` along ``dim`` (``n`` =
    ``values.shape[dim]``), in place.  A DTensor leaf: each rank writes the
    part of ``values`` that falls in its own range of ``dim`` (none where
    the range misses it), the values first brought to the leaf's layout
    with ``dim`` whole."""
    n = values.shape[dim]
    if not isinstance(leaf, DTensor):
        leaf[(slice(None),) * dim + (slice(start, start + n),)] = values.to(leaf.dtype)
        return
    vals = _slab(leaf, values, dim)
    lo, size = local_range(leaf, dim)
    a, b = max(lo, start), min(lo + size, start + n)
    if a < b:
        leaf.to_local().narrow(dim, a - lo, b - a).copy_(vals.narrow(dim, a - start, b - a))


def cache_write_ring(leaf: torch.Tensor, values: torch.Tensor, start: int, *,
                     dim: int = 1) -> None:
    """The ring form of :func:`cache_write`: ``values`` of positions
    ``start ..`` written at slots ``position % w`` (``w = leaf.shape[dim]``),
    only the last ``w`` of them when there are more.  A DTensor leaf: each
    rank writes the slots in its own range."""
    w, n = leaf.shape[dim], values.shape[dim]
    if n > w:   # only the last w tokens survive the write
        values, start, n = values.narrow(dim, n - w, w), start + n - w, w
    if not isinstance(leaf, DTensor):
        slots = (start + torch.arange(n, device=values.device)) % w
        leaf[(slice(None),) * dim + (slots,)] = values.to(leaf.dtype)
        return
    vals = _slab(leaf, values, dim)
    lo, size = local_range(leaf, dim)
    local = leaf.to_local()
    # the slots run from start % w up to the ring's end, then from 0: two
    # runs of positions (n <= w, so no slot is written twice); each rank
    # copies the parts of them that fall in its slots lo .. lo + size - 1
    first = min(n, w - start % w)
    for j0, s0, count in ((0, start % w, first), (first, 0, n - first)):
        a, b = max(s0, lo), min(s0 + count, lo + size)
        if a < b:
            local.narrow(dim, a - lo, b - a).copy_(vals.narrow(dim, j0 + a - s0, b - a))


def cache_set(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src`` in place, ``dst`` a cache leaf's (per-layer) view
    and ``src`` of its shape: a DTensor ``src`` is brought to ``dst``'s
    layout first (a state computed in its heads' layout goes back to the
    cache's), and each rank writes its own shard."""
    if not isinstance(dst, DTensor):
        dst[...] = src.to(dst.dtype)
        return
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    dst.to_local().copy_(src.to(dst.dtype).redistribute(mesh, dst.placements).to_local())


def _whole_over_uneven(t: torch.Tensor, dim: int, units: int) -> torch.Tensor:
    """A DTensor ``t`` with dimension ``dim`` gathered over every mesh
    dimension whose shards do not hold whole ``units`` of it; else ``t``."""
    if not isinstance(t, DTensor):
        return t
    mesh, dim = t.device_mesh, dim % t.ndim
    split = math.prod(mesh.size(i) for i, p in enumerate(t.placements) if p == Shard(dim))
    if units % split == 0:
        return t
    pl = tuple(Replicate() if p == Shard(dim) else p for p in t.placements)
    return t.redistribute(mesh, pl)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H·hd) -> (B, S, H, hd).  A DTensor whose last dimension is
    split over ranks in pieces that are not whole heads (28 heads over
    ``model = 16``) is gathered over those ranks first: DTensor cannot
    unflatten an uneven split, and attention re-splits the heads
    (``kernels.ops.flash_attention``)."""
    t = _whole_over_uneven(t, -1, heads)
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


class _WholeGradOver(torch.autograd.Function):
    """``t`` itself; a DTensor gradient split along ``dim`` is gathered
    along it first: ``_WholeGradOver.apply(t, dim)``."""

    @staticmethod
    def forward(ctx, t, dim: int):
        ctx.dim = dim
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and Shard(ctx.dim) in g.placements:
            g = g.redistribute(g.device_mesh, tuple(Replicate() if p == Shard(ctx.dim) else p
                                                    for p in g.placements))
        return g, None


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H·hd); a DTensor whose heads are split
    unevenly over ranks is gathered over them first (see
    :func:`split_heads`), and so is one whose head width is split (the
    cross cache's layout, read by ``attention.decode_attention``): a merged
    axis split inside every head is a strided shard that DTensor's
    products refuse.  Where some mesh dimension does not divide the heads,
    the merged gradient is gathered along H·hd before it is split back
    into heads (DTensor cannot unflatten an uneven split: xLSTM's 4 heads
    over ``model = 16``)."""
    heads = t.shape[2]
    t = _whole_over_uneven(t, 2, heads)
    t = _whole_over_uneven(t, 3, 1)
    out = t.reshape(*t.shape[:2], heads * t.shape[3])
    if isinstance(out, DTensor) and any(heads % out.device_mesh.size(i)
                                        for i in range(out.device_mesh.ndim)):
        out = _WholeGradOver.apply(out, 2)
    return out


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last axis (neox style) by the angles."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = replicated_like(cos.to(x.dtype), x)
    sin = replicated_like(sin.to(x.dtype), x)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    ang = _rope_angles(positions, x.shape[-1], theta)    # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    sections: tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, hd); positions: (B, S, 3),
    the temporal / height / width position ids.

    The hd/2 rotary frequencies split into three contiguous sections, each
    driven by its own position stream; with three equal streams this is
    :func:`apply_rope` exactly (the same angles, in the same order)."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover hd/2 = {hd // 2}")
    s0, s1, _ = sections
    ang = torch.cat([
        _rope_angles(positions[..., 0], hd, theta)[..., :s0],
        _rope_angles(positions[..., 1], hd, theta)[..., s0:s0 + s1],
        _rope_angles(positions[..., 2], hd, theta)[..., s0 + s1:],
    ], dim=-1)                                           # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


# ----------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          ignore_id: int = -100) -> torch.Tensor:
    """Mean token NLL in float32 over the labels that are not ``ignore_id``.
    logits: (..., V); labels: (...).  DTensor logits take
    :func:`_cross_entropy_sharded`."""
    if isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, labels, ignore_id=ignore_id)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = labels != ignore_id
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1)


class SumAcross(torch.autograd.Function):
    """The sum of a tensor over a process group, whose result every rank
    holds: forward an all-reduce, backward the identity (each rank's part
    enters the sum once).  ``SumAcross.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class GradIf(torch.autograd.Function):
    """``t`` itself; its gradient passes where ``keep``, else is zero:
    ``GradIf.apply(t, keep)``.  A value that every rank of a group computes
    alike takes its gradient on one of them, so that the group's gradients
    sum to it once; every rank keeps the same graph (a tensor detached on
    some ranks only would leave their backward without the collectives the
    others wait in)."""

    @staticmethod
    def forward(ctx, t, keep: bool):
        ctx.keep = keep
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


# token rows of the vocab-parallel loss taken at a time: (rows, V/ranks)
# float32 logits, recomputed in the backward
SHARDED_CE_ROWS = 2048


def _ce_rows(lf, m, cols):
    """Each row's sum of ``exp(l - m)`` over a rank's vocabulary columns,
    and the gold logit where the label lies among them (else 0)."""
    lf = lf.to(torch.float32)
    s = torch.exp(lf - m[:, None]).sum(-1)
    here = (cols >= 0) & (cols < lf.shape[-1])
    gold = torch.gather(lf, -1, cols.clamp(0, lf.shape[-1] - 1)[:, None])[:, 0]
    return s, torch.where(here, gold, 0.0)


def _cross_entropy_sharded(logits: DTensor, labels, *, ignore_id: int) -> DTensor:
    """:func:`softmax_cross_entropy` of DTensor logits, vocab-parallel.

    DTensor has no sharding rule for a log-sum-exp and a gather over a
    vocabulary split across ranks (the LM head's columns over
    ``"model"``), and gathering the (B, S, V) logits would cost a rank the
    whole vocabulary.  So each rank takes its local block of token rows and
    vocabulary columns: the row maxima are all-reduced (MAX) over the
    vocabulary's mesh dimensions, then the sums of ``exp(l - max)`` and the
    gold logit (0 where the label lies in another rank's columns) are
    all-reduced (SUM), and the NLL of the local rows is summed.  The rows go
    ``SHARDED_CE_ROWS`` at a time under ``torch.utils.checkpoint``, so a
    rank never holds more than one chunk of float32 logits beside its
    model-dtype block (the maxima are taken first, without a gradient: the
    loss does not depend on them).  The sums over the token rows' mesh
    dimensions are left ``Partial`` and reduced before the division.  The
    same function to float32 rounding (the sum of exponentials runs in
    another order)."""
    mesh = logits.device_mesh
    vd = logits.ndim - 1
    layout = tuple(p if isinstance(p, Shard) else Replicate() for p in logits.placements)
    rows = tuple(p if isinstance(p, Shard) and p.dim < vd else Replicate() for p in layout)
    vocab_groups = [mesh.get_group(i) for i, p in enumerate(layout) if p == Shard(vd)]
    _, offset = local_shape_offset(logits.shape, mesh, layout)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    logits = logits.redistribute(mesh, layout)
    labels = labels.redistribute(mesh, rows)

    def local(lf, lab):
        lf, lab = lf.reshape(-1, lf.shape[-1]), lab.reshape(-1)
        chunks = range(0, lf.shape[0], SHARDED_CE_ROWS)
        with torch.no_grad():
            m = torch.cat([lf[i:i + SHARDED_CE_ROWS].to(torch.float32).amax(-1) for i in chunks])
        for g in vocab_groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        cols = lab - offset[vd]
        parts = [torch.utils.checkpoint.checkpoint(
            _ce_rows, lf[i:i + SHARDED_CE_ROWS], m[i:i + SHARDED_CE_ROWS],
            cols[i:i + SHARDED_CE_ROWS], use_reentrant=False) for i in chunks]
        s = torch.cat([p[0] for p in parts])
        gold = torch.cat([p[1] for p in parts])
        for g in vocab_groups:
            s, gold = SumAcross.apply(s, g), SumAcross.apply(gold, g)
        mask = lab != ignore_id
        return ((m + torch.log(s) - gold) * mask).sum(), mask.sum().to(torch.float32)

    summed = tuple(Partial() if p != Replicate() else Replicate() for p in rows)
    nll, count = local_map(local, out_placements=(summed, summed),
                           in_placements=(layout, rows), device_mesh=mesh)(logits, labels)
    whole = [Replicate()] * mesh.ndim
    return nll.redistribute(mesh, whole) / count.redistribute(mesh, whole).clamp_min(1)


def _ce_chunk(h, wc, col0: int, vocab: int, labels, m, l, gold):
    """One vocab chunk of the online log-sum-exp: the running max ``m``,
    sum ``l`` and gold logit ``gold`` after the columns ``col0 ..``."""
    chunk = wc.shape[1]
    logits = (h @ wc).to(torch.float32)                                # (B, S, c)
    cols = col0 + torch.arange(chunk, device=h.device)
    logits = torch.where(cols < vocab, logits, -1e30)
    m_new = torch.maximum(m, logits.amax(-1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= col0) & (labels < col0 + chunk)
    idx = (labels - col0).clamp(0, chunk - 1)
    gold_here = torch.gather(logits, -1, idx[..., None])[..., 0]
    return m_new, l, torch.where(in_chunk, gold_here, gold)


def softmax_cross_entropy_chunked(
    h: torch.Tensor,        # (B, S, d) final hidden states (already normed)
    head: Dense,            # lm_head, w (d, V)
    labels: torch.Tensor,   # (B, S)
    *,
    chunk: int = 8192,
    ignore_id: int = -100,
) -> torch.Tensor:
    """Cross-entropy without materialising the (B, S, V) logits: vocab
    chunks of ``chunk`` columns (the last zero-padded, its padding masked
    to -1e30) with an online log-sum-exp, as the JAX package's scan.  Each
    chunk runs under ``torch.utils.checkpoint``: autograd keeps only its
    inputs (the (B, S) carries) and recomputes its (B, S, chunk) logits in
    the backward, as ``jax.checkpoint(body)`` does, so live memory is one
    chunk of logits either way."""
    b, s, _ = h.shape
    w = head.w
    vocab = w.shape[1]
    pad = (-vocab) % chunk
    wp = torch.nn.functional.pad(w, (0, pad))
    labels_c = labels.clamp_min(0)
    f32 = torch.float32
    m = torch.full((b, s), -1e30, dtype=f32, device=h.device)
    l = torch.zeros((b, s), dtype=f32, device=h.device)
    gold = torch.zeros((b, s), dtype=f32, device=h.device)
    for col0 in range(0, vocab + pad, chunk):
        m, l, gold = torch.utils.checkpoint.checkpoint(
            _ce_chunk, h, wp[:, col0:col0 + chunk], col0, vocab, labels_c, m, l, gold,
            use_reentrant=False)
    nll = m + torch.log(l.clamp_min(1e-30)) - gold
    mask = labels != ignore_id
    return (nll * mask).sum() / mask.sum().clamp_min(1)
