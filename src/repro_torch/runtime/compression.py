"""Gradient compression for the data-parallel all-reduce.

The JAX package's ``runtime/compression.py`` on dicts of tensors, as a
simulated wire: compress, then decompress, so the compressed
representation is what would cross the network.

* **Top-k with error feedback** — per leaf, keep the entries of ``g + r``
  whose magnitude is at least the k-th largest magnitude (``k = max(1,
  int(size frac))``), send them and bank the rest as the next residual.
  The kept set is decided by that threshold value alone (every entry equal
  to it is kept), so the result is ``==`` the JAX package's however the two
  libraries' top-k orders equal magnitudes.
* **Int8 stochastic rounding** — per leaf, ``scale = max|g| / 127`` and
  ``q = clip(floor(g / scale) + [u < frac], -127, 127)`` with ``u`` uniform
  from an explicit ``torch.Generator``: ``E[q scale] = g``.  Its contract
  is that distribution, not the JAX package's draws (the generators
  differ).

A "leaf" is the JAX package's: it stacks a layer's parameters over the
layers in one array, which the port holds as one tensor a layer.  Every
function groups the tensors it is given by their names' JAX leaf
(``convert.jax_leaf_groups``) and compresses a group as one leaf, in the
order the tensors are given (layer order), so the threshold, the scale and
the wire count are those of the JAX leaf; a name the JAX package does not
stack is a leaf of its own.  :func:`wire_bytes` counts what one replica
would send.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.convert import jax_leaf_groups

__all__ = [
    "CompressionState",
    "init_compression_state",
    "topk_compress_with_ef",
    "int8_compress",
    "int8_decompress",
    "wire_bytes",
]


@dataclasses.dataclass
class CompressionState:
    """Error-feedback residuals, one float32 tensor per grad leaf."""

    residual: dict


def init_compression_state(grads_like: Mapping[str, torch.Tensor]) -> CompressionState:
    return CompressionState(residual={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def _leaves(tensors: Mapping[str, torch.Tensor]) -> list[list[str]]:
    """The names of each JAX leaf's tensors, leaves in first-seen order."""
    out: dict[str, list[str]] = {}
    for k, leaf in jax_leaf_groups(tensors).items():
        out.setdefault(leaf, []).append(k)
    return list(out.values())


def _topk_leaf(gs: list, rs: list, frac: float) -> list:
    """[(sparse grad to send, new residual)] of one leaf's tensors."""
    accs = [g.to(torch.float32) + r for g, r in zip(gs, rs)]
    flat = torch.cat([a.reshape(-1) for a in accs])
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k, sorted=True).values[-1]
    out = []
    for g, acc in zip(gs, accs):
        sent = torch.where(acc.abs() >= thresh, acc, 0.0)
        out.append((sent.to(g.dtype), acc - sent))
    return out


def topk_compress_with_ef(grads: Mapping[str, torch.Tensor], state: CompressionState, *,
                          frac: float = 0.01) -> tuple[dict, CompressionState]:
    """Sparsify each leaf to its top-``frac`` entries and bank the residual.
    The returned grads are dense, zero outside the kept entries; the wire
    format would be (index, value) pairs (:func:`wire_bytes`)."""
    sent, resid = {}, {}
    for names in _leaves(grads):
        done = _topk_leaf([grads[k] for k in names], [state.residual[k] for k in names], frac)
        for k, (s_k, r_k) in zip(names, done):
            sent[k], resid[k] = s_k, r_k
    return sent, CompressionState(residual=resid)


def int8_compress(grads: Mapping[str, torch.Tensor],
                  generator: torch.Generator) -> tuple[dict, dict]:
    """Per-leaf linear int8 quantisation with stochastic rounding drawn from
    ``generator`` (on the grads' device).  Returns ``(q8, scales)``, a scale
    for each tensor (its leaf's); ``E[int8_decompress(q8, scales)] == grads``."""
    q8, scales = {}, {}
    for names in _leaves(grads):
        top = torch.stack([grads[k].to(torch.float32).abs().max() for k in names]).max()
        scale = torch.clamp(top, min=1e-30) / 127.0
        for k in names:
            x = grads[k].to(torch.float32) / scale
            lo = torch.floor(x)
            up = torch.rand(x.shape, generator=generator, device=x.device) < (x - lo)
            q8[k] = torch.clamp(lo + up.to(torch.float32), -127, 127).to(torch.int8)
            scales[k] = scale
    return q8, scales


def int8_decompress(q8: Mapping[str, torch.Tensor], scales: Mapping[str, torch.Tensor],
                    dtype: torch.dtype = torch.float32) -> dict:
    return {k: (q.to(torch.float32) * scales[k]).to(dtype) for k, q in q8.items()}


def wire_bytes(grads: Mapping[str, torch.Tensor], *, scheme: str, frac: float = 0.01) -> int:
    """Bytes one replica would put on the wire for a single all-reduce."""
    sizes = [sum(int(grads[k].numel()) for k in names) for names in _leaves(grads)]
    n = sum(sizes)
    if scheme == "none":  # bf16 dense
        return 2 * n
    if scheme == "int8":
        return n + 4 * len(sizes)  # values + scales
    if scheme == "topk":  # (int32 index + f16 value) per kept entry
        return 6 * sum(max(1, int(size * frac)) for size in sizes)
    raise ValueError(scheme)
