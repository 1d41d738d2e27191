"""The reference's reading of served tokens.

A served request is the row the engine ran (its prompt as admitted, with
the wave's left padding) followed by its served tokens; the reference runs
the row and every served token but the last once, forward, in float32, and
reads the logits at the positions that produced the served tokens.  A
served token's gap is how far its reference logit lies below the
reference's best at that position: 0 where the program served the
reference's own greedy choice."""

from __future__ import annotations

import torch

from bench.reference.common import Weights, logits_at, plain_f32


@torch.no_grad()
def reference_logits(family, weights: dict, m: dict, rows: torch.Tensor, k: int, *,
                     precision: str = "f32", batch: int = 2) -> torch.Tensor:
    """(R, k, V) logits at the last ``k`` positions of each token row of
    ``rows`` (R, T), in blocks of ``batch`` rows."""
    w = Weights(weights, precision)
    out = []
    with plain_f32():
        for r in range(0, rows.shape[0], batch):
            h = family.hidden(w, rows[r:r + batch], m)
            t = rows.shape[1]
            out.append(logits_at(w, h, m, torch.arange(t - k, t, device=rows.device)))
            del h
    return torch.cat(out)


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(R, k) gaps of the served tokens (R, k) under the reference logits
    (R, k, V)."""
    return ref.amax(dim=-1) - torch.gather(ref, -1, served[..., None].long())[..., 0]
