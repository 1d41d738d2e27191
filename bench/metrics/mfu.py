"""``mfu``: the model FLOPs the traced units' useful tokens need
(``bench/families/<family>.py``: products of the weights, attention's
visible pairs, the scan; no padding, no recomputation) over the traced
window's seconds times the bf16 tensor-core peak, in %."""

from bench.harness.peaks import FLOP_PER_S


def read(ctx: dict):
    s = ctx["trace"]
    if s is None or not ctx["traced_flops"]:
        return None
    return 100.0 * ctx["traced_flops"] / (s.window_s * FLOP_PER_S["bf16"])
