"""``prefill_ms``: the median host-clock time of the window's prefilling
engine steps (a wave's prompts; each ends when its first tokens reach the
host), in ms.  The card sets it, where the decode steps follow the host."""

import statistics


def read(ctx: dict):
    steps = ctx["spans"].get("prefill_ms")
    return statistics.median(steps) if steps else None
