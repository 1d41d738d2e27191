"""``decode_step_ms``: the median host-clock time of the window's decoding
engine steps (each ends when its tokens reach the host), in ms."""

import statistics


def read(ctx: dict):
    steps = ctx["spans"].get("decode_step_ms")
    return statistics.median(steps) if steps else None
