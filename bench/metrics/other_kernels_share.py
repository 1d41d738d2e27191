"""``other_kernels_share``: the share of the device's busy time (the union
of its activity in the traced units) spent in kernels that are neither
matrix products nor a kernel of ``bench/kernels`` (the port's own: B4, B5
and their backward kernels), in %: the eager elementwise and reduction
work around them."""

from bench.harness.trace import is_matmul


def read(ctx: dict):
    s = ctx["trace"]
    if s is None or s.busy_s <= 0:
        return None
    mods = ctx["kernel_modules"].values()
    other = s.kernel_seconds(lambda n: not is_matmul(n) and not any(m.matches(n) for m in mods))
    return 100.0 * other / s.busy_s
