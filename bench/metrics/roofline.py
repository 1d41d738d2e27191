"""A kernel's share of its roofline over the traced units: the least time
the chip could take for the launches the window's shapes give (per launch
the larger of its bytes over the HBM rate and its operations over the
unit's peak, from ``bench/kernels/<kernel>.py``), over the device time of
the kernel's launches in the trace.  Nothing to read (None) where the
traced units launch none, where the program's counter disagrees with the
shapes' count, or where the trace holds no time for the kernel."""

import sys

from bench.harness.peaks import FLOP_PER_S, HBM_BYTES_PER_S


def kernel_roofline(ctx: dict, kernel: str):
    launches = ctx["launches"].get(kernel)
    summary = ctx["trace"]
    if not launches or summary is None:
        return None
    n = sum(count for _, count in launches)
    counted = (ctx["counted"] or {}).get(kernel)
    if counted != n:
        print(f"bench: {kernel}: the program counted {counted} launches, the shapes give {n}",
              file=sys.stderr)
        return None
    mod = ctx["kernel_modules"][kernel]
    bound = sum(count * max(mod.nbytes(s) / HBM_BYTES_PER_S, mod.ops(s) / FLOP_PER_S[mod.UNIT])
                for s, count in launches)
    seconds = summary.kernel_seconds(mod.matches)
    return 100.0 * bound / seconds if seconds > 0 else None
