"""``b5_bwd_roofline``: the share of its roofline that b5_bwd reaches in the
traced units (``roofline.kernel_roofline``), in %."""

from bench.metrics.roofline import kernel_roofline


def read(ctx: dict):
    return kernel_roofline(ctx, "b5_bwd")
