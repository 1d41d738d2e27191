"""B5-bwd, the Mamba2 scan's backward kernels (``mamba_scan_bwd_kernel_*``):
operations and bytes of one call.  Shape keys as ``b5``.  Operations: C B^T
once per (batch, chunk); per (batch, head, chunk) four triangular products
and five state products.  Bytes: x and dx, dt (read) with ddt and the
decay's gradient, the log decay and its gradient, B, C and their
gradients, the final state's gradient and dh0, the chunk states and h0."""

UNIT = "tf32"
COUNTER = ("repro_torch.kernels.mamba_scan", "BWD_LAUNCHES", "mamba_chunk_scan_bwd_kernel")


def matches(name: str) -> bool:
    return "mamba_scan_bwd_kernel" in name


def ops(s: dict) -> float:
    b, h, nc, q, p, n = (s[k] for k in ("b", "h", "nc", "q", "p", "n"))
    pairs = q * (q + 1) // 2
    return 2.0 * b * nc * pairs * n + 2.0 * b * h * nc * (pairs * (2 * p + 2 * n)
                                                          + 5 * q * p * n)


def nbytes(s: dict) -> float:
    b, h, nc, q, p, n = (s[k] for k in ("b", "h", "nc", "q", "p", "n"))
    x = b * h * nc * q * p
    dt = b * h * nc * q
    bm = b * nc * q * n
    h0 = b * h * p * n
    states = b * h * nc * p * n
    return 4.0 * (2 * x + 3 * dt + 2 * dt + 2 * bm + 2 * bm + 2 * h0 + states + h0)
