"""B5, the Mamba2 chunked-scan kernel (``mamba_scan_kernel_*``, its passes
together): operations and bytes of one call, in float32.

Shape keys: ``b``, ``h`` (heads), ``nc`` (chunks), ``q`` (chunk length),
``p`` (head width), ``n`` (state size).  Operations: C B^T once per (batch,
chunk); per (batch, head, chunk) the triangular W x product, the C h^T
read-out and the state update.  Bytes: x and y, dt, the log decay, B, C, and
the entering and final states, once each.  Its products run as 3xTF32 on
the tensor cores, so the bound takes the TF32 rate."""

UNIT = "tf32"
COUNTER = ("repro_torch.kernels.mamba_scan", "LAUNCHES", "mamba_chunk_scan_kernel")


def matches(name: str) -> bool:
    return "mamba_scan_kernel" in name


def ops(s: dict) -> float:
    b, h, nc, q, p, n = (s[k] for k in ("b", "h", "nc", "q", "p", "n"))
    pairs = q * (q + 1) // 2
    return 2.0 * b * nc * pairs * n + 2.0 * b * h * nc * (pairs * p + 2 * q * p * n)


def nbytes(s: dict) -> float:
    b, h, nc, q, p, n = (s[k] for k in ("b", "h", "nc", "q", "p", "n"))
    x = b * h * nc * q * p
    dt = b * h * nc * q
    bm = b * nc * q * n
    h0 = b * h * p * n
    return 4.0 * (2 * x + 2 * dt + 2 * bm + 2 * h0)
