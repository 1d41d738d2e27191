"""B4-bwd, the flash-attention backward kernels (``flash_attention_bwd_*``):
operations and bytes of one call (its delta, dq and dk/dv launches
together).  Shape keys as ``b4``.  Operations: ``2 (3 hd + 2 hd_v)`` a
visible pair (S again, dP = dout v^T, dv, dq, dk).  Bytes: q, k, v, the
output and dout read once, dq, dk and dv written once."""

from bench.kernels.pairs import attention_pairs

UNIT = "bf16"
COUNTER = ("repro_torch.kernels.flash_attention", "BWD_LAUNCHES", "flash_attention_bwd_kernel")


def matches(name: str) -> bool:
    return "flash_attention_bwd" in name


def ops(s: dict) -> float:
    pairs = attention_pairs(s["sq"], s["sk"], s["causal"], s["window"])
    return 2.0 * (3 * s["hd"] + 2 * s["hd_v"]) * pairs * s["b"] * s["h"]


def nbytes(s: dict) -> float:
    q = s["b"] * s["h"] * s["sq"] * s["hd"]
    k = s["b"] * s["hkv"] * s["sk"] * s["hd"]
    v = s["b"] * s["hkv"] * s["sk"] * s["hd_v"]
    out = s["b"] * s["h"] * s["sq"] * s["hd_v"]
    return float(2 * (q + k + v) + 2 * out) * s["elem"]
