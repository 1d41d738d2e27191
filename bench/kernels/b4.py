"""B4, the flash-attention kernel (``flash_attention_kernel``, both
variants): operations and bytes of one launch.

Shape keys: ``b``, ``h`` (query heads), ``hkv``, ``sq``, ``sk``, ``hd``,
``hd_v``, ``causal``, ``window`` (or None), ``elem`` (bytes an element).
Operations: ``2 (hd + hd_v)`` a visible (query, key) pair (S = q k^T and
P v).  Bytes: q, k and v read once and the output written once."""

from bench.kernels.pairs import attention_pairs

UNIT = "bf16"
# the program's launch counter of this kernel: (module, table, key)
COUNTER = ("repro_torch.kernels.flash_attention", "LAUNCHES", "flash_attention_kernel")


def matches(name: str) -> bool:
    return "flash_attention_kernel" in name


def ops(s: dict) -> float:
    pairs = attention_pairs(s["sq"], s["sk"], s["causal"], s["window"])
    return 2.0 * (s["hd"] + s["hd_v"]) * pairs * s["b"] * s["h"]


def nbytes(s: dict) -> float:
    q = s["b"] * s["h"] * s["sq"] * s["hd"]
    k = s["b"] * s["hkv"] * s["sk"] * s["hd"]
    v = s["b"] * s["hkv"] * s["sk"] * s["hd_v"]
    out = s["b"] * s["h"] * s["sq"] * s["hd_v"]
    return float(q + k + v + out) * s["elem"]
