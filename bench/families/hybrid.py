"""The hybrid family (zamba2-1.2b): Mamba2 layers and one shared attention
and SwiGLU block invoked after every ``shared_attn_every`` of them.  Its
kernel launches and model FLOPs by shape, counted as ``dense`` counts them;
the scan's FLOPs are B5's formula at the real length (the products of the
chunked form), and a decoded token's are the recurrence's (4 P N a head:
the state update and the read-out)."""

import math

from bench.kernels import b5
from bench.kernels.pairs import attention_pairs

CHUNKED_ABOVE = 4096


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def _mamba(m: dict) -> tuple[int, int]:
    d_inner = m["ssm_expand"] * m["d_model"]
    return d_inner, d_inner // m["mamba_headdim"]


def groups(m: dict) -> int:
    return m["n_layers"] // m["shared_attn_every"]


def matmul_params(m: dict) -> int:
    """Weights a token multiplies by, the LM head left out (the shared
    block counted at each invocation)."""
    d, hd = m["d_model"], _hd(m)
    d_inner, heads = _mamba(m)
    mamba = d * (2 * d_inner + 2 * m["ssm_state"] + heads) + d_inner * d
    attn = d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd + m["n_heads"] * hd * d
    return m["n_layers"] * mamba + groups(m) * (attn + 3 * d * m["d_ff"])


def _b5(m: dict, b: int, s: int) -> dict:
    q = min(m["ssm_chunk"], s)
    _, heads = _mamba(m)
    return {"b": b, "h": heads, "nc": math.ceil(s / q), "q": q, "p": m["mamba_headdim"],
            "n": m["ssm_state"]}


def _scan_flops(m: dict, length: int) -> float:
    shape = _b5(m, 1, length)
    return b5.ops(shape) * length / (shape["nc"] * shape["q"]) * m["n_layers"]


def _attn_flops(m: dict, pairs: int) -> float:
    return 2.0 * 2 * _hd(m) * pairs * m["n_heads"] * groups(m)


def forward_flops(m: dict, length: int, logits: int) -> float:
    w = m["attn_window"]
    return (2.0 * length * matmul_params(m) + 2.0 * logits * m["d_model"] * m["vocab_size"]
            + _attn_flops(m, attention_pairs(length, length, True, w))
            + _scan_flops(m, length))


def decode_flops(m: dict, position: int) -> float:
    _, heads = _mamba(m)
    seen = min(position + 1, m["attn_window"])
    return (2.0 * matmul_params(m) + 2.0 * m["d_model"] * m["vocab_size"]
            + _attn_flops(m, seen)
            + 4.0 * heads * m["mamba_headdim"] * m["ssm_state"] * m["n_layers"])


def train_flops(m: dict, batch: int, seq: int) -> float:
    return 3.0 * batch * forward_flops(m, seq, seq)


def _b4(m: dict, b: int, s: int) -> dict:
    hd = _hd(m)
    return {"b": b, "h": m["n_heads"], "hkv": m["n_kv_heads"], "sq": s, "sk": s, "hd": hd,
            "hd_v": hd, "causal": True, "window": m["attn_window"], "elem": 2}


def prefill_launches(m: dict, b: int, s: int) -> dict:
    out = {"b5": [(_b5(m, b, s), m["n_layers"])]}
    if s > CHUNKED_ABOVE:
        out["b4"] = [(_b4(m, b, s), groups(m))]
    return out


def train_launches(m: dict, b: int, s: int) -> dict:
    out = {"b5": [(_b5(m, b, s), 2 * m["n_layers"])],
           "b5_bwd": [(_b5(m, b, s), m["n_layers"])]}
    if s > CHUNKED_ABOVE:
        out["b4"] = [(_b4(m, b, s), 2 * groups(m))]
        out["b4_bwd"] = [(_b4(m, b, s), groups(m))]
    return out
