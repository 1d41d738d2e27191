"""The dense decoder family (qwen2-7b): its kernel launches and model FLOPs
by shape, from the config's widths.

Model FLOPs count the matrix products a token needs (2 a weight), the
attention of its visible (query, key) pairs (2 (hd + hd_v) a pair and
head), and nothing for norms, activations, padding or recomputation.
Training counts three times the forward (forward, and the backward's two
products a weight); the LM head is counted at every position in training
and at the positions whose logits serving reads."""

from bench.kernels.pairs import attention_pairs

CHUNKED_ABOVE = 4096   # a longer prefill or training sequence runs B4


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layer_matmul_params(m: dict) -> int:
    d, hd = m["d_model"], _hd(m)
    attn = d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd + m["n_heads"] * hd * d
    return attn + 3 * d * m["d_ff"]


def _attn_flops(m: dict, pairs: int) -> float:
    return 2.0 * 2 * _hd(m) * pairs * m["n_heads"] * m["n_layers"]


def forward_flops(m: dict, length: int, logits: int) -> float:
    """One sequence of ``length`` tokens from position 0, the LM head at
    ``logits`` positions."""
    mm = 2.0 * length * layer_matmul_params(m) * m["n_layers"]
    head = 2.0 * logits * m["d_model"] * m["vocab_size"]
    return mm + head + _attn_flops(m, attention_pairs(length, length, True, None))


def decode_flops(m: dict, position: int) -> float:
    """One decoded token at ``position`` (it sees ``position + 1`` keys)."""
    return (2.0 * layer_matmul_params(m) * m["n_layers"]
            + 2.0 * m["d_model"] * m["vocab_size"] + _attn_flops(m, position + 1))


def train_flops(m: dict, batch: int, seq: int) -> float:
    return 3.0 * batch * forward_flops(m, seq, seq)


def _b4(m: dict, b: int, s: int) -> dict:
    hd = _hd(m)
    return {"b": b, "h": m["n_heads"], "hkv": m["n_kv_heads"], "sq": s, "sk": s, "hd": hd,
            "hd_v": hd, "causal": True, "window": None, "elem": 2}


def prefill_launches(m: dict, b: int, s: int) -> dict:
    """``{kernel: [(shape, launches)]}`` of one prefill of ``b`` rows of
    ``s`` tokens into an empty cache."""
    if s <= CHUNKED_ABOVE:
        return {}
    return {"b4": [(_b4(m, b, s), m["n_layers"])]}


def train_launches(m: dict, b: int, s: int) -> dict:
    """Of one training step (every layer body recomputed in the backward)."""
    if s <= CHUNKED_ABOVE:
        return {}
    return {"b4": [(_b4(m, b, s), 2 * m["n_layers"])],
            "b4_bwd": [(_b4(m, b, s), m["n_layers"])]}
