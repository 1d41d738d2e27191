"""B6 (``decode_attention_kernel`` in ``csrc/decode_attention.cu``): its
arithmetic, emulated in PyTorch on the CPU, against the path it replaces
(``models.attention._decode_local``) and the JAX package's
``_flash_decode_attention``; its plain version; its split count; and the
routing predicate that sends a decode to it.

The emulation follows the kernel's decomposition: the slots any row sees,
``[lo, hi)``, cut into tiles of ``TILE`` and the tiles split evenly over
``splits`` blocks; in each block, the scores ``scale q . k`` of its slots in
float32, the softmax once over them (the max over the slots the row sees,
``P = exp(s - max)``, 0 where unseen, and its sum ``l``), and ``O = P V``
with P in float32; then the combine of the blocks' ``(m, l, O)``, each
weighed by ``exp(m - max m)``, and ``O / l``.  Only the order of the float32
sums differs from ``_decode_local`` (which rescales its running sums at each
of its chunks), so fed the same values in float32 the two agree to float32
rounding.  The CUDA kernel itself is held to ``_decode_local`` on the card
by ``chip_smoke.py``."""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import attention as j_attn
from repro_torch.kernels import decode_attention as b6
from repro_torch.models import attention as t_attn
from repro_torch.obs import Tracer, trace

F32_ATOL, F32_RTOL = 2e-6, 1e-5     # float32 sums in another order
BF16_STEP = 2.0**-7                 # one bf16 step of the output: both round an f32 result


def split_ranges(lo: int, hi: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's slots of each block: ``[lo, hi)`` in tiles of TILE,
    ``ceil(tiles / splits)`` tiles a block, the last ones short or empty."""
    tiles = -(-max(hi - lo, 0) // b6.TILE)
    per = -(-tiles // splits)
    out = []
    for s in range(splits):
        t0 = min(tiles, s * per)
        n = min(tiles, t0 + per) - t0
        j0 = lo + t0 * b6.TILE
        out.append((j0, min(hi, j0 + n * b6.TILE)))
    return out


def emulate_b6(q, k, v, q_pos, *, scale, window, splits):
    """B6's decomposition on float32 (B, Sq, H, hd) queries over (B, S, Hkv,
    hd) k and v; returns (B, Sq, H, hd) float32, before the cast."""
    b, sq, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    rows = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * g, hd)
    row_pos = q_pos.repeat_interleave(g)                         # row r = qi g + gi
    lo = max(0, int(q_pos.min()) - window + 1) if window is not None else 0
    hi = min(s, int(q_pos.max()) + 1)
    parts = []
    for j_lo, j_hi in split_ranges(lo, hi, splits):
        if j_hi <= j_lo:     # a block past the visible tiles: m = -inf, l = 0, O = 0
            parts.append((torch.full((b, hkv, sq * g, 1), -math.inf),
                          torch.zeros((b, hkv, sq * g, 1)), torch.zeros((b, hkv, sq * g, hd))))
            continue
        j = torch.arange(j_lo, j_hi)
        scores = (rows @ k[:, j].permute(0, 2, 3, 1)) * scale    # (B, Hkv, Sq g, slots)
        seen = j[None, :] <= row_pos[:, None]
        if window is not None:
            seen = seen & (j[None, :] > row_pos[:, None] - window)
        m = torch.where(seen, scores, -math.inf).amax(-1, keepdim=True)
        p = torch.where(seen, torch.exp(scores - m), 0.0)
        o = p @ v[:, j].permute(0, 2, 1, 3).to(f32)
        parts.append((m, p.sum(-1, keepdim=True), o))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(m == -math.inf, 0.0, torch.exp(m - m_all)) for m, _, _ in parts]
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    num = sum(wi * o for wi, (_, _, o) in zip(w, parts))
    out = torch.where(den > 0, num / den, 0.0)                   # (B, Hkv, Sq g, hd)
    return out.reshape(b, hkv, sq, g, hd).permute(0, 2, 1, 3, 4).reshape(b, sq, h, hd)


def decode_local(q, k, v, q_pos, *, scale, window):
    return t_attn._decode_local([q], [k], v, None, j0=0, q_pos=q_pos, scale=scale,
                                k_pos=t_attn._slot_positions, window=window,
                                score_groups=(), slot_groups=())


def bf16_inputs(case, seed):
    b, h, hkv, s, _, sq, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
            for shape in ((b, sq, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


CASES = [
    # (B, H, Hkv, slots, first position, Sq, hd, window, splits)
    (1, 7, 1, 100, 99, 1, 128, None, 1),      # GQA 7:1, B 1, a length no multiple of a tile
    (8, 28, 4, 300, 257, 1, 128, None, 3),    # the cell's heads, B 8, ragged last split
    (2, 4, 4, 333, 200, 1, 64, None, 8),      # 1:1 at hd 64, more splits than tiles need
    (2, 8, 8, 200, 150, 1, 64, 70, 2),        # a window: the first slots are not read
    (3, 14, 2, 90, 0, 1, 128, None, 4),       # the query at position 0: one slot seen
    (2, 12, 4, 160, 100, 2, 128, None, 2),    # a prompt of 2 into the cache: 6 rows
    (1, 7, 1, 129, 128, 1, 64, 64, 5),        # window ending at a tile's edge, GQA 7:1
]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_decode_local_at_f32_rounding(case):
    q, k, v = (t.float() for t in bf16_inputs(case, 3))
    *_, pos, sq, hd, window, splits = case
    q_pos = pos + torch.arange(sq)
    scale = 1.0 / math.sqrt(hd)
    got = emulate_b6(q, k, v, q_pos, scale=scale, window=window, splits=splits)
    want = decode_local(q, k, v, q_pos, scale=scale, window=window)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[5] == 1 and c[7] is None])
def test_emulation_matches_jax_flash_decode(case):
    """The JAX package's decode of one query at position ``new_len - 1``
    over the slots below ``new_len``, through numpy."""
    q, k, v = bf16_inputs(case, 4)
    *_, pos, _, hd, _, splits = case
    scale = 1.0 / math.sqrt(hd)
    got = emulate_b6(q.float(), k.float(), v.float(), torch.tensor([pos]), scale=scale,
                     window=None, splits=splits)
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = j_attn._flash_decode_attention(qj, kj, vj, jnp.int32(pos + 1), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("case", CASES[:4])
def test_emulation_in_bf16_is_decode_local_to_one_step(case):
    """Fed bf16, both round an f32 result to bf16: at most one step apart."""
    q, k, v = bf16_inputs(case, 5)
    *_, pos, sq, hd, window, splits = case
    q_pos = pos + torch.arange(sq)
    scale = 1.0 / math.sqrt(hd)
    got = emulate_b6(q.float(), k.float(), v.float(), q_pos, scale=scale, window=window,
                     splits=splits).bfloat16().float()
    want = decode_local(q, k, v, q_pos, scale=scale, window=window).float()
    assert bool(((got - want).abs() <= 1e-5 + BF16_STEP * want.abs()).all())


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_decode_local(case):
    """The wrapper on CPU tensors runs the plain version, which counts no
    launch and is ``_decode_local``'s function."""
    q, k, v = (t.float() for t in bf16_inputs(case, 6))
    *_, pos, sq, hd, window, _ = case
    q_pos = pos + torch.arange(sq)
    scale = 1.0 / math.sqrt(hd)
    b6.reset_launches()
    got = b6.decode_attention_kernel(q, k, v, q_pos, scale=scale, window=window)
    assert b6.LAUNCHES == {"decode_attention_kernel": 0}
    torch.testing.assert_close(got, decode_local(q, k, v, q_pos, scale=scale, window=window),
                               atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("lo,hi,splits", [(0, 8193, 8), (0, 8193, 17), (0, 100, 8), (37, 1000, 3),
                                          (5, 5, 4), (0, 64, 1), (0, 65, 2)])
def test_splits_read_each_visible_slot_once(lo, hi, splits):
    ranges = split_ranges(lo, hi, splits)
    assert len(ranges) == splits
    read = [j for a, b in ranges for j in range(a, b)]
    assert read == list(range(lo, hi))
    assert all(a % b6.TILE == lo % b6.TILE for a, b in ranges if b > a)


@pytest.mark.parametrize("pairs,slots,resident,want", [
    (32, 8201, 396, 12),    # the cell: 8 x 4 pairs on 132 SMs x 3 blocks
    (32, 8201, 264, 9),     # 129 tiles, 16 a block at most
    (1, 10, 264, 1),        # one tile: one block
    (600, 8201, 264, 9),    # more pairs than the card holds: 16 tiles a block at most
    (4, 300, 264, 5),       # at most a block a tile
])
def test_decode_splits(pairs, slots, resident, want):
    assert b6.decode_splits(pairs, slots, resident) == want


# ----------------------------------------------------------------------
# The route: B6 where the predicate holds, _decode_local everywhere else
# ----------------------------------------------------------------------


def stand_in(shape, *, device="cuda", dtype=torch.bfloat16):
    """What the predicate reads of a tensor: its device, dtype and shape."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape)


def kv_cache(b=8, s=8201, hkv=4, hd=128, **kw):
    return stand_in((b, s, hkv, hd), **kw), stand_in((b, s, hkv, hd), **kw)


def test_route_takes_b6_for_a_plain_kv_cache_on_the_card():
    k, v = kv_cache()
    q = stand_in((8, 1, 28, 128))
    assert t_attn._takes_b6([q], [k], v, None, t_attn._slot_positions, None)
    assert t_attn._takes_b6([q], [k], v, None, t_attn._slot_positions, 4096)
    assert t_attn._takes_b6([stand_in((2, 1, 8, 64))], [stand_in((2, 50, 8, 64))],
                            stand_in((2, 50, 8, 64)), None, t_attn._slot_positions, None)


@pytest.mark.parametrize("what", ["ring", "cross", "mla", "cpu", "float32", "hd32", "rows",
                                  "window0", "fake", "dtensor"])
def test_route_keeps_decode_local(what, monkeypatch):
    k, v = kv_cache()
    q = stand_in((8, 1, 28, 128))
    qs, ks, v_key, k_pos, window = [q], [k], None, t_attn._slot_positions, None
    if what == "ring":
        k_pos = t_attn._ring_positions(100, 64)
    elif what == "cross":
        k_pos = None
    elif what == "mla":      # MLA's absorbed form: two key parts, the value one of them
        lat = stand_in((8, 8201, 1, 128))
        qs, ks, v, v_key = [q, stand_in((8, 1, 28, 64))], [lat, stand_in((8, 8201, 1, 64))], \
            lat, 0
    elif what == "cpu":
        q, (k, v) = stand_in((8, 1, 28, 128), device="cpu"), kv_cache(device="cpu")
        qs, ks = [q], [k]
    elif what == "float32":
        q, (k, v) = stand_in((8, 1, 28, 128), dtype=torch.float32), kv_cache(dtype=torch.float32)
        qs, ks = [q], [k]
    elif what == "hd32":
        q, (k, v) = stand_in((8, 1, 28, 32)), kv_cache(hd=32)
        qs, ks = [q], [k]
    elif what == "rows":     # a prompt of 2 over GQA 7:1: 14 rows
        qs = [stand_in((8, 2, 28, 128))]
    elif what == "window0":
        window = 0
    elif what == "fake":     # the dry run's fake CUDA tensors
        with FakeTensorMode():
            q = torch.empty((8, 1, 28, 128), dtype=torch.bfloat16, device="cuda")
            k = torch.empty((8, 64, 4, 128), dtype=torch.bfloat16, device="cuda")
            v = torch.empty((8, 64, 4, 128), dtype=torch.bfloat16, device="cuda")
        qs, ks = [q], [k]
    elif what == "dtensor":  # a cache on a mesh
        class Sharded(types.SimpleNamespace):
            pass
        monkeypatch.setattr(t_attn, "DTensor", Sharded)
        v = Sharded(device=torch.device("cuda"), dtype=torch.bfloat16, shape=(8, 8201, 4, 128))
    assert not t_attn._takes_b6(qs, ks, v, v_key, k_pos, window)


def test_decode_attention_calls_b6_and_names_the_route(monkeypatch):
    calls = []

    def kernel(q, k, v, q_pos, *, scale, window=None):
        calls.append((q, k, v, q_pos, scale, window))
        return "out"

    monkeypatch.setattr(t_attn, "decode_attention_kernel", kernel)
    k, v = kv_cache()
    q = stand_in((8, 1, 28, 128))
    q_pos = torch.tensor([8192])
    tracer = Tracer()
    with tracer.activate(), trace.span("model.attention", layer=0):
        out = t_attn.decode_attention([q], [k], v, q_pos=q_pos, scale=0.25,
                                      k_pos=t_attn._slot_positions)
    assert out == "out" and calls == [(q, k, v, q_pos, 0.25, None)]
    assert tracer.spans("model.attention")[0].attrs == {"layer": 0, "route": "b6"}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 7, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 10, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        b6.decode_attention_kernel(q, k, k, torch.tensor([3]), scale=0.1, window=0)
    with pytest.raises(ValueError, match="positions"):
        b6.decode_attention_kernel(q, k, k, torch.tensor([3.0]), scale=0.1)
    with pytest.raises(ValueError, match="multiple"):
        b6.decode_attention_kernel(torch.zeros(1, 1, 7, 64), torch.zeros(1, 10, 2, 64),
                                   torch.zeros(1, 10, 2, 64), torch.tensor([3]), scale=0.1)
    assert b6.takes(q, k, k, None)
    assert not b6.takes(torch.zeros(1, 2, 7, 64, dtype=torch.bfloat16), k, k, None)
