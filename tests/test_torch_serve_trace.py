"""The serving engine's and the model's trace spans on the CPU.

A reduced model's engine with a ``Tracer`` under ``torch.profiler`` puts
its spans into the profiler's host events, nested as ``docs/PORT.md``
(section 6, the serving engine's spans) lists them; the tracer changes no
token; with no tracer attached the engine builds no span and opens no
profiler range; a tracer opens none while no profiler records; the
attention core a call reaches names its route; and the engine's counters
count what it served."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHITECTURES, reduce_config
from repro_torch.launch import serve as serve_main
from repro_torch.models import attention as attn_lib
from repro_torch.models.transformer import Model
from repro_torch.obs import NULL_SPAN, MetricsRegistry, Tracer, trace
from repro_torch.serving import ServingConfig, ServingEngine

# prompt lengths and new tokens of the requests: two waves of two on a
# pool of two (the second wave's second request alone decodes longer)
REQUESTS = ((5, 3), (11, 3), (9, 4), (7, 2))
SCFG = ServingConfig(max_batch=2, max_prompt_len=16, max_len=24)


@pytest.fixture(scope="module", params=["qwen2-7b", "zamba2-1.2b"])
def model(request):
    cfg = reduce_config(ARCHITECTURES[request.param], dtype="float32")
    m = Model(cfg, device="cpu")
    return m, m.init(0)


def _serve(model, **obs) -> dict:
    m, params = model
    eng = ServingEngine(m, params, SCFG, rng_seed=1, **obs)
    rng = np.random.default_rng(3)
    for plen, new in REQUESTS:
        eng.submit(rng.integers(1, m.cfg.vocab_size, size=plen), max_new_tokens=new)
    return eng.run_to_completion()


def _host_ranges(prof) -> list:
    """(name, start_ns, end_ns) of the program's ranges among the host
    events of a finished profiler."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("engine.", "model.")) and "CUDA" not in str(e.device_type()):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(ranges, outer, name) -> list:
    return [r for r in ranges if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]]


def test_spans_reach_the_profiler_nested_as_listed(model):
    m, _ = model
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, tracer=tracer)
    ranges = _host_ranges(prof)
    hybrid = m.cfg.family == "hybrid"
    n_attn = m.cfg.n_layers // m.cfg.shared_attn_every if hybrid else m.cfg.n_layers
    prefills = [r for r in ranges if r[0] == "engine.prefill"]
    decodes = [r for r in ranges if r[0] == "engine.decode"]
    # two waves: the first decodes 2 steps (3 tokens), the second 3 (4 tokens)
    assert len(prefills) == 2 and len(decodes) == 5
    for step in prefills:
        for child in ("engine.init_cache", "engine.admit", "engine.pack", "model.prefill",
                      "engine.sample", "engine.push"):
            assert len(_inside(ranges, step, child)) == 1, child
        (call,) = _inside(ranges, step, "model.prefill")
        assert len(_inside(ranges, call, "model.attention")) == n_attn
        assert len(_inside(ranges, call, "model.ffn")) == n_attn
        assert len(_inside(ranges, call, "model.embed")) == 1
        assert len(_inside(ranges, call, "model.logits")) == 1
    for step in decodes:
        for child in ("model.decode_step", "engine.sample", "engine.push"):
            assert len(_inside(ranges, step, child)) == 1, child
        (call,) = _inside(ranges, step, "model.decode_step")
        assert len(_inside(ranges, call, "model.attention")) == n_attn
        assert len(_inside(ranges, call, "model.ffn")) == n_attn
        assert len(_inside(ranges, call, "model.mamba")) == (m.cfg.n_layers if hybrid else 0)
        assert not _inside(ranges, step, "engine.pack")
    # the tracer's own ring holds the same spans, parented as nested
    spans = {s.span_id: s for s in tracer.spans()}
    assert sorted(s.name for s in spans.values()) == sorted(r[0] for r in ranges)
    for s in spans.values():
        if s.name in ("model.decode_step", "engine.sample", "engine.push"):
            assert spans[s.parent_id].name in ("engine.prefill", "engine.decode")
        if s.name == "model.attention":
            assert spans[s.parent_id].name in ("model.prefill", "model.decode_step")


def test_span_attributes_carry_the_wave_and_the_layer(model):
    m, _ = model
    tracer = Tracer()
    _serve(model, tracer=tracer)
    pre = [s.attrs for s in tracer.spans("engine.prefill")]
    assert pre == [
        {"wave": 0, "requests": 2, "prompt_tokens": 16, "padded_tokens": 22, "longest": 11},
        {"wave": 1, "requests": 2, "prompt_tokens": 16, "padded_tokens": 18, "longest": 9},
    ]
    dec = [s.attrs for s in tracer.spans("engine.decode")]
    assert dec == [{"wave": 0, "step": 1, "active": 2}, {"wave": 0, "step": 2, "active": 2},
                   {"wave": 1, "step": 1, "active": 2}, {"wave": 1, "step": 2, "active": 1},
                   {"wave": 1, "step": 3, "active": 1}]
    (init,) = tracer.spans("engine.init_cache")[:1]
    assert init.attrs["bytes"] == sum(
        t.nbytes for t in torch.utils._pytree.tree_leaves(m.init_cache(2, 24))
        if isinstance(t, torch.Tensor))
    attn = tracer.spans("model.attention")
    if m.cfg.family == "hybrid":
        groups = m.cfg.n_layers // m.cfg.shared_attn_every
        assert [a.attrs["group"] for a in attn[:groups]] == list(range(groups))
        mamba = tracer.spans("model.mamba")[:m.cfg.n_layers]
        assert [(a.attrs["group"], a.attrs["layer"]) for a in mamba] == [
            (g, i) for g in range(groups) for i in range(m.cfg.shared_attn_every)]
    else:
        n = m.cfg.n_layers
        assert [a.attrs["layer"] for a in attn[:n]] == list(range(n))
        assert [a.attrs["layer"] for a in tracer.spans("model.ffn")[:n]] == list(range(n))
    # short prompts read their cache; the decode steps too
    assert {a.attrs["route"] for a in attn} == {"decode"}


def test_tracer_changes_no_token(model):
    want = _serve(model)
    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _serve(model, tracer=Tracer(), metrics=reg)
    assert got == want
    assert [len(v) for v in got.values()] == [new for _, new in REQUESTS]


def test_no_tracer_builds_no_span_and_opens_no_range(model, monkeypatch):
    want = _serve(model, tracer=Tracer())

    def refuse(*args, **kwargs):
        raise AssertionError("built with no tracer attached")

    monkeypatch.setattr(trace, "Span", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _serve(model) == want
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _serve(model) == want
    assert _host_ranges(prof) == []


def test_counters_count_tokens_and_steps(model):
    reg = MetricsRegistry()
    _serve(model, metrics=reg)
    assert reg.value("serve_prompt_tokens") == sum(p for p, _ in REQUESTS)
    # each wave pads its rows to its longest prompt: 2 x 11 and 2 x 9
    assert reg.value("serve_padded_tokens") == 2 * 11 + 2 * 9
    assert reg.value("serve_generated_tokens") == sum(n for _, n in REQUESTS)
    assert reg.value("serve_steps", kind="prefill") == 2
    assert reg.value("serve_steps", kind="decode") == 5


def test_bridge_opens_no_range_while_no_profiler_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")

    tracer = Tracer()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with tracer.span("outer", k=1):
        with tracer.span("inner"):
            pass
    assert [s.name for s in tracer.spans()] == ["inner", "outer"]


def test_bridge_range_spans_the_span_and_closes_on_error():
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("engine.outer"):
            with pytest.raises(ValueError):
                with tracer.span("engine.inner"):
                    torch.ones(4).sum()
                    raise ValueError
            torch.ones(4).sum()
    ranges = {r[0]: r for r in _host_ranges(prof)}
    assert set(ranges) == {"engine.outer", "engine.inner"}
    assert ranges["engine.outer"][1] <= ranges["engine.inner"][1]
    assert ranges["engine.inner"][2] <= ranges["engine.outer"][2]
    assert tracer.spans("engine.inner")[0].attrs == {"error": "ValueError"}


def test_active_tracer_nests_and_is_restored():
    assert trace.span("model.x", layer=0) is NULL_SPAN
    a, b = Tracer(), Tracer()
    with a.activate():
        with trace.span("model.x", layer=0):
            with b.activate():
                with trace.span("model.y"):
                    pass
            with trace.span("model.z"):
                pass
    assert trace.span("model.x") is NULL_SPAN
    assert [(s.name, s.attrs) for s in a.spans()] == [("model.z", {}),
                                                      ("model.x", {"layer": 0})]
    assert [s.name for s in b.spans()] == ["model.y"]


def test_disabled_tracer_gives_null_spans_when_active():
    with Tracer(enabled=False).activate():
        assert trace.span("model.x") is NULL_SPAN


def test_trace_module_imports_without_torch():
    code = ("import sys; sys.modules['torch'] = None; "
            "from repro_torch.obs import trace; t = trace.Tracer(); "
            "s = t.span('a'); s.__enter__(); s.__exit__(None, None, None); "
            "print(len(t))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, env={"PYTHONPATH": "src"},
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


# (family, queries, use_chunked, tokens already cached (None: no cache),
# ring, the route the call takes)
ROUTES = [
    ("qwen2-7b", 8, True, None, False, "chunked"),      # training, a long sequence
    ("qwen2-7b", 8, False, None, False, "naive"),
    ("qwen2-7b", 8, True, 0, False, "chunked"),         # the empty-cache prefill route
    ("qwen2-7b", 8, True, 5, False, "decode"),          # a prompt into a cache that holds some
    ("qwen2-7b", 8, False, 0, False, "decode"),         # a short prompt reads the cache
    ("qwen2-7b", 1, False, 5, False, "decode"),         # a decode step
    ("qwen2-7b", 8, True, 0, True, "chunked"),          # the ring: a long prefill
    ("qwen2-7b", 8, False, 0, True, "decode"),          # the ring: a short one
    ("qwen2-7b", 1, False, 5, True, "decode"),          # the ring: a decode step
    ("deepseek-v2-236b", 8, False, None, False, "naive"),   # MLA, decompressed
    ("deepseek-v2-236b", 8, True, 0, False, "chunked"),     # MLA, the empty-cache route
    ("deepseek-v2-236b", 1, False, 5, False, "decode"),     # MLA, the absorbed form
]


@pytest.mark.parametrize("arch,s,chunked,length,ring,want", ROUTES)
def test_attention_route(arch, s, chunked, length, ring, want):
    """The attention core an attention call reaches sets the route on the
    enclosing ``model.attention`` span (the CPU's plain flash attention
    reads ``chunked``; B4 on the card reads ``b4``)."""
    cfg = reduce_config(ARCHITECTURES[arch], dtype="float32")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, s, cfg.d_model, generator=gen)
    pos = torch.arange(s)[None].expand(2, s) + (length or 0)
    slots = 16
    if cfg.attn_kind == "mla":
        p = attn_lib.init_mla(gen, cfg, device="cpu")
        cache = None if length is None else attn_lib.MLACache(
            torch.zeros(2, slots, cfg.mla.kv_lora_rank),
            torch.zeros(2, slots, cfg.mla.qk_rope_head_dim), length)

        def call():
            attn_lib.mla_forward(cfg, p, x, positions=pos, cache=cache, use_chunked=chunked)
    else:
        p = attn_lib.init_attention(gen, cfg, device="cpu")
        kv = (2, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = None if length is None else attn_lib.KVCache(
            torch.zeros(kv), torch.zeros(kv), length)

        def call():
            attn_lib.attention_forward(cfg, p, x, positions=pos, cache=cache,
                                       use_chunked=chunked, ring=ring,
                                       window=slots if ring else None)
    tracer = Tracer()
    with tracer.activate(), trace.span("model.attention", layer=0):
        call()
    assert tracer.spans("model.attention")[0].attrs == {"layer": 0, "route": want}
    call()      # with no active tracer the core sets nothing, and does not fail


def test_annotate_sets_only_the_innermost_span_of_its_name():
    trace.annotate("model.attention", route="naive")     # no active tracer: nothing
    tracer = Tracer()
    with tracer.activate():
        with trace.span("model.attention"):
            with trace.span("model.inner"):
                trace.annotate("model.attention", route="naive")
            trace.annotate("model.attention", route="decode")
        with trace.span("model.prefill"):
            trace.annotate("model.attention", route="b4")
    assert [(s.name, s.attrs) for s in tracer.spans()] == [
        ("model.inner", {}), ("model.attention", {"route": "decode"}), ("model.prefill", {})]


def test_serve_main_writes_the_trace_and_prints_the_counters(tmp_path):
    out = tmp_path / "serve.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_main.main(["--arch", "qwen2-7b", "--reduced", "--requests", "3",
                                "--max-new-tokens", "2", "--prompt-len", "8",
                                "--max-batch", "2", "--device", "cpu",
                                "--trace-out", str(out)]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[1].startswith("[serve] 3 requests, 6 tokens")
    assert lines[2].startswith("[serve] counters: prompt_tokens=")
    assert "generated_tokens=6 steps prefill=2 decode=2;" in lines[2]
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"engine.prefill", "engine.decode", "model.attention", "model.ffn"} <= names
    assert f"{len(events)} trace events in {out}" in lines[2]
