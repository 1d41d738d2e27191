"""Serving entry point: batched requests through the KV-cache engine.

    python -m repro_torch.launch.serve --arch zamba2-1.2b --prompt-len 8192
    python -m repro_torch.launch.serve --arch qwen2-vl-72b --reduced --device cpu

First prints the paper's placement report for the serving stage graph:
the decode pool and the prefill pool are the two tiers and MCOP decides
which layer groups would move across under the configured interconnect.
Then builds the model from ``--seed`` (random weights), serves
``--requests`` prompts of random length below ``--prompt-len`` and prints
the throughput.  Every architecture of ``configs`` serves (dense, MoE with
GQA or MLA, VLM, encoder-decoder, hybrid, SSM).  The frontends' stubs are
fed random embeddings drawn from ``--seed``: ``frontend_seq`` patch
embeddings for the vision frontend (every prompt must then be at least
that long: a ``--prompt-len`` not above ``frontend_seq`` is refused), frame
embeddings for the audio one.  Everything runs on
``--device`` (default the GPU; without one this raises ``KernelError``).

``--trace-out PATH`` attaches a tracer and a metrics registry to the
engine: the engine's and the model's spans go to ``PATH`` as Chrome
``trace_event`` JSON (``about://tracing``, Perfetto), and one more line
prints the engine's counters (prompt, padded and generated tokens, steps by
kind).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the serving spans here (Chrome trace JSON)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.placement import TPUV5E_TIER, plan_placement
    from repro_torch.kernels.mcop_phase import require_device
    from repro_torch.models import common
    from repro_torch.models.transformer import build_model
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.profilers.program import stage_specs
    from repro_torch.serving import ServingConfig, ServingEngine

    device = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    shape = ShapeConfig("cli", "decode", 4096, args.max_batch)
    plan = plan_placement(
        stage_specs(cfg, shape, group=max(cfg.n_layers // 8, 1)),
        dataclasses.replace(TPUV5E_TIER, name="decode-pool", chips=64),
        dataclasses.replace(TPUV5E_TIER, name="prefill-pool", chips=192),
    )
    print(
        f"[serve] MCOP placement: cut={plan.mcop_cost:.3e}s "
        f"split={plan.contiguous_boundary}/{plan.stage_tier.shape[0]} "
        f"cut_bytes={plan.cut_bytes:.3e}",
        flush=True,
    )

    model = build_model(cfg, device=device)
    params = model.init(args.seed)
    extras = {}
    lo = 4
    if cfg.frontend != "none":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        embeds = torch.randn((args.max_batch, cfg.frontend_seq, cfg.d_model),
                             generator=gen, device=device).to(common.dtype_of(cfg.dtype))
        if cfg.frontend == "vision_patches":
            if args.prompt_len <= cfg.frontend_seq:
                ap.error(f"--prompt-len {args.prompt_len}: {args.arch} splices "
                         f"{cfg.frontend_seq} patch embeddings into every prompt; "
                         f"give at least {cfg.frontend_seq + 1}")
            extras["patch_embeds"] = embeds
            lo = cfg.frontend_seq
        else:
            extras["frame_embeds"] = embeds
    tracer = metrics = None
    if args.trace_out:
        tracer, metrics = Tracer(capacity=1 << 16), MetricsRegistry()
    engine = ServingEngine(
        model,
        params,
        ServingConfig(
            max_batch=args.max_batch,
            max_prompt_len=args.prompt_len,
            max_len=args.prompt_len + args.max_new_tokens + 1,
        ),
        extras=extras,
        rng_seed=args.seed,
        tracer=tracer,
        metrics=metrics,
    )
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(lo, args.prompt_len))
        engine.submit(
            rng.integers(1, cfg.vocab_size, size=plen),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
        )
    out = engine.run_to_completion()  # every step ends in a copy of tokens to the host
    dt = time.time() - t0
    toks = sum(len(v) for v in out.values())
    print(
        f"[serve] {len(out)} requests, {toks} tokens in {dt:.1f}s "
        f"({toks/max(dt,1e-9):.1f} tok/s aggregate) on {device}",
        flush=True,
    )
    if tracer is not None:
        n = tracer.export_chrome(args.trace_out)
        v = metrics.value
        print(
            f"[serve] counters: prompt_tokens={v('serve_prompt_tokens'):.0f} "
            f"padded_tokens={v('serve_padded_tokens'):.0f} "
            f"generated_tokens={v('serve_generated_tokens'):.0f} "
            f"steps prefill={v('serve_steps', kind='prefill'):.0f} "
            f"decode={v('serve_steps', kind='decode'):.0f}; "
            f"{n} trace events in {args.trace_out}",
            flush=True,
        )
    for uid in list(out)[:3]:
        print(f"[serve]   req {uid}: {out[uid][:12]}…", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
