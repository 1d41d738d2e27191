#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, needs one GPU

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``
(one process per source, all at once), then runs these phases and prints
one JSON object per line:

1. ``env``          — GPU name and power limit, torch / CUDA / nvcc versions,
                      build seconds.
2. ``kernel_checks``— the two MCOP solve kernels (B1, B2) against their plain
                      PyTorch versions on the card at every shape bucket and,
                      for B1, at the last n whose packed adjacency fits a
                      block (warp variant) and the first that does not
                      (scratch variant) (masks equal or equal-cost, cuts to
                      ``rtol=1e-5, atol=1e-5·C_local``), B1 at two
                      graphs-a-block settings (bits equal), the fused kernel
                      against the solve kernel fed with ``batch_weights``,
                      and samples against the f64 oracle.
   ``near_symmetric`` — adjacencies symmetric only to a tolerance: the n = 5
                      input that told B1's warp variant from the reference,
                      and 240 perturbed integer graphs, through
                      ``mcop_batch``, ``mcop`` and ``mcop_min_cut`` on the card
                      (B1's full-row variant, B3's full loop state), masks
                      equal to the f64 reference's (where the plain version
                      on the CPU departs too, an f32 tie, equal to its mask);
                      B1 on both sides of the packed limit and the loop's
                      phase log at n = 200, 256 and 300 against the plain
                      versions.
3. ``model_kernel_checks`` — the flash-attention kernel (B4) and the Mamba2
                      scan kernel (B5) against their plain versions at the
                      hybrid model's prefill shapes and at GQA, odd-length
                      and padded shapes (tolerances stated per shape), B4
                      also at MLA's heads (q/k 192, v 128) at deepseek-v2's
                      prefill (timed beside SDPA) and at the reduced pair
                      (24, 16); each B4 check launches the variant its dtype
                      and head widths call for (tensor cores: bf16 at (64,
                      64), (128, 128) and (192, 128); CUDA cores: the rest).
                      B4's row log-sum-exp L (written for B4-bwd) against
                      torch.logsumexp of the plain scores in f32 and bf16,
                      on both variants, rows without a visible key at 0,
                      and the output beside it bit for bit the output
                      without it.  B6 (decode attention over a KV cache)
                      through ``decode_attention`` against ``_decode_local``,
                      the path it replaces, and a float64 yardstick, at the
                      served decode step (timed for the kernels line) and
                      at windows, 1 to 8 rows, hd 64 and position 0.
                      Then the two backward kernels against autograd of the
                      plain versions, each from the forward's L:
                      B4-bwd at zamba2-1.2b's training shape
                      (bf16, 2 x 32 heads x 8192, window 4096; timed beside
                      SDPA's forward + backward), qwen2-7b's GQA 28/4 at
                      (128, 128) (also at 8192 tokens, and a sharded
                      rank's 14/2, as the distributed phases run them; B4
                      too), odd and padded lengths, MLA's (192, 128)
                      and (24, 16) in f32 and bf16, each launching the
                      variant its dtype and widths call for (tensor cores:
                      bf16 at (64, 64), (128, 128) and (192, 128)); B5-bwd at
                      zamba2-1.2b's training shape (2 x 64 heads x 32 chunks
                      of 256), a ragged final chunk and the reduced widths
                      (tolerances stated per dtype).
4. ``solve_plane``  — ``solve_envs`` / ``mcop_batch`` at full size.
5. ``broker``       — a two-tenant ``OffloadBroker`` tick loop (100 000
                      batched sessions + 256 per-object sessions), one fused
                      ``tick_sessions``, and a replay of the same workload on
                      the f64 reference backend that every placement must
                      match.
   ``solver_fleet`` — the solver fleet (``core/mcop_shard.py``) on a mesh of
                      four repeated ``cuda:0`` entries (every GPU where the
                      host has several) against the unsharded
                      (``mesh=False``) solve, every cut and mask bit for bit:
                      ``solve_envs``
                      with both kernels at K = 13, 4096 (n = 64) and 1024
                      (n = 256), ``mcop_batch`` over 2048 graphs of 5-200
                      vertices and 16 of the first n above the packed limit,
                      one ``tick_sessions`` tick of 100 000 sessions and its
                      empty-miss tick (no launch); a one-device mesh and
                      ``mesh=None`` (one launch) against it; one shard span a
                      shard and one launch a
                      shard holding a row; then two elastic resizes of
                      zamba2-1.2b's stage graph through a broker's elastic
                      lane, each plan equal to a synchronous reference
                      resize.
6. ``serve``        — zamba2-1.2b at full width in bf16 (random weights from
                      seed 0): the placement report of ``launch/serve.py``,
                      then 8 requests of 4608-8192 prompt tokens through the
                      ``ServingEngine`` in two waves of 4, 16 new tokens each;
                      every B4 launch of a prefill on the tensor-core variant.
7. ``serve_replay`` — the same engine at reduced width in f32 on the card and
                      on the CPU (plain versions), prompts of 4100-4608 tokens:
                      greedy tokens equal, prefill logits within tolerance;
                      then the same for qwen2-7b, deepseek-v2, qwen2-vl (over
                      4096 tokens: B4's CUDA-core variant at (16, 16) and
                      MLA's (24, 16)), seamless and xlstm, with the
                      frontends' embeddings.
   ``serve_families`` — qwen2-7b (28 of 28 layers), deepseek-v2-236b (3 of
                      60: the dense one and two MoE), qwen2-vl-72b (4 of 80),
                      seamless-m4t-large-v2 (24 + 24) and xlstm-1.3b (48 of
                      48) at their published widths in bf16 (random weights
                      from seed 0), one at a time, through the engine with
                      the frontends' embeddings: one wave of 4 requests,
                      16 new tokens each; B4 launched 28 / 3 / 4 / 0 / 0
                      times a prefill, all on the tensor-core variant.
   ``train``        — zamba2-1.2b at published widths and all 38 layers
                      trained through ``launch/train.py``'s entry in bf16,
                      2 x 8192 tokens a step, a warm-up step and five more,
                      a checkpoint saved at step 3: losses finite and
                      falling, tokens/s, peak memory, and every step's
                      launches (B4 2 x 19, B4-bwd 19, all on its tensor-core
                      variant, B5 2 x 38, B5-bwd 38);
                      then a run resumed from the step-3 checkpoint alone,
                      whose losses must equal the first run's bit for bit.
   ``train_replay`` — three training steps of reduced zamba2 and qwen2-7b
                      in f32 at 4160 tokens on the card (kernels) and on
                      the CPU (plain versions): loss and gradient norm
                      within 1e-4 relative; B4-bwd on its CUDA-core variant.
   ``train_sharded`` — qwen2-7b at published widths, 4 of its 28 layers,
                      trained sharded (bf16, 2 x 8192 tokens, 3 steps) on a
                      (data 2, model 2) mesh of four ranks run as threads of
                      one child process over PyTorch's threaded process
                      group: every rank launches B4 2 x 4 and B4-bwd 4 times a
                      step on its 14 query / 2 kv heads; losses within 5e-2,
                      parameters after step 1 within 0.15, gradient norms
                      within 5e-3 relative and each leaf's step-1 change
                      within 0.3 of the unsharded change, against the same
                      steps unsharded on the card; an f32 replay at reduced
                      width and 4160 tokens within 1e-5 (each leaf's
                      change within 1e-2); tokens/s,
                      peak memory, collective calls and bytes a rank and step.
   ``train_sharded_families`` — zamba2-1.2b at published widths, 4 of its 38
                      layers (two shared-block invocations), trained sharded
                      like ``train_sharded`` (bf16, 2 x 8192 tokens, 2 steps,
                      (data 2, model 2), four thread ranks): every rank runs
                      B5 2 x 4 and B5-bwd 4 times a step on its 32 of the 64
                      Mamba2 heads and B4 2 x 2 and B4-bwd 2 times on its 16
                      of the shared block's 32 heads; held to the unsharded
                      run on the card and to a float32 step by the limits
                      of TRAIN_SHARDED_HYBRID; then two
                      f32 replays, sharded on the card against unsharded on
                      the CPU (plain versions) within 1e-5 (each leaf's
                      change within 1e-2): the reduced zamba2 at 4160 tokens
                      and the reduced deepseek-v2 with MLA's published
                      (192, 128) heads at 4160 tokens (B4 and B4-bwd on the
                      CUDA cores at (192, 128), 2 heads a rank; the MoE
                      layer's capacity drops over the whole batch).
   ``pipeline``     — qwen2-7b's 4 blocks through ``runtime.pipeline_apply``
                      on (pod 2, data 2), two stages of two, x (8, 8192, 3584)
                      bf16, n_micro 1, 2, 4: output and gradients against the
                      blocks in sequence on the card (within 2^-5 of the
                      largest value), B4 and B4-bwd launches a rank, forward
                      time a slot beside the predicted bubble.
   ``serve_sharded`` — ``launch.specs.build_cell``'s prefill and decode
                      steps on (data 2, model 2), four thread ranks, caches
                      in ``state_shardings``' layouts: qwen2-7b (4 of 28
                      layers) and zamba2-1.2b (4 of 38: two shared-block
                      invocations) in bf16, 2 prompts of 4608 tokens into
                      8192 positions and 8 greedy steps (zamba2 3),
                      zamba2 (4 of 38) at long_500k's shape (a seeded cache
                      of 524 288 positions, 3 steps); every rank's B4 and B5 launches
                      and heads a prefill, none in decode; held to the
                      unsharded run on the card (bf16: against the same run
                      in f32, SERVE_SHARDED's f32_slack), and f32 replays of
                      all three at reduced widths within 1e-5, greedy
                      tokens equal; tokens/s, peak memory, collective bytes
                      a rank and decode step.
   ``dryrun``       — ``launch.dryrun`` in a child process, the fake shards
                      on the card's device: qwen2-7b ``decode_32k`` on a
                      fake world of 256 ranks (16 x 16) and zamba2-1.2b
                      ``prefill_32k`` on 512 (2 x 16 x 16), each rank's
                      FLOPs, bytes, collective bytes by kind, peak memory
                      and roofline terms; zamba2's rank traces B4 19 and B5
                      38 times by shape and launches nothing; then
                      ``serve_sharded``'s qwen2-7b decode cell on a fake
                      world of 4, whose collective calls and bytes by kind
                      must equal what ``serve_sharded`` measured for a
                      decode step.
8. ``min_cut``      — the per-phase kernel (B3) against its plain version on
                      single phases of 6-1024 vertices ((s, t) equal, cuts to
                      ``rtol=1e-5``), then ``kernels.ops.mcop_min_cut`` on the
                      card on the paper example (cut 22, {a, c} local) and on
                      100 random graphs of 5-256 vertices, every mask equal to
                      the f64 ``mcop_reference``'s; the device loop's phase
                      log against the CPU loop's (plain step) on 10 of them
                      and on a graph above the warp variant's n = 256; B3's
                      time (launches captured in one CUDA graph, and back to
                      back through its wrapper), the device loop's time with
                      its rows staged in shared memory and read from L2, and
                      the loop's time per graph.
9. ``serve_broker`` — ``python -m repro_torch.launch.serve_broker --backend
                      cuda`` as a process of its own on the card, driven over a
                      unix socket by a ``BrokerClient``: 300 sessions, 24 ticks,
                      a 2048-slot batch group; replies ``==`` an in-process
                      broker's, placements equal to the f64 reference's; then
                      a server that SIGKILLs itself mid-tick, restarted on its
                      journal and snapshots, whose replies ``==`` the run that
                      was not killed.  Ticks/s and round-trip ms per submit.
10. ``examples_tools`` — the port's examples and tools as a user runs them on
                      the card: ``examples/torch_quickstart.py``,
                      ``torch_serve_lm.py`` (12 requests of 16 tokens) and
                      ``torch_train_lm.py --steps 40`` (finite losses, the
                      smoothed loss falling) in child processes, each model
                      example's placement report equal to its ``--device
                      cpu`` run's; ``torch_adaptive_offload`` in this
                      process, its output on the card ``==`` its output on
                      the CPU, 0 dispatches on its warm restart;
                      ``tools/torch_chaos_trace.py`` at its defaults (every
                      request resolved, faults injected) and
                      ``tools/tracequery.py --audit`` of its trace;
                      ``tools/torch_ipc_smoke.py`` at its defaults (a solver
                      process on the card, 1 000 users over 2 client
                      processes, 6 ticks): every tick reported, solves in
                      the server's reports, ``tracequery --audit`` and
                      ``tools/wire_journal.py --verify`` rc 0, no process
                      left.  Seconds of each run.

Main paths, each driven with every launch counter set to 0 just before
it and read just after: phases 4-5 (the broker tick: B1, B2), phase
``solver_fleet`` (B1 and B2 once per shard holding a row), phase 6
(serving: B4 19 times and B5 38 times per prefill; one B5 call is four
launches of its passes, counted once), each model of phase
``serve_families`` (B4 once per attention layer of a prefill, no other
kernel), each step of phase ``train`` (B4, B4-bwd, B5, B5-bwd) and phase 8 (the per-phase tier: B3 once per MinCutPhase).  A
kernel of a path that was not launched there fails the run; in phases
``train_sharded``, ``train_sharded_families``, ``pipeline`` and
``serve_sharded`` each rank keeps
its own counts (B4, B4-bwd, B5 and B5-bwd),
set to 0 before each step or run and read after it; the server of phase 9 runs B1 in its own
process, so the phase fails unless its tick reports show solves, and so
does the ipc smoke's server in phase 10 (its workers' reports must show
solves); that phase's ``torch_adaptive_offload`` and ``torch_chaos_trace``
runs on the card each set B1's and B2's counts to 0 before and fail unless
one of them was launched (the model examples run reduced configs, whose
prompts take no kernel).  Then a
``kernel_work`` line counts the work of the MCOP kernels' timed shapes
(absorb steps, row traffic, B3's chain and bound terms; computed from the
inputs, not measured), the measured ns per absorb step of B1 and B2 at the
solve-plane shapes (kernel time x graphs the card works on at once / absorb
steps) and of B3, and B3's absorb steps over the per-phase path, with its
kernel time estimated from them and the device loop's timed shapes; a
``{"kernels": [...]}`` line gives, for all five kernels, the two
backward kernels (B4-bwd with its variant) and B6, its launches on
its main path (B1 and B2 also on the fleet path, B4 also on the families'
paths and at MLA's heads, B6 on the families' decode steps), its measured
time, its plain version's measured
time, the time of one PyTorch call computing the same function where there
is one,
and its roofline bound at the main path's shape (B4 and B5 also their
achieved TFLOP/s and share of the bound; B5's bound against the TF32 rate
its products run at, the f32 rate's beside it); the GPU's name and power
limit; and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero; without a GPU nothing runs.

Switches for work on the kernels (environment variables, all off by default):
``SMOKE_PTXAS=1`` rebuilds with ``-Xptxas -v`` and prints registers and
spills; ``SMOKE_ONLY_CHECKS=1`` stops after phase 3; ``SMOKE_CHECK_MIN_N=342``
skips phase 2's shapes below that vertex count (on an H100 what is left runs
the solve kernels' scratch-matrix variant only; a value above 768 skips phase
2's shapes altogether); ``SMOKE_PROFILE=1`` wraps the timed broker ticks in
``torch.profiler`` and reports the GPU's busy time and idle share.  The
served model's device time by step is the benchmark's (``bench/``, with
the engine's trace spans).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.append(os.path.join(ROOT, "tools"))

import torch_dist_ranks as ranks  # noqa: E402  (a rank's work in train_sharded, pipeline)

RTOL = 1e-5          # cut tolerance: f32 sums taken in different orders
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM data sheet, dense tensor cores
SMEM_BYTES_PER_S = 132 * 128 * 1.755e9  # 132 SMs x 128 B/clk x boost clock

DEVICE = "cuda"
# solve kernel checks: (n, kernel batch, plain batch, f64 oracle samples);
# the plain version is a Python loop of ~n^2/2 steps, so its batch shrinks
# (at n=64 and n=256 the batch exceeds the blocks the card keeps resident, so
# blocks walk over several graphs and reuse their scratch).  The plain
# version's time is set by its step count, not its batch, so the shapes that
# run the scratch-matrix variant (n above ~235) get tens of plain graphs too;
# at n=768 one plain graph takes ~26 s on an H100's host, so one is held.
SW_CHECKS = ((16, 2048, 2048, 8), (64, 4096, 256, 4), (256, 1200, 32, 2),
             (320, 132, 16, 2), (768, 2, 1, 0))
# fused kernel checks: (n, kernel batch, plain batch); all kinds up to 256
FUSED_CHECKS = ((16, 2048, 2048), (64, 1024, 256), (256, 264, 16), (512, 2, 2))
CHECK_MIN_N = int(os.environ.get("SMOKE_CHECK_MIN_N", "0"))
TOO_BIG = 832                      # above both kernels' stated bounds
PLANE = ((64, 4096, "weighted"), (256, 1024, "time"))   # (n, K, cost model)
HETERO = (2048, 5, 200)            # graphs, smallest, largest
BROKER = {"u": 100_000, "users_b": 256, "steps_b": 6, "n_b": 64, "replay_u": 2_000}
LINE_SHAPE = (64, 4096)            # (n, K) of the per-kernel line
FLEET_REPS = 5                     # host-clock readings of each fleet call
BROKER_PATH_KERNELS = ("mcop_stoer_wagner_kernel", "mcop_fused_solve_kernel")

# flash-attention checks: (B, H, Hkv, Sq, Sk, hd, causal, window, dtype,
# layout).  The first is the hybrid model's prefill (zamba2-1.2b: 32 heads
# of 64, a 4096-token window, 8192-token prompts, a wave of 4) and gives the
# kernel's line; then GQA at hd 128, f32 over 4096-key rows, and odd
# lengths with a window on full attention, in f32 and on the tensor cores,
# odd lengths with more keys than queries at hd 128, a narrow bf16 head, and
# qwen2-7b's heads at 8192 tokens as the distributed phases hand them to
# B4: a rank's 14 q / 2 kv heads in train_sharded, the pipeline's 28 / 4 over
# a stage's largest microbatch.
# Layout "model": transpose(1, 2) views of (B, S, H, hd) tensors, as
# chunked_attention hands them over; "heads": contiguous (B, H, S, hd).  The
# bf16 cases at hd 64 and 128 must run the tensor-core variant, the others
# the CUDA-core one (expected_flash_variant).
FLASH_CHECKS = (
    (4, 32, 32, 8192, 8192, 64, True, 4096, "bfloat16", "model"),
    (2, 28, 4, 4096, 4096, 128, True, None, "bfloat16", "model"),
    (1, 32, 32, 4500, 4500, 64, True, 4096, "float32", "heads"),
    (3, 2, 2, 17, 63, 8, False, 16, "float32", "heads"),
    (2, 4, 2, 1000, 1337, 64, False, 300, "float32", "model"),
    (2, 4, 2, 1000, 1337, 64, False, 300, "bfloat16", "model"),
    (1, 8, 2, 333, 517, 128, True, 100, "bfloat16", "heads"),
    (2, 4, 2, 1000, 1337, 32, True, 300, "bfloat16", "model"),
    (1, 14, 2, 8192, 8192, 128, True, None, "bfloat16", "model"),
    (4, 28, 4, 8192, 8192, 128, True, None, "bfloat16", "model"),
    (1, 16, 16, 8192, 8192, 64, True, 4096, "bfloat16", "model"),
    (1, 2, 2, 4160, 4160, 16, True, 4096, "float32", "model"),
    (1, 14, 2, 4608, 4608, 128, True, None, "bfloat16", "model"),
    (1, 16, 16, 4608, 4608, 64, True, 4096, "bfloat16", "model"),
    (1, 2, 1, 4608, 4608, 16, True, None, "float32", "model"),
    (1, 2, 2, 4608, 4608, 16, True, 4096, "float32", "model"),
)
# then zamba2's shared block as train_sharded_families hands it to B4 on a
# rank (16 of 32 heads; the f32 replay's 2 of 4); and a rank's prefill in
# serve_sharded (a prompt of 4608 tokens): qwen2-7b's 14 / 2 heads, zamba2's
# 16 of 32, and the f32 runs' qwen2-7b 2 / 1 and zamba2 2 of 4.
# (atol, rtol) by dtype.  bf16: both sides round an f32 result to bf16, so
# they may differ by one bf16 step of the output, at most 2^-7 |o|, plus
# what f32 sums in another order leave before the rounding (under 1e-6 in
# the f32 cases).  With unit-normal q, k, v and scale 1/sqrt(hd) a row of
# the prefill shape spreads over ~1500 keys and |o| is ~0.02 on average:
# there the bf16 tolerance is ~1.7e-4, under 1 % of a typical output (a
# uniform error of 0.0156 fails wherever |o| < 2).  f32: sums in another
# order.  Each check reports the mean |o| and the tolerance there.
FLASH_TOL = {"bfloat16": (1e-5, 2.0**-7), "float32": (2e-5, 2e-5)}
# MLA's heads: q/k of 192 and values of 128 (an 11th field, hd_v).  First the
# deepseek-v2 prefill phase serve_families runs (128 heads, a wave of 4
# prompts of up to 6144 tokens), timed for the kernels line beside SDPA on
# the same inputs; then odd lengths with a window, full attention, and the
# reduced pair (24, 16) of the f32 replay (CUDA cores, instantiated for it).
MLA_FLASH_CHECKS = (
    (4, 128, 128, 6144, 6144, 192, True, None, "bfloat16", "model", 128),
    (2, 4, 4, 1000, 1337, 192, False, 300, "bfloat16", "heads", 128),
    (1, 8, 8, 700, 700, 192, True, None, "float32", "model", 128),
    (2, 4, 4, 4200, 4200, 24, True, None, "float32", "model", 16),
    (1, 2, 2, 4160, 4160, 192, True, None, "float32", "model", 128),
    (1, 64, 64, 8192, 8192, 192, True, None, "bfloat16", "model", 128),
)
# the last two: MLA's heads on a rank of (data 2, model 2): the f32 replay
# of train_sharded_families (2 of 4 heads) and deepseek-v2 at published
# widths as tools/torch_sharded_train.py runs it (64 of 128 heads).


def expected_flash_variant(dtype: str, hd: int, hd_v: int | None = None) -> str:
    """The B4 (and B4-bwd) variant a check of ``dtype`` and ``(hd, hd_v)``
    must launch."""
    pair = (hd, hd if hd_v is None else hd_v)
    return ("tensor_cores" if dtype == "bfloat16" and pair in ((64, 64), (128, 128), (192, 128))
            else "cuda_cores")


# Mamba2 scan checks: (B, S real, S padded, H, P, N, Q, layout).  The hybrid
# model's prefill (64 heads, 64 x 64 state, chunk 256, a wave of 4 prompts
# of 8192) gives the kernel's line; then a prompt padded to the chunk as
# mamba2_forward pads it (dt = 0 on the padded steps), and the reduced
# model's widths that phase serve_replay runs.  Layout "model": views of
# step-major (B, S, H, P) / (B, S, H) / (B, S, N) tensors, as the bf16
# model's cast to f32 gives them; "slices": x, Bm and Cm are slices of one
# (B, S, H P + 2 N) tensor, as in the f32 model; "heads": contiguous.
MAMBA_CHECKS = (
    (4, 8192, 8192, 64, 64, 64, 256, "model"),
    (2, 4100, 4352, 64, 64, 64, 256, "heads"),
    (2, 4100, 4112, 8, 16, 16, 16, "slices"),
    (1, 8192, 8192, 32, 64, 64, 256, "model"),
    (1, 4160, 4160, 4, 16, 16, 16, "model"),
    (1, 4608, 4608, 32, 64, 64, 256, "model"),
    (1, 4608, 4608, 4, 16, 16, 16, "model"),
)
# then a rank's heads in train_sharded_families (zamba2's 32 of 64, the f32
# replay's 4 of 8) and in serve_sharded's prefill of 4608 tokens (the same
# heads, from a state h0).
MAMBA_RTOL = 1e-4   # f32 sums in another order; atol = rtol x the output's max
SERVE = {"arch": "zamba2-1.2b", "requests": 8, "max_batch": 4,
         "prompt": (4608, 8192), "new_tokens": 16, "seed": 0}
# logits: f32 sums in another order (kernels vs plain versions, cuBLAS vs the
# CPU's matrix products) through two layers; atol = rtol x the logits' max
REPLAY = {"requests": 4, "max_batch": 2, "prompt": (4100, 4608), "new_tokens": 8,
          "seed": 1, "logits_rtol": 1e-4}
# training: zamba2-1.2b at published widths and depth through launch/train.py,
# 2 x 8192 tokens a step, step 0 a warm-up, a checkpoint saved at step 3
TRAIN = {"arch": "zamba2-1.2b", "seq_len": 8192, "global_batch": 2, "steps": 6,
         "ckpt_at": 3, "seed": 0, "lr": 1e-3}
TRAIN_KERNELS = ("flash_attention_kernel", "flash_attention_bwd_kernel",
                 "mamba_chunk_scan_kernel", "mamba_chunk_scan_bwd_kernel")
# B4-bwd's launches by variant (flash_attention.BWD_VARIANT_LAUNCHES), as
# phase train's steps and train_replay record them
BWD_VARIANT_KEYS = {"tensor_cores": "flash_attention_bwd_kernel.tensor_cores",
                    "cuda_cores": "flash_attention_bwd_kernel.cuda_cores"}
# three steps card vs CPU at reduced width in f32, s = 4160 > 4096 so the
# attention runs B4 and B4-bwd; loss and grad norm: f32 sums in another
# order through two layers and their backward, and one optimizer step
# between readings, 1e-4 relative
TRAIN_REPLAY = {"archs": ("zamba2-1.2b", "qwen2-7b"), "seq_len": 4160, "batch": 2,
                "steps": 3, "seed": 3, "rtol": 1e-4}
# the replay of the other families (one wave each, same tolerance): the
# attention families with prompts over 4096 tokens, so the f32 (CUDA-core)
# B4 runs at the reduced heads, (16, 16), and MLA's reduced pair (24, 16)
REPLAY_FAMILIES = {"requests": 2, "max_batch": 2, "new_tokens": 6, "seed": 2, "archs": (
    ("qwen2-7b", (4100, 4400)), ("deepseek-v2-236b", (4100, 4400)),
    ("qwen2-vl-72b", (4100, 4400)), ("seamless-m4t-large-v2", (64, 200)),
    ("xlstm-1.3b", (64, 160)))}
# every other family served at its published widths in bf16 (random weights
# from `seed`), one model at a time: (arch, layers kept or None for all,
# prompt lengths, B4 launches a prefill: one per attention layer of a
# prompt over 4096 tokens, all on the tensor-core variant; B6 launches a
# decode step: one per self-attention layer over a plain KV cache, none for
# MLA's latent cache, the cross cache or a model without attention)
SERVE_FAMILIES = {"requests": 4, "max_batch": 4, "new_tokens": 16, "seed": 0, "models": (
    ("qwen2-7b", None, (4608, 6144), 28, 28),
    ("deepseek-v2-236b", 3, (4608, 6144), 3, 0),
    ("qwen2-vl-72b", 4, (4608, 6144), 4, 4),
    ("seamless-m4t-large-v2", None, (64, 256), 0, 24),
    ("xlstm-1.3b", None, (128, 256), 0, 0))}
# the per-phase tier: B3 against its plain version on single phases at
# phase_n (all vertices alive, and with holes after random merges), then
# mcop_min_cut on `graphs` random graphs of sizes log-uniform over `sizes`
# (both ends included; seeds seed + i) against the f64 oracle, which
# `workers` processes solve meanwhile; the device loop's phase log against
# the CPU loop's on every `log_every`-th graph and on one graph of `block_n`
# vertices (B3's block variant); B3, the device loop (both row strategies)
# and the loop timed at time_n, the kernels line at line_n; the loop on a
# full state (near-symmetric graphs: rows staged, rows from L2, the block
# variant) against the CPU loop at near_symmetric_n
MIN_CUT ={"phase_n": (6, 16, 64, 256, 1024), "graphs": 100, "sizes": (5, 256),
           "seed": 1000, "workers": 6, "time_n": (64, 256), "line_n": 256,
           "time_reps": 20, "loop_reps": 3, "log_every": 10, "block_n": 300,
           "near_symmetric_n": (200, 256, 300)}
# the broker behind a process boundary: `sessions` per-user sessions through
# `ticks` ticks of the demo tenant (`nodes` vertices), a batch group of
# `capacity` slots from tick `group_tick` on; the second server SIGKILLs
# itself in tick `kill_tick` and is restarted on its journal and snapshots
SERVE_BROKER = {"nodes": 24, "seed": 0, "sessions": 300, "ticks": 24,
                "group_tick": 14, "capacity": 2048, "kill_tick": 10,
                "snapshot_every": 4, "ready_s": 120.0}
# the examples and tools of the port (phase examples_tools): the two model
# examples' request and step counts, torch_ipc_smoke's defaults (U users over
# `clients` client processes, `ticks` ticks), and a child's time limit (s)
EXAMPLES_TOOLS = {"serve_requests": 12, "serve_new_tokens": 16, "train_steps": 40,
                  "ipc": {"users": 1000, "clients": 2, "ticks": 6}, "timeout": 300}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, *, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` with ``reps`` calls captured in
    one CUDA graph and replayed, by CUDA events: the kernels' device time
    without the host's work between launches."""
    fn()  # warm: build, load, allocate outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ----------------------------------------------------------------------
# Seeded inputs (numpy), in the style of core.graph.random_wcg
# ----------------------------------------------------------------------


def random_batch(rng, b: int, n: int, *, n_valid=None, edge_prob=0.4):
    """B random connected WCGs padded to n vertices, as f32 arrays.

    ``n_valid`` (B,) gives each graph's true size; the rest is padding:
    pinned, zero weights, zero edges.  ``edge_prob`` is one density or one
    per graph.  One random vertex per graph is
    unoffloadable.  Even graphs follow ``random_wcg`` (cloud cost = half
    the local cost: the best cut offloads nearly everything); odd graphs
    draw each vertex's cloud cost between 0.2x and 1.8x its local cost, so
    that their best cut depends on the whole order of absorptions and
    merges — the inputs that tell a wrong solver from a right one.  Every
    fourth graph has small integer weights throughout, which makes scores
    and cuts tie exactly and so holds the solvers to the tie rules (lowest
    index absorbs first, a cut improves only on strict ``<``).
    Returns ``(adj, wl, wc, pinned)``.
    """
    nv = np.full(b, n) if n_valid is None else np.asarray(n_valid)
    live = np.arange(n)[None, :] < nv[:, None]                       # (b, n)
    t_local = rng.uniform(0.0, 20.0, size=(b, n)) * live
    prob = np.broadcast_to(np.asarray(edge_prob, np.float64), (b,))
    upper = np.triu(rng.random((b, n, n)) < prob[:, None, None], k=1)
    w = rng.uniform(0.0, 10.0, size=(b, n, n)) * upper
    # a chain 0-1-2-... keeps every graph connected
    chain = rng.uniform(0.0, 10.0, size=(b, n - 1))
    ar = np.arange(n - 1)
    w[:, ar, ar + 1] = np.where(upper[:, ar, ar + 1], w[:, ar, ar + 1], chain)
    w = w * (live[:, :, None] & live[:, None, :])
    adj = w + w.transpose(0, 2, 1)
    pinned = ~live
    pinned[np.arange(b), rng.integers(0, nv)] = True
    ratio = np.where(np.arange(b)[:, None] % 2 == 1,
                     rng.uniform(0.2, 1.8, size=(b, n)), 0.5)
    w_cloud = t_local * ratio
    ints = np.arange(b) % 4 == 3
    t_local[ints] = np.floor(t_local[ints])
    w_cloud[ints] = rng.integers(0, 20, size=(int(ints.sum()), n)) * live[ints]
    adj[ints] = np.floor(np.minimum(adj[ints], 3.9))
    return (
        adj.astype(np.float32),
        t_local.astype(np.float32),
        w_cloud.astype(np.float32),
        pinned,
    )


def check_density(b: int, n: int) -> np.ndarray:
    """Edge density of each graph of a kernel check: 0.4, or about six edges
    per vertex for the integer-weight family of ``random_batch`` and, four
    graphs in eight, for the other families; a batch under eight graphs is
    all sparse.
    In a dense graph of hundreds of vertices every cut but the trivial ones
    costs far more than any vertex gains, so the answer no longer depends on
    the order of absorptions; the sparse graphs keep the large shapes able to
    tell a wrong tie rule or merge from a right one."""
    i = np.arange(b)
    sparse = (i % 4 == 3) | ((i // 4) % 2 == 1) if b >= 8 else np.ones(b, bool)
    return np.where(sparse, min(0.4, 6.4 / n), 0.4)


def random_env_matrix(rng, k: int) -> np.ndarray:
    """K environments as a (K, 6) f32 matrix.  Bandwidths and speed-up are
    log-uniform over two decades, so the batch spans everything-offloaded,
    nothing-offloaded and the contested range in between."""
    def log_uniform(lo, hi):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), k))

    return np.stack([
        log_uniform(0.02, 8.0), log_uniform(0.02, 8.0), log_uniform(1.02, 6.0),
        rng.uniform(0.5, 1.5, k), rng.uniform(0.1, 0.5, k),
        rng.uniform(0.8, 2.0, k)], axis=1).astype(np.float32)


def timed(fn):
    """``(fn(), milliseconds)`` for one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def price_masks(adj, wl, wc, masks) -> np.ndarray:
    """Eq. 2 in f64: cost of each placement (True = local) on its graph."""
    adj, wl, wc = (np.asarray(a, np.float64) for a in (adj, wl, wc))
    node = np.where(masks, wl, wc).sum(-1)
    cut = masks[:, :, None] != masks[:, None, :]
    return node + (adj * cut).sum((-1, -2)) / 2.0


def hold_equal(tag, got, want, adj, wl, wc) -> dict:
    """Hold (cuts, masks) ``got`` against ``want`` on the same graphs.

    Masks must be equal; where they differ, both placements must price (in
    f64) to the same cost within tolerance — an exact tie broken the other
    way by rounding.  Cuts within rtol, atol = RTOL * C_local.  Each cut must
    also equal the f64 price of its own mask.
    """
    cuts_g, masks_g = (np.asarray(a) for a in got)
    cuts_w, masks_w = (np.asarray(a) for a in want)
    c_local = np.asarray(wl, np.float64).sum(-1)
    tol = RTOL * np.abs(cuts_w) + RTOL * c_local
    err = np.abs(cuts_g.astype(np.float64) - cuts_w.astype(np.float64))
    if not (err <= tol).all():
        i = int(np.argmax(err - tol))
        raise AssertionError(
            f"{tag}: cut mismatch on graph {i}: {cuts_g[i]} vs {cuts_w[i]}"
        )
    differ = np.nonzero((masks_g != masks_w).any(-1))[0]
    if differ.size:
        pg = price_masks(adj[differ], wl[differ], wc[differ], masks_g[differ])
        pw = price_masks(adj[differ], wl[differ], wc[differ], masks_w[differ])
        bad = np.abs(pg - pw) > tol[differ]
        if bad.any():
            raise AssertionError(
                f"{tag}: placements differ in cost on graphs {differ[bad][:8]}"
            )
    hold_own_price(tag, got, adj, wl, wc)
    return {"max_abs_err": float(err.max()), "tie_masks": int(differ.size)}


def hold_own_price(tag, got, adj, wl, wc, chunk: int = 256) -> None:
    """Every cut must be the f64 Eq.-2 price of its own placement (the
    solver's Eq.-10 value and the placement's cost are the same number)."""
    cuts, masks = (np.asarray(a) for a in got)
    for lo in range(0, len(cuts), chunk):
        sl = slice(lo, lo + chunk)
        own = price_masks(adj[sl], wl[sl], wc[sl], masks[sl])
        tol = 4 * RTOL * (np.abs(own) + np.asarray(wl[sl], np.float64).sum(-1))
        finite = cuts[sl] < 1e29  # a graph with one live vertex has no cut
        if not (np.abs(own - cuts[sl])[finite] <= tol[finite]).all():
            raise AssertionError(f"{tag}: a cut is not the price of its own mask")


def to_dev(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in arrays)


def to_host(pair):
    return tuple(t.cpu().numpy() for t in pair)


def absorb_steps(pinned: np.ndarray) -> np.ndarray:
    """Absorb steps each graph's solve needs: sum over phases of
    (n_alive - 1), with n_alive starting at n minus the folded vertices."""
    alive0 = pinned.shape[-1] - np.maximum(pinned.sum(-1) - 1, 0)
    return alive0 * (alive0 - 1) // 2


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions on the card
# ----------------------------------------------------------------------


def fits(n: int, b: int, graphs_per_block: int) -> bool:
    """Whether B1's warp variant takes ``graphs_per_block`` n-vertex graphs
    a block on this card."""
    from repro_torch.kernels import mcop_phase as K

    try:
        K.solve_plan("mcop_stoer_wagner_kernel", n, b, graphs_per_block=graphs_per_block,
                     device=DEVICE)
    except K.KernelError:
        return False
    return True


def phase_kernel_checks(rng) -> dict:
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_reference
    from repro_torch.core.cost_models import (
        EnergyModel, ResponseTimeModel, WeightedModel,
    )
    from repro_torch.kernels import mcop_phase as K

    entries = []
    # ---- solve kernel: (n, kernel batch, plain batch, oracle samples) ----
    # and both sides of the warp variant's packed limit
    limit = K.packed_limit(DEVICE)
    for n, b, b_plain, n_ref in (*SW_CHECKS, (limit, 264, 8, 1), (limit + 1, 132, 8, 1)):
        if n < CHECK_MIN_N:
            continue
        # a third of the graphs are smaller than the bucket (padding)
        nv = np.where(rng.random(b) < 0.33, rng.integers(max(2, n // 4), n + 1, b), n)
        host = random_batch(rng, b, n, n_valid=nv, edge_prob=check_density(b, n))
        dev = to_dev(host)
        got = to_host(K.mcop_stoer_wagner_kernel(*dev))
        torch.cuda.synchronize()
        plan = K.solve_plan("mcop_stoer_wagner_kernel", n, b, device=DEVICE)
        entry = {"name": "mcop_stoer_wagner_kernel", "shape": [b, n, n],
                 "plain_batch": b_plain, "variant": "warp" if plan["cpl"] else "block",
                 "graphs_per_block": plan["graphs_per_block"], "packed_limit": limit}
        if bool(plan["cpl"]) != (n <= limit):
            raise AssertionError(f"sw n={n}: {plan} on the wrong side of the limit {limit}")
        # the same bits at one graph a block, the most that fit up to 8, and
        # the plan's own choice (the run above)
        most = next((g for g in (8, 4, 2) if plan["cpl"] and fits(n, b, g)), None)
        if most is not None:
            settings = (1, most)
            runs = [to_host(K._solve_sw(*dev, graphs_per_block=g)) for g in settings]
            for cuts, masks in runs:
                if not (np.array_equal(cuts.view(np.int32), got[0].view(np.int32))
                        and np.array_equal(masks, got[1])):
                    raise AssertionError(
                        f"sw n={n}: bits differ across graphs a block {settings}")
            entry["bitwise_graphs_per_block"] = list(settings)
        if b_plain:
            sub = tuple(t[:b_plain].contiguous() for t in dev)
            want, entry["plain_ms"] = timed(lambda: K.stoer_wagner_plain(*sub))
            entry.update(hold_equal(
                f"sw n={n}", tuple(a[:b_plain] for a in got), to_host(want),
                *(a[:b_plain] for a in host[:3])))
        # the whole kernel batch, beyond what the plain version covered
        hold_own_price(f"sw n={n}", got, *host[:3])
        entry["kernel_ms"] = cuda_ms(
            lambda: K.mcop_stoer_wagner_kernel(*dev), reps=3 if n <= 256 else 1)
        # oracle samples: a sparse integer-weight graph first, then a dense
        # contested one, then the other families
        for i in (3, 1, 0, 2, 7, 5, 4, 6)[:n_ref]:
            g = WCG(host[1][i, :nv[i]], host[2][i, :nv[i]],
                    host[0][i, :nv[i], :nv[i]], ~host[3][i, :nv[i]])
            ref = mcop_reference(g)
            tol = RTOL * (abs(ref.min_cut) + g.local_cost_total)
            if abs(ref.min_cut - got[0][i]) > tol:
                raise AssertionError(
                    f"sw n={n} graph {i}: {got[0][i]} vs oracle {ref.min_cut}")
            if not (ref.local_mask == got[1][i, :nv[i]]).all():
                if abs(g.total_cost(got[1][i, :nv[i]]) - ref.min_cut) > tol:
                    raise AssertionError(f"sw n={n} graph {i}: mask vs oracle")
        entry["oracle_samples"] = n_ref
        entries.append(entry)

    # ---- fused kernel: per kind, vs plain and vs the solve kernel --------
    models = {"time": ResponseTimeModel(), "energy": EnergyModel(),
              "weighted": WeightedModel(0.5)}
    for n, k, k_plain in FUSED_CHECKS:
        if n < CHECK_MIN_N:
            continue
        adj1, t_loc, _, pin1 = random_batch(
            rng, 1, n, n_valid=[n - n // 8], edge_prob=check_density(1, n))
        data = adj1[0] / 2.0
        prof = to_dev((t_loc[0], data, np.ascontiguousarray(data.T), pin1[0]))
        env_d = torch.from_numpy(random_env_matrix(rng, k)).to(DEVICE)
        for kind in K.FUSED_MODEL_KINDS if n <= 256 else ("weighted",):
            got = to_host(K.mcop_fused_solve_kernel(*prof, env_d, kind=kind))
            torch.cuda.synchronize()
            # the graphs this kernel built, rebuilt on the host side for pricing
            wl, wc, adj = (
                t.cpu().numpy() for t in K._kernel_weights(
                    kind, 0.5, prof[0], prof[1], prof[2], env_d))
            entry = {"name": "mcop_fused_solve_kernel", "kind": kind,
                     "shape": [k, n], "plain_batch": k_plain}
            if k_plain:
                want, entry["plain_ms"] = timed(lambda: K.fused_solve_plain(
                    *prof, env_d[:k_plain].contiguous(), kind=kind))
                entry.update(hold_equal(
                    f"fused n={n} {kind}", tuple(a[:k_plain] for a in got),
                    to_host(want), adj[:k_plain], wl[:k_plain], wc[:k_plain]))
            # fused == solve kernel fed with the cost model's batch_weights
            from repro_torch.core.cost_models import EnvArrays
            bw = models[kind].batch_weights(
                prof[0], prof[1], prof[2], EnvArrays(*env_d.unbind(1)))
            via_sw = to_host(K.mcop_stoer_wagner_kernel(
                bw[2].contiguous(), bw[0].contiguous(), bw[1].contiguous(),
                prof[3][None, :].expand(k, -1).contiguous()))
            res = hold_equal(f"fused==sw n={n} {kind}", got, via_sw, adj, wl, wc)
            entry["vs_solve_kernel"] = res
            entry["kernel_ms"] = cuda_ms(
                lambda: K.mcop_fused_solve_kernel(*prof, env_d, kind=kind),
                reps=3 if n <= 256 else 1)
            entries.append(entry)

    # ---- the bounds the kernels state for themselves ---------------------
    too_big = to_dev(random_batch(rng, 1, TOO_BIG))
    for call in (
        lambda: K.mcop_stoer_wagner_kernel(*too_big),
        lambda: K.mcop_fused_solve_kernel(
            too_big[1][0], too_big[0][0], too_big[0][0], too_big[3][0],
            torch.ones((1, 6), device=DEVICE), kind="time"),
    ):
        try:
            call()
        except ValueError as e:
            if f"n={TOO_BIG}" not in str(e):
                raise
        else:
            raise AssertionError(f"a kernel accepted n={TOO_BIG}, above its bound")
    return {"phase": "kernel_checks", "entries": entries,
            "plain_note": "plain_ms is one run of the plain version at "
                          "plain_batch graphs; kernel_ms is at the full shape"}


# ----------------------------------------------------------------------
# Phase 2, part two: adjacencies symmetric only to a tolerance
# ----------------------------------------------------------------------


def queue_c_graph():
    """The input that told B1's warp variant from the reference (n = 5,
    vertex 0 pinned): integer weights, the lower triangle the upper one
    times (1 +- 5e-6).  ``WCG`` accepts it (``np.allclose``)."""
    from repro_torch.core.graph import WCG

    adj = np.zeros((5, 5))
    for i, j, w in ((0, 2, 2), (0, 3, 3), (0, 4, 1), (1, 3, 1), (1, 4, 2), (2, 3, 1), (2, 4, 2)):
        adj[i, j] = w
    adj += adj.T
    for (i, j), v in {(2, 0): 2.00001, (3, 0): 2.999985, (3, 1): 1.000005,
                      (3, 2): 1.000005, (4, 0): 0.999995, (4, 1): 1.99999,
                      (4, 2): 1.99999}.items():
        adj[i, j] = v
    return WCG([5, 5, 5, 3, 3], [0, 1, 0, 2, 1], adj, np.arange(5) != 0)


def perturbed_graphs(rng, count: int, sizes=(4, 8)):
    """Integer WCGs of ``sizes`` vertices whose lower triangle is the upper
    one times (1 +- 5e-6), one or two vertices pinned: the exact ties of
    small integer weights, each broken by the direction it is read in."""
    from repro_torch.core.graph import WCG

    out = []
    for _ in range(count):
        n = int(rng.integers(sizes[0], sizes[1] + 1))
        up = np.triu(rng.integers(0, 4, (n, n)).astype(np.float64), 1)
        sign = rng.choice([-1.0, 1.0], (n, n))
        off = np.ones(n, bool)
        off[0] = False
        if rng.random() < 0.3:
            off[rng.integers(1, n)] = False
        out.append(WCG(rng.integers(0, 6, n).astype(np.float64),
                       rng.integers(0, 3, n).astype(np.float64),
                       up + (up * (1 + sign * 5e-6)).T, off))
    return out


def near_symmetric_batch(rng, b: int, n: int):
    """``random_batch`` with each lower triangle times (1 +- 5e-6)."""
    adj, wl, wc, pin = random_batch(rng, b, n, edge_prob=check_density(b, n))
    lower = np.tril(np.ones((n, n), bool), -1)
    noise = 1 + rng.choice([-5e-6, 5e-6], adj.shape)
    return np.where(lower, adj * noise, adj).astype(np.float32), wl, wc, pin


def phase_near_symmetric(rng) -> dict:
    """B1 (``mcop_batch``, ``mcop``) and the per-phase loop (``mcop_min_cut``,
    B3) on adjacencies that ``WCG`` accepts as symmetric but that are not
    exactly symmetric: each such graph of a bucket goes to B1's full-row
    variant and to a full loop state.  Masks against the f64 reference: equal,
    except where the plain version on the CPU (the same algorithm in f32)
    departs from the reference too, where the card must give the plain
    version's mask (an f32-resolution tie, counted).  The warp variant fed
    the same batch (it reads the upper triangle) is counted beside it."""
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop, mcop_batch, mcop_reference
    from repro_torch.kernels import mcop_phase as K
    from repro_torch.kernels.ops import _min_cut_run, mcop_min_cut

    out = {"phase": "near_symmetric"}
    g = queue_c_graph()
    ref = mcop_reference(g)
    got = {
        "mcop_batch": mcop_batch([g], backend="cuda", device=DEVICE)[0],
        "mcop": mcop(g, backend="cuda", device=DEVICE),
    }
    cut, mask = mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device=DEVICE)
    out["queue_c_input"] = {"reference": [ref.min_cut, ref.local_mask.astype(int).tolist()]}
    for name, (c, m) in {**{k: (r.min_cut, r.local_mask) for k, r in got.items()},
                         "mcop_min_cut": (cut, mask)}.items():
        out["queue_c_input"][name] = [c, m.astype(int).tolist()]
        if not np.array_equal(m, ref.local_mask) or abs(c - ref.min_cut) > RTOL * ref.min_cut:
            raise AssertionError(f"near_symmetric: {name} gave {c} {m} on the n=5 input")

    graphs = perturbed_graphs(rng, 240)
    refs = [mcop_reference(x) for x in graphs]
    plain = mcop_batch(graphs, backend="torch", device="cpu")
    batch = mcop_batch(graphs, backend="cuda", device=DEVICE)
    fronts = [mcop(x, backend="cuda", device=DEVICE) for x in graphs]
    loops = [mcop_min_cut(x.adj, x.w_local, x.w_cloud, x.offloadable, device=DEVICE)
             for x in graphs]
    # what the warp variant answers for the same bucket (upper triangle)
    packed = [np.zeros((len(graphs), 16, 16), np.float32), np.zeros((len(graphs), 16), np.float32),
              np.zeros((len(graphs), 16), np.float32), np.ones((len(graphs), 16), bool)]
    for i, x in enumerate(graphs):
        packed[0][i, :x.n, :x.n] = x.adj
        packed[1][i, :x.n], packed[2][i, :x.n] = x.w_local, x.w_cloud
        packed[3][i, :x.n] = ~x.offloadable
    warp = to_host(K.mcop_stoer_wagner_kernel(*to_dev(packed)))
    counts = {"graphs": len(graphs), "f32_ties": 0, "warp_variant_departs": 0}
    for i, (x, r, p) in enumerate(zip(graphs, refs, plain)):
        tie = not np.array_equal(p.local_mask, r.local_mask)
        want = p.local_mask if tie else r.local_mask
        counts["f32_ties"] += tie
        counts["warp_variant_departs"] += not np.array_equal(warp[1][i, :x.n], r.local_mask)
        for name, (c, m) in (("mcop_batch", (batch[i].min_cut, batch[i].local_mask)),
                             ("mcop", (fronts[i].min_cut, fronts[i].local_mask)),
                             ("mcop_min_cut", loops[i])):
            if not np.array_equal(m, want) or abs(c - r.min_cut) > RTOL * (abs(r.min_cut) + 1):
                raise AssertionError(
                    f"near_symmetric: {name} graph {i}: {c} {m.astype(int)} vs reference "
                    f"{r.min_cut} {r.local_mask.astype(int)} (plain {p.local_mask.astype(int)})")
    out["perturbed"] = counts

    # one bucket of both kinds: its exactly symmetric graphs keep the warp
    # variant and the others take full rows (two launches), each answer
    # scattered back to its row with the bits it has in a bucket of its kind
    sym = []
    for n in rng.integers(4, 9, 40):
        adj, wl, wc, pin = random_batch(rng, 1, int(n))
        sym.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    mixed = [x for pair in zip(graphs[:40], sym) for x in pair]
    before = K.LAUNCHES["mcop_stoer_wagner_kernel"]
    got_mixed = mcop_batch(mixed, backend="cuda", device=DEVICE)
    launched = K.LAUNCHES["mcop_stoer_wagner_kernel"] - before
    alone = [r for pair in zip(batch[:40], mcop_batch(sym, backend="cuda", device=DEVICE))
             for r in pair]
    if launched != 2 or any(a.min_cut != b.min_cut or not np.array_equal(a.local_mask, b.local_mask)
                            for a, b in zip(got_mixed, alone)):
        raise AssertionError(f"near_symmetric: a mixed bucket ({launched} launches) "
                             "differs from its graphs solved by kind")
    out["mixed_bucket"] = {"graphs": len(mixed), "launches": launched}

    # both sides of B1's packed limit, and B3's full loop state above n = 241
    limit = K.packed_limit(DEVICE)
    sides = []
    for n, b in ((limit, 8), (limit + 1, 4)):
        host = near_symmetric_batch(rng, b, n)
        dev = to_dev(host)
        got_k = to_host(K.mcop_stoer_wagner_kernel(*dev, full_rows=True))
        want_k, plain_ms = timed(lambda: K.stoer_wagner_plain(*dev))
        sides.append({"n": n, "graphs": b, "plain_ms": plain_ms,
                      **hold_equal(f"near_symmetric sw n={n}", got_k, to_host(want_k),
                                   *host[:3])})
    out["packed_limit_sides"] = sides
    logs = []
    for n in MIN_CUT["near_symmetric_n"]:
        adj, wl, wc, pin = near_symmetric_batch(rng, 1, n)
        x = WCG(wl[0], wc[0], adj[0], ~pin[0])
        logs.append(hold_phase_log(f"near_symmetric n={n}", x, _min_cut_run))
        if not _min_cut_run(x.adj, x.w_local, x.w_cloud, x.offloadable,
                            device="cpu")[2].full:
            raise AssertionError("near_symmetric: the loop state is not full")
    out["min_cut_logs"] = logs

    # what the full-row routes cost: B1's block variant against the warp
    # variant on one symmetric batch at the per-kernel line's shape, and the
    # device loop on a full state (rows staged up to n = 241, from L2 above)
    n, k = LINE_SHAPE
    dev = to_dev(random_batch(rng, k, n))
    same = [to_host(K.mcop_stoer_wagner_kernel(*dev, full_rows=f)) for f in (False, True)]
    hold_equal("near_symmetric full rows vs warp", same[1], same[0],
               *(t.cpu().numpy() for t in dev[:3]))
    out["full_rows_cost"] = {
        "shape": [k, n],
        "warp_ms": cuda_ms(lambda: K.mcop_stoer_wagner_kernel(*dev), reps=3),
        "full_rows_ms": cuda_ms(lambda: K.mcop_stoer_wagner_kernel(*dev, full_rows=True),
                                reps=3),
        "device_loop": []}
    for n in MIN_CUT["time_n"]:
        adj, wl, wc, pin = near_symmetric_batch(rng, 1, n)
        x = WCG(wl[0], wc[0], adj[0], ~pin[0])
        out["full_rows_cost"]["device_loop"].append(
            {"n": n, **device_loop_ms(x, reps=MIN_CUT["loop_reps"])})
    return out


# ----------------------------------------------------------------------
# Phase 3: solve plane at full size
# ----------------------------------------------------------------------


def random_profile(rng, n: int):
    from repro_torch.core.cost_models import AppProfile
    from repro_torch.core.graph import WCG

    adj, wl, wc, pin = random_batch(rng, 1, n)
    g = WCG(wl[0], wc[0], adj[0], ~pin[0])
    return AppProfile.from_wcg_times(g)


def random_envs(rng, k: int):
    from repro_torch.core.cost_models import EnvArrays

    return EnvArrays(*random_env_matrix(rng, k).astype(np.float64).T)


def phase_solve_plane(rng) -> dict:
    from repro_torch.core.cost_models import ResponseTimeModel, WeightedModel
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_batch, solve_envs

    models = {"weighted": WeightedModel(0.5), "time": ResponseTimeModel()}
    out = {"phase": "solve_plane", "calls": []}
    for n, k, kind in PLANE:
        model = models[kind]
        profile = random_profile(rng, n)
        envs = random_envs(rng, k)
        results = {}
        for backend in ("cuda_fused", "cuda"):
            solve_envs(profile, model, envs, backend=backend, device=DEVICE)  # warm
            t0 = time.perf_counter()
            results[backend] = solve_envs(
                profile, model, envs, backend=backend, device=DEVICE)
            dt = time.perf_counter() - t0
            out["calls"].append({
                "entry": "solve_envs", "backend": backend, "n": n, "k": k,
                "model": model.name, "seconds": dt, "graphs_per_s": k / dt})
        # the two kernels must agree with each other, placement by placement
        batch = model.build_batch(profile, envs)
        a, b = results["cuda_fused"], results["cuda"]
        cuts = [np.array([r.min_cut for r in rs]) for rs in (a, b)]
        masks = [np.stack([r.local_mask for r in rs]) for rs in (a, b)]
        out["calls"][-1]["fused_vs_cuda"] = hold_equal(
            f"solve_envs n={n}", (cuts[0], masks[0]), (cuts[1], masks[1]),
            batch.adj, batch.w_local, batch.w_cloud)

    # heterogeneous graphs of 5..200 vertices: all three buckets
    sizes = rng.integers(HETERO[1], HETERO[2] + 1, HETERO[0])
    graphs = []
    for n in sizes:
        adj, wl, wc, pin = random_batch(rng, 1, int(n))
        graphs.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    mcop_batch(graphs[:64], backend="cuda", device=DEVICE)  # warm
    t0 = time.perf_counter()
    res = mcop_batch(graphs, backend="cuda", device=DEVICE)
    dt = time.perf_counter() - t0
    for g, r in zip(graphs[::97], res[::97]):
        tol = 4 * RTOL * (abs(r.min_cut) + g.local_cost_total)
        if abs(g.total_cost(r.local_mask) - r.min_cut) > tol:
            raise AssertionError("mcop_batch: cut is not its mask's price")
        g.validate_placement(r.local_mask)
    out["calls"].append({
        "entry": "mcop_batch", "backend": "cuda", "graphs": len(graphs),
        "sizes": f"{HETERO[1]}..{HETERO[2]}", "seconds": dt, "graphs_per_s": len(graphs) / dt})
    return out


# ----------------------------------------------------------------------
# Phase 4: the broker
# ----------------------------------------------------------------------


def face_profile():
    from repro_torch.core.cost_models import AppProfile
    from repro_torch.core.graph import face_recognition_graph

    return AppProfile.from_wcg_times(
        face_recognition_graph(speedup=1.0, bandwidth_mbps=1.0))


def device_busy_ms(prof) -> float:
    """Sum of kernel and copy time on the card over a profiler window."""
    total = 0.0
    for ev in prof.key_averages():
        total += getattr(ev, "self_device_time_total", None) or getattr(
            ev, "self_cuda_time_total", 0.0)
    return total / 1e3


def drive_broker(backend: str, device: str, u: int, users_b: int, steps_b: int,
                 profile_b, tracer=None, profile_device: bool = False):
    """The two-tenant workload; returns (batch reports, object events,
    broker, timing dict, traffic ticks).  ``profile_device`` wraps the timed
    batched ticks in ``torch.profiler`` and adds the card's busy time."""
    from repro_torch.core.cost_models import ResponseTimeModel, WeightedModel
    from repro_torch.service import (
        OffloadBroker, TrafficGenerator, run_workload, user_traces,
    )

    warmup, steps = 2, 5
    broker = OffloadBroker(backend=backend, device=device, tracer=tracer)
    broker.register("face", face_profile(), ResponseTimeModel())
    broker.register("wide", profile_b, WeightedModel(0.5))
    group = broker.register_batch("face", u, threshold=0.15, min_interval=2)
    gen = TrafficGenerator(u, seed=7, arrival_rate=max(1.0, 0.02 * u),
                           churn=0.02, initial=u)
    ticks = [gen.step() for _ in range(warmup + steps)]
    for tk in ticks[:warmup]:
        group.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
        broker.tick()
    if tracer is not None:
        tracer.clear()  # keep the timed ticks' spans only
    prof = None
    if profile_device:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    for tk in ticks[warmup:]:
        group.observe(tk.envs, arrived=tk.arrived, departed=tk.departed)
        broker.tick()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    busy_ms = None
    if prof is not None:
        prof.__exit__(None, None, None)
        busy_ms = device_busy_ms(prof)
    stage_s = {}
    if tracer is not None:
        for sp in tracer.spans():
            stage_s[sp.name] = stage_s.get(sp.name, 0.0) + sp.duration
    reports = group.drain()
    traces = user_traces(users_b, steps_b, seed=11)
    t0 = time.perf_counter()
    work = run_workload(broker, "wide", n_users=users_b, steps=steps_b,
                        threshold=0.15, min_interval=2, traces=traces)
    object_s = time.perf_counter() - t0
    timing = {"batch_seconds": batch_s, "batch_steps": steps,
              "object_seconds": object_s, "object_steps": steps_b,
              "stage_seconds": stage_s, "device_busy_ms": busy_ms}
    return reports, work.events, broker, timing, ticks


def hold_events(tag, got_events, want_events) -> int:
    """Every event's placement must match the reference replay; a mask that
    differs must price to the same cost (an exact tie).  Returns ties."""
    ties = 0
    for u, (ge, we) in enumerate(zip(got_events, want_events)):
        if len(ge) != len(we):
            raise AssertionError(f"{tag}: user {u} event count differs")
        for a, b in zip(ge, we):
            if (a.repartitioned, a.step) != (b.repartitioned, b.step):
                raise AssertionError(f"{tag}: user {u} decisions differ")
            tol = RTOL * (abs(b.result.min_cut) + abs(b.no_offload_cost))
            if abs(a.result.min_cut - b.result.min_cut) > tol:
                raise AssertionError(
                    f"{tag}: user {u} step {a.step}: cut {a.result.min_cut} "
                    f"vs reference {b.result.min_cut}")
            if not np.array_equal(a.result.local_mask, b.result.local_mask):
                if abs(a.partial_cost - b.partial_cost) > tol:
                    raise AssertionError(
                        f"{tag}: user {u} step {a.step}: placement differs")
                ties += 1
    return ties


def hold_batch_reports(tag, got_reports, want_reports) -> int:
    """Every batched tick's decisions must match the reference replay, its
    cuts within tolerance, and a placement that differs must price to the
    same cost (an exact tie).  Returns ties."""
    ties = 0
    if len(got_reports) != len(want_reports):
        raise AssertionError(f"{tag}: tick count differs from reference")
    for rg, rw in zip(got_reports, want_reports):
        act = rw.active
        if not (np.array_equal(rg.active, act)
                and np.array_equal(rg.repartitioned, rw.repartitioned)):
            raise AssertionError(f"{tag}: decisions differ from reference")
        tol = RTOL * (np.abs(rw.min_cut[act]) + rw.no_offload_cost[act])
        if not (np.abs(rg.min_cut[act] - rw.min_cut[act]) <= tol).all():
            raise AssertionError(f"{tag}: cuts differ from reference")
        differ = (rg.placements[act] != rw.placements[act]).any(-1)
        if differ.any():
            same_cost = np.abs(rg.partial_cost[act] - rw.partial_cost[act]) <= tol
            if not same_cost[differ].all():
                raise AssertionError(f"{tag}: placements differ from reference")
            ties += int(differ.sum())
    return ties


def phase_broker(rng) -> dict:
    from repro_torch.core.cost_models import ResponseTimeModel
    from repro_torch.core.placement_cache import PlacementCache
    from repro_torch.core.session_batch import SessionBatch, tick_sessions
    from repro_torch.kernels.mcop_phase import LAUNCHES
    from repro_torch.obs.trace import Tracer

    u, users_b, steps_b = BROKER["u"], BROKER["users_b"], BROKER["steps_b"]
    profile_b = random_profile(np.random.default_rng(5), BROKER["n_b"])
    before = dict(LAUNCHES)
    tracer = Tracer()
    reports, _, broker, timing, ticks = drive_broker(
        "cuda", DEVICE, u, users_b, steps_b, profile_b, tracer=tracer,
        profile_device=bool(os.environ.get("SMOKE_PROFILE")))
    tel = broker.telemetry
    steps = timing["batch_steps"]
    out = {
        "phase": "broker", "sessions": u,
        "ticks_per_s": steps / timing["batch_seconds"],
        "us_per_user_observation": timing["batch_seconds"] / (steps * u) * 1e6,
        "batch_hits": sum(r.hits for r in reports),
        "batch_solved": sum(r.solved for r in reports),
        "batch_coalesced": sum(r.coalesced for r in reports),
        "object_users": users_b, "object_steps": steps_b,
        "object_seconds": timing["object_seconds"],
        "object_hit_rate": tel.hit_rate,
        # seconds per tick stage, summed over the timed batched ticks
        "stage_seconds": timing["stage_seconds"],
        # the card's busy share of those ticks (SMOKE_PROFILE=1), else null
        "device_busy_ms": timing["device_busy_ms"],
        "device_idle_share": None if timing["device_busy_ms"] is None else
        1.0 - timing["device_busy_ms"] / 1e3 / timing["batch_seconds"],
        # (bucket, graphs) of every solve flush: null bucket = solve_envs flush
        "flush_shapes": sorted({
            (s.attrs.get("bucket") or 16, s.attrs["batch"])
            for s in tracer.spans("stage.solve_flush")}),
    }
    for r in reports:
        if not (np.isfinite(r.partial_cost[r.active]).all()
                and r.placements.shape == (u, 9)):
            raise AssertionError("broker: batched tick report malformed")

    # one fused tick over tenant (a)'s traffic, on a fresh batch and cache
    batch = SessionBatch.create(u, 9, threshold=0.15, min_interval=2)
    batch.activate(ticks[0].arrived)
    t0 = time.perf_counter()
    fused = tick_sessions(
        batch, ticks[0].envs, profile=face_profile(), model=ResponseTimeModel(),
        cache=PlacementCache(), backend="cuda_fused", device=DEVICE,
        device_telemetry=True)
    out["fused_tick_seconds"] = time.perf_counter() - t0
    out["fused_tick"] = {"due": fused.due, "solved": fused.solved,
                         "coalesced": fused.coalesced,
                         "device_summary": fused.device_summary}
    if not all(np.isfinite(v) for v in fused.device_summary.values()):
        raise AssertionError("broker: device telemetry not finite")
    out["launches"] = {k: LAUNCHES[k] - before[k] for k in BROKER_PATH_KERNELS}
    # since the reset before phase 4
    out["main_path_launches"] = {k: LAUNCHES[k] for k in BROKER_PATH_KERNELS}
    for name, count in out["launches"].items():
        if count <= 0:
            raise AssertionError(f"broker path never launched {name}")

    # replay at U = 2000 on the card and on the f64 reference; all must match
    small = BROKER["replay_u"]
    got = drive_broker("cuda", DEVICE, small, users_b, steps_b, profile_b)
    want = drive_broker("reference", "cpu", small, users_b, steps_b, profile_b)
    ties = hold_events("object path", got[1], want[1])
    ties += hold_batch_reports("batched path", got[0], want[0])
    out["replay"] = {"sessions": small, "object_users": users_b,
                     "events_checked": sum(len(e) for e in want[1])
                     + sum(int(r.active.sum()) for r in want[0]),
                     "tie_masks": ties}
    return out


# ----------------------------------------------------------------------
# Phase 5b: the solver fleet (a mesh of repeated cuda:0 entries)
# ----------------------------------------------------------------------


def hold_results(tag, got, want) -> None:
    """Sharded against unsharded: every cut and mask bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} results for {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if not (np.float32(a.min_cut).view(np.int32) == np.float32(b.min_cut).view(np.int32)
                and np.array_equal(a.local_mask, b.local_mask)):
            raise AssertionError(f"{tag}: result {i} differs from the unsharded solve")


def fleet_call(fn, tag, shards, *, spans, stage, rows):
    """Run one sharded call; return its results after checking its shard
    spans (one per shard, the reference's real rows each) and its launches
    (one per shard holding a real row)."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    before = dict(all_launches())
    res = fn(tracer)
    launched = {k: v - before[k] for k, v in all_launches().items() if v != before[k]}
    got = [(s.attrs["shard"], s.attrs["devices"], s.attrs["rows"])
           for s in tracer.spans(f"{stage}.shard")]
    want = []
    for k in rows:
        want += [(s, shards, len(range(s, k, shards))) for s in range(shards)]
    if got != want:
        raise AssertionError(f"{tag}: shard spans {got}, expected {want}")
    expected = sum(min(k, shards) for k in rows)
    if sum(launched.values()) != expected:
        raise AssertionError(f"{tag}: {launched} launches, expected {expected}")
    spans.append({"call": tag, "spans": len(got), "launches": launched})
    return res


def fleet_seconds(unsharded, sharded, reps: int = FLEET_REPS) -> dict:
    """Host seconds of ``reps`` calls of each, in turns (unsharded first),
    each ending in its read-back: the medians and every reading (a call of
    tens of ms on this host varies by up to ~2x from one reading to the
    next)."""
    got = {"unsharded": [], "sharded": []}
    for _ in range(reps):
        for key, fn in (("unsharded", unsharded), ("sharded", sharded)):
            t0 = time.perf_counter()
            fn()
            got[key].append(time.perf_counter() - t0)
    return {"unsharded_s": float(np.median(got["unsharded"])),
            "sharded_s": float(np.median(got["sharded"])), "readings": got}


def phase_solver_fleet(rng, devices=None) -> dict:
    """The solver fleet on the card: a one-device mesh and ``mesh=None``
    (one launch: auto never shards) against ``mesh=False``, and a mesh of
    ``devices`` (default: every GPU when there are two or more, else four
    repeated ``cuda:0`` entries) against the unsharded (``mesh=False``)
    solve on the first card, bits ``==``, in
    ``solve_envs`` (both kernels), ``mcop_batch`` and a ``tick_sessions``
    tick with its empty-miss tick; then elastic resizes through a broker's
    elastic lane against synchronous reference resizes."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_models import ResponseTimeModel, WeightedModel
    from repro_torch.core.graph import WCG
    from repro_torch.core.mcop import mcop_batch, solve_envs
    from repro_torch.core.placement import TPUV5E_TIER
    from repro_torch.core.placement_cache import PlacementCache
    from repro_torch.core.session_batch import SessionBatch, tick_sessions
    from repro_torch.kernels import mcop_phase
    from repro_torch.launch.mesh import make_solver_mesh
    from repro_torch.profilers.program import stage_specs
    from repro_torch.runtime import ElasticMeshManager
    from repro_torch.service import OffloadBroker, TrafficGenerator

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    fleet = make_solver_mesh(devices or ([f"{DEVICE}:{i}" for i in range(count)]
                                         if count > 1 else [f"{DEVICE}:0"] * 4))
    shards = len(fleet.devices)
    one = make_solver_mesh([DEVICE])
    out = {"phase": "solver_fleet", "devices": [str(d) for d in fleet.devices],
           "calls": [], "spans": []}
    spans = out["spans"]
    reset_all_launches()  # ---- the fleet path starts here ----
    models = {"weighted": WeightedModel(0.5), "time": ResponseTimeModel()}
    for n, k, kind in ((64, 13, "weighted"), *PLANE):
        profile = random_profile(rng, n)
        envs = random_envs(rng, k)
        for backend in ("cuda", "cuda_fused"):
            model = models[kind]
            args = (profile, model, envs)
            kw = {"backend": backend, "device": DEVICE}
            base = solve_envs(*args, **kw, mesh=False)
            sharded = fleet_call(
                lambda tr: solve_envs(*args, **kw, mesh=fleet, tracer=tr),
                f"solve_envs {backend} K={k} n={n}", shards, spans=spans,
                stage="solve_envs", rows=[k])
            hold_results(f"solve_envs {backend} K={k} n={n}", sharded, base)
            call = {"entry": "solve_envs", "backend": backend, "n": n, "k": k,
                    **fleet_seconds(lambda: solve_envs(*args, **kw, mesh=False),
                                    lambda: solve_envs(*args, **kw, mesh=fleet))}
            if (n, k) == LINE_SHAPE:
                t0 = time.perf_counter()
                single = solve_envs(*args, **kw, mesh=one)
                call["one_device_mesh_s"] = time.perf_counter() - t0
                hold_results(f"solve_envs {backend} one-device mesh", single, base)
                # auto never shards, even where the host has a fleet
                before = sum(all_launches().values())
                hold_results(f"solve_envs {backend} mesh=None",
                             solve_envs(*args, **kw, mesh=None), base)
                if sum(all_launches().values()) - before != 1:
                    raise AssertionError(f"solve_envs {backend} mesh=None: not one launch")
            out["calls"].append(call)

    # mcop_batch: the solve plane's heterogeneous graphs, and the block variant
    sizes = rng.integers(HETERO[1], HETERO[2] + 1, HETERO[0])
    graphs = []
    for n in sizes:
        adj, wl, wc, pin = random_batch(rng, 1, int(n))
        graphs.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    wide = []
    limit = mcop_phase.packed_limit(DEVICE)
    for _ in range(16):
        adj, wl, wc, pin = random_batch(rng, 1, limit + 1, edge_prob=check_density(1, limit + 1))
        wide.append(WCG(wl[0], wc[0], adj[0], ~pin[0]))
    for tag, gs, buckets in (("mcop_batch 2048 graphs", graphs, (16, 64, 256)),
                             ("mcop_batch 16 graphs n=342", wide, (limit + 1,))):
        base = mcop_batch(gs, backend="cuda", device=DEVICE, buckets=buckets, mesh=False)
        per_bucket = {}
        for x in gs:
            m = next((b for b in buckets if x.n <= b), None)
            per_bucket[m] = per_bucket.get(m, 0) + 1
        sharded = fleet_call(
            lambda tr: mcop_batch(gs, backend="cuda", device=DEVICE, buckets=buckets,
                                  mesh=fleet, tracer=tr),
            tag, shards, spans=spans, stage="solve",
            rows=[per_bucket[b] for b in sorted(per_bucket)])
        hold_results(tag, sharded, base)
        out["calls"].append({"entry": tag, **fleet_seconds(
            lambda: mcop_batch(gs, backend="cuda", device=DEVICE, buckets=buckets,
                               mesh=False),
            lambda: mcop_batch(gs, backend="cuda", device=DEVICE, buckets=buckets,
                               mesh=fleet), reps=3)})

    # tick_sessions: the broker phase's 100 000-session face-profile group
    u = BROKER["u"]
    gen = TrafficGenerator(u, seed=7, arrival_rate=max(1.0, 0.02 * u), churn=0.02, initial=u)
    first = gen.step()

    def drive(mesh, tracer=None):
        """Two ticks: the arrivals, then the same environments again (no
        miss: the cooldown holds every session).  Returns the reports, the
        cache counters and the launches of each tick."""
        batch = SessionBatch.create(u, 9, threshold=0.15, min_interval=2)
        batch.activate(first.arrived)
        cache = PlacementCache()
        reps, launched = [], []
        for t in range(2):
            before = sum(all_launches().values())
            reps.append(tick_sessions(
                batch, first.envs, profile=face_profile(), model=ResponseTimeModel(),
                cache=cache, backend="cuda_fused", device=DEVICE, mesh=mesh,
                tracer=tracer, tick=t))
            launched.append(sum(all_launches().values()) - before)
        return reps, cache.stats, launched

    t0 = time.perf_counter()
    base, stats_1, _ = drive(False)
    t_base = time.perf_counter() - t0
    solved = base[0].solved
    t0 = time.perf_counter()
    sharded, stats_sh, launched = fleet_call(
        lambda tr: drive(fleet, tr), "tick_sessions", shards, spans=spans,
        stage="solve_envs", rows=[solved])
    t_fleet = time.perf_counter() - t0
    if stats_sh != stats_1:
        raise AssertionError(f"tick_sessions: cache counters {stats_sh} vs {stats_1}")
    for t, (rs, r1) in enumerate(zip(sharded, base)):
        for f in ("active", "repartitioned", "cache_hit", "placements", "min_cut",
                  "partial_cost", "no_offload_cost", "full_offload_cost", "gain"):
            a, b = getattr(rs, f), getattr(r1, f)
            if not np.array_equal(a, b, equal_nan=b.dtype.kind == "f"):
                raise AssertionError(f"tick_sessions tick {t}: {f} differs")
        if (rs.hits, rs.solved, rs.coalesced, rs.due) != (r1.hits, r1.solved, r1.coalesced, r1.due):
            raise AssertionError(f"tick_sessions tick {t}: counts differ")
    if not (solved > 0 and sharded[1].solved == 0 and launched[1] == 0):
        raise AssertionError(f"tick_sessions: tick 0 solved {solved}, the empty-miss tick "
                             f"solved {sharded[1].solved} and launched {launched[1]}")
    out["calls"].append({"entry": "tick_sessions", "sessions": u, "solved": solved,
                         "second_tick": {"solved": 0, "launches": 0},
                         "unsharded_s": t_base, "sharded_s": t_fleet})
    out["main_path_launches"] = {k: v for k, v in all_launches().items()}
    # ---- and ends here ----

    # elastic resizes on the broker's elastic lane against reference resizes
    cfg = get_config(SERVE["arch"])
    stages = stage_specs(cfg, ShapeConfig("cli", "decode", 4096, SERVE["max_batch"]),
                         group=max(cfg.n_layers // 8, 1))
    tl = dc.replace(TPUV5E_TIER, name="decode-pool", chips=64)
    tr = dc.replace(TPUV5E_TIER, name="prefill-pool", chips=192)
    mgr = ElasticMeshManager(stages, tl, tr, backend="cuda", device=DEVICE)
    sync = ElasticMeshManager(stages, tl, tr, backend="reference")
    broker = OffloadBroker(backend="cuda", device=DEVICE)
    broker.register("fleet")
    resizes = []
    for step, chips in ((1, 16), (2, 512)):
        pending = mgr.submit_resize(broker, "fleet", step, remote_chips=chips)
        broker.tick()
        ev = pending.resolve()
        want = sync.resize(step, remote_chips=chips)
        if not (np.array_equal(ev.plan.stage_tier, want.plan.stage_tier)
                and ev.plan.cut_bytes == want.plan.cut_bytes):
            raise AssertionError(f"elastic resize to {chips} chips: {ev.plan} vs {want.plan}")
        resizes.append({"remote_chips": chips, "stages": int(ev.plan.stage_tier.size),
                        "offloaded": int(ev.plan.stage_tier.sum()),
                        "cut_bytes": ev.plan.cut_bytes})
    out["elastic"] = {"arch": SERVE["arch"], "resizes": resizes}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# The per-kernel line: time, plain time, bound, at the solve-plane shape
# ----------------------------------------------------------------------


def measure_kernels(rng, n: int, k: int, kind: str, *, reps: int) -> dict:
    """Both kernels at one solve-plane shape: K environments on an n-vertex
    profile.  Returns per kernel: error against the plain version, time,
    plain time, and the roofline bound for this run's inputs."""
    from repro_torch.kernels import mcop_phase as K

    adj1, t_loc, _, pin1 = random_batch(rng, 1, n)
    data = adj1[0] / 2.0
    prof = to_dev((t_loc[0], data, np.ascontiguousarray(data.T), pin1[0]))
    env_d = torch.from_numpy(random_env_matrix(rng, k)).to(DEVICE)
    wl, wc, adj = (t.contiguous() for t in K._kernel_weights(
        kind, 0.5, prof[0], prof[1], prof[2], env_d))
    pin = prof[3][None, :].expand(k, -1).contiguous()
    steps = int(absorb_steps(pin.cpu().numpy()).sum())

    def sw():
        return K.mcop_stoer_wagner_kernel(adj, wl, wc, pin)

    def fused():
        return K.mcop_fused_solve_kernel(*prof, env_d, kind=kind)

    # the plain version at a batch it finishes in seconds (n^2/2 tiny steps)
    k_plain = k if n <= 64 else 16
    sub = tuple(t[:k_plain].contiguous() for t in (adj, wl, wc, pin))
    plain, plain_sw_ms = timed(lambda: K.stoer_wagner_plain(*sub))
    _, plain_fused_ms = timed(lambda: K.fused_solve_plain(
        *prof, env_d[:k_plain].contiguous(), kind=kind))
    host = tuple(t[:k_plain].cpu().numpy() for t in (adj, wl, wc))
    want = to_host(plain)
    err = {
        "sw": hold_equal(f"sw ({k},{n})", tuple(
            a[:k_plain] for a in to_host(sw())), want, *host),
        "fused": hold_equal(f"fused ({k},{n})", tuple(
            a[:k_plain] for a in to_host(fused())), want, *host),
    }

    # every absorb step scores n candidates (subtract, compare) and adds one
    # row (n adds); every phase prices a cut and merges (about 4n operations)
    solve_flops = steps * 3 * n + k * (n - 1) * 4 * n
    sw_bytes = adj.numel() * 4 + 2 * wl.numel() * 4 + pin.numel() + k * (4 + n)
    # the fused build: 4 divisions, 3 additions, 5 multiplies/divides per edge
    fused_bytes = 2 * n * n * 4 + n * 4 + n + k * 24 + k * (4 + n)
    fused_flops = solve_flops + k * n * n * 12
    common = {"shape": [k, n], "kind": kind, "plain_batch": k_plain}
    # counted from the inputs and an assumed shared-memory rate, not measured:
    # kept out of the per-kernel line, which holds measurements and the bound
    out = {"work": {"shape": [k, n], "absorb_steps": steps,
                    "row_traffic_bytes": steps * n * 4,
                    "row_traffic_ms_computed": steps * n * 4 / SMEM_BYTES_PER_S * 1e3}}
    plans = {key: K.solve_plan(name, n, k, device=DEVICE) for key, name in (
        ("sw", "mcop_stoer_wagner_kernel"), ("fused", "mcop_fused_solve_kernel"))}
    for key, fn, plain_ms, (b_ms, b_by) in (
        ("sw", sw, plain_sw_ms, bound(sw_bytes, solve_flops, FP32_FLOP_PER_S)),
        ("fused", fused, plain_fused_ms, bound(fused_bytes, fused_flops, FP32_FLOP_PER_S)),
    ):
        out[key] = {"max_abs_err": err[key]["max_abs_err"],
                    "tie_masks": err[key]["tie_masks"],
                    "ms": cuda_ms(fn, reps=reps), "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, **common}
        # the chain's latency: each resident graph advances one absorb step
        # at a time, so a step takes time x graphs at once / all steps
        resident = plans[key]["resident_graphs"]
        out["work"][f"{key}_plan"] = plans[key]
        out["work"][f"{key}_ns_per_step"] = out[key]["ms"] * 1e6 * resident / steps
    return out


def kernel_lines(rng, launches: dict) -> tuple[dict, dict]:
    """``(kernel_work line, per-kernel line)``.  The per-kernel line holds
    the contract's keys at LINE_SHAPE and the same measurements at the other
    solve-plane shape under ``other_shapes``: measured values and the
    roofline bound only.  The work line holds what was counted."""
    n, k = LINE_SHAPE
    main = measure_kernels(rng, n, k, "weighted", reps=5)
    others = [measure_kernels(rng, n2, k2, kind, reps=2)
              for n2, k2, kind in PLANE if (n2, k2) != (n, k)]
    names = {
        "sw": ("mcop_stoer_wagner_kernel", "mcop_sw.cu", 382),
        "fused": ("mcop_fused_solve_kernel", "mcop_fused.cu", 606),
    }
    work = {"phase": "kernel_work",
            "assumed_smem_bytes_per_s": SMEM_BYTES_PER_S,
            "shapes": [m["work"] for m in (main, *others)]}
    return work, {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": f"src/repro/kernels/mcop_phase.py:{line}",
         "launches": launches[name], "library_ms": None, **main[key],
         "other_shapes": [o[key] for o in others]}
        for key, (name, src, line) in names.items()
    ]}


# ----------------------------------------------------------------------
# Phase 3: the attention and Mamba2-scan kernels against their plain versions
# ----------------------------------------------------------------------


def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attention, mamba_scan, mcop_phase

    for mod in (mcop_phase, flash_attention, mamba_scan):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import flash_attention, mamba_scan, mcop_phase

    return {**mcop_phase.LAUNCHES, **flash_attention.LAUNCHES, **mamba_scan.LAUNCHES,
            **flash_attention.BWD_LAUNCHES, **mamba_scan.BWD_LAUNCHES}


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, per (batch, head)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, q + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, q - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def bound(nbytes: float, flops: float, flop_rate: float):
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def flash_inputs(gen, case):
    """q, k (B, H, S, hd) and v (B, H, S, hd_v) of a FLASH_CHECKS or
    MLA_FLASH_CHECKS case, in its layout."""
    b, h, hkv, sq, sk, hd, _, _, dtype, layout, *rest = case
    hd_v = rest[0] if rest else hd

    def draw(heads, s, width):
        shape = (b, heads, s, width) if layout == "heads" else (b, s, heads, width)
        t = torch.randn(shape, generator=gen, device=DEVICE).to(getattr(torch, dtype))
        return t if layout == "heads" else t.transpose(1, 2)

    return draw(h, sq, hd), draw(hkv, sk, hd), draw(hkv, sk, hd_v)


def check_flash(rng, case, *, measure: bool) -> dict:
    from repro_torch.kernels.flash_attention import VARIANT_LAUNCHES, flash_attention_kernel
    from repro_torch.kernels.ref import flash_attention_plain

    b, h, hkv, sq, sk, hd, causal, window, dtype, layout, *rest = case
    hd_v = rest[0] if rest else hd
    atol, rtol = FLASH_TOL[dtype]
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    q, k, v = flash_inputs(gen, case)
    variant = expected_flash_variant(dtype, hd, hd_v)
    before = dict(VARIANT_LAUNCHES)
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {name: VARIANT_LAUNCHES[name] - before[name] for name in VARIANT_LAUNCHES}
    if ran != {name: int(name == variant) for name in VARIANT_LAUNCHES}:
        raise AssertionError(f"flash {case}: launched {ran}, expected the {variant} variant")
    want, plain_ms = timed(lambda: flash_attention_plain(q, k, v, causal=causal, window=window))
    want = want.float()
    tol = atol + rtol * want.abs()
    err = (got.float() - want).abs()
    worst = float((err / tol).max())
    if worst > 1.0:
        raise AssertionError(f"flash {case}: kernel vs plain max error {float(err.max())}, "
                             f"{worst} x the tolerance")
    mean_abs = float(want.abs().mean())
    entry = {"name": "flash_attention_kernel",
             "shape": [b, h, hkv, sq, sk, hd] + ([hd_v] if rest else []),
             "variant": variant,
             "causal": causal, "window": window, "dtype": dtype, "layout": layout,
             "atol": atol, "rtol": rtol, "max_abs_err": float(err.max()),
             "max_err_over_tol": worst, "mean_abs_out": mean_abs,
             "tol_at_mean_abs_out": atol + rtol * mean_abs}
    del err
    if measure:
        pairs = attention_pairs(sq, sk, causal, window)
        nbytes = (q.numel() + k.numel() + v.numel() + b * h * sq * hd_v) * q.element_size()
        flops = 2.0 * (hd + hd_v) * pairs * b * h
        b_ms, b_by = bound(nbytes, flops,
                           BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S)
        idx = torch.arange(sq, device=DEVICE)[:, None], torch.arange(sk, device=DEVICE)[None]
        band = torch.ones((sq, sk), dtype=torch.bool, device=DEVICE)
        if causal:
            band &= idx[1] <= idx[0]
        if window is not None:
            band &= idx[1] > idx[0] - window
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library():
            if causal and window is None and sq == sk:  # the same band, SDPA's fast path
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)
            return sdpa(q, k, v, attn_mask=band, enable_gqa=True)

        try:
            lib = library().float()
        except RuntimeError as refusal:  # SDPA refuses the shape: say so, time nothing
            entry["library_refused"] = str(refusal)[:300]
            library = None
        if library is not None:
            # how the library's own arithmetic fares under the same tolerance
            entry["library_max_abs_err"] = float((lib - want).abs().max())
            entry["library_share_outside_tol"] = float(((lib - want).abs() > tol).float().mean())
            del lib
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=causal, window=window),
                     reps=3)
        entry.update({
            "ms": ms, "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else cuda_ms(library, reps=3),
            "pairs_per_head": pairs,
        })
    return entry


# B4's row log-sum-exp L (return_lse, which FlashAttentionFn keeps for
# B4-bwd), MLA_FLASH_CHECKS' fields: the tensor-core variant at (64, 64),
# (128, 128) and (192, 128), the CUDA-core one in f32 and at a narrow bf16
# head, and rows that see no key (full attention, window 16, 63 keys: rows
# from 78 on), where L is 0.  Held to torch.logsumexp of the plain version's
# scaled scores: |L - want| <= FLASH_LSE_TOL x max(1, |want|) (f32 sums of up
# to 4500 exponentials in another order, and the SFU's exp2 in the
# tensor-core variant, ~1e-6 of L).  The output written beside L must equal
# the output without it bit for bit (serving's path passes no L).
FLASH_LSE_CHECKS = (
    (2, 8, 2, 1000, 1337, 64, False, 300, "bfloat16", "model"),
    (1, 8, 8, 4500, 4500, 128, True, 4096, "bfloat16", "heads"),
    (2, 4, 4, 1000, 1337, 192, False, 300, "bfloat16", "heads", 128),
    (1, 4, 2, 200, 63, 64, False, 16, "bfloat16", "heads"),
    (1, 4, 2, 200, 63, 64, False, 16, "float32", "heads"),
    (1, 8, 8, 4500, 4500, 64, True, 4096, "float32", "model"),
    (2, 4, 2, 1000, 1337, 32, True, 300, "bfloat16", "model"),
)
FLASH_LSE_TOL = 1e-4


def check_flash_lse(rng, case) -> dict:
    from repro_torch.kernels.flash_attention import VARIANT_LAUNCHES, flash_attention_kernel
    from repro_torch.kernels.ref import flash_attention_lse_plain

    b, h, hkv, sq, sk, hd, causal, window, dtype, layout, *rest = case
    hd_v = rest[0] if rest else hd
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    q, k, v = flash_inputs(gen, case)
    variant = expected_flash_variant(dtype, hd, hd_v)
    before = dict(VARIANT_LAUNCHES)
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window, return_lse=True)
    plain_out = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {name: VARIANT_LAUNCHES[name] - before[name] for name in VARIANT_LAUNCHES}
    if ran != {name: 2 * int(name == variant) for name in VARIANT_LAUNCHES}:
        raise AssertionError(f"flash lse {case}: launched {ran}, expected the {variant} variant")
    if not torch.equal(out, plain_out):
        raise AssertionError(f"flash lse {case}: the output differs when L is written")
    want = flash_attention_lse_plain(q, k, causal=causal, window=window)
    err = (lse - want).abs()
    worst = float((err / (FLASH_LSE_TOL * want.abs().clamp_min(1.0))).max())
    if not worst <= 1.0:
        raise AssertionError(f"flash lse {case}: L max error {float(err.max())}, "
                             f"{worst} x the tolerance")
    return {"name": "flash_attention_kernel.lse", "shape": [b, h, hkv, sq, sk, hd, hd_v],
            "variant": variant, "causal": causal, "window": window, "dtype": dtype,
            "tol": FLASH_LSE_TOL, "max_abs_err": float(err.max()), "max_err_over_tol": worst,
            "rows_without_keys": int((want == 0).sum()), "out_equal_without_lse": True}


def mamba_inputs(gen, case):
    """(x, dt, ld, Bm, Cm, h0) of a MAMBA_CHECKS case, in its layout, as
    kernels.ops.mamba_chunk_scan hands them to the kernel."""
    b, s_real, s, h, p, n, q, layout = case
    nc = s // q

    def draw(shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, device=DEVICE)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEVICE)

    real = (torch.arange(s, device=DEVICE) < s_real).float()[None, :, None]
    dt = draw((b, s, h), 0.05, 1.0) * real        # padded steps: dt = 0
    ld = -draw((b, s, h), 0.01, 0.8) * real
    if layout == "slices":
        x, bm, cm = torch.split(draw((b, s, h * p + 2 * n)), [h * p, n, n], dim=-1)
    else:
        x, bm, cm = draw((b, s, h * p)), draw((b, s, n)), draw((b, s, n))
    args = (x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4),
            dt.reshape(b, nc, q, h).permute(0, 3, 1, 2),
            ld.reshape(b, nc, q, h).permute(0, 3, 1, 2),
            bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n), draw((b, h, p, n)))
    return tuple(t.contiguous() for t in args) if layout == "heads" else args


def check_mamba(rng, case, *, measure: bool) -> dict:
    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_kernel
    from repro_torch.kernels.ref import mamba_chunk_scan_plain

    b, s_real, s, h, p, n, q, layout = case
    nc = s // q
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    args = mamba_inputs(gen, case)
    x, dt, ld, bm, cm, h0 = args
    got = mamba_chunk_scan_kernel(*args)
    torch.cuda.synchronize()
    want, plain_ms = timed(lambda: mamba_chunk_scan_plain(*args))
    errs, over = [], []
    for g_t, w_t in zip(got, want):
        err = float((g_t - w_t).abs().max())
        scale = max(1.0, float(w_t.abs().max()))
        if err > MAMBA_RTOL * scale:
            raise AssertionError(f"mamba {case}: kernel vs plain max error {err} at scale {scale}")
        errs.append(err)
        over.append(err / (MAMBA_RTOL * scale))
    entry = {"name": "mamba_chunk_scan_kernel", "shape": [b, h, nc, q, p, n],
             "real_steps": s_real, "layout": layout, "max_abs_err": max(errs),
             "y_err": errs[0], "h_err": errs[1], "max_err_over_tol": max(over)}
    if measure:
        pairs = q * (q + 1) // 2
        # C.B^T once per (batch, chunk), since Bm and Cm are shared by every
        # head; per (batch, head, chunk) the triangular W.x product, the
        # C h^T read-out and the state update
        flops = 2.0 * b * nc * pairs * n + 2.0 * b * h * nc * (pairs * p + 2 * q * p * n)
        nbytes = 4 * (2 * x.numel() + dt.numel() + ld.numel() + bm.numel() + cm.numel()
                      + 2 * h0.numel())
        # the products run on the tensor cores as TF32 (3xTF32): the bound is
        # against that unit's rate, the CUDA cores' f32 rate beside it
        b_ms, b_by = bound(nbytes, flops, TF32_FLOP_PER_S)
        f32_ms, _ = bound(nbytes, flops, FP32_FLOP_PER_S)
        ms = cuda_ms(lambda: mamba_chunk_scan_kernel(*args), reps=3)
        entry.update({"ms": ms, "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "bound_f32_ms": f32_ms, "library_ms": None})
    return entry


# B4-bwd checks, MLA_FLASH_CHECKS' fields (hd_v last).  First zamba2-1.2b's
# training shape (bf16, 2 sequences of 8192, 32 heads of 64, window 4096),
# timed for the kernels line beside SDPA's forward + backward; then
# qwen2-7b's GQA 28/4 at (128, 128) over the train_replay length, odd and
# padded lengths with a window on full attention in f32 and bf16, MLA's
# (192, 128) and the reduced pair (24, 16) in f32 and bf16, a narrow head,
# and qwen2-7b's heads at 8192 tokens as the distributed phases hand them to
# B4-bwd: a rank's 14 q / 2 kv heads (train_sharded), 28 / 4 (pipeline).
FLASH_BWD_CHECKS = (
    (2, 32, 32, 8192, 8192, 64, True, 4096, "bfloat16", "model", 64),
    (1, 28, 4, 4160, 4160, 128, True, None, "bfloat16", "model", 128),
    (1, 8, 8, 4500, 4500, 64, True, 4096, "float32", "heads", 64),
    (3, 2, 2, 17, 63, 8, False, 16, "float32", "heads", 8),
    (2, 4, 2, 1000, 1337, 64, False, 300, "float32", "model", 64),
    (2, 4, 2, 1000, 1337, 64, False, 300, "bfloat16", "model", 64),
    (1, 8, 8, 700, 700, 192, True, None, "float32", "model", 128),
    (2, 4, 4, 1000, 1337, 192, False, 300, "bfloat16", "heads", 128),
    (2, 4, 4, 4200, 4200, 24, True, None, "float32", "model", 16),
    (2, 4, 4, 1000, 1337, 24, False, 300, "bfloat16", "heads", 16),
    (1, 8, 2, 333, 517, 32, True, 100, "bfloat16", "heads", 32),
    (1, 14, 2, 8192, 8192, 128, True, None, "bfloat16", "model", 128),
    (1, 28, 4, 8192, 8192, 128, True, None, "bfloat16", "model", 128),
    (1, 16, 16, 8192, 8192, 64, True, 4096, "bfloat16", "model", 64),
    (1, 2, 2, 4160, 4160, 16, True, 4096, "float32", "model", 16),
    (1, 2, 2, 4160, 4160, 192, True, None, "float32", "model", 128),
    (1, 64, 64, 8192, 8192, 192, True, None, "bfloat16", "model", 128),
)
# the last four: the local shapes of train_sharded_families and of
# deepseek-v2 on four GPUs (FLASH_CHECKS, MLA_FLASH_CHECKS).
# max |kernel - plain| of each gradient over its max |plain|.  f32: sums in
# another order over up to 8192 keys, and P = exp(s - L) against the plain
# version's exp(s - max) / sum, ~1e-6 of the largest gradient; 1e-4 leaves
# room for the cancellation in dS = P (dP - D).  bf16: both sides round
# each gradient to bf16 (one step is 2^-8 of the value) and the kernel's D
# reads the bf16 output where autograd has the f32 one: 2^-7 of the largest.
FLASH_BWD_TOL = {"bfloat16": 2.0**-7, "float32": 1e-4}
FLASH_BWD_PLAIN_HEADS = 4  # query heads a call of the plain backward takes (its memory)
# B5-bwd checks, MAMBA_CHECKS' fields: zamba2-1.2b's training shape (2 x 8192
# tokens, 64 heads, 32 chunks of 256, P = N = 64), timed for the kernels line,
# then a ragged final chunk (4100 steps padded to 4352, dt = 0 on the padding)
# and the reduced model's widths.  Held like the forward: max |kernel -
# plain| <= 1e-4 x max(1, max |plain|) for each gradient.
MAMBA_BWD_CHECKS = (
    (2, 8192, 8192, 64, 64, 64, 256, "model"),
    (2, 4100, 4352, 64, 64, 64, 256, "heads"),
    (2, 4100, 4112, 8, 16, 16, 16, "slices"),
    (1, 8192, 8192, 32, 64, 64, 256, "model"),
    (1, 4160, 4160, 4, 16, 16, 16, "model"),
)


def flash_bwd_plain_sliced(q, k, v, dout, *, causal, window):
    """The plain backward (autograd through the plain version) over groups
    of KV heads holding ``FLASH_BWD_PLAIN_HEADS`` query heads or more, one
    call each: the whole input, in pieces autograd's memory allows."""
    from repro_torch.kernels.ref import flash_attention_bwd_plain

    hkv = k.shape[1]
    rep = q.shape[1] // hkv
    step = max(1, FLASH_BWD_PLAIN_HEADS // rep)
    parts = [[], [], []]
    for g in range(0, hkv, step):
        qs, ks = slice(g * rep, (g + step) * rep), slice(g, g + step)
        for i, t in enumerate(flash_attention_bwd_plain(
                q[:, qs], k[:, ks], v[:, ks], dout[:, qs], causal=causal, window=window)):
            parts[i].append(t)
    return tuple(torch.cat(p_, dim=1) for p_ in parts)


def hold_grads(tag, got, want, names, tol, *, floor=0.0) -> dict:
    """Each gradient's max |got - want| against ``tol`` x max(floor, max
    |want|); returns the errors."""
    out = {}
    for name, g_t, w_t in zip(names, got, want):
        err = float((g_t.float() - w_t.float()).abs().max())
        scale = max(floor, float(w_t.float().abs().max()))
        if not err <= tol * scale:
            raise AssertionError(f"{tag}: {name} kernel vs plain max error {err}, "
                                 f"tolerance {tol} x {scale}")
        out[name] = {"max_abs_err": err, "max_abs": scale, "err_over_tol": err / (tol * scale)}
    return out


def check_flash_bwd(rng, case, *, measure: bool) -> dict:
    from repro_torch.kernels.flash_attention import (
        BWD_LAUNCHES, BWD_VARIANT_LAUNCHES, flash_attention_bwd_kernel, flash_attention_kernel,
    )

    b, h, hkv, sq, sk, hd, causal, window, dtype, layout, hd_v = case
    tol = FLASH_BWD_TOL[dtype]
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    q, k, v = flash_inputs(gen, case)
    shape = (b, h, sq, hd_v) if layout == "heads" else (b, sq, h, hd_v)
    dout = torch.randn(shape, generator=gen, device=DEVICE).to(q.dtype)
    dout = dout if layout == "heads" else dout.transpose(1, 2)
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window, return_lse=True)
    variant = expected_flash_variant(dtype, hd, hd_v)
    before, before_v = BWD_LAUNCHES["flash_attention_bwd_kernel"], dict(BWD_VARIANT_LAUNCHES)
    got = flash_attention_bwd_kernel(q, k, v, out, dout, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    if BWD_LAUNCHES["flash_attention_bwd_kernel"] - before != 1:
        raise AssertionError(f"flash bwd {case}: the backward kernel did not launch once")
    ran = {n: BWD_VARIANT_LAUNCHES[n] - before_v[n] for n in BWD_VARIANT_LAUNCHES}
    if ran != {n: int(n == variant) for n in BWD_VARIANT_LAUNCHES}:
        raise AssertionError(f"flash bwd {case}: launched {ran}, expected the {variant} variant")
    want, plain_ms = timed(lambda: flash_bwd_plain_sliced(q, k, v, dout, causal=causal,
                                                          window=window))
    errs = hold_grads(f"flash bwd {case}", got, want, ("dq", "dk", "dv"), tol)
    del want
    entry = {"name": "flash_attention_bwd_kernel", "shape": [b, h, hkv, sq, sk, hd, hd_v],
             "variant": variant, "causal": causal, "window": window, "dtype": dtype, "layout": layout,
             "tol": tol, "grads": errs,
             "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
             "max_err_over_tol": max(e["err_over_tol"] for e in errs.values())}
    if measure:
        pairs = attention_pairs(sq, sk, causal, window)
        nbytes = (2 * (q.numel() + k.numel() + v.numel())
                  + 2 * out.numel()) * q.element_size()
        # the function's products a visible pair: S again (hd), dP = dout v^T
        # (hd_v), dv (hd_v), dq and dk (hd each)
        flops = 2.0 * (3 * hd + 2 * hd_v) * pairs * b * h
        b_ms, b_by = bound(nbytes, flops,
                           BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S)
        ms = cuda_ms(lambda: flash_attention_bwd_kernel(q, k, v, out, dout, lse, causal=causal,
                                                        window=window), reps=2)
        idx = torch.arange(sq, device=DEVICE)[:, None], torch.arange(sk, device=DEVICE)[None]
        band = torch.ones((sq, sk), dtype=torch.bool, device=DEVICE)
        if causal:
            band &= idx[1] <= idx[0]
        if window is not None:
            band &= idx[1] > idx[0] - window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def library():  # SDPA's forward and backward on the same inputs
            o_ = sdpa(*leaves, attn_mask=band, enable_gqa=True)
            return torch.autograd.grad(o_, leaves, dout)

        try:
            library()
            lib_ms = cuda_ms(library, reps=2)
        except RuntimeError as refusal:  # SDPA refuses the shape: say so, time nothing
            entry["library_refused"] = str(refusal)[:300]
            lib_ms = None
        entry.update({"ms": ms, "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms, "library": "sdpa forward + backward",
                      "pairs_per_head": pairs})
    return entry


def check_mamba_bwd(rng, case, *, measure: bool) -> dict:
    from repro_torch.kernels import mamba_scan
    from repro_torch.kernels.ref import mamba_chunk_scan_bwd_plain

    b, s_real, s, h, p, n, q, layout = case
    nc = s // q
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    x, dt, ld, bm, cm, h0 = mamba_inputs(gen, case)
    _, _, states = mamba_scan._scan(x, dt, ld, bm, cm, h0)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE)
    dh = torch.randn(h0.shape, generator=gen, device=DEVICE)
    before = mamba_scan.BWD_LAUNCHES["mamba_chunk_scan_bwd_kernel"]
    got = mamba_scan.mamba_chunk_scan_bwd_kernel(x, dt, ld, bm, cm, states, dy, dh)
    torch.cuda.synchronize()
    if mamba_scan.BWD_LAUNCHES["mamba_chunk_scan_bwd_kernel"] - before != 1:
        raise AssertionError(f"mamba bwd {case}: the backward kernel did not launch once")
    want, plain_ms = timed(lambda: mamba_chunk_scan_bwd_plain(x, dt, ld, bm, cm, h0, dy, dh))
    names = ("dx", "ddt", "dld", "dbm", "dcm", "dh0")
    errs = hold_grads(f"mamba bwd {case}", got, want, names, MAMBA_RTOL, floor=1.0)
    del want
    entry = {"name": "mamba_chunk_scan_bwd_kernel", "shape": [b, h, nc, q, p, n],
             "real_steps": s_real, "layout": layout, "tol": MAMBA_RTOL, "grads": errs,
             "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
             "max_err_over_tol": max(e["err_over_tol"] for e in errs.values())}
    if measure:
        pairs = q * (q + 1) // 2
        # per (batch, chunk) C B^T; per (batch, head, chunk) the four
        # triangular products (D, W^T dy, V C, V B) and five state products
        # (the chunk's part of the state gradient, g B, g^T u, h^T dy, h C)
        flops = 2.0 * b * nc * pairs * n + 2.0 * b * h * nc * (
            pairs * (2 * p + 2 * n) + 5 * q * p * n)
        nbytes = 4 * (2 * x.numel() + 3 * dt.numel() + 2 * ld.numel() + 2 * bm.numel()
                      + 2 * cm.numel() + 2 * dh.numel() + states.numel() + h0.numel())
        # bounded as B5 is: f32 products at the card's peak for them (the
        # tensor cores as TF32), the CUDA cores' f32 rate, which this kernel
        # runs on, beside it
        b_ms, b_by = bound(nbytes, flops, TF32_FLOP_PER_S)
        f32_ms, _ = bound(nbytes, flops, FP32_FLOP_PER_S)
        ms = cuda_ms(lambda: mamba_scan.mamba_chunk_scan_bwd_kernel(
            x, dt, ld, bm, cm, states, dy, dh), reps=3)
        entry.update({"ms": ms, "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "bound_f32_ms": f32_ms, "library_ms": None})
    return entry


# step 0's uneven GQA: qwen2-7b's 28 query / 4 kv heads chunked over 16
# model ranks (2 a rank on 14, none on 2), bf16, 2048 tokens
GQA_UNEVEN = {"heads": 28, "kv_heads": 4, "ranks": 16, "seq": 2048, "hd": 128}


def check_gqa_uneven(rng) -> dict:
    """B4 and B4-bwd on each rank's query heads and the kv heads
    ``kernels.ops.gqa_local_kv`` selects for them (a view, or one kv head
    per query head), through ``ops.flash_attention`` with autograd: each
    rank's output against the plain version's of the whole GQA at its
    heads, and the sum of the ranks' k/v gradients (DTensor's ``Partial``
    over the replicated k and v) and their q gradients against the plain
    backward's, at the bf16 tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain

    c = GQA_UNEVEN
    h, hkv, s, hd, m = c["heads"], c["kv_heads"], c["seq"], c["hd"], c["ranks"]
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    q, k, v = (torch.randn((1, s, n, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
               for n in (h, hkv, hkv))
    dout = torch.randn((1, s, h, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = flash_attention_plain(*(t.transpose(1, 2) for t in leaves), causal=True)
    want.backward(dout.float().transpose(1, 2))
    want = want.transpose(1, 2).to(torch.bfloat16)
    per = -(-h // m)
    out_err, local = 0.0, []
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for r in range(m):
        h0, nh = min(r * per, h), max(0, min(per, h - r * per))
        local.append(nh)
        if nh == 0:
            continue
        ql = q[:, :, h0:h0 + nh].detach().requires_grad_(True)
        kk, vv = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
        kl, vl = ops.gqa_local_kv(kk, vv, h0, nh, h // hkv)
        got = ops.flash_attention(ql, kl, vl, causal=True)
        got.backward(dout[:, :, h0:h0 + nh])
        want_r = want[:, :, h0:h0 + nh].float()
        out_err = max(out_err, float((got.float() - want_r).abs().max()
                                     / want_r.abs().max()))
        dq[:, :, h0:h0 + nh] += ql.grad.float()
        dk += kk.grad.float()
        dv += vv.grad.float()
    tol = FLASH_BWD_TOL["bfloat16"]
    errs = {"out": out_err}
    for name, got_g, leaf in (("dq", dq, leaves[0]), ("dk", dk, leaves[1]), ("dv", dv, leaves[2])):
        errs[name] = float((got_g - leaf.grad).abs().max() / leaf.grad.abs().max())
    if not max(errs.values()) <= tol:
        raise AssertionError(f"uneven GQA over {m} ranks: {errs} over {tol}")
    return {"name": "flash_attention_kernel.gqa_uneven", "heads": [h, hkv], "ranks": m,
            "local_heads": local, "seq": s, "hd": hd, "dtype": "bfloat16",
            "max_rel_err": errs, "tol": tol,
            "tol_meaning": "max |kernel - plain| / max |plain|, each of out, dq, dk, dv"}


# B6 (decode_attention_kernel) through models.attention.decode_attention,
# held to _decode_local (the path it replaces) on the same inputs:
# (B, H, Hkv, slots, position of the first query, Sq, hd, window, dtype).
# First the served cell's decode step (qwen2-7b: a wave of 8, 28 / 4 heads
# of 128, a cache of 8 201 slots, the query at position 8 192), timed for
# the kernels line; then a prompt of 2 into the cache (6 rows), a window
# over 1:1 heads of 64 (1 row), 8 rows at the last slot, 8 rows at position
# 0 (one slot seen), 7 rows at hd 64 with a window, 4 rows, and lengths that
# are no multiple of a tile.  k and v are one layer's views of a stacked
# (L, B, S, Hkv, hd) cache, as the model reads them.
DECODE_CHECKS = (
    (8, 28, 4, 8201, 8192, 1, 128, None, "bfloat16"),
    (2, 12, 4, 4200, 4097, 2, 128, None, "bfloat16"),
    (2, 8, 8, 1000, 700, 1, 64, 300, "bfloat16"),
    (3, 16, 2, 517, 516, 1, 128, None, "bfloat16"),
    (1, 8, 1, 333, 0, 1, 128, None, "bfloat16"),
    (1, 7, 1, 6001, 5000, 1, 64, 4096, "bfloat16"),
    (2, 8, 2, 300, 299, 1, 128, None, "bfloat16"),
)
# atol; both sides round an f32 result to bf16, so they may differ by one
# step of it (eps |o|, eps = 2^-7), and each lies within half a step of the
# float64 value (eps / 2 |o|) plus what f32 sums in another order leave
# (under 1e-6 at unit-normal inputs)
DECODE_ATOL = 1e-5
DECODE_TIME_LAYERS = 4   # distinct caches the timed calls cycle over (537 MB: L2 stays cold)


def decode_f64(q, k, v, q_pos, *, scale, window):
    """The function of B6 in float64 (the yardstick of both sides)."""
    b, sq, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, hkv, h // hkv, hd).double(),
                          k.double()) * scale
    j = torch.arange(s, device=q.device)
    seen = j[None, :] <= q_pos[:, None]
    if window is not None:
        seen &= j[None, :] > q_pos[:, None] - window
    p = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.double())
    return out.reshape(b, sq, h, hd)


def check_decode_attention(rng, case, *, measure: bool) -> dict:
    from repro_torch.kernels import decode_attention as b6
    from repro_torch.models import attention as attn

    b, h, hkv, slots, pos, sq, hd, window, dtype = case
    dt = getattr(torch, dtype)
    eps = torch.finfo(dt).eps
    layers = DECODE_TIME_LAYERS if measure else 1
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    kc, vc = (torch.randn((layers, b, slots, hkv, hd), generator=gen, device=DEVICE).to(dt)
              for _ in range(2))
    q = torch.randn((b, sq, h, hd), generator=gen, device=DEVICE).to(dt)
    q_pos = pos + torch.arange(sq, device=DEVICE)
    scale = 1.0 / np.sqrt(hd)
    kw = {"q_pos": q_pos, "scale": scale, "k_pos": attn._slot_positions, "window": window}
    before = b6.LAUNCHES["decode_attention_kernel"]
    got = attn.decode_attention([q], [kc[0]], vc[0], **kw)
    torch.cuda.synchronize()
    if b6.LAUNCHES["decode_attention_kernel"] - before != 1:
        raise AssertionError(f"decode {case}: decode_attention did not take B6")

    def local(j=0):
        return attn._decode_local([q], [kc[j]], vc[j], None, j0=0, score_groups=(),
                                  slot_groups=(), **kw)

    want, local_ms = timed(local)
    ref = decode_f64(q, kc[0], vc[0], q_pos, scale=scale, window=window)
    err = (got.float() - want.float()).abs()
    worst = float((err / (DECODE_ATOL + eps * want.float().abs())).max())
    err64 = (got.double() - ref).abs()
    worst64 = float((err64 / (DECODE_ATOL + eps / 2 * ref.abs())).max())
    local64 = float(((want.double() - ref).abs() / (DECODE_ATOL + eps / 2 * ref.abs())).max())
    if worst > 1.0 or worst64 > 1.0:
        raise AssertionError(f"decode {case}: kernel vs _decode_local {worst}, vs float64 "
                             f"{worst64} x the tolerance")
    entry = {"name": "decode_attention_kernel", "shape": [b, h, hkv, slots, sq, hd],
             "position": pos, "window": window, "dtype": dtype,
             "max_abs_err": float(err.max()), "max_err_over_tol": worst,
             "equal_share": float((got == want).float().mean()),
             "f64_err_over_half_step": worst64, "decode_local_f64_err_over_half_step": local64,
             "atol": DECODE_ATOL, "rtol": eps,
             "tol_meaning": "|kernel - _decode_local| <= atol + eps |_decode_local|; "
                            "|kernel - f64| <= atol + eps / 2 |f64|"}
    del err, err64, ref
    if measure:
        hi = min(slots, pos + sq)
        lo = max(0, pos - window + 1) if window is not None else 0
        seen = hi - lo
        nbytes = (2 * b * hkv * seen * hd + 2 * b * sq * h * hd) * q.element_size()
        flops = 4.0 * hd * b * h * sq * seen
        b_ms, b_by = bound(nbytes, flops, FP32_FLOP_PER_S)
        turn = [0]

        def layer() -> int:   # each call a layer of its own, as the model's step reads them
            turn[0] += 1
            return turn[0] % layers

        def call():
            j = layer()
            return b6.decode_attention_kernel(q, kc[j], vc[j], q_pos, scale=scale, window=window)

        ms = graph_ms(call, reps=8 * layers)
        _, plain_ms = timed(lambda: b6.decode_attention_plain(q, kc[0], vc[0], q_pos,
                                                              scale=scale, window=window))
        entry.update({
            "ms": ms, "call_ms": cuda_ms(call, reps=8 * layers),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "gbytes_per_s": nbytes / ms / 1e6, "slots_read": seen,
            "splits": b6.decode_splits(b * hkv, slots, b6._resident(q.device, hd,
                                                                    h // hkv * sq)),
            "plain_ms": plain_ms, "decode_local_ms": local_ms,
            "decode_local_call_ms": cuda_ms(lambda: local(layer()), reps=2 * layers),
            "library_ms": None,
        })
    return entry


def phase_model_kernel_checks(rng) -> dict:
    """B4 and B5 against their plain versions; the first shape of each is
    the hybrid model's prefill and is also timed for the kernels line, and
    so is the first MLA shape (deepseek-v2's prefill)."""
    flash = [check_flash(rng, c, measure=i == 0) for i, c in enumerate(FLASH_CHECKS)]
    mla = [check_flash(rng, c, measure=i == 0) for i, c in enumerate(MLA_FLASH_CHECKS)]
    lse = [check_flash_lse(rng, c) for c in FLASH_LSE_CHECKS]
    torch.cuda.empty_cache()
    mamba = [check_mamba(rng, c, measure=i == 0) for i, c in enumerate(MAMBA_CHECKS)]
    torch.cuda.empty_cache()
    flash_bwd = [check_flash_bwd(rng, c, measure=i == 0)
                 for i, c in enumerate(FLASH_BWD_CHECKS)]
    torch.cuda.empty_cache()
    mamba_bwd = [check_mamba_bwd(rng, c, measure=i == 0)
                 for i, c in enumerate(MAMBA_BWD_CHECKS)]
    torch.cuda.empty_cache()
    gqa = [check_gqa_uneven(rng)]
    torch.cuda.empty_cache()
    decode = [check_decode_attention(rng, c, measure=i == 0) for i, c in enumerate(DECODE_CHECKS)]
    torch.cuda.empty_cache()
    return {"phase": "model_kernel_checks",
            "entries": flash + mla + lse + mamba + flash_bwd + mamba_bwd + gqa + decode}


# ----------------------------------------------------------------------
# Phases 6 and 7: serving the hybrid model
# ----------------------------------------------------------------------


class StepWatch:
    """The model as the serving engine sees it; every step's logits must be
    finite, and each prefill's are kept on the host."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.prefill_logits = []

    def init_cache(self, batch_size, max_len):
        return self.model.init_cache(batch_size, max_len)

    def prefill(self, params, batch, cache):
        logits, cache = self.model.prefill(params, batch, cache)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        self.prefill_logits.append(logits.float().cpu())
        return logits, cache

    def decode_step(self, params, tokens, cache):
        logits, cache = self.model.decode_step(params, tokens, cache)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
        return logits, cache


def submit_requests(engine, spec: dict, vocab: int) -> None:
    prng = np.random.default_rng(spec["seed"])
    lo, hi = spec["prompt"]
    for _ in range(spec["requests"]):
        plen = int(prng.integers(lo, hi + 1))
        engine.submit(prng.integers(1, vocab, size=plen), max_new_tokens=spec["new_tokens"])


def drive_engine(engine, sync) -> list[dict]:
    """Run the engine to completion one step at a time; per wave, the
    prefill's seconds and tokens and the decode steps' seconds and tokens."""
    waves = []
    while engine.active or engine.queue:
        prefill = not engine.active
        if prefill:
            n = min(len(engine.queue), engine.cfg.max_batch)
            prompts = [len(r.prompt) for r in list(engine.queue)[:n]]
            waves.append({"requests": n, "prompt_tokens": sum(prompts),
                          "padded_tokens": engine.cfg.max_batch * max(prompts),
                          "decode_steps": 0, "decode_tokens": 0, "decode_seconds": 0.0})
        active = len(engine.active)
        t0 = time.perf_counter()
        engine.step()
        sync()
        dt = time.perf_counter() - t0
        wave = waves[-1]
        if prefill:
            wave["prefill_seconds"] = dt
        else:
            wave["decode_steps"] += 1
            wave["decode_tokens"] += active
            wave["decode_seconds"] += dt
    return waves


def phase_serve() -> dict:
    """zamba2-1.2b at full width through the KV-cache engine (the main
    path of this slice): the launch counters are read around it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.placement import TPUV5E_TIER, plan_placement
    from repro_torch.kernels.flash_attention import VARIANT_LAUNCHES
    from repro_torch.models.transformer import build_model
    from repro_torch.profilers.program import stage_specs
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_config(SERVE["arch"])
    mb, (lo, hi), new = SERVE["max_batch"], SERVE["prompt"], SERVE["new_tokens"]
    # the placement report of launch/serve.py
    plan = plan_placement(
        stage_specs(cfg, ShapeConfig("cli", "decode", 4096, mb), group=max(cfg.n_layers // 8, 1)),
        dataclasses.replace(TPUV5E_TIER, name="decode-pool", chips=64),
        dataclasses.replace(TPUV5E_TIER, name="prefill-pool", chips=192),
    )
    report = (f"[serve] MCOP placement: cut={plan.mcop_cost:.3e}s "
              f"split={plan.contiguous_boundary}/{plan.stage_tier.shape[0]} "
              f"cut_bytes={plan.cut_bytes:.3e}")
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE)
    params = model.init(SERVE["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    watch = StepWatch(model)
    engine = ServingEngine(watch, params, ServingConfig(
        max_batch=mb, max_prompt_len=hi, max_len=hi + new + 1), rng_seed=SERVE["seed"])
    submit_requests(engine, SERVE, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()  # ---- this slice's main path starts here ----
    waves = drive_engine(engine, torch.cuda.synchronize)
    launches = all_launches()  # ---- and ends here ----
    variants = dict(VARIANT_LAUNCHES)
    prefills = len(waves)
    groups = cfg.n_layers // cfg.shared_attn_every
    want = {"flash_attention_kernel": groups * prefills,
            "mamba_chunk_scan_kernel": cfg.n_layers * prefills}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"serve: {name} launched {launches[name]} times, "
                                 f"expected {count} ({prefills} prefills)")
    if variants != {"tensor_cores": launches["flash_attention_kernel"], "cuda_cores": 0}:
        raise AssertionError(f"serve: B4 variants {variants}; every prefill launch "
                             "must take the tensor-core variant")
    done = engine.finished
    if len(done) != SERVE["requests"] or any(len(s.generated) != new for s in done.values()):
        raise AssertionError("serve: not every request got its tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre_s = sum(w["prefill_seconds"] for w in waves)
    dec_s = sum(w["decode_seconds"] for w in waves)
    return {
        "phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
        "params": sum(p_.numel() for p_ in params.parameters()),
        "placement_report": report, "init_seconds": init_s, "waves": waves,
        "prefill_tokens_per_s": sum(w["prompt_tokens"] for w in waves) / pre_s,
        "prefill_padded_tokens_per_s": sum(w["padded_tokens"] for w in waves) / pre_s,
        "decode_tokens_per_s": sum(w["decode_tokens"] for w in waves) / dec_s,
        "peak_memory_gb": peak_gb,
        "launches": {k: launches[k] for k in want},
        "flash_variant_launches": variants,
        "launches_per_prefill": {k: launches[k] / prefills for k in want},
        "main_path_launches": launches,
    }


def phase_serve_replay() -> dict:
    """The engine at reduced width in f32 on the card (kernels) and on the
    CPU (plain versions), same parameters, same requests."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = reduce_config(get_config(SERVE["arch"]), dtype="float32")
    _, hi = REPLAY["prompt"]
    params_cpu = Model(cfg, device="cpu").init(REPLAY["seed"])
    params_dev = copy.deepcopy(params_cpu).to(DEVICE)
    runs = {}
    for dev, params in ((DEVICE, params_dev), ("cpu", params_cpu)):
        watch = StepWatch(Model(cfg, device=dev))
        engine = ServingEngine(watch, params, ServingConfig(
            max_batch=REPLAY["max_batch"], max_prompt_len=hi,
            max_len=hi + REPLAY["new_tokens"] + 1), rng_seed=REPLAY["seed"])
        submit_requests(engine, REPLAY, cfg.vocab_size)
        t0 = time.perf_counter()
        out = engine.run_to_completion()
        runs[dev] = (out, watch.prefill_logits, time.perf_counter() - t0)
    (got, got_logits, dev_s), (want, want_logits, cpu_s) = runs[DEVICE], runs["cpu"]
    if got != want:
        raise AssertionError(f"serve_replay: greedy tokens differ: {got} vs {want}")
    errs = []
    for g_l, w_l in zip(got_logits, want_logits):
        err = float((g_l - w_l).abs().max())
        if err > REPLAY["logits_rtol"] * max(1.0, float(w_l.abs().max())):
            raise AssertionError(f"serve_replay: prefill logits differ by {err}")
        errs.append(err)
    families = [replay_family(arch, prompt) for arch, prompt in REPLAY_FAMILIES["archs"]]
    return {"phase": "serve_replay", "requests": len(want), "waves": len(want_logits),
            "tokens_checked": sum(len(v) for v in want.values()),
            "logits_max_abs_err": max(errs), "device_seconds": dev_s, "cpu_seconds": cpu_s,
            "families": families}


def frontend_extras(cfg, max_batch: int, gen, device, dtype) -> dict:
    """The frontend stub's embeddings the engine hands to every prefill:
    ``frontend_seq`` patch or frame embeddings a slot, N(0, 1) from ``gen``."""
    key = {"vision_patches": "patch_embeds", "audio_frames": "frame_embeds"}.get(cfg.frontend)
    if key is None:
        return {}
    shape = (max_batch, cfg.frontend_seq, cfg.d_model)
    return {key: torch.randn(shape, generator=gen, device=device).to(dtype)}


def replay_family(arch: str, prompt: tuple[int, int]) -> dict:
    """One family's engine at reduced width in f32, on the card (kernels)
    and on the CPU (plain versions): same parameters, extras and requests;
    greedy tokens equal, prefill logits within REPLAY's tolerance, and on
    the card B4 once per attention layer of each prefill over 4096 tokens,
    on the CUDA-core variant."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels.flash_attention import VARIANT_LAUNCHES
    from repro_torch.models.transformer import CHUNKED_ABOVE, Model
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = reduce_config(get_config(arch), dtype="float32")
    spec = {**REPLAY_FAMILIES, "prompt": prompt}
    mb, (_, hi) = spec["max_batch"], prompt
    params_cpu = Model(cfg, device="cpu").init(spec["seed"])
    params_dev = copy.deepcopy(params_cpu).to(DEVICE)
    gen = torch.Generator().manual_seed(spec["seed"])
    extras = frontend_extras(cfg, mb, gen, "cpu", torch.float32)
    runs = {}
    for dev, params in ((DEVICE, params_dev), ("cpu", params_cpu)):
        watch = StepWatch(Model(cfg, device=dev))
        engine = ServingEngine(watch, params, ServingConfig(
            max_batch=mb, max_prompt_len=hi, max_len=hi + spec["new_tokens"] + 1),
            extras=extras, rng_seed=spec["seed"])
        submit_requests(engine, spec, cfg.vocab_size)
        reset_all_launches()
        t0 = time.perf_counter()
        out = engine.run_to_completion()
        runs[dev] = (out, watch.prefill_logits, time.perf_counter() - t0,
                     all_launches(), dict(VARIANT_LAUNCHES))
    (got, got_logits, dev_s, launches, variants), (want, want_logits, cpu_s, _, _) = (
        runs[DEVICE], runs["cpu"])
    if got != want:
        raise AssertionError(f"serve_replay {arch}: greedy tokens differ: {got} vs {want}")
    errs = []
    for g_l, w_l in zip(got_logits, want_logits):
        err = float((g_l - w_l).abs().max())
        if err > REPLAY["logits_rtol"] * max(1.0, float(w_l.abs().max())):
            raise AssertionError(f"serve_replay {arch}: prefill logits differ by {err}")
        errs.append(err)
    attention = cfg.family in ("dense", "moe", "vlm") and hi > CHUNKED_ABOVE
    want_b4 = cfg.n_layers * len(want_logits) if attention else 0
    if launches["flash_attention_kernel"] != want_b4 or variants["tensor_cores"]:
        raise AssertionError(f"serve_replay {arch}: B4 launches {launches} {variants}, "
                             f"expected {want_b4} on the CUDA cores")
    heads = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim)
             if cfg.attn_kind == "mla" else (cfg.resolved_head_dim,) * 2)
    return {"arch": arch, "family": cfg.family, "requests": len(want),
            "tokens_checked": sum(len(v) for v in want.values()),
            "logits_max_abs_err": max(errs), "flash_launches": launches["flash_attention_kernel"],
            # the (hd, hd_v) pair B4's CUDA-core variant was instantiated for
            "flash_head_pair": list(heads) if attention else None,
            "device_seconds": dev_s, "cpu_seconds": cpu_s}


def phase_serve_families() -> dict:
    """The dense, MoE (MLA), VLM, encoder-decoder and SSM families at their
    published widths through the engine, one model at a time, each its own
    main path: the launch counters are read around each model's wave."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as b6
    from repro_torch.kernels.flash_attention import VARIANT_LAUNCHES
    from repro_torch.models import common
    from repro_torch.models.transformer import build_model
    from repro_torch.serving import ServingConfig, ServingEngine

    spec = SERVE_FAMILIES
    mb, new, seed = spec["max_batch"], spec["new_tokens"], spec["seed"]
    lines = []
    for arch, layers, (lo, hi), b4, b6_step in spec["models"]:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        t0 = time.perf_counter()
        model = build_model(cfg, device=DEVICE)
        params = model.init(seed)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        extras = frontend_extras(cfg, mb, gen, DEVICE, common.dtype_of(cfg.dtype))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        engine = ServingEngine(StepWatch(model), params, ServingConfig(
            max_batch=mb, max_prompt_len=hi, max_len=hi + new + 1),
            extras=extras, rng_seed=seed)
        submit_requests(engine, {**spec, "prompt": (lo, hi)}, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()  # ---- this model's path starts here ----
        b6.reset_launches()
        waves = drive_engine(engine, torch.cuda.synchronize)
        launches = all_launches()  # ---- and ends here ----
        b6_launches = b6.LAUNCHES["decode_attention_kernel"]
        variants = dict(VARIANT_LAUNCHES)
        want = {name: 0 for name in launches}
        want["flash_attention_kernel"] = b4 * len(waves)
        if launches != want or variants != {"tensor_cores": b4 * len(waves), "cuda_cores": 0}:
            raise AssertionError(f"serve_families {arch}: launches {launches}, B4 variants "
                                 f"{variants}; expected B4 {b4} a prefill on the tensor cores")
        steps = sum(w["decode_steps"] for w in waves)
        if b6_launches != b6_step * steps:
            raise AssertionError(f"serve_families {arch}: B6 launched {b6_launches} times over "
                                 f"{steps} decode steps; expected {b6_step} a step")
        done = engine.finished
        if len(done) != spec["requests"] or any(len(s_.generated) != new for s_ in done.values()):
            raise AssertionError(f"serve_families {arch}: not every request got its tokens")
        pre_s = sum(w["prefill_seconds"] for w in waves)
        dec_s = sum(w["decode_seconds"] for w in waves)
        line = {"phase": "serve_families", "arch": arch, "family": cfg.family,
                "dtype": cfg.dtype, "params": sum(p_.numel() for p_ in params.parameters()),
                "depth": f"{cfg.n_layers} of {full.n_layers}"
                         + (f" (+{cfg.encoder_layers} encoder)" if cfg.encoder_layers else ""),
                "init_seconds": init_s, "waves": waves,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "prefill_tokens_per_s": sum(w["prompt_tokens"] for w in waves) / pre_s,
                "prefill_padded_tokens_per_s": sum(w["padded_tokens"] for w in waves) / pre_s,
                "decode_tokens_per_s": sum(w["decode_tokens"] for w in waves) / dec_s,
                "flash_launches": launches["flash_attention_kernel"],
                "flash_launches_per_prefill": launches["flash_attention_kernel"] / len(waves),
                "flash_variant_launches": variants,
                "decode_attention_launches": b6_launches, "decode_steps": steps}
        emit(line)
        lines.append({k: v for k, v in line.items() if k not in ("phase", "waves")})
        del engine, model, params, extras
        gc.collect()
        torch.cuda.empty_cache()
    return {"phase": "serve_families", "models": lines,
            "flash_launches": sum(m["flash_launches"] for m in lines),
            "decode_attention_launches": sum(m["decode_attention_launches"] for m in lines)}


# ----------------------------------------------------------------------
# Phases 7b and 7c: training the hybrid model
# ----------------------------------------------------------------------


def train_argv(ckpt_dir: str) -> list[str]:
    spec = TRAIN
    return ["--arch", spec["arch"], "--seq-len", str(spec["seq_len"]),
            "--global-batch", str(spec["global_batch"]), "--steps", str(spec["steps"]),
            "--seed", str(spec["seed"]), "--lr", str(spec["lr"]), "--log-every", "1",
            "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(spec["ckpt_at"]), "--device", DEVICE]


def bwd_variant_launches() -> dict:
    from repro_torch.kernels.flash_attention import BWD_VARIANT_LAUNCHES

    return {key: BWD_VARIANT_LAUNCHES[v] for v, key in BWD_VARIANT_KEYS.items()}


def train_step_launches(record: list):
    """A hook of ``launch.train.run``: each step's launches of B4, B4-bwd
    (also by variant), B5 and B5-bwd, read and zeroed after the step."""
    def hook(step, metrics):
        launches = all_launches()
        record.append({**{k: launches[k] for k in TRAIN_KERNELS}, **bwd_variant_launches()})
        reset_all_launches()
    return hook


def phase_train() -> dict:
    """zamba2-1.2b at published widths and depth trained through
    ``launch/train.py``'s entry (bf16, 2 x 8192 tokens a step, one warm-up
    step and five measured), a checkpoint saved at step 3; then a second
    run from that checkpoint alone, whose steps must give the first run's
    losses bit for bit: the entry runs with
    ``torch.use_deterministic_algorithms(True)`` on, and the kernels are
    deterministic by design.  The loss must be finite at every step and
    fall: the last two steps' mean below step 0's loss (step 1 overshoots
    it at the first full learning rate, so a window holding step 1 is no
    evidence).  Every step launches B4 twice per shared
    block (forward and remat's recompute: 2 x 19), B4-bwd once (19, each on
    its tensor-core variant), B5 twice per Mamba2 layer (2 x 38) and B5-bwd
    once (38).  Last,
    ``train_step_breakdown`` outside the counted path."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launch

    cfg = get_config(TRAIN["arch"])
    groups = cfg.n_layers // cfg.shared_attn_every
    want = {"flash_attention_kernel": 2 * groups, "flash_attention_bwd_kernel": groups,
            "mamba_chunk_scan_kernel": 2 * cfg.n_layers,
            "mamba_chunk_scan_bwd_kernel": cfg.n_layers,
            BWD_VARIANT_KEYS["tensor_cores"]: groups, BWD_VARIANT_KEYS["cuda_cores"]: 0}
    ckpt = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        full_launches: list = []
        reset_all_launches()  # ---- this slice's training path starts here ----
        full = train_launch.run(train_argv(ckpt), hooks=[train_step_launches(full_launches)])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # ---- and ends here (each step's launches read by the hook) ----
        for step, launches in enumerate(full_launches):
            if launches != want:
                raise AssertionError(f"train: step {step} launched {launches}, expected {want}")
        # the run saved steps 3 and 6: keep step 3 alone and resume from it
        t0 = time.perf_counter()
        shutil.rmtree(os.path.join(ckpt, f"step_{TRAIN['steps']:09d}"))
        resumed = train_launch.run(train_argv(ckpt))
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    hist = full["history"]
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses not finite: {losses}")
    measured = hist[1:]  # step 0 is the warm-up
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if resumed["start"] != TRAIN["ckpt_at"]:
        raise AssertionError(f"train: resumed from step {resumed['start']}")
    again = [h["loss"] for h in resumed["history"]]
    if again != losses[TRAIN["ckpt_at"]:]:
        raise AssertionError(f"train: the resumed run's losses {again} differ from "
                             f"{losses[TRAIN['ckpt_at']:]}")
    tokens = TRAIN["seq_len"] * TRAIN["global_batch"]
    step_s = [h["seconds"] for h in measured]
    torch.use_deterministic_algorithms(True)  # as the entry trains
    try:
        breakdown = train_step_breakdown()
    finally:
        torch.use_deterministic_algorithms(False)
    return {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
            "layers": cfg.n_layers, "seq_len": TRAIN["seq_len"],
            "global_batch": TRAIN["global_batch"], "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
            "step_seconds": [h["seconds"] for h in hist],
            "tokens_per_s": tokens * len(measured) / sum(step_s),
            "peak_memory_gb": peak_gb, "launches_per_step": want,
            "main_path_launches": {k: sum(l_[k] for l_ in full_launches) for k in want},
            "resumed_from": resumed["start"], "resumed_losses": again,
            "resume_equal": True, "resume_seconds": resume_s,
            "deterministic_algorithms": "on (launch/train.py)", "breakdown": breakdown}


def train_step_breakdown() -> dict:
    """Where a training step of zamba2-1.2b (TRAIN's shape, bf16) spends
    its time, by CUDA events around synchronised parts: the forward alone
    (``train_loss`` under ``no_grad``), forward and backward
    (``autograd.grad``, which runs each layer's forward again under remat),
    and the AdamW update; then one whole step under ``torch.profiler``: the
    card's busy time by kernel family and its idle share."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.transformer import Model
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_update, init_opt_state,
                                   make_train_step)

    cfg = get_config(TRAIN["arch"])
    model = Model(cfg, device=DEVICE)
    params = model.init(TRAIN["seed"])
    leaves = dict(params.named_parameters())
    batch = SyntheticLMDataset(DataConfig(TRAIN["seq_len"], TRAIN["global_batch"],
                                          cfg.vocab_size), cfg, device=DEVICE).batch(0)
    opt = AdamWConfig(lr=TRAIN["lr"])
    state = init_opt_state(leaves)

    def forward():
        with torch.no_grad():
            model.train_loss(params, batch)

    def forward_backward():
        loss, _ = model.train_loss(params, batch)
        return torch.autograd.grad(loss, list(leaves.values()))

    grads = {k: g.float() for k, g in zip(leaves, forward_backward())}
    out = {"forward_ms": cuda_ms(forward, reps=2),
           "forward_backward_ms": cuda_ms(forward_backward, reps=2),
           "adamw_ms": cuda_ms(lambda: adamw_update(opt, leaves, grads, state),
                               reps=2)}
    del grads
    step = make_train_step(model.train_loss, TrainConfig(optimizer=opt))
    step(params, state, None, batch, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, None, batch, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"flash_attention_kernel": 0.0, "flash_attention_bwd": 0.0,
              "mamba_scan_kernel": 0.0, "mamba_scan_bwd": 0.0,
              "matrix products": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        ms = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        family = next((f for f in groups if f in ev.key), None)
        if family is None:
            family = ("matrix products" if any(t in ev.key.lower() for t in (
                "gemm", "cutlass", "nvjet", "sm90_xmma")) else "other")
        groups[family] += max(ms, 0.0)
    busy = sum(groups.values())
    out.update({"step_wall_ms": wall * 1e3, "device_busy_ms": groups,
                "device_busy_ms_total": busy, "device_idle_share": 1.0 - busy / 1e3 / wall})
    del model, params, leaves, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def replay_training(arch: str) -> dict:
    """Three training steps of ``arch`` at reduced width in f32 on the card
    (kernels) and on the CPU (plain versions), from the same parameters and
    batches: per-step loss and gradient norm within TRAIN_REPLAY's
    tolerance, and on the card each kernel of the path launched as the
    step's layers call for."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.transformer import Model
    from repro_torch.train import AdamWConfig, TrainConfig, train_loop

    spec = TRAIN_REPLAY
    cfg = reduce_config(get_config(arch), dtype="float32")
    params_cpu = Model(cfg, device="cpu").init(spec["seed"])
    params_dev = copy.deepcopy(params_cpu).to(DEVICE)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=spec["steps"]))
    runs = {}
    for dev, params in ((DEVICE, params_dev), ("cpu", params_cpu)):
        data = SyntheticLMDataset(DataConfig(spec["seq_len"], spec["batch"], cfg.vocab_size,
                                             seed=spec["seed"]), cfg, device=dev)
        reset_all_launches()
        t0 = time.perf_counter()
        _, hist = train_loop(Model(cfg, device=dev).train_loss, params,
                             data.take(spec["steps"]), tcfg)
        runs[dev] = (hist, {**all_launches(), **bwd_variant_launches()},
                     time.perf_counter() - t0)
    (got, launches, dev_s), (want, _, cpu_s) = runs[DEVICE], runs["cpu"]
    errs = {}
    for key in ("loss", "grad_norm"):
        g_, w_ = np.array([h[key] for h in got]), np.array([h[key] for h in want])
        rel = float(np.max(np.abs(g_ - w_) / np.abs(w_)))
        if not rel <= spec["rtol"]:
            raise AssertionError(f"train_replay {arch}: {key} {g_.tolist()} on the card, "
                                 f"{w_.tolist()} on the CPU")
        errs[key] = rel
    steps = spec["steps"]
    if cfg.family == "hybrid":
        attn, mamba = cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    else:
        attn, mamba = cfg.n_layers, 0
    expect = {"flash_attention_kernel": 2 * attn * steps,
              "flash_attention_bwd_kernel": attn * steps,
              "mamba_chunk_scan_kernel": 2 * mamba * steps,
              "mamba_chunk_scan_bwd_kernel": mamba * steps,
              # f32: B4-bwd's CUDA-core variant
              BWD_VARIANT_KEYS["cuda_cores"]: attn * steps,
              BWD_VARIANT_KEYS["tensor_cores"]: 0}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"train_replay {arch}: launches {launches}, expected {expect}")
    return {"arch": arch, "family": cfg.family, "seq_len": spec["seq_len"],
            "losses": [h["loss"] for h in got], "cpu_losses": [h["loss"] for h in want],
            "grad_norms": [h["grad_norm"] for h in got],
            "cpu_grad_norms": [h["grad_norm"] for h in want],
            "max_rel_err": errs, "rtol": spec["rtol"], "launches": expect,
            "device_seconds": dev_s, "cpu_seconds": cpu_s}


def phase_train_replay() -> dict:
    return {"phase": "train_replay",
            "models": [replay_training(arch) for arch in TRAIN_REPLAY["archs"]]}


# ----------------------------------------------------------------------
# Phase 8: the per-phase MCOP tier (kernel B3 and mcop_min_cut)
# ----------------------------------------------------------------------


def merged_phase_state(rng, adj, wl, wc, pinned, merges: int):
    """One MinCutPhase's inputs on a graph of ``random_batch``: the pinned
    vertices folded into the first of them, then ``merges`` Algorithm-1
    merges of random alive pairs in f32 and in the host loop's order, so
    that ``alive`` has holes and the anchor may have moved.  Returns
    ``(adj, gains, alive, src, C_local)``."""
    adj, wl, wc = adj.copy(), wl.copy(), wc.copy()
    alive = np.ones(adj.shape[0], bool)
    pins = np.nonzero(pinned)[0]
    src = int(pins[0]) if pins.size else 0
    ctot = float(wl.sum())

    def merge(s, t):
        adj[s, :] += adj[t, :]
        adj[:, s] += adj[:, t]
        adj[s, s] = 0.0
        adj[t, :] = 0.0
        adj[:, t] = 0.0
        wl[s] += wl[t]
        wc[s] += wc[t]
        alive[t] = False

    for t in pins[1:]:
        merge(src, int(t))
    for _ in range(merges):
        s, t = (int(v) for v in rng.choice(np.nonzero(alive)[0], 2, replace=False))
        merge(s, t)
        if t == src:
            src = s
    return adj, wl - wc, alive, src, ctot


def hold_phase_log(tag, g, run) -> dict:
    """``mcop_min_cut``'s loop on the card and on the CPU (plain step) on
    graph ``g``: every phase's ``(s, t)`` equal, its cut to ``rtol``, the
    results equal."""
    cut_d, mask_d, st_d = run(g.adj, g.w_local, g.w_cloud, g.offloadable, device=DEVICE)
    cut_c, mask_c, st_c = run(g.adj, g.w_local, g.w_cloud, g.offloadable, device="cpu")
    log_d, log_c = st_d.read_log(), st_c.read_log()
    if [p[1:] for p in log_d] != [p[1:] for p in log_c] or not np.array_equal(mask_d, mask_c):
        raise AssertionError(f"min_cut: graph {tag} (n={g.n}): phase log differs from the CPU loop")
    err = max(abs(a[0] - b[0]) for a, b in zip(log_d, log_c))
    if err > RTOL * max(abs(b[0]) for b in log_c) or abs(cut_d - cut_c) > RTOL * abs(cut_c):
        raise AssertionError(f"min_cut: graph {tag} (n={g.n}): phase cuts differ by {err}")
    return {"graph": tag, "n": g.n, "phases": len(log_d), "max_abs_cut_err": err}


def device_loop_ms(g, *, reps: int) -> dict:
    """The device loop's kernel time on graph ``g`` for each row strategy
    of B3's step kernel: ``reps`` runs of every phase's launch, captured in
    one CUDA graph, each behind a copy that restores the folded state; the
    copy alone; and ns per absorb step (counted: m (m - 1) / 2 for m
    vertices alive after the fold)."""
    from repro_torch.kernels.mcop_phase import mcop_phase_step
    from repro_torch.kernels.ops import _min_cut_state

    state, c_total = _min_cut_state(g.adj, g.w_local, g.w_cloud, g.offloadable,
                                    device=DEVICE)
    pristine = state.buffer.clone()
    m = state.phases + 1
    steps = m * (m - 1) // 2
    out = {"device_loop_absorb_steps": steps,
           "restore_copy_ms": graph_ms(lambda: state.buffer.copy_(pristine), reps=reps)}
    for rows in ("staged", "l2"):
        def loop():
            state.buffer.copy_(pristine)
            for phase in range(state.phases):
                mcop_phase_step(state, phase, c_total, rows=rows)

        ms = graph_ms(loop, reps=reps)
        out[f"device_loop_ms_{rows}"] = ms
        out[f"ns_per_step_{rows}"] = (ms - out["restore_copy_ms"]) * 1e6 / steps
    return out


class OracleWorkers:
    """The f64 oracle (``mcop_reference``) on ``graphs``, solved in
    ``workers`` child processes while the caller works: child ``k`` takes
    graphs ``k, k + workers, ...`` from a pickle file and writes their
    results as one pickle on its standard output.  Leaving the ``with``
    block kills and reaps every child still running, so none outlives it
    (a ``multiprocessing`` pool would leave its resource tracker behind)."""

    CODE = ("import pickle, sys; from repro_torch.core import mcop_reference; "
            "gs = pickle.load(open(sys.argv[1], 'rb')); "
            "pickle.dump([mcop_reference(g) for g in gs], sys.stdout.buffer)")

    def __init__(self, graphs: list, workers: int):
        import pickle
        import tempfile

        self.n, self.workers = len(graphs), workers
        self.tmp = tempfile.TemporaryDirectory(prefix="oracle_")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        self.procs = []
        for k in range(workers):
            path = os.path.join(self.tmp.name, f"graphs{k}.pkl")
            with open(path, "wb") as f:
                pickle.dump(graphs[k::workers], f)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", self.CODE, path],
                stdout=subprocess.PIPE, env=env, cwd=ROOT))

    def results(self) -> list:
        """Every graph's result, in the order of ``graphs``."""
        import pickle

        chunks = []
        for k, proc in enumerate(self.procs):
            data, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"oracle worker {k} exited {proc.returncode}")
            chunks.append(pickle.loads(data))
        return [chunks[i % self.workers][i // self.workers] for i in range(self.n)]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        self.tmp.cleanup()


def phase_min_cut(rng) -> dict:
    """B3 against its plain version on single phases; ``mcop_min_cut`` on
    the card (the path that launches B3, read with the launch counters set
    to 0 just before it) on the paper example and on random graphs, every
    mask equal to the f64 oracle's; B3's and the loop's times."""
    from repro_torch.core import mcop_reference, paper_example_graph, random_wcg
    from repro_torch.kernels import mcop_phase as K
    from repro_torch.kernels.ops import _min_cut_run, mcop_min_cut
    from repro_torch.kernels.ref import mcop_phase_plain

    spec = MIN_CUT
    lo, hi = spec["sizes"]
    sizes = np.exp(np.random.default_rng(spec["seed"]).uniform(
        np.log(lo), np.log(hi + 1), spec["graphs"])).astype(int)
    sizes[:2] = (lo, hi)
    graphs = [random_wcg(int(n), rng=np.random.default_rng(spec["seed"] + i))
              for i, n in enumerate(sizes)]
    out = {"phase": "min_cut"}
    # the f64 oracle is a host loop of ~n^2/2 steps: solve it in worker
    # processes while the card works
    with OracleWorkers(graphs, spec["workers"]) as oracle:

        # ---- B3 against mcop_phase_plain, single phases ------------------
        checks, differ, worst = 0, [], 0.0
        for n in spec["phase_n"]:
            sparse = min(0.4, 6.4 / n)
            # graph 0: cloud cost half the local; 1: contested costs; 2: sparse;
            # 3: sparse, small integer weights (exact ties)
            host = random_batch(rng, 4, n, edge_prob=np.array([0.4, 0.4, sparse, sparse]))
            for i in range(4):
                for merges in (0, n // 3):
                    adj, gains, alive, src, ctot = merged_phase_state(
                        rng, *(a[i] for a in host), merges)
                    dev = to_dev((adj, gains, alive))
                    got = K.phase_result(K.mcop_phase_packed(*dev, src, ctot))
                    cut, s, t = mcop_phase_plain(*dev, src, ctot)
                    want = (float(cut), s, t)
                    err = abs(got[0] - want[0])
                    worst = max(worst, err)
                    checks += 1
                    if got[1:] != want[1:] or err > RTOL * abs(want[0]):
                        differ.append({"n": n, "graph": i, "merges": merges,
                                       "src": src, "kernel": got, "plain": want})
        out["phase_checks"] = {"phases": checks, "differences": differ,
                               "max_abs_err": worst, "n": list(spec["phase_n"])}
        if differ:
            emit(out)
            raise AssertionError(f"min_cut: B3 differs from its plain version {differ}")

        # ---- the main path: mcop_min_cut on the card ---------------------
        paper = paper_example_graph()
        reset_all_launches()  # ---- the per-phase path starts here ----
        t0 = time.perf_counter()
        paper_cut, paper_mask = mcop_min_cut(paper.adj, paper.w_local, paper.w_cloud,
                                             paper.offloadable, device=DEVICE)
        results = [mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device=DEVICE)
                   for g in graphs]
        path_s = time.perf_counter() - t0
        launches = all_launches()  # ---- and ends here ----
        # the device loop's phase log against the CPU loop's (the plain step)
        logged = [(i, g) for i, g in enumerate(graphs)][::spec["log_every"]]
        logged.append(("block", random_wcg(spec["block_n"], rng=np.random.default_rng(
            spec["seed"] - 1))))
        out["phase_logs"] = [hold_phase_log(tag, g, _min_cut_run) for tag, g in logged]
        refs = oracle.results()

    # ---- B3's time per launch, and the loop's per graph, with the -----
    # ---- oracle's workers gone (they share the host with the loop) ---
    timing, work, loop = [], [], []
    for n in spec["time_n"]:
        host = random_batch(rng, 2, n)
        adj, gains, alive, src, ctot = merged_phase_state(
            rng, *(a[1] for a in host), 0)
        dev = to_dev((adj, gains, alive))
        n_alive = int(alive.sum())
        plain, plain_ms = timed(lambda: mcop_phase_plain(*dev, src, ctot))
        got = K.phase_result(K.mcop_phase_packed(*dev, src, ctot))
        if got[1:] != plain[1:]:
            raise AssertionError(f"min_cut: B3 differs from plain at n={n}")
        nbytes, flops = (n_alive + 2) * n * 4, 3.0 * n * n
        b_ms, b_by = bound(nbytes, flops, FP32_FLOP_PER_S)
        g = random_wcg(n, rng=np.random.default_rng(spec["seed"] - n))
        mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device=DEVICE)  # warm
        t0 = time.perf_counter()
        for _ in range(spec["loop_reps"]):
            mcop_min_cut(g.adj, g.w_local, g.w_cloud, g.offloadable, device=DEVICE)
        loop_ms = (time.perf_counter() - t0) / spec["loop_reps"] * 1e3
        t0 = time.perf_counter()
        mcop_reference(g)
        ref_ms = (time.perf_counter() - t0) * 1e3
        launch = functools.partial(K.mcop_phase_packed, *dev, src, ctot)
        timing.append({
            "n": n, "ms": graph_ms(launch, reps=spec["time_reps"]),
            "wrapper_ms": cuda_ms(launch, reps=spec["time_reps"]),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "max_abs_err": abs(got[0] - float(plain[0]))})
        work.append({"n": n, "n_alive": n_alive, "chain_argmaxes": n_alive - 1,
                     "bound_bytes": nbytes, "bound_flops": flops})
        loop.append({"n": n, "min_cut_ms_per_graph": loop_ms,
                     "reference_ms_per_graph": ref_ms,
                     **device_loop_ms(g, reps=spec["loop_reps"])})
    out["timing"], out["work"], out["loop"] = timing, work, loop

    local = {paper.names[i] for i in np.nonzero(paper_mask)[0]}
    if paper_cut != 22.0 or local != {"a", "c"}:
        raise AssertionError(f"min_cut: paper example gave {paper_cut} with {local}")
    # one launch per phase: n_alive - 1 phases after the fold; the phase with
    # k alive vertices absorbs k - 1 of them, so a graph of m alive vertices
    # costs B3 m (m - 1) / 2 absorb steps in all (counted, not measured)
    alive0 = [g.n - max(int((~g.offloadable).sum()) - 1, 0) for g in (paper, *graphs)]
    phases = sum(m - 1 for m in alive0)
    absorb_steps = sum(m * (m - 1) // 2 for m in alive0)
    sizes_steps = [(g.n, m * (m - 1) // 2) for g, m in zip((paper, *graphs), alive0)]
    if launches["mcop_phase_kernel"] != phases or any(
            v for k, v in launches.items() if k != "mcop_phase_kernel"):
        raise AssertionError(f"min_cut: launches {launches}, expected {phases} of B3 only")
    differ, worst = [], 0.0
    for i, (g, (cut, mask), ref) in enumerate(zip(graphs, results, refs)):
        err = abs(cut - ref.min_cut)
        worst = max(worst, err)
        if not np.array_equal(mask, ref.local_mask) or err > RTOL * abs(ref.min_cut):
            differ.append({"graph": i, "n": g.n, "seed": spec["seed"] + i,
                           "input": "random_wcg(n, rng=np.random.default_rng(seed))",
                           "cut": cut, "reference_cut": ref.min_cut,
                           "price_of_mask": g.total_cost(mask),
                           "mask": mask.astype(int).tolist(),
                           "reference_mask": ref.local_mask.astype(int).tolist()})
    out["main_path"] = {
        "paper_example": {"cut": paper_cut, "local": sorted(local)},
        "graphs": len(graphs), "sizes": [int(sizes.min()), int(sizes.max())],
        "mean_n": float(sizes.mean()), "mask_differences": differ,
        "max_abs_cut_err": worst, "seconds": path_s, "launches": launches,
        "phases": phases, "absorb_steps": absorb_steps}
    out["absorb_steps_by_n"] = sizes_steps
    out["main_path_launches"] = launches
    if differ:
        emit(out)
        raise AssertionError(f"min_cut: {len(differ)} masks differ from the f64 oracle")
    return out


# ----------------------------------------------------------------------
# Phase 9: the broker served across a process boundary
# ----------------------------------------------------------------------


class SubmitsAsEnvs:
    """A broker or a client as BrokerSession sees it, sending each
    session's solve as its environment — what a client sends; the server
    rebuilds the graph — and timing every submit."""

    def __init__(self, target):
        self.target = target
        self.backend = target.backend
        self.device = target.device
        self.tenant = target.tenant
        self.submits = 0
        self.submit_s = 0.0

    def submit_graph(self, name, g, env):
        t0 = time.perf_counter()
        fut = self.target.submit(name, env)
        self.submit_s += time.perf_counter() - t0
        self.submits += 1
        return fut


def drive_serving(front: SubmitsAsEnvs, tick, register_group) -> dict:
    """The serving workload: ``sessions`` per-user sessions through
    ``ticks`` ticks, and from ``group_tick`` on a batch session group of
    ``capacity`` slots observed every tick.  Returns per-session events,
    tick reports, batch reports and the seconds spent in ticks."""
    from repro_torch.service import BrokerSession, TrafficGenerator, user_traces

    spec = SERVE_BROKER
    walks = user_traces(spec["sessions"], spec["ticks"], seed=21)
    traffic = TrafficGenerator(spec["capacity"], seed=22, arrival_rate=spec["capacity"] / 50,
                               churn=0.05, initial=spec["capacity"] // 2)
    sessions = [BrokerSession(front, "app", threshold=0.15, min_interval=2)
                for _ in walks]
    out = {"events": [[] for _ in walks], "ticks": [], "batch": [], "tick_s": 0.0,
           "group": None}
    group = None
    for i in range(spec["ticks"]):
        for sess, walk in zip(sessions, walks):
            sess.observe(walk[i])
        if i >= spec["group_tick"]:
            if group is None:
                group = register_group()
                out["group"] = getattr(group, "id", None)
            tk = traffic.step()
            group.observe(tk.envs, arrived=np.flatnonzero(tk.arrived),
                          departed=np.flatnonzero(tk.departed))
        t0 = time.perf_counter()
        out["ticks"].append(tick())
        out["tick_s"] += time.perf_counter() - t0
        for u, sess in enumerate(sessions):
            out["events"][u].extend(sess.drain())
        if group is not None:
            out["batch"].extend(group.drain())
    return out


def in_process_serving(backend: str, device: str) -> tuple[dict, object]:
    """The workload against an in-process broker set up as the server sets
    up its own (``launch.serve_broker``: demo tenant, broker clock at 0,
    the ``--batch-capacity`` group)."""
    from repro_torch.launch.serve_broker import demo_tenant
    from repro_torch.service import OffloadBroker

    spec = SERVE_BROKER
    broker = OffloadBroker(backend=backend, device=device, clock=lambda: 0.0)
    broker.register("app", *demo_tenant(spec["nodes"], spec["seed"]))
    broker.register_batch("app", spec["capacity"])
    front = SubmitsAsEnvs(broker)
    run = drive_serving(front, broker.tick, lambda: broker.register_batch(
        "app", spec["capacity"], threshold=0.15, min_interval=2))
    run["submits"], run["submit_s"] = front.submits, front.submit_s
    return run, broker


class ServerProcess:
    """``python -m repro_torch.launch.serve_broker`` on the card, its
    standard output and errors in files that go to this script's output
    when a check fails."""

    def __init__(self, workdir: str, name: str, *, kill_at_tick=None):
        spec = SERVE_BROKER
        self.sock = os.path.join(workdir, "solver.sock")
        self.log_out = os.path.join(workdir, f"{name}.out")
        self.log_err = os.path.join(workdir, f"{name}.err")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve_broker",
               "--backend", "cuda", "--device", DEVICE, "--socket", self.sock,
               "--journal", os.path.join(workdir, "journal.jsonl"),
               "--snapshot-dir", os.path.join(workdir, "snaps"),
               "--snapshot-every", str(spec["snapshot_every"]),
               "--nodes", str(spec["nodes"]), "--seed", str(spec["seed"]),
               "--batch-capacity", str(spec["capacity"])]
        if kill_at_tick is not None:
            cmd += ["--kill-at-tick", str(kill_at_tick)]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        with open(self.log_out, "w") as fo, open(self.log_err, "w") as fe:
            self.proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, env=env, cwd=ROOT)
        self.started = time.perf_counter()

    def wait_ready(self) -> float:
        """Seconds from the start to the READY line; fails past the limit."""
        limit = SERVE_BROKER["ready_s"]
        while time.perf_counter() - self.started < limit:
            with open(self.log_out) as f:
                if any(line.startswith("READY") for line in f):
                    return time.perf_counter() - self.started
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"serve_broker: the server did not reach READY within "
                             f"{limit} s (exit {self.proc.poll()})\n{self.logs()}")

    def logs(self) -> str:
        text = []
        for path in (self.log_out, self.log_err):
            with open(path) as f:
                text.append(f"--- {os.path.basename(path)}\n{f.read()}")
        return "\n".join(text)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def reply_keys(run: dict) -> dict:
    """A run's replies as the wire carries them, for ``==``."""
    from repro_torch.service.server import batch_report_frame, tick_report_frame

    def tick_frame(r):
        return r if isinstance(r, dict) else tick_report_frame(r)

    def batch_frame(r):
        return r if isinstance(r, dict) else batch_report_frame(run["gid"], r)

    return {
        "events": [[event_fields(e) for e in evs] for evs in run["events"]],
        "ticks": json.dumps([tick_frame(r) for r in run["ticks"]], sort_keys=True),
        "batch": json.dumps([batch_frame(r) for r in run["batch"]], sort_keys=True),
    }


def event_fields(e) -> tuple:
    return (e.step, e.env, float(e.result.min_cut),
            tuple(bool(b) for b in e.result.local_mask), e.partial_cost,
            e.no_offload_cost, e.full_offload_cost, e.gain, e.repartitioned,
            e.cache_hit)


def phase_serve_broker() -> dict:
    """The broker behind a process boundary on the card: a solver process
    with ``--backend cuda`` driven by a BrokerClient; replies ``==`` an
    in-process broker's on the same inputs, placements equal to the f64
    reference's; then SIGKILL mid-tick, warm restart on the same journal
    and snapshots, and replies ``==`` the run that was not killed."""
    import tempfile

    from repro_torch.launch.serve_broker import demo_tenant
    from repro_torch.service import BrokerClient, RetryPolicy, unix_address

    spec = SERVE_BROKER
    out = {"phase": "serve_broker", "spec": spec}
    servers = []
    with tempfile.TemporaryDirectory(prefix="serve_broker_") as tmp:
        try:
            dirs = {k: os.path.join(tmp, k) for k in ("a", "b")}
            for d in dirs.values():
                os.makedirs(d)
            # both servers boot while the in-process runs go
            servers.append(ServerProcess(dirs["a"], "a"))
            servers.append(ServerProcess(dirs["b"], "b_killed", kill_at_tick=spec["kill_tick"]))
            local, local_broker = in_process_serving("cuda", DEVICE)
            reference, _ = in_process_serving("reference", "cpu")

            def client(d, name):
                return BrokerClient(
                    unix_address(os.path.join(d, "solver.sock")),
                    tenants={"app": demo_tenant(spec["nodes"], spec["seed"])},
                    client=name, timeout=spec["ready_s"],
                    retry=RetryPolicy(max_retries=1, base_backoff_s=0.01,
                                      max_backoff_s=0.05))

            # ---- run A: across the boundary, not killed ------------------
            ready_a = servers[0].wait_ready()
            ca = client(dirs["a"], "a")
            ca.connect()
            if ca.backend != "cuda":
                raise AssertionError(f"serve_broker: the server runs {ca.backend!r}")
            front = SubmitsAsEnvs(ca)
            remote = drive_serving(front, ca.tick, lambda: ca.register_batch(
                "app", spec["capacity"], threshold=0.15, min_interval=2))
            telemetry = ca.telemetry()
            ca.close()

            # ---- run B: killed in tick kill_tick, restarted warm ---------
            ready_b = servers[1].wait_ready()
            cb = client(dirs["b"], "b")
            cb.connect()
            restart = {}

            def tick_b():
                try:
                    return cb.tick()
                except ConnectionError:
                    servers[1].proc.wait(timeout=60)
                    if servers[1].proc.returncode != -9:
                        raise
                    restart["tick"] = cb.server_tick + 1
                    servers.append(ServerProcess(dirs["b"], "b_restarted"))
                    restart["ready_s"] = servers[-1].wait_ready()
                    return cb.tick()

            killed = drive_serving(SubmitsAsEnvs(cb), tick_b, lambda: cb.register_batch(
                "app", spec["capacity"], threshold=0.15, min_interval=2))
            resubmitted = cb.resubmitted
            cb.close()
            if restart.get("tick") != spec["kill_tick"]:
                raise AssertionError(f"serve_broker: no SIGKILL at tick {spec['kill_tick']}")

            for run in (local, reference):
                run["gid"] = remote["group"]
            want = reply_keys(local)
            got_a, got_b = reply_keys(remote), reply_keys(killed)
            for key in want:
                if got_a[key] != want[key]:
                    raise AssertionError(f"serve_broker: {key} across the boundary "
                                         f"differ from the in-process broker's")
                if got_b[key] != got_a[key]:
                    raise AssertionError(f"serve_broker: {key} after the SIGKILL and "
                                         f"warm restart differ from the run not killed")
            summary = local_broker.telemetry.summary()
            if json.dumps(telemetry["summary"], sort_keys=True) != json.dumps(
                    summary, sort_keys=True):
                raise AssertionError("serve_broker: telemetry differs from in-process")
            ties = hold_events("serve_broker sessions", local["events"],
                               reference["events"])
            ties += hold_batch_reports("serve_broker batch group", local["batch"],
                                       reference["batch"])
            solved = sum(r["solved"] for r in remote["ticks"])
            dispatches = sum(r["dispatches"] for r in remote["ticks"])
            batch_solved = sum(r["solved"] for r in remote["batch"])
            if solved <= 0 or dispatches <= 0 or batch_solved <= 0:
                raise AssertionError("serve_broker: the server solved nothing on the card")
            ticks = spec["ticks"]
            out.update({
                "server_ready_s": {"a": ready_a, "b": ready_b,
                                   "b_restarted": restart["ready_s"]},
                "sessions": spec["sessions"], "ticks": ticks,
                "events": sum(len(e) for e in remote["events"]),
                "batch_reports": len(remote["batch"]),
                "server_solved": solved, "server_dispatches": dispatches,
                "server_batch_solved": batch_solved,
                "telemetry": telemetry["summary"],
                "ticks_per_s": ticks / remote["tick_s"],
                "in_process_ticks_per_s": ticks / local["tick_s"],
                "submits": front.submits,
                "round_trip_ms_per_submit": front.submit_s / front.submits * 1e3,
                "in_process_ms_per_submit": local["submit_s"] / local["submits"] * 1e3,
                "killed_at_tick": restart["tick"], "resubmitted": resubmitted,
                "replies_equal_in_process": True, "replies_equal_after_restart": True,
                "reference_tie_masks": ties,
            })
        except BaseException:
            for server in servers:
                print(server.logs(), file=sys.stderr, flush=True)
            raise
        finally:
            for server in servers:
                server.stop()
    return out


# ----------------------------------------------------------------------
# Phase examples_tools: the examples and tools of the port
# ----------------------------------------------------------------------

class Child:
    """A script of the repository in a process of its own (and its own
    process group, so that nothing it starts outlives a timeout).  A thread
    reads its output as it comes and notes when it ended, so the seconds
    are its own whenever the phase collects it."""

    def __init__(self, *argv):
        import threading

        self.argv = [str(a) for a in argv]
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *self.argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=ROOT, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        try:
            out, err = self.proc.communicate(timeout=EXAMPLES_TOOLS["timeout"])
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, 9)
            out, err = self.proc.communicate()
        self.stdout, self.stderr = out, err
        self.seconds = time.perf_counter() - self.started

    def finish(self) -> float:
        """The child's seconds once it has ended; a nonzero exit fails."""
        self.reader.join()
        if self.proc.returncode != 0:
            raise AssertionError(f"examples_tools: {' '.join(self.argv)} exited "
                                 f"{self.proc.returncode}\n{self.stdout}\n{self.stderr}")
        return self.seconds

    def lines(self, prefix: str) -> list[str]:
        return [ln for ln in self.stdout.splitlines() if ln.startswith(prefix)]


def script_main(rel: str):
    """The ``main`` of an example or tool of the repository, in process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "script_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def stdout_of(fn, argv) -> str:
    """What ``fn(argv)`` prints; it must return 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    if rc != 0:
        raise AssertionError(f"examples_tools: {argv} returned {rc}\n{buf.getvalue()}")
    return buf.getvalue()


def stdlib_tool(*argv) -> None:
    """``tools/tracequery.py`` or ``tools/wire_journal.py`` as it is: rc 0."""
    out = subprocess.run([sys.executable, *[str(a) for a in argv]], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"examples_tools: {' '.join(map(str, argv))} exited "
                             f"{out.returncode}\n{out.stdout}\n{out.stderr}")


def processes_naming(text: str) -> list[str]:
    """Living processes whose command line names ``text`` (Linux ``/proc``)."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if text in cmd:
            left.append(f"{pid}: {cmd}")
    return left


def phase_examples_tools() -> dict:
    """The port's examples and tools on the card, as a user runs them:
    ``torch_quickstart``, ``torch_serve_lm`` and ``torch_train_lm`` in child
    processes (started first, they run beside the rest), then
    ``torch_adaptive_offload`` and ``torch_chaos_trace`` in this process
    (B1 and B2 counted around each card run), then ``torch_ipc_smoke``
    (a solver process on the card and two client processes).  Each model
    example's placement report equals its ``--device cpu`` run's."""
    import tempfile

    from repro_torch.kernels import mcop_phase as K

    spec = EXAMPLES_TOOLS
    out = {"phase": "examples_tools", "spec": spec}
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="examples_tools_") as tmp:
        children = {}
        try:
            children["quickstart"] = Child("examples/torch_quickstart.py", "--device", DEVICE)
            children["serve_lm"] = Child("examples/torch_serve_lm.py", "--device", DEVICE)
            children["train_lm"] = Child("examples/torch_train_lm.py", "--device", DEVICE,
                                         "--steps", spec["train_steps"], "--ckpt-dir",
                                         os.path.join(tmp, "train_lm"))

            # ---- adaptive_offload: the card's output == the CPU's -----------
            adaptive = script_main("examples/torch_adaptive_offload.py")
            t0 = time.perf_counter()
            K.reset_launches()
            on_card = stdout_of(adaptive, ["--device", DEVICE])
            launches = {k: K.LAUNCHES[k] for k in BROKER_PATH_KERNELS}
            seconds["adaptive_offload"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_cpu = stdout_of(adaptive, ["--device", "cpu"])
            seconds["adaptive_offload_cpu"] = time.perf_counter() - t0
            if on_card != on_cpu:
                raise AssertionError("examples_tools: torch_adaptive_offload prints other "
                                     f"lines on the card\n{on_card}\n---\n{on_cpu}")
            if sum(launches.values()) <= 0:
                raise AssertionError("examples_tools: torch_adaptive_offload launched "
                                     f"no solve kernel {launches}")
            warm = "→ restart + warm cache, same day replayed: 0 solver dispatches"
            if warm not in on_card:
                raise AssertionError("examples_tools: the warm restart dispatched")
            out["adaptive_offload"] = {"launches": launches, "stdout_equal_cpu": True,
                                       "lines": len(on_card.splitlines())}

            # ---- chaos_trace at its defaults, then the trace audit ---------
            chaos_out = os.path.join(tmp, "chaos.jsonl")
            t0 = time.perf_counter()
            K.reset_launches()
            line = stdout_of(script_main("tools/torch_chaos_trace.py"),
                             ["--out", chaos_out, "--device", DEVICE]).strip()
            launches = {k: K.LAUNCHES[k] for k in BROKER_PATH_KERNELS}
            seconds["chaos_trace"] = time.perf_counter() - t0
            fields = dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
            if int(fields["faults"]) <= 0 or sum(launches.values()) <= 0:
                raise AssertionError(f"examples_tools: chaos trace {line} {launches}")
            stdlib_tool("tools/tracequery.py", "--audit", chaos_out)
            out["chaos_trace"] = {"launches": launches, "audit": 0, **{
                k: fields[k] for k in ("requests", "faults", "retries", "breaker_trips",
                                       "degraded")}}

            # ---- ipc_smoke at its defaults: a solver process on the card ----
            ipc_dir = os.path.join(tmp, "ipc")
            ipc = spec["ipc"]
            smoke = Child("tools/torch_ipc_smoke.py", "--dir", ipc_dir, "--device", DEVICE,
                          "--users", ipc["users"], "--clients", ipc["clients"],
                          "--ticks", ipc["ticks"])
            children["ipc_smoke"] = smoke
            seconds["ipc_smoke"] = smoke.finish()
            names = [f"smoke{i}" for i in range(ipc["clients"])]
            reports = {}
            for name in names:
                with open(os.path.join(ipc_dir, f"{name}.reports.json")) as f:
                    reports[name] = json.load(f)
            if any(len(r) != ipc["ticks"] for r in reports.values()):
                raise AssertionError("examples_tools: a worker missed a tick report")
            solved = sum(r["solved"] for rs in reports.values() for r in rs)
            if solved <= 0:
                raise AssertionError("examples_tools: the ipc server solved nothing")
            stdlib_tool("tools/tracequery.py", "--audit", os.path.join(ipc_dir,
                                                                        "ipc_trace.jsonl"))
            stdlib_tool("tools/wire_journal.py", "--verify",
                        os.path.join(ipc_dir, "journal.jsonl"),
                        "--snapshot-dir", os.path.join(ipc_dir, "snaps"))
            out["ipc_smoke"] = {"smoke_line": smoke.lines("SMOKE ok")[0], "solved": solved,
                                "reports": {k: len(v) for k, v in reports.items()},
                                "audit": 0, "journal_verify": 0}

            # ---- the children started first --------------------------------
            for name in ("quickstart", "serve_lm", "train_lm"):
                seconds[name] = children[name].finish()
            qs = children["quickstart"]
            if not qs.lines("optimal cut = 22  local=['a', 'c']"):
                raise AssertionError(f"examples_tools: quickstart\n{qs.stdout}")
            serve = children["serve_lm"]
            n, tokens = spec["serve_requests"], spec["serve_requests"] * spec["serve_new_tokens"]
            if not serve.lines(f"[serve] {n} requests, {tokens} tokens in "):
                raise AssertionError(f"examples_tools: serve_lm\n{serve.stdout}")
            t0 = time.perf_counter()
            serve_cpu = stdout_of(script_main("examples/torch_serve_lm.py"),
                                  ["--device", "cpu"])
            train_cpu = stdout_of(script_main("examples/torch_train_lm.py"),
                                  ["--steps", "1", "--device", "cpu",
                                   "--ckpt-dir", os.path.join(tmp, "train_lm_cpu")])
            seconds["placements_cpu"] = time.perf_counter() - t0
            train = children["train_lm"]
            for child, cpu, prefix in ((serve, serve_cpu, "[serve] MCOP placement:"),
                                       (train, train_cpu, "[train] MCOP placement:")):
                want = [ln for ln in cpu.splitlines() if ln.startswith(prefix)]
                if child.lines(prefix) != want or len(want) != 1:
                    raise AssertionError(f"examples_tools: {child.lines(prefix)} on the card "
                                         f"against {want} on the CPU")
            losses = [float(ln.split()[4]) for ln in train.lines("[train] step ")]
            done = train.lines("[train] done: ")
            smoothed = done[0].split("(")[1].split(" ")[0].split("->") if done else []
            if not (losses and np.isfinite(losses).all() and len(smoothed) == 2
                    and float(smoothed[1]) < float(smoothed[0])):
                raise AssertionError(f"examples_tools: train_lm\n{train.stdout}")
            out["serve_lm"] = {"line": serve.lines(f"[serve] {n} requests")[0],
                               "placement": serve.lines("[serve] MCOP placement:")[0]}
            out["train_lm"] = {"losses": losses, "done": done[0],
                               "placement": train.lines("[train] MCOP placement:")[0],
                               "params": train.lines("[train] qwen2-7b:")[0]}
        finally:
            for child in children.values():
                if child.proc.poll() is None:
                    os.killpg(child.proc.pid, 9)
                child.reader.join()
        left = processes_naming(tmp) + child_processes()
        if left:
            raise AssertionError(f"examples_tools: processes left: {left}")
    out["seconds_by_run"] = seconds
    return out


# ----------------------------------------------------------------------
# Phases train_sharded and pipeline: distributed training on one card
# ----------------------------------------------------------------------

# qwen2-7b at published widths, 4 of its 28 layers, trained sharded over
# (data 2, model 2) and held against the same steps unsharded on the card,
# with the reference test's bounds (tests/test_distributed.py: loss within
# 5e-2, parameters after step 1 within 0.15) and two limits set from the
# readings of sound runs on an H100: every step's gradient norm within
# 5e-3 relative (read 2.42e-3), and each leaf's change in step 1 within 0.3
# of the unsharded change in norm (read 0.223; a lost update reads 1.  The
# bf16 parameters move by about one bf16 step in step 1, lr 1e-4 against
# weights of ~0.02, so an element whose gradient is at the rounding of the
# bf16 sums moves a step either way).  Then a reduced-width f32 replay of
# the same, losses and gradient norms within 1e-5 relative (f32 sums in
# another order through two layers, their backward and the all-reduced
# norm), each leaf's change within 1e-2 (read 1.4e-4; the CPU tests' bound
# for a float32 step).  The unsharded run takes the model's vocab-chunked
# loss, which never holds the (2, 8192, 152064) logits beside the whole
# model's states.
TRAIN_SHARDED = {"arch": "qwen2-7b", "layers": 4, "seq_len": 8192, "global_batch": 2,
                 "steps": 3, "mesh": (2, 2), "seed": 0, "lr": 1e-4, "ref_vocab_chunk": 32768,
                 "timeout": 420,
                 "loss_tol": 5e-2, "param_tol": 0.15, "grad_norm_rtol": 5e-3, "change_rtol": 0.3,
                 "replay": {"seq_len": 4160, "global_batch": 2, "steps": 3, "rtol": 1e-5,
                            "change_rtol": 1e-2,
                            "widths": dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                                           d_ff=128, vocab_size=256)}}
# qwen2-7b's blocks at published widths, two stages of two over (pod 2,
# data 2); x (8, 8192, 3584) bf16 so each data shard of 4 splits into 1, 2
# and 4 microbatches.  Output and the gradients of its sum (x and every
# stage parameter) against the 4 blocks in sequence on the card, each
# within tol x the reference's largest magnitude: bf16 products whose
# matrix shapes differ between a microbatch and the whole batch.
PIPELINE = {"arch": "qwen2-7b", "blocks": 4, "mesh": (2, 2), "batch": 8, "seq_len": 8192,
            "n_micro": (1, 2, 4), "seed": 0, "tol": 2.0**-5, "timeout": 300}
# zamba2-1.2b at published widths, 4 of its 38 layers (two groups: the
# shared block runs twice), trained sharded as TRAIN_SHARDED, with its
# limits on the loss and the step-1 parameters; the unsharded run takes the
# whole vocabulary's loss (32 000 columns).  Its gradient norm and step-1
# changes differ from the unsharded run's by more than qwen2-7b's: the bf16
# rounding of the partial sums over "model" (tools/torch_sharded_limits.py
# on an H100: seeds 0-2 read 3.4e-3 to 8.5e-3 and 0.40 to 0.49; with every
# sharded product's partial sums reduced in float32 the sharded step's
# distance from a float32 step falls from 1.89x the unsharded step's to
# 1.02x; on (data 2, model 1) it reads 0.99x, on (data 1, model 4) 2.01x).
# So the two bf16 runs are held to each other within 1.5e-2 and 0.6, and
# each to the same step in float32 on the card (f32_distances): the sharded
# one no further from it than f32_slack times the unsharded one (sound
# runs 0.93x to 2.52x).  Faults planted by the tool read far outside: B and
# C's gradient lost 0.29, 1.08 and 99x; taken twice 0.84, 0.87 and 304x.
# Its f32 replay (the reduced config at 4160 tokens, so that the shared
# block takes B4) runs unsharded on the CPU; so does the reduced
# deepseek-v2's, whose MLA keeps the published (192, 128) heads: B4 and
# B4-bwd at (192, 128) in f32 (the CUDA cores), 2 heads a rank.
TRAIN_SHARDED_HYBRID = {
    "arch": "zamba2-1.2b", "layers": 4, "seq_len": 8192, "global_batch": 2, "steps": 2,
    "mesh": (2, 2), "seed": 0, "lr": 1e-4, "ref_vocab_chunk": 0, "timeout": 600,
    "loss_tol": 5e-2, "param_tol": 0.15, "grad_norm_rtol": 1.5e-2, "change_rtol": 0.6,
    "f32_reference": True, "f32_slack": 5.0,
    "replay": {"seq_len": 4160, "global_batch": 2, "steps": 2, "rtol": 1e-5,
               "change_rtol": 1e-2, "widths": {}, "device": "cpu"}}
TRAIN_SHARDED_MLA = {
    "arch": "deepseek-v2-236b", "mesh": (2, 2), "seed": 0, "lr": 1e-4, "timeout": 600,
    "expert_mode": "ep_model",
    "replay": {"seq_len": 4160, "global_batch": 2, "steps": 2, "rtol": 1e-5,
               "change_rtol": 1e-2, "device": "cpu",
               "widths": {"mla": dict(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=128,
                                      qk_rope_head_dim=64, v_head_dim=128)}}}

# Serving sharded on (data 2, model 2), four ranks as threads on the card:
# qwen2-7b (4 of its 28 layers) and zamba2-1.2b (4 of its 38: two groups,
# so the shared block and B4 still run twice, and B5 on every rank) at
# published widths in bf16, 2 prompts of 4608 tokens (above 4096: B4's
# chunked route) into a cache of 8192 positions, then 8 greedy decode steps
# (zamba2's 3); zamba2 (4 layers) at long_500k's shape (batch 1, a cache of
# 524 288 positions, its 4096-slot ring and the Mamba2 states seeded, at
# length 524 280), 3 steps; and f32 replays of those three runs at reduced
# widths.  The readings below were taken with zamba2 at all 38 layers (a
# decode step then ~10 s of four threads' host time); at 4 layers an H100
# read 1.39 (prompt run) and 1.07 (long_500k) at seed 0.  The unsharded runs on
# the card take the sharded runs' tokens.  bf16: the partial sums over
# "model" round in bf16 in another order, so each run is also replayed
# unsharded in f32 on the same tokens, and the sharded logits must lie
# within f32_slack times as far from those as the unsharded bf16 logits do
# (zamba2's own bf16 logits lie 0.12-0.32 of the largest from its f32
# logits at 38 layers, so no fixed share of the largest says anything
# there); qwen2-7b's also within logit_tol of the unsharded run's largest.
# tools/torch_sharded_limits.py --phase serve on an H100 read zamba2's
# ratios (the prompt run then took 8 steps): seeds 0-2 0.96-0.98 (prompt
# run) and 0.38, 1.25, 2.07
# (long_500k: seed 2 would fail; the phase runs seed 0, the same reading
# every call); planted faults 3.4-4.4 (the Mamba2 step's state dropped, h's
# N block paired with the wrong B and C), but a ring written one slot off
# reads 0.98 and 0.50: bf16 cannot see it (in the prompt run nothing can:
# with the ring full, every slot is in the window, and attention does not
# depend on the slots' order).
# The f32 replays, qwen2-7b's and both zamba2 runs' (the prompt run, and
# long_500k's shape from a seeded cache: B5 on local heads and the
# ring's writes across ranks, then the Mamba2 step on h split over N) at
# reduced widths: within rtol, their greedy tokens equal; these hold the
# sharded route exactly where bf16 cannot (sound seeds 5.7e-7 to 7.4e-6;
# every planted fault fails them, the ring offset at 3.0e-4 in the
# long_500k run, the others at 1.2-1.5 of the largest).  (Four layers at batch 2:
# ``state_shardings`` splits over "data" the first axis of the batch's
# size, and two layers would be that axis.)
SERVE_SHARDED = {
    "mesh": (2, 2), "seed": 0, "timeout": 600, "f32_slack": 2.0,
    "runs": {
        "qwen2-7b": {"arch": "qwen2-7b", "layers": 4, "prompt_len": 4608, "batch": 2,
                     "max_len": 8192, "steps": 8, "logit_tol": 5e-2},
        "zamba2-1.2b": {"arch": "zamba2-1.2b", "layers": 4, "prompt_len": 4608, "batch": 2,
                        "max_len": 8192, "steps": 3},
        "zamba2-1.2b_long500k": {"arch": "zamba2-1.2b", "layers": 4, "batch": 1,
                                 "max_len": 524_288, "length": 524_280, "steps": 3},
        "qwen2-7b_f32": {"arch": "qwen2-7b", "prompt_len": 4608, "batch": 2, "max_len": 8192,
                         "steps": 8, "rtol": 1e-5,
                         "widths": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                                        d_ff=128, vocab_size=256, n_layers=4)},
        "zamba2-1.2b_f32": {"arch": "zamba2-1.2b", "prompt_len": 4608, "batch": 2,
                            "max_len": 8192, "steps": 8, "rtol": 1e-5,
                            "widths": dict(n_layers=4)},
        "zamba2-1.2b_long500k_f32": {"arch": "zamba2-1.2b", "batch": 1, "max_len": 524_288,
                                     "length": 524_280, "steps": 4, "rtol": 1e-5,
                                     "widths": dict(n_layers=4)}}}
# the thread worlds' switch interval (s): a sharded step is hundreds of
# collectives, each a meeting of every rank's thread
WORLD_SWITCH_INTERVAL = 1e-4


def _warm_python_ops() -> int:
    """Look up every registered operator's ``torch.ops`` overload once, on
    one thread, and return how many.  When C++ dispatch first hands an
    operator to Python (the rank counters' ``__torch_dispatch__``), PyTorch
    caches the operator's Python object; building that object runs Python
    code, and a rank thread switched out there while another thread fills
    the same cache trips PyTorch's internal assertion "expected !=
    self_interpreter" (``c10/core/PyHandleCache.h``).  Once the objects
    exist, filling the cache runs no Python code, so no thread is switched
    out inside it."""
    n = 0
    for name in torch._C._dispatch_get_all_op_names():
        ns, _, rest = name.partition("::")
        op, _, overload = rest.partition(".")
        try:
            getattr(getattr(getattr(torch.ops, ns), op), overload or "default")
        except (AttributeError, RuntimeError):
            continue   # not reachable from Python: never handed to it either
        n += 1
    return n


def _thread_world(kind: str, spec: dict, world: int, out_path: str) -> None:
    """A child process: ``world`` ranks as threads over the threaded process
    group, each on ``cuda:0``; their results (or the first failure) go to
    ``out_path``."""
    import threading
    import traceback

    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg)

    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks meet at every collective; at the interpreter's default switch
    # interval (5 ms) each meeting waits for the threads holding its lock
    sys.setswitchinterval(WORLD_SWITCH_INTERVAL)
    ranks.install_rank_counts()
    shared = WORLD_SETUP[kind](spec)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    _warm_python_ops()
    store = dist.HashStore()
    results, failures = [None] * world, []

    def rank_main(rank: int) -> None:
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world, store=store)
            torch.cuda.set_device(0)
            results[rank] = WORLD_RANK[kind](rank, world, spec, shared)
        except BaseException as err:  # the phase fails; the other ranks are woken
            failures.append(f"rank {rank}: {traceback.format_exc()}")
            ProcessLocalGroup.exception_handle(err)

    threads = [threading.Thread(target=rank_main, args=(r,), name=f"rank{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(spec["timeout"])
    if any(t.is_alive() for t in threads):
        failures.append("a rank did not finish in time")
    out = {"results": results, "failures": failures}
    if not failures:
        out["after"] = WORLD_AFTER[kind](spec, shared, results)
    torch.save(out, out_path)
    sys.stdout.flush()
    os._exit(0)  # threads of a failed world may still wait in a collective


def run_world(kind: str, spec: dict, world: int) -> dict:
    """Run phase ``kind``'s ranks as threads of one child process on the
    card (the kernels are built; the child loads them) and return what the
    child saved.  The child is a plain ``subprocess`` (a ``multiprocessing``
    child would leave its resource tracker behind), waited for, or killed
    and reaped."""
    import pickle
    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"smoke_{kind}_")
    args, out_path = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "world.pt")
    with open(args, "wb") as f:
        pickle.dump((kind, spec, world, out_path), f)
    code = ("import pickle, sys; import chip_smoke as c; "
            "c._thread_world(*pickle.load(open(sys.argv[1], 'rb')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code, args], env=env, cwd=ROOT)
    try:
        proc.wait(timeout=spec["timeout"] + 120)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"{kind}: the world's process ended with {proc.returncode}")
    out = torch.load(out_path, weights_only=False)
    if out["failures"]:
        raise AssertionError(f"{kind}: " + "\n".join(out["failures"]))
    return out


def sharded_config(spec: dict, *, replay: bool = False):
    from repro_torch.configs import MLAConfig, get_config, reduce_config

    if replay:
        widths = dict(spec["replay"]["widths"])
        if "mla" in widths:
            widths["mla"] = MLAConfig(**widths["mla"])
        return reduce_config(get_config(spec["arch"]), dtype="float32", **widths)
    return ranks.depth_config(spec["arch"], spec["layers"])


def sharded_tags(spec: dict) -> tuple:
    """The runs of a sharded-training spec: at published widths ("full",
    when it names a depth) and the f32 replay."""
    return (("full",) if spec.get("layers") else ()) + (("replay",) if "replay" in spec else ())


def setup_train_sharded(spec: dict) -> dict:
    """The full model (seeded on the card, kept on the host while the ranks
    train: the card's memory is theirs) and the batches every rank shares:
    the sharded run takes its shards from these, the unsharded reference
    runs on them afterwards; and the same for the f32 replay."""
    from repro_torch.models.transformer import Model

    out = {}
    for tag in sharded_tags(spec):
        replay = tag == "replay"
        cfg = sharded_config(spec, replay=replay)
        r = spec["replay"] if replay else spec
        params = Model(cfg, device=DEVICE).init(spec["seed"])
        out[tag] = {"cfg": cfg,
                    "params": {k: p.detach().cpu() for k, p in params.named_parameters()},
                    "batches": ranks.train_batches(cfg, r["seq_len"], r["global_batch"],
                                               r["steps"], spec["seed"])}
    return out


def rank_train_sharded(rank: int, world: int, spec: dict, shared: dict) -> dict:
    """One rank: its shards of the full model, then the steps."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import shard_params

    mesh = make_mesh(spec["mesh"], ("data", "model"), device=DEVICE)
    out = {}
    for tag in sharded_tags(spec):
        s = shared[tag]
        params = ranks.module_with(s["cfg"], shard_params(
            s["params"], mesh, expert_mode=spec.get("expert_mode", "ep_model")))
        if tag == "full":
            torch.cuda.reset_peak_memory_stats()
        run = ranks.train_run(s["cfg"], params, s["batches"], spec["lr"], mesh=mesh,
                              step1="keep" if rank == 0 else "join")
        if tag == "full":
            run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[tag] = run
        del params
    return out


def step1_changes(before: dict, got: dict, want: dict) -> dict:
    """The parameters after step 1, sharded (``got``) against unsharded
    (``want``), both from ``before``: the largest difference
    (``param_step1``); each leaf's change against the unsharded change,
    ||got - want|| / ||want - before|| over the leaves the unsharded step
    moved (``change_rel``: 1 where a leaf's update was lost); and the
    leaves the unsharded step left as they were (a bf16 element moves only
    if lr times its update reaches half a step of bf16) that the sharded
    step moved (``still_moved``)."""
    err, rel, worst, still, moved = 0.0, 0.0, None, 0, 0
    for k, b0 in before.items():
        b0, g1, w1 = (t.detach().to(DEVICE, torch.float32) for t in (b0, got[k], want[k]))
        err = max(err, float((g1 - w1).abs().max()))
        change = float((w1 - b0).norm())
        if change > 0:
            if float((g1 - w1).norm()) / change > rel:
                rel, worst = float((g1 - w1).norm()) / change, k
        else:
            still += 1
            moved += int(not torch.equal(g1, b0))
        del b0, g1, w1
    return {"param_step1": err, "change_rel": rel, "change_rel_leaf": worst,
            "still_leaves": still, "still_moved": moved}


def f32_distances(spec: dict, s: dict, got: dict, ref: dict) -> dict:
    """Step 1 of the unsharded run again with the same weights in float32 on
    the card: how far the sharded and the unsharded bf16 steps each are
    from it (gradient norm, relative; each leaf's step-1 change, as
    ``step1_changes``), so that a difference between the two bf16 runs can
    be told from bf16 rounding."""
    cfg = dataclasses.replace(s["cfg"], dtype="float32")
    on_card = {k: t.to(DEVICE, torch.float32) for k, t in s["params"].items()}
    run = ranks.train_run(cfg, ranks.module_with(cfg, on_card), s["batches"][:1],
                          spec["lr"], step1="keep")
    gn = run["steps"][0]["grad_norm"]
    out = {"grad_norm": gn}
    for name, res in (("sharded", got), ("unsharded", ref)):
        ch = step1_changes(s["params"], res["step1"], run["step1"])
        out[name] = {"grad_norm_rel": abs(res["steps"][0]["grad_norm"] - gn) / gn,
                     "change_rel": ch["change_rel"], "change_rel_leaf": ch["change_rel_leaf"]}
    del run, on_card
    return out


def after_train_sharded(spec: dict, shared: dict, results: list) -> dict:
    """The unsharded reference runs on the card (the ranks are done), or on
    the CPU for a replay that says so, and the sharded results are held to
    it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for tag in reversed(sharded_tags(spec)):
        s = shared[tag]
        dev = spec["replay"].get("device", DEVICE) if tag == "replay" else DEVICE
        torch.cuda.reset_peak_memory_stats()
        on_dev = {k: t.to(dev, copy=True) for k, t in s["params"].items()}
        batches = [{k: v.to(dev) for k, v in b.items()} for b in s["batches"]]
        ref = ranks.train_run(s["cfg"], ranks.module_with(s["cfg"], on_dev), batches,
                              spec["lr"], step1="keep", device=dev,
                              vocab_chunk=spec["ref_vocab_chunk"] if tag == "full" else 0)
        ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        got = results[0][tag]
        errs = {"loss": max(abs(a["loss"] - b["loss"]) for a, b in zip(got["steps"], ref["steps"])),
                "grad_norm_rel": max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                                     for a, b in zip(got["steps"], ref["steps"]))}
        errs.update(step1_changes(s["params"], got["step1"], ref["step1"]))
        if tag == "full" and spec.get("f32_reference"):
            errs["f32"] = f32_distances(spec, s, got, ref)
        got["step1"] = ref["step1"] = None
        if tag == "replay":
            errs["loss_rel"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                   for a, b in zip(got["steps"], ref["steps"]))
        out[tag] = {"errs": errs, "ref_steps": [{k: st[k] for k in ("loss", "grad_norm", "seconds")}
                                                for st in ref["steps"]],
                    "ref_peak_gb": ref["peak_gb"], "ref_device": dev}
        del ref, on_dev, batches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_sharded() -> dict:
    """qwen2-7b trained sharded on the card (TRAIN_SHARDED): four ranks of
    a (data 2, model 2) mesh as threads of one child process, over the
    threaded process group (gloo's functional collectives fail on CUDA
    tensors and NCCL takes one rank a card).  Every rank runs B4 on its 14
    query / 2 kv heads (2 a layer and step: the forward and remat's
    recompute) and B4-bwd once a layer and step; the steps are held to the
    unsharded run on the card, and the f32 replay at 1e-5."""
    spec = TRAIN_SHARDED
    world = spec["mesh"][0] * spec["mesh"][1]
    t0 = time.perf_counter()
    out = run_world("train_sharded", spec, world)
    seconds = time.perf_counter() - t0
    results, after = out["results"], out["after"]
    layers = spec["layers"]
    # B4 2 x layers (tensor cores) and B4-bwd once a layer; the replay on the CUDA cores
    want = ranks.step_launches(sharded_config(spec), spec["seq_len"])
    want_replay = ranks.step_launches(sharded_config(spec, replay=True),
                                      spec["replay"]["seq_len"])
    for rank, res in enumerate(results):
        for tag, expect in (("full", want), ("replay", want_replay)):
            for i, st in enumerate(res[tag]["steps"]):
                if st["launches"] != expect:
                    raise AssertionError(f"train_sharded {tag}: rank {rank} step {i} launched "
                                         f"{st['launches']}, expected {expect}")
    errs, rerrs = after["full"]["errs"], after["replay"]["errs"]
    if not (errs["loss"] <= spec["loss_tol"] and errs["param_step1"] <= spec["param_tol"]
            and errs["grad_norm_rel"] <= spec["grad_norm_rtol"]
            and errs["change_rel"] <= spec["change_rtol"] and errs["still_moved"] == 0):
        raise AssertionError(f"train_sharded: sharded vs unsharded {errs}")
    r = spec["replay"]
    if not (rerrs["loss_rel"] <= r["rtol"] and rerrs["grad_norm_rel"] <= r["rtol"]
            and rerrs["change_rel"] <= r["change_rtol"] and rerrs["still_moved"] == 0):
        raise AssertionError(f"train_sharded replay: sharded vs unsharded {rerrs}")
    steps = results[0]["full"]["steps"]
    losses = [st["loss"] for st in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_sharded: losses {losses}")
    tokens = spec["seq_len"] * spec["global_batch"]
    measured = steps[1:]   # step 0 warms up
    step_s = [max(res["full"]["steps"][i]["seconds"] for res in results)
              for i in range(1, len(steps))]
    return {"phase": "train_sharded", "backend": "threaded (4 ranks as threads on cuda:0)",
            "arch": spec["arch"], "layers": layers, "mesh": {"data": spec["mesh"][0],
                                                              "model": spec["mesh"][1]},
            "seq_len": spec["seq_len"], "global_batch": spec["global_batch"],
            "losses": losses, "ref_losses": [st["loss"] for st in after["full"]["ref_steps"]],
            "grad_norms": [st["grad_norm"] for st in steps],
            "step_seconds": [max(res["full"]["steps"][i]["seconds"] for res in results)
                             for i in range(len(steps))],
            "ref_step_seconds": [st["seconds"] for st in after["full"]["ref_steps"]],
            "tokens_per_s": tokens * len(measured) / sum(step_s),
            "steps_per_s": len(measured) / sum(step_s),
            "peak_gb_process": max(res["full"]["peak_gb"] for res in results),
            "state_gb_per_rank": [res["full"]["state_bytes"] / 1e9 for res in results],
            "ref_peak_gb": after["full"]["ref_peak_gb"],
            "launches_per_rank_step": want,
            "collectives_per_rank_step": measured[-1]["collectives"],
            "errors": errs, "bounds": {"loss": spec["loss_tol"], "param_step1": spec["param_tol"],
                                       "grad_norm_rel": spec["grad_norm_rtol"],
                                       "change_rel": spec["change_rtol"], "still_moved": 0},
            "replay": {"seq_len": r["seq_len"], "losses": [
                st["loss"] for st in results[0]["replay"]["steps"]],
                "ref_losses": [st["loss"] for st in after["replay"]["ref_steps"]],
                "errors": rerrs, "rtol": r["rtol"], "change_rtol": r["change_rtol"],
                "launches_per_rank_step": want_replay},
            "main_path_launches": {
                "flash_attention_kernel": sum(st["launches"]["flash_attention_kernel"]
                                              for res in results for st in res["full"]["steps"]),
                "flash_attention_bwd_kernel": sum(
                    st["launches"]["flash_attention_bwd_kernel"]
                    for res in results for st in res["full"]["steps"])},
            "seconds": seconds}



def sharded_family_run(spec: dict) -> dict:
    """One spec of phase ``train_sharded_families``: its world of four
    thread ranks, every rank's launches each step against
    ``ranks.step_launches``, and the errors against the unsharded runs
    within the spec's limits."""
    world = spec["mesh"][0] * spec["mesh"][1]
    t0 = time.perf_counter()
    out = run_world("train_sharded", spec, world)
    seconds = time.perf_counter() - t0
    results, after = out["results"], out["after"]
    res = {"arch": spec["arch"], "mesh": {"data": spec["mesh"][0], "model": spec["mesh"][1]},
           "expert_mode": spec.get("expert_mode"), "seconds": seconds, "main_path_launches": {}}
    for tag in sharded_tags(spec):
        replay = tag == "replay"
        r = spec["replay"] if replay else spec
        cfg = sharded_config(spec, replay=replay)
        want = ranks.step_launches(cfg, r["seq_len"])
        for rank, rank_res in enumerate(results):
            for i, st in enumerate(rank_res[tag]["steps"]):
                if st["launches"] != want:
                    raise AssertionError(f"{spec['arch']} {tag}: rank {rank} step {i} launched "
                                         f"{st['launches']}, expected {want}")
        for k in want:
            res["main_path_launches"][k] = res["main_path_launches"].get(k, 0) + sum(
                st["launches"][k] for rank_res in results for st in rank_res[tag]["steps"])
        errs = after[tag]["errs"]
        steps = results[0][tag]["steps"]
        row = {"seq_len": r["seq_len"], "global_batch": r["global_batch"],
               "dtype": cfg.dtype, "layers": cfg.n_layers,
               "losses": [st["loss"] for st in steps],
               "ref_losses": [st["loss"] for st in after[tag]["ref_steps"]],
               "grad_norms": [st["grad_norm"] for st in steps],
               "ref_grad_norms": [st["grad_norm"] for st in after[tag]["ref_steps"]],
               "ref_device": after[tag]["ref_device"], "errors": errs,
               "launches_per_rank_step": want}
        if replay:
            bounds = {"loss_rel": r["rtol"], "grad_norm_rel": r["rtol"],
                      "change_rel": r["change_rtol"]}
        else:
            bounds = {"loss": spec["loss_tol"], "param_step1": spec["param_tol"],
                      "grad_norm_rel": spec["grad_norm_rtol"], "change_rel": spec["change_rtol"]}
            tokens = r["seq_len"] * r["global_batch"]
            step_s = [max(rr[tag]["steps"][i]["seconds"] for rr in results)
                      for i in range(len(steps))]
            ref_s = [st["seconds"] for st in after[tag]["ref_steps"]]
            row.update({"step_seconds": step_s, "ref_step_seconds": ref_s,
                        "tokens_per_s": tokens * (len(steps) - 1) / sum(step_s[1:]),
                        "ref_tokens_per_s": tokens * (len(ref_s) - 1) / sum(ref_s[1:]),
                        "peak_gb_process": max(rr[tag]["peak_gb"] for rr in results),
                        "state_gb_per_rank": [rr[tag]["state_bytes"] / 1e9 for rr in results],
                        "ref_peak_gb": after[tag]["ref_peak_gb"],
                        "collectives_per_rank_step": steps[-1]["collectives"]})
        bad = {k: errs[k] for k, b in bounds.items() if not errs[k] <= b}
        if "f32" in errs:   # within f32_slack x the unsharded step's f32 distance
            f32, slack = errs["f32"], spec["f32_slack"]
            for key in ("grad_norm_rel", "change_rel"):
                if not f32["sharded"][key] <= slack * f32["unsharded"][key]:
                    bad[f"f32_{key}"] = (f32["sharded"][key], f32["unsharded"][key])
        if bad or errs["still_moved"]:
            raise AssertionError(f"{spec['arch']} {tag}: sharded vs unsharded {errs}, "
                                 f"bounds {bounds}")
        row["bounds"] = {**bounds, "still_moved": 0}
        res[tag] = row
    return res


def phase_train_sharded_families() -> dict:
    """The hybrid and MoE families trained sharded on the card
    (TRAIN_SHARDED_HYBRID, TRAIN_SHARDED_MLA): B5 and B5-bwd on each rank's
    Mamba2 heads, B4 and B4-bwd on its shared-block heads and on MLA's
    (192, 128) heads, each rank's launches read around each step."""
    runs = [sharded_family_run(spec) for spec in (TRAIN_SHARDED_HYBRID, TRAIN_SHARDED_MLA)]
    total = {}
    for run in runs:
        for k, n in run["main_path_launches"].items():
            total[k] = total.get(k, 0) + n
    return {"phase": "train_sharded_families",
            "backend": "threaded (4 ranks as threads on cuda:0)",
            "runs": runs, "main_path_launches": total,
            "seconds": sum(run["seconds"] for run in runs)}


def after_pipeline(spec: dict, shared: dict, results: list) -> dict:
    """The blocks in sequence on the card: output and gradients of its sum."""
    import gc

    stage_fn = ranks.block_stage(ranks.block_call(shared["cfg"]))
    leaves = {k: v.clone().requires_grad_(True) for k, v in shared["stacked"].items()}
    x = shared["x"].clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = stage_fn(leaves, x)
    y.sum().backward()
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    n_stages = spec["mesh"][0]
    ref_p = {k: g.reshape(n_stages, -1, *g.shape[1:]) for k, g in
             ((k, v.grad) for k, v in leaves.items())}

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())

    errs = {}
    for n_micro, res in results[0].items():
        errs[n_micro] = {"out": rel(res["out"], y), "x_grad": rel(res["x_grad"], x.grad),
                         "p_grads": max(rel(res["p_grads"][k], ref_p[k]) for k in ref_p)}
        for k in ("out", "x_grad", "p_grads"):
            res[k] = None
    del leaves, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return {"errors": errs, "sequential_seconds": seq_s}


def phase_pipeline() -> dict:
    """qwen2-7b's blocks through ``pipeline_apply`` (PIPELINE): four ranks of
    a (pod 2, data 2) mesh as threads of one child process on the card,
    each running its stage's two blocks on its local microbatches (B4 at
    8192 tokens: once a block and microbatch in the forward, again in
    remat's recompute), against the blocks in sequence on the card."""
    spec = PIPELINE
    world = spec["mesh"][0] * spec["mesh"][1]
    t0 = time.perf_counter()
    out = run_world("pipeline", spec, world)
    seconds = time.perf_counter() - t0
    results, after = out["results"], out["after"]
    n_stages, blocks = spec["mesh"][0], spec["blocks"]
    per_stage = blocks // n_stages
    rows = []
    for n_micro in spec["n_micro"]:
        err = after["errors"][n_micro]
        if not max(err.values()) <= spec["tol"]:
            raise AssertionError(f"pipeline n_micro={n_micro}: {err} over {spec['tol']}")
        # every rank: its blocks, once a microbatch forward and once again
        # in the backward's recompute; B4-bwd once a block and microbatch
        want = {"flash_attention_kernel": 2 * per_stage * n_micro,
                "flash_attention_bwd_kernel": per_stage * n_micro}
        for rank, res in enumerate(results):
            got = {k: res[n_micro]["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"pipeline n_micro={n_micro}: rank {rank} launched {got}, "
                                     f"expected {want}")
        slots = n_micro + n_stages - 1
        total = max(res[n_micro]["seconds"] for res in results)
        fwd = max(res[n_micro]["forward_seconds"] for res in results)
        rows.append({"n_micro": n_micro, "slots": slots,
                     "bubble_predicted": (n_stages - 1) / slots,
                     "forward_seconds": fwd, "seconds": total,
                     "forward_ms_per_slot": fwd / slots * 1e3,
                     "launches_per_rank": want, "errors": err,
                     "collectives_per_rank": results[0][n_micro]["collectives"]})
    return {"phase": "pipeline", "backend": "threaded (4 ranks as threads on cuda:0)",
            "arch": spec["arch"], "blocks": blocks, "stages": n_stages,
            "mesh": dict(zip(("pod", "data"), spec["mesh"])),
            "x": [spec["batch"], spec["seq_len"], "d_model", "bfloat16"], "tol": spec["tol"],
            "tol_meaning": "max |pipeline - sequential| / max |sequential|, bf16",
            "runs": rows, "sequential_seconds": after["sequential_seconds"],
            "main_path_launches": {
                k: sum(res[n]["launches"][k] for res in results for n in spec["n_micro"])
                for k in ("flash_attention_kernel", "flash_attention_bwd_kernel")},
            "seconds": seconds}


def serve_config(run: dict):
    """A serving run's config: published widths at ``layers`` (all by
    default), or the reduced config in float32 at ``widths``."""
    from repro_torch.configs import get_config, reduce_config

    if "widths" in run:
        return reduce_config(get_config(run["arch"]), dtype="float32", **run["widths"])
    return ranks.depth_config(run["arch"], run.get("layers"))


def setup_serve_sharded(spec: dict) -> dict:
    """Each run's model (seeded on the card, kept on the host while the
    ranks serve) and its prompts, or its seeded cache and first tokens."""
    from repro_torch.models.transformer import Model

    ranks.LaunchHeads.install()
    out = {}
    for name, run in spec["runs"].items():
        cfg = serve_config(run)
        params = Model(cfg, device=DEVICE).init(spec["seed"])
        s = {"cfg": cfg, "params": {k: p.detach().cpu() for k, p in params.named_parameters()}}
        del params
        if "prompt_len" in run:
            s["batch"] = {k: v.cpu() for k, v in ranks.serve_batch(
                cfg, run["prompt_len"], run["batch"], spec["seed"]).items()}
        else:
            cache = ranks.seeded_cache(cfg, run["batch"], run["max_len"], run["length"],
                                       spec["seed"])
            s["cache"] = _tree_to(cache, "cpu")
            gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"] + 1)
            s["start"] = torch.randint(1, cfg.vocab_size, (run["batch"], 1), generator=gen,
                                       device=DEVICE).cpu()
        out[name] = s
        torch.cuda.empty_cache()
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _place_tree(tree, shardings, mesh):
    from repro_torch.runtime.sharding import place

    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k], mesh) for k, v in tree.items()}
    return place(tree.to(DEVICE), mesh, shardings) if isinstance(tree, torch.Tensor) else tree


def rank_serve_sharded(rank: int, world: int, spec: dict, shared: dict) -> dict:
    """One rank: its shards of each run's model, then the run's cells."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.runtime import shard_params

    mesh = make_mesh(spec["mesh"], ("data", "model"), device=DEVICE)
    out = {}
    for name, run in spec["runs"].items():
        s = shared[name]
        cfg = s["cfg"]
        params = ranks.module_with(cfg, shard_params(s["params"], mesh))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kw = dict(max_len=run["max_len"], steps=run["steps"], mesh=mesh, keep=rank == 0)
        if "batch" in s:
            res = ranks.serve_run(cfg, params, batch={k: v.to(DEVICE) for k, v in
                                                      s["batch"].items()}, **kw)
        else:
            cell = build_cell(cfg, ShapeConfig("long", "decode", run["max_len"], run["batch"]),
                              mesh)
            cache = _place_tree(s["cache"], cell.in_shardings[2], mesh)
            res = ranks.serve_run(cfg, params, cache=cache, start=s["start"].to(DEVICE),
                                  bsz=run["batch"], **kw)
            del cache
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        del params
    return out


def after_serve_sharded(spec: dict, shared: dict, results: list) -> dict:
    """The unsharded runs on the card (the ranks are done): bf16 runs take
    the sharded run's tokens, the f32 replay its own greedy ones; each held
    to the sharded run."""
    import gc

    out = {}
    for name, run in spec["runs"].items():
        gc.collect()
        torch.cuda.empty_cache()
        s, got = shared[name], results[0][name]
        cfg = s["cfg"]
        t0 = time.perf_counter()
        params = ranks.module_with(cfg, {k: t.to(DEVICE) for k, t in s["params"].items()})
        forced = None if "rtol" in run else [t.to(DEVICE) for t in got["tokens"]]
        torch.cuda.reset_peak_memory_stats()
        kw = dict(max_len=run["max_len"], steps=run["steps"], forced=forced)
        if "batch" in s:
            ref = ranks.serve_run(cfg, params, batch={k: v.to(DEVICE) for k, v in
                                                      s["batch"].items()}, **kw)
        else:
            ref = ranks.serve_run(cfg, params, cache=_tree_to(s["cache"], DEVICE),
                                  start=s["start"].to(DEVICE), bsz=run["batch"], **kw)
        scale = max(float(t.abs().max()) for t in ref["logits"])
        err = max(float((a - b).abs().max()) for a, b in zip(got["logits"], ref["logits"]))
        same = [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(got["logits"], ref["logits"])]
        f32 = {}
        if "rtol" not in run:   # the unsharded run in f32, on the same tokens
            del params
            ref["logits"] = [t.cpu() for t in ref["logits"]]
            f32 = _f32_distances(s, run, got, ref, kw)
        out[name] = {"logit_err": err, "logit_scale": scale, "logit_rel": err / scale, **f32,
                     "greedy_equal": same,
                     "tokens_equal": all(torch.equal(a, b) for a, b in
                                         zip(got["tokens"], ref["tokens"])),
                     "ref_prefill_seconds": ref.get("prefill_seconds"),
                     "ref_decode_seconds": ref["decode_seconds"],
                     "ref_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "ref_cache_bytes": ref["cache_bytes"],
                     "ref_seconds": time.perf_counter() - t0}
        for res in results:
            res[name]["logits"] = None
        del ref
    return out


def _f32_distances(s: dict, run: dict, got: dict, ref: dict, kw: dict) -> dict:
    """The unsharded run again in float32 (the same bf16 weights and cache
    values, the same tokens), and how far the sharded and the unsharded
    bf16 logits each lie from it, as shares of its largest: a difference
    between the two bf16 runs told from bf16 rounding."""
    cfg = dataclasses.replace(s["cfg"], dtype="float32")
    params = ranks.module_with(cfg, {k: t.to(DEVICE, torch.float32) for k, t in
                                     s["params"].items()})
    if "batch" in s:
        r32 = ranks.serve_run(cfg, params, batch={k: v.to(DEVICE) for k, v in
                                                  s["batch"].items()}, **kw)
    else:
        cache = _tree_to(s["cache"], DEVICE)
        cache = {k: _tree_f32(v) for k, v in cache.items()}
        r32 = ranks.serve_run(cfg, params, cache=cache, start=s["start"].to(DEVICE),
                              bsz=run["batch"], **kw)
    scale = max(float(t.abs().max()) for t in r32["logits"])

    def dist(res):
        return max(float((a - b).abs().max()) for a, b in zip(res["logits"], r32["logits"]))
    return {"f32_sharded": dist(got) / scale, "f32_unsharded": dist(ref) / scale}


def _tree_f32(tree):
    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    return tree.float() if isinstance(tree, torch.Tensor) else tree


def phase_serve_sharded() -> dict:
    """The serving cells sharded on the card (SERVE_SHARDED): four ranks of
    a (data 2, model 2) mesh as threads of one child process, each running
    ``build_cell``'s prefill step (B4 on its 14 query / 2 kv heads of
    qwen2-7b, on 16 of zamba2's 32 shared-block heads; B5 on 32 of its 64
    Mamba2 heads) and decode steps (no kernel: the cache read where it
    lies), each run held to the unsharded run on the card."""
    spec = SERVE_SHARDED
    world = spec["mesh"][0] * spec["mesh"][1]
    t0 = time.perf_counter()
    out = run_world("serve_sharded", spec, world)
    seconds = time.perf_counter() - t0
    results, after = out["results"], out["after"]
    none = {k: 0 for k in ranks.RANK_KEYS}
    rows, total = [], dict.fromkeys(("flash_attention_kernel", "mamba_chunk_scan_kernel"), 0)
    bad = []
    for name, run in spec["runs"].items():
        cfg, err = serve_config(run), after[name]
        want = ranks.serve_launches(cfg, run["prompt_len"]) if "prompt_len" in run else None
        for rank, res in enumerate(results):
            r = res[name]
            if want is not None and r["prefill_launches"] != want:
                raise AssertionError(f"serve_sharded {name}: rank {rank}'s prefill launched "
                                     f"{r['prefill_launches']}, expected {want}")
            if any(d != none for d in r["decode_launches"]):
                raise AssertionError(f"serve_sharded {name}: rank {rank}'s decode launched "
                                     f"{r['decode_launches']}")
            for k in total:
                total[k] += r.get("prefill_launches", none)[k]
        if "rtol" in run:
            if not (err["tokens_equal"] and err["logit_rel"] <= run["rtol"]):
                bad.append(f"{name}: against the unsharded run {err}")
        elif not (err["logit_rel"] <= run.get("logit_tol", np.inf)
                  and err["f32_sharded"] <= spec["f32_slack"] * max(err["f32_unsharded"], 1e-5)):
            bad.append(f"{name}: against the unsharded run {err}")
        r0 = results[0][name]
        bsz = run["batch"]
        dec = [max(res[name]["decode_seconds"][i] for res in results)
               for i in range(run["steps"])]
        row = {"run": name, "seconds": max(res[name]["seconds"] for res in results),
               "ref_seconds": err["ref_seconds"],
               "arch": run["arch"], "layers": cfg.n_layers, "dtype": cfg.dtype,
               "batch": bsz, "max_len": run["max_len"],
               "prompt_len": run.get("prompt_len"), "length": r0["length"],
               "decode_step_seconds": dec, "decode_tokens_per_s": bsz * (len(dec) - 1)
               / sum(dec[1:]),
               "ref_decode_step_seconds": err["ref_decode_seconds"],
               "collectives_per_decode_step": r0["collectives"][-1],
               "collective_bytes_per_decode_step": ranks.collective_bytes(
                   r0["collectives"][-1]),
               "cache_bytes_per_rank": [res[name]["cache_bytes"] for res in results],
               "ref_cache_bytes": err["ref_cache_bytes"],
               "peak_gb_process": max(res[name]["peak_gb"] for res in results),
               "ref_peak_gb": err["ref_peak_gb"],
               "errors": {k: err[k] for k in ("logit_rel", "logit_err", "logit_scale",
                                              "greedy_equal", "tokens_equal", "f32_sharded",
                                              "f32_unsharded") if k in err},
               "bound": {"rtol": run["rtol"]} if "rtol" in run
               else {"logit_tol": run.get("logit_tol"), "f32_slack": spec["f32_slack"]}}
        if want is not None:
            pre = max(res[name]["prefill_seconds"] for res in results)
            row.update({"prefill_seconds": pre,
                        "prefill_tokens_per_s": bsz * run["prompt_len"] / pre,
                        "ref_prefill_seconds": err["ref_prefill_seconds"],
                        "prefill_launches_per_rank": want,
                        "prefill_heads_per_rank": [res[name].get("prefill_heads")
                                                   for res in results]})
        rows.append(row)
    if bad:
        raise AssertionError("serve_sharded: " + "; ".join(bad) + "\n" + json.dumps(rows))
    return {"phase": "serve_sharded", "backend": "threaded (4 ranks as threads on cuda:0)",
            "mesh": {"data": spec["mesh"][0], "model": spec["mesh"][1]}, "runs": rows,
            "main_path_launches": total, "seconds": seconds}


# phase dryrun: launch.dryrun on fake worlds, in a child process, with the
# fake shards on the card's device: (arch, shape, two pods) cells, and
# SERVE_SHARDED's qwen2-7b decode cell on a fake world of its mesh's 4 ranks
DRYRUN = {"cells": (("qwen2-7b", "decode_32k", False), ("zamba2-1.2b", "prefill_32k", True)),
          "serve_run": "qwen2-7b", "timeout": 600}


def _dryrun_child(out_path: str) -> None:
    """A child process: the dry run of DRYRUN's cells and of SERVE_SHARDED's
    decode cell (each makes and destroys its own fake world); the results
    as JSON in ``out_path``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    out = {f"{arch}/{shape}": dryrun.run_cell(arch, shape, multi_pod=mp, device=DEVICE)
           for arch, shape, mp in DRYRUN["cells"]}
    run = SERVE_SHARDED["runs"][DRYRUN["serve_run"]]
    out["serve_sharded"] = dryrun.run_cell(
        run["arch"], "decode_32k", multi_pod=False, device=DEVICE,
        mesh_shape=SERVE_SHARDED["mesh"], cfg=serve_config(run),
        shape=ShapeConfig("decode_cell", "decode", run["max_len"], run["batch"]))
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_dryrun(served_sharded: dict) -> dict:
    """``launch.dryrun`` on fake worlds with fake CUDA shards, in a child
    process that leaves no process group: qwen2-7b ``decode_32k`` on the
    256-rank mesh; zamba2-1.2b ``prefill_32k`` on the 512-rank mesh, whose
    rank traces B4 and B5 as many times as a prefill launches them
    (``ranks.serve_launches``) and launches none; and SERVE_SHARDED's
    qwen2-7b decode cell on a fake world of 4, whose collective calls and
    bytes by kind must be ``==`` those phase ``serve_sharded`` measured for
    rank 0's last decode step (the same counter)."""
    import tempfile

    from repro_torch.configs import get_config, get_shape

    t0 = time.perf_counter()
    out_path = os.path.join(tempfile.mkdtemp(prefix="smoke_dryrun_"), "dryrun.json")
    code = f"import chip_smoke as c; c._dryrun_child({out_path!r})"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT)
    try:
        proc.wait(timeout=DRYRUN["timeout"])
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"dryrun: the child process ended with {proc.returncode}")
    with open(out_path) as f:
        res = json.load(f)
    cells = []
    for key, r in res.items():
        if any(r["launches"].values()):
            raise AssertionError(f"dryrun {key}: the trace launched {r['launches']}")
        if r["memory"]["peak_bytes"] > 80e9:
            raise AssertionError(f"dryrun {key}: a rank's peak {r['memory']} passes 80 GB")
        cells.append({
            "cell": key, "mesh": r["mesh"], "chips": r["chips"],
            "memory_gb": {k: v / 1e9 for k, v in r["memory"].items()},
            "collective_gb": {k: v / 1e9 for k, v in r["collectives"].items()
                              if k != "num_ops"},
            "collective_calls": r["collective_calls"],
            "kernel_calls": {k: v["calls"] for k, v in r["kernels"].items()},
            "kernel_shapes": {k: v["shapes"] for k, v in r["kernels"].items() if v["calls"]},
            "flops_per_rank": r["flops_per_device"], "bytes_per_rank": r["bytes_per_device"],
            "roofline": r["roofline"], "useful_flops_ratio": r["useful_flops_ratio"],
            "trace_seconds": r["lower_s"] + r["compile_s"]})
    traced = {}
    for arch, shape, _ in DRYRUN["cells"]:   # a prefill traces what it would launch
        calls = {k: v["calls"] for k, v in res[f"{arch}/{shape}"]["kernels"].items()}
        traced[f"{arch}/{shape}"] = calls
        if get_shape(shape).kind == "prefill":
            want = ranks.serve_launches(get_config(arch), get_shape(shape).seq_len)
            if calls != {k: want[k] for k in calls}:
                raise AssertionError(f"dryrun {arch} {shape}: traced {calls}, a prefill "
                                     f"launches {want}")
    run = next(r for r in served_sharded["runs"] if r["run"] == DRYRUN["serve_run"])
    measured = run["collectives_per_decode_step"]
    dry = res["serve_sharded"]
    dry_kinds = {k: {"calls": dry["collective_calls"][k], "bytes": dry["collectives"][k]}
                 for k in dry["collective_calls"]}
    if dry_kinds != measured:
        raise AssertionError(f"dryrun: serve_sharded's decode cell counts {dry_kinds} on a "
                             f"fake world, the threads measured {measured}")
    return {"phase": "dryrun", "device": DEVICE, "cells": cells,
            "traced_kernel_calls": traced,
            "serve_sharded_decode": {"dry_run": dry_kinds, "measured": measured},
            "seconds": time.perf_counter() - t0}


WORLD_SETUP = {"train_sharded": setup_train_sharded, "pipeline": ranks.setup_pipeline,
               "serve_sharded": setup_serve_sharded}
WORLD_RANK = {"train_sharded": rank_train_sharded, "pipeline": ranks.rank_pipeline,
              "serve_sharded": rank_serve_sharded}
WORLD_AFTER = {"train_sharded": after_train_sharded, "pipeline": after_pipeline,
               "serve_sharded": after_serve_sharded}


def child_processes() -> list[str]:
    """The command lines of this process's living children (Linux ``/proc``)."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            # fields after the parenthesised command: state, ppid, ...
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if int(ppid) != os.getpid():
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (FileNotFoundError, ProcessLookupError):  # ended meanwhile
            continue
        left.append(f"{pid} ({state}): {cmd}")
    return left


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import mcop_phase as K

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    built = build.build_all(verbose_ptxas=bool(os.environ.get("SMOKE_PTXAS")))
    if os.environ.get("SMOKE_PTXAS"):
        for name, log in built["log"].items():
            print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    nvcc = next(
        (ln.strip() for ln in subprocess.run(
            [build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True).stdout.splitlines() if "release" in ln), "unknown")
    emit({"phase": "env", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "build_seconds": built["seconds"], "built": built["built"]})

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    checks = phase_kernel_checks(rng)
    checks["seconds"] = time.perf_counter() - t0
    emit(checks)
    t0 = time.perf_counter()
    near = phase_near_symmetric(np.random.default_rng(16))
    near["seconds"] = time.perf_counter() - t0
    emit(near)
    t0 = time.perf_counter()
    model_checks = phase_model_kernel_checks(rng)
    model_checks["seconds"] = time.perf_counter() - t0
    emit(model_checks)
    if os.environ.get("SMOKE_ONLY_CHECKS"):
        return 0

    reset_all_launches()  # ---- the broker path starts here ----
    t0 = time.perf_counter()
    plane = phase_solve_plane(rng)
    plane["seconds"] = time.perf_counter() - t0
    plane["launches"] = {k: K.LAUNCHES[k] for k in BROKER_PATH_KERNELS}
    emit(plane)
    t0 = time.perf_counter()
    broker = phase_broker(rng)
    broker["seconds"] = time.perf_counter() - t0
    launches = broker["main_path_launches"]  # ---- and ends before the replay ----
    emit(broker)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"broker path never launched {name}")
    fleet = phase_solver_fleet(np.random.default_rng(17))  # its own path and counters
    emit(fleet)
    for name in BROKER_PATH_KERNELS:
        if fleet["main_path_launches"][name] <= 0:
            raise AssertionError(f"solver fleet path never launched {name}")

    t0 = time.perf_counter()
    serve = phase_serve()  # resets and reads the counters around its own path
    serve["seconds"] = time.perf_counter() - t0
    emit(serve)
    t0 = time.perf_counter()
    replay = phase_serve_replay()
    replay["seconds"] = time.perf_counter() - t0
    emit(replay)
    t0 = time.perf_counter()
    families = phase_serve_families()  # resets and reads the counters around each model
    families["seconds"] = time.perf_counter() - t0
    emit(families)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained = phase_train()  # resets and reads the counters around each step
    trained["seconds"] = time.perf_counter() - t0
    emit(trained)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_replay = phase_train_replay()
    train_replay["seconds"] = time.perf_counter() - t0
    emit(train_replay)
    torch.cuda.empty_cache()
    sharded = phase_train_sharded()  # each rank resets and reads its counters around each step
    emit(sharded)
    families_sharded = phase_train_sharded_families()  # the same, for each spec's runs
    emit(families_sharded)
    for name in ("mamba_chunk_scan_kernel", "mamba_chunk_scan_bwd_kernel",
                 "flash_attention_kernel", "flash_attention_bwd_kernel"):
        if families_sharded["main_path_launches"][name] <= 0:
            raise AssertionError(f"train_sharded_families never launched {name}")
    piped = phase_pipeline()  # each rank resets and reads its counters around each run
    emit(piped)
    served_sharded = phase_serve_sharded()  # each rank: around its prefill and each step
    emit(served_sharded)
    for name, count in served_sharded["main_path_launches"].items():
        if count <= 0:
            raise AssertionError(f"serve_sharded never launched {name}")
    emit(phase_dryrun(served_sharded))  # traces, launches nothing, in a child process

    t0 = time.perf_counter()
    min_cut = phase_min_cut(rng)  # resets and reads the counters around its path
    min_cut["seconds"] = time.perf_counter() - t0
    emit(min_cut)
    t0 = time.perf_counter()
    served = phase_serve_broker()
    served["seconds"] = time.perf_counter() - t0
    served["gpu"] = gpu
    emit(served)
    t0 = time.perf_counter()
    examples = phase_examples_tools()
    examples["seconds"] = time.perf_counter() - t0
    emit(examples)

    work, kernels = kernel_lines(rng, launches)
    for entry in kernels["kernels"]:  # B1 and B2: their launches on the fleet path too
        entry["fleet_launches"] = fleet["main_path_launches"][entry["name"]]
    for name, path, line in (
        ("flash_attention_kernel", "flash_attention", 152),
        ("mamba_chunk_scan_kernel", "mamba_scan", 132),
    ):
        timed_entry = next(e for e in model_checks["entries"]
                           if e["name"] == name and "ms" in e)
        if name == "flash_attention_kernel":  # its other paths and MLA's heads
            mla = next(e for e in model_checks["entries"] if e["name"] == name
                       and "ms" in e and len(e["shape"]) == 7)
            timed_entry = {**timed_entry, "launches_serve_families": families["flash_launches"],
                           "launches_by_model": {m["arch"]: m["flash_launches"]
                                                 for m in families["models"]},
                           "launches_train_sharded": sharded["main_path_launches"][name],
                           "launches_pipeline": piped["main_path_launches"][name],
                           "mla": {k: mla.get(k) for k in (
                               "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_refused", "tflops",
                               "bound_share")}}
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{path}.cu",
            "replaces": f"src/repro/kernels/{path}.py:{line}",
            "launches": serve["main_path_launches"][name],
            **{k: timed_entry[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "shape", "tflops", "bound_share")},
            **{k: timed_entry[k] for k in ("variant", "bound_f32_ms", "launches_serve_families",
                                           "launches_by_model", "launches_train_sharded",
                                           "launches_pipeline", "mla") if k in timed_entry},
        })
    for name, path, replaces in (
        ("flash_attention_bwd_kernel", "flash_attention_bwd", "src/repro/models/attention.py:177"),
        ("mamba_chunk_scan_bwd_kernel", "mamba_scan_bwd", "src/repro/models/ssm.py:190"),
    ):
        timed_entry = next(e for e in model_checks["entries"] if e["name"] == name and "ms" in e)
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{path}.cu",
            # no TPU kernel: the JAX package autodiffs the function at this line
            "replaces": replaces, "tpu_kernel": None,
            "launches": trained["main_path_launches"][name],
            "launches_per_step": trained["launches_per_step"][name],
            **({"launches_train_sharded": sharded["main_path_launches"][name],
                "launches_pipeline": piped["main_path_launches"][name]}
               if name == "flash_attention_bwd_kernel" else {}),
            **({"variant": timed_entry["variant"],
                "launches_by_variant": {v: trained["main_path_launches"][key]
                                        for v, key in BWD_VARIANT_KEYS.items()}}
               if "variant" in timed_entry else {}),
            **{k: timed_entry[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "shape", "tflops", "bound_share")},
            **({"bound_f32_ms": timed_entry["bound_f32_ms"]} if "bound_f32_ms" in timed_entry
               else {}),
        })
    timed_entry = next(e for e in model_checks["entries"]
                       if e["name"] == "decode_attention_kernel" and "ms" in e)
    kernels["kernels"].append({
        "name": "decode_attention_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        # no TPU kernel: the JAX package's jnp decode at this line
        "replaces": "src/repro/models/attention.py:72", "tpu_kernel": None,
        "launches": families["decode_attention_launches"],
        "launches_by_model": {m["arch"]: m["decode_attention_launches"]
                              for m in families["models"]},
        **{k: timed_entry[k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "decode_local_ms",
            "decode_local_call_ms", "bound_ms", "bound_by", "bound_share", "library_ms",
            "shape", "splits")},
    })
    line = next(t for t in min_cut["timing"] if t["n"] == MIN_CUT["line_n"])
    kernels["kernels"].append({
        "name": "mcop_phase_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mcop_phase.cu",
        "replaces": "src/repro/kernels/mcop_phase.py:162",
        "launches": min_cut["main_path_launches"]["mcop_phase_kernel"],
        "max_abs_err": min_cut["phase_checks"]["max_abs_err"],
        **{k: line[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "shape": [line["n"], line["n"]],
        "other_shapes": [t for t in min_cut["timing"] if t is not line],
    })
    work["mcop_phase_kernel"] = min_cut["work"]
    # B3's kernel time on the per-phase path, estimated from counts and the
    # device loop's two timed graphs: an absorb step on a graph of n
    # vertices costs the staged loop's ns per step, interpolated linearly in
    # n between the timed n = 64 and n = 256 (held at the ends)
    (n_a, t_a), (n_b, t_b) = sorted(
        (t["n"], t["ns_per_step_staged"] * 1e-6) for t in min_cut["loop"])
    step_a, step_b = t_a, t_b

    def step_ms(n: int) -> float:
        f = min(max((n - n_a) / (n_b - n_a), 0.0), 1.0)
        return step_a + f * (step_b - step_a)

    path = min_cut["main_path"]
    work["mcop_phase_kernel_main_path"] = {
        "launches": path["phases"], "absorb_steps": path["absorb_steps"],
        "step_us": {str(n_a): step_a * 1e3, str(n_b): step_b * 1e3},
        "estimated_kernel_ms": sum(s * step_ms(n) for n, s in min_cut["absorb_steps_by_n"]),
        "path_ms": path["seconds"] * 1e3}
    for entry in kernels["kernels"]:  # B4, B4-bwd, B5, B5-bwd on local shards
        if entry["name"] in families_sharded["main_path_launches"]:
            entry["launches_train_sharded_families"] = (
                families_sharded["main_path_launches"][entry["name"]])
        if entry["name"] in served_sharded["main_path_launches"]:
            entry["launches_serve_sharded"] = served_sharded["main_path_launches"][entry["name"]]
    for entry in kernels["kernels"]:
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} was launched on no path")
    emit(work)
    emit(kernels)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    left = child_processes()
    if left:
        raise AssertionError(f"processes this script started are still running: {left}")
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
