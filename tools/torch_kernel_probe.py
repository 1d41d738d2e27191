#!/usr/bin/env python3
"""Measurements behind the design of the port's kernels, on one NVIDIA GPU
(Hopper).  Diagnostic only: nothing here is imported by the package, and
``chip_smoke.py`` stays the check of record.

    python3 tools/torch_kernel_probe.py wgmma-layout    # descriptor fields of wgmma operands
    python3 tools/torch_kernel_probe.py flash-variants  # B4 at the prefill shape, by design knob
    python3 tools/torch_kernel_probe.py flash-mla-variants  # B4 at MLA's heads, by warpgroups
    python3 tools/torch_kernel_probe.py flash-bwd-variants  # B4-bwd by variant and warpgroups
    python3 tools/torch_kernel_probe.py mamba-passes    # B5's four passes, device time each
    python3 tools/torch_kernel_probe.py mcop-variants   # B1's warp body, by design knob
    python3 tools/torch_kernel_probe.py decode-splits   # B6 at the served decode step, by splits
    python3 tools/torch_kernel_probe.py decode-variants # B6 there, by design knob

``wgmma-layout`` runs ``tools/torch_wgmma_probe.cu``: for no-swizzle K-major
and MN-major operands, which (LBO, SBO) assignment gives the right product.
``flash-variants`` builds ``csrc/flash_attention.cu`` as it is and with one
knob changed by a text edit (warpgroups a block and blocks an SM; P V
without the P_lo product; exp2 left out), checks each against the plain
version at the served prefill shape (bf16 4 x 32 x 8192 x 64, causal,
window 4096) and times each in the order A, B, ..., ..., B, A; variants
that change the arithmetic are timings only, their error is printed.
``flash-mla-variants`` does the same for the tensor-core variant at MLA's
(hd, hd_v) = (192, 128), 4 warpgroups as built against 2, at deepseek-v2's
prefill shape (bf16 4 x 128 x 6144, causal).
``flash-bwd-variants`` builds ``csrc/flash_attention_bwd.cu`` as it is (the
tensor-core variant at 1 warpgroup a block at (64, 64) and (128, 128), 2 at
(192, 128)) and with the other count at each pair; prints ptxas's registers and spills of every
tensor-core kernel; and times B4-bwd at zamba2-1.2b's training shape (bf16
2 x 32 x 8192 x 64, causal, window 4096), qwen2-7b's (bf16 1 x 28/4 x 4160
x 128, causal) and at MLA's (192, 128) (bf16 2 x 16 x 4096, causal) by
variant (CUDA cores, tensor cores as built and with the other warpgroup
count) in the order A, B, C, C, B, A, each result against the as-built
tensor-core kernel's (max |diff| over the largest gradient).
``mamba-passes`` profiles one B5 call at the served prefill shape (f32 4 x
64 heads x 32 chunks x 256, P = N = 64) and prints each pass's device time.
``mcop-variants`` builds ``csrc/mcop_sw.cu`` as it is and with one knob of
the warp body (``csrc/sw_common.cuh``) changed by a text edit (each row
load paired with its add, without the guard value that makes the adds wait
for all the loads; the warp argmax by a shuffle butterfly on (score, index)
in place of the two redux.sync), checks that each gives the same bits, and
times each at the solve plane's shapes (K = 4096 graphs of 64 vertices,
K = 1024 of 256) in the order A, B, C, C, B, A; then it runs
``tools/torch_latency_probe.cu``: SM cycles per dependent redux.sync (max,
min), shuffle, ballot, shared-memory load and integer multiply-add on a
warp alone on its SM, the links an absorb step chains together.
``decode-splits`` times B6 (``kernels/decode_attention.py``) at the served
decode step (bf16, a wave of 8, 28 / 4 heads of 128, 8 201 slots, the query
at position 8 192) with the split count the wrapper chooses replaced by each
of ``DECODE_SPLITS`` in turn, in the order A, B, ..., ..., B, A, each in a
CUDA graph over four layers' caches (L2 cold, no host time), each result
against ``_decode_local``'s.
``decode-variants`` builds ``csrc/decode_attention.cu`` as it is and with one
knob changed by a text edit (the score step's products left out, the P V
products left out, the tile loads left out, three ring stages, three
stages and 24 tiles a block at two blocks an SM), each in a process of its
own on a copy of ``src/`` (libraries built apart, one CUDA runtime a
process), and times each as ``decode-splits`` does; variants that change the arithmetic are timings
only, their error against the as-built kernel is printed.
Everything is built into ``build/repro_torch/probe/`` with ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

OUT = os.path.join(ROOT, "build", "repro_torch", "probe")


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def nvcc(src: str, out: str, *flags: str) -> subprocess.Popen:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    return subprocess.Popen([nvcc_path(), *NVCC_FLAGS, *flags, "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wgmma_layout() -> dict:
    so = os.path.join(OUT, "wgmma_probe.so")
    proc = nvcc(os.path.join(ROOT, "tools", "torch_wgmma_probe.cu"), so)
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    lib = ctypes.CDLL(so)
    lib.probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    b = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    d = torch.zeros(64, 64, device="cuda")
    rows = []
    # layout 0: cores along the rows of the operand 1024 B apart, along the
    # other dim 128 B (for which 1: the reverse); the k step is 16 elements
    for which, want in ((0, a.float() @ b.float().T), (1, a.float() @ b.float())):
        kstep = {0: {0: 256, 1: 2048}, 1: {0: 2048, 1: 256}}[which]
        for layout in (0, 1):
            for lbo, sbo in ((128, 1024), (1024, 128)):
                d.zero_()
                err = lib.probe(which, a.data_ptr(), b.data_ptr(), d.data_ptr(), layout, lbo,
                                sbo, kstep[layout])
                rows.append({"which": ["K-major A and B", "register A, MN-major B"][which],
                             "layout": layout, "lbo": lbo, "sbo": sbo, "cuda_error": err,
                             "max_abs_err": float((d - want).abs().max()) if err == 0 else None})
    # 128-byte swizzle, 64 bf16 a row: the k step is 32 bytes along a
    # K-major row, two 8-row groups (2048 bytes) down an MN-major operand
    for which, want, kstep in ((2, a.float() @ b.float().T, 32), (3, a.float() @ b.float(), 2048)):
        for lbo, sbo in ((16, 1024), (1024, 1024), (1024, 16)):
            d.zero_()
            err = lib.probe(which, a.data_ptr(), b.data_ptr(), d.data_ptr(), 0, lbo, sbo, kstep)
            rows.append({"which": ["K-major A and B", "register A, MN-major B"][which - 2]
                         + ", 128-byte swizzle", "lbo": lbo, "sbo": sbo, "cuda_error": err,
                         "max_abs_err": float((d - want).abs().max()) if err == 0 else None})
    return {"probe": "wgmma-layout", "rows": rows}


FLASH_SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
HD64 = "tc::launch<64, 64, 2, 2>"
FLASH_VARIANTS = {
    "as built (2 warpgroups, 2 blocks an SM)": [],
    "2 warpgroups, 1 block an SM": [(HD64, "tc::launch<64, 64, 2, 1>")],
    "4 warpgroups, 1 block an SM": [(HD64, "tc::launch<64, 64, 4, 1>")],
    "without the P_lo product": [("        wgmma_o(o[h2], pl[kk], dv);\n", "")],
    "without exp2": [("float p = ex2(fmaf(x, scale_log2, -m_new));",
                      "float p = fmaf(x, scale_log2, -m_new);")],
}


HD192 = "tc::launch<192, 128, 4, 1>"
FLASH_MLA_VARIANTS = {
    "as built (4 warpgroups)": [],
    "2 warpgroups": [(HD192, "tc::launch<192, 128, 2, 1>")],
}
# probe -> (variants, the tensor-core kernel's template arguments as mangled,
# (B, H, S, hd, hd_v, window))
FLASH_PROBES = {
    "flash-variants": (FLASH_VARIANTS, "ILi64ELi64E", (4, 32, 8192, 64, 64, 4096)),
    "flash-mla-variants": (FLASH_MLA_VARIANTS, "ILi192ELi128E", (4, 128, 6144, 192, 128, None)),
}


def flash_variants(probe: str = "flash-variants") -> dict:
    from repro_torch.kernels.ref import flash_attention_plain

    variants, mangled, (b, h, s, hd, hd_v, window) = FLASH_PROBES[probe]
    src = open(FLASH_SRC).read()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{probe}_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (path[:-3] + ".so", nvcc(path, path[:-3] + ".so", "-Xptxas", "-v",
                                               "-I", os.path.dirname(FLASH_SRC)))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        lines = log.splitlines()
        regs[name] = [" ".join(x.split("ptxas info    :")[-1].strip() for x in lines[i + 1:i + 4]
                               if "Used" in x or "spill" in x)
                      for i, line in enumerate(lines)
                      if "Compiling entry" in line and "flash_attention_kernel_tc" in line
                      and mangled in line]
        lib = ctypes.CDLL(so)
        lib.repro_torch_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(width):
        return torch.randn((b, s, h, width), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)

    q, k, v = draw(hd), draw(hd), draw(hd_v)
    want = flash_attention_plain(q, k, v, causal=True, window=window).float()
    tol = 1e-5 + 2.0**-7 * want.abs()

    def run(name):
        out = torch.empty((b, s, h, hd_v), dtype=q.dtype, device="cuda").transpose(1, 2)
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
        err = libs[name].repro_torch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, h, h, s, s, hd,
            hd_v,
            1, -1 if window is None else window, 1.0 / hd**0.5, 1, 1,
            (ctypes.c_longlong * 12)(*strides), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        return out

    names = list(libs)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append(cuda_ms(lambda: run(n)))
    rows = []
    for n in names:
        got = run(n).float()
        rows.append({"variant": n, "ms": times[n], "registers": regs[n],
                     "max_err_over_tol": float(((got - want).abs() / tol).max())})
    return {"probe": probe, "shape": [b, h, h, s, s, hd, hd_v], "window": window,
            "rows": rows}


BWD_SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention_bwd.cu")
BWD_SWAPPED = [(f"fb::tc::launch<{w}, {a}>", f"fb::tc::launch<{w}, {3 - a}>")
               for w, a in (("64, 64", 1), ("128, 128", 1), ("192, 128", 2))]
FLASH_BWD_BUILDS = {"as built": [], "the other warpgroup count": BWD_SWAPPED}
# (B, H, Hkv, S, hd, hd_v, window), causal
FLASH_BWD_SHAPES = {"zamba2-1.2b": (2, 32, 32, 8192, 64, 64, 4096),
                    "qwen2-7b": (1, 28, 4, 4160, 128, 128, None),
                    "mla (192, 128)": (2, 16, 16, 4096, 192, 128, None)}


def flash_bwd_variants() -> dict:
    """B4-bwd by variant and warpgroups a block, with ptxas's report."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    src = open(BWD_SRC).read()
    procs = {}
    for i, (name, edits) in enumerate(FLASH_BWD_BUILDS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"build {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"flash_bwd_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (path[:-3] + ".so", nvcc(path, path[:-3] + ".so", "-Xptxas", "-v",
                                               "-I", os.path.dirname(BWD_SRC)))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        lines = log.splitlines()
        regs[name] = [line.split("'")[1][:60] + ": " + " ".join(
                          x.split("ptxas info    :")[-1].strip() for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x)
                      for i, line in enumerate(lines)
                      if "Compiling entry" in line and "_tc" in line]
        lib = ctypes.CDLL(so)
        lib.repro_torch_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        libs[name] = lib

    def run(lib, variant, t):
        q, k, v, o, lse, dout = t
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty_like(lse)
        tensors = (q, k, v, o, dout, dq, dk, dv)
        strides = [st for x in tensors for st in x.stride()[:3]]
        b, h, s, hd = q.shape
        window = t_window[0]
        err = lib.repro_torch_flash_attention_bwd(
            *(x.data_ptr() for x in tensors), lse.data_ptr(), delta.data_ptr(), b, h,
            k.shape[1], s, s, hd, v.shape[3], 1, -1 if window is None else window,
            1.0 / hd**0.5, 1, variant, (ctypes.c_longlong * 24)(*strides),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")
        return dq, dk, dv

    gen = torch.Generator(device="cuda").manual_seed(0)
    t_window = [None]
    shapes = []
    for label, (b, h, hkv, s, hd, hd_v, window) in FLASH_BWD_SHAPES.items():
        def draw(heads, width):
            return torch.randn((b, s, heads, width), generator=gen,
                               device="cuda").bfloat16().transpose(1, 2)

        q, k, v, dout = draw(h, hd), draw(hkv, hd), draw(hkv, hd_v), draw(h, hd_v)
        o, lse = flash_attention_kernel(q, k, v, causal=True, window=window, return_lse=True)
        t, t_window[0] = (q, k, v, o, lse, dout), window
        built = 2 if hd == 192 else 1
        runs = {"cuda cores": (libs["as built"], 0),
                f"tensor cores ({built} warpgroups, as built)": (libs["as built"], 1),
                f"tensor cores ({3 - built} warpgroups)": (libs["the other warpgroup count"], 1)}
        want = run(*runs[f"tensor cores ({built} warpgroups, as built)"], t)
        names = list(runs)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(cuda_ms(lambda: run(*runs[n], t), reps=2))
        rows = []
        for n in names:
            got = run(*runs[n], t)
            rows.append({"variant": n, "ms": times[n], "max_diff_over_max": max(
                float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip(got, want))})
        shapes.append({"shape": label, "dims": [b, h, hkv, s, s, hd, hd_v], "window": window,
                       "rows": rows})
        del q, k, v, dout, o, lse, want
        torch.cuda.empty_cache()
    return {"probe": "flash-bwd-variants", "registers": regs, "shapes": shapes}


def mamba_passes() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_kernel

    b, h, nc, q, p, n = 4, 64, 32, 256, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    def heads(t, *tail):  # step-major (B, S, H, ...) -> head-major views
        return t.reshape(b, nc, q, h, *tail).movedim(3, 1)

    x = heads(torch.randn((b, nc * q, h, p), generator=gen, device="cuda"), p)
    dt = heads(uniform(0.05, 1.0, (b, nc * q, h)))
    ld = heads(-uniform(0.01, 0.8, (b, nc * q, h)))
    bm = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    cm = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda")
    args = (x, dt, ld, bm, cm, h0)
    reps = 5
    mamba_chunk_scan_kernel(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mamba_chunk_scan_kernel(*args)
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and "mamba_scan_kernel" in ev.key:
            passes[ev.key.split("(")[0].split("::")[-1]] = us / reps / 1e3
    return {"probe": "mamba-passes", "shape": [b, h, nc, q, p, n], "pass_ms": passes,
            "call_ms": cuda_ms(lambda: mamba_chunk_scan_kernel(*args))}


CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
MCOP_VARIANTS = {
    "as built": [],
    "loads paired with their adds": [("conn[k] + (r[k] + g)", "conn[k] + r[k]")],
    "argmax by shuffle butterfly": [(
        "    const int v = warp_argmax(score_key(sc[0]), ix[0]);",
        "    float bs = sc[0];\n    int v = ix[0];\n"
        "    for (int o = 16; o > 0; o >>= 1) {\n"
        "      const float os = __shfl_xor_sync(kFull, bs, o);\n"
        "      const int oi = __shfl_xor_sync(kFull, v, o);\n"
        "      if (os > bs || (os == bs && oi < v)) { bs = os; v = oi; }\n    }")],
}


def mcop_variants() -> dict:
    import numpy as np

    header = open(os.path.join(CSRC, "sw_common.cuh")).read()
    procs = {}
    for i, (name, edits) in enumerate(MCOP_VARIANTS.items()):
        text = header
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        vdir = os.path.join(OUT, f"mcop_{i}")
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "sw_common.cuh"), "w") as f:
            f.write(text)
        src = os.path.join(vdir, "mcop_sw.cu")
        with open(src, "w") as f:
            f.write(open(os.path.join(CSRC, "mcop_sw.cu")).read())
        procs[name] = (src[:-3] + ".so", nvcc(src, src[:-3] + ".so"))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(so)
        lib.repro_torch_sw_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.repro_torch_sw_solve.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        libs[name] = lib

    sys.path.insert(0, ROOT)
    from chip_smoke import random_batch

    rows = []
    for n, k in ((64, 4096), (256, 1024)):
        adj, wl, wc, pin = (torch.from_numpy(a).cuda()
                            for a in random_batch(np.random.default_rng(n), k, n))
        cuts = {name: torch.empty(k, device="cuda") for name in libs}
        masks = {name: torch.empty((k, n), dtype=torch.bool, device="cuda") for name in libs}

        def run(name):
            lib, plan = libs[name], (ctypes.c_int * 5)()
            if lib.repro_torch_sw_plan(n, k, 0, plan):
                raise SystemExit(f"{name}: plan failed")
            cpl, threads, smem, resident, gpb = plan
            err = lib.repro_torch_sw_solve(
                adj.data_ptr(), wl.data_ptr(), wc.data_ptr(), pin.data_ptr(),
                cuts[name].data_ptr(), masks[name].data_ptr(), 0, k, n,
                min(-(-k // gpb), resident), threads, cpl, smem, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        names = list(libs)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: run(name), reps=3))
        for name in names:
            rows.append({"variant": name, "shape": [k, n], "ms": times[name],
                         "same_bits": bool(torch.equal(cuts[name], cuts["as built"])
                                           and torch.equal(masks[name], masks["as built"]))})
    so = os.path.join(OUT, "latency_probe.so")
    proc = nvcc(os.path.join(ROOT, "tools", "torch_latency_probe.cu"), so)
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    lat = ctypes.CDLL(so)
    lat.latency_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    iters, latency = 4096, {}
    for which, name in enumerate(("redux_max", "redux_min", "shfl", "ballot", "lds", "imad")):
        for _ in range(2):  # the first run warms up
            if lat.latency_probe(which, iters, cycles.data_ptr(), sink.data_ptr()):
                raise SystemExit("latency probe launch failed")
        torch.cuda.synchronize()
        latency[name] = int(cycles.item()) / iters
    return {"probe": "mcop-variants", "rows": rows, "cycles_per_dependent_op": latency}


DECODE_SPLITS = (9, 10, 12, 14, 16, 24, 32)  # blocks a (batch, kv head) pair: 32 pairs, 9 at least


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn``: ``reps`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def decode_splits() -> dict:
    from repro_torch.kernels import decode_attention as b6
    from repro_torch.models.attention import _decode_local, _slot_positions

    b, h, hkv, s, pos, hd, layers = 8, 28, 4, 8201, 8192, 128, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    kc, vc = (torch.randn((layers, b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
    qp = torch.tensor([pos], device="cuda")
    scale = hd ** -0.5
    want = _decode_local([q], [kc[0]], vc[0], None, j0=0, q_pos=qp, scale=scale,
                         k_pos=_slot_positions, window=None, score_groups=(),
                         slot_groups=()).float()
    auto = b6.decode_splits(b * hkv, s, b6._resident(q.device, hd, h // hkv))
    nbytes = (2 * b * hkv * (pos + 1) * hd + 2 * b * h * hd) * 2
    chosen, turn, times, errs = b6.decode_splits, [0], {}, {}

    def call():
        turn[0] += 1
        j = turn[0] % layers
        return b6.decode_attention_kernel(q, kc[j], vc[j], qp, scale=scale)

    try:
        for n in DECODE_SPLITS + DECODE_SPLITS[::-1]:
            b6.decode_splits = lambda *_, n=n: n
            got = b6.decode_attention_kernel(q, kc[0], vc[0], qp, scale=scale).float()
            errs[n] = float((got - want).abs().max())
            times.setdefault(n, []).append(graph_ms(call, 8 * layers))
    finally:
        b6.decode_splits = chosen
    return {"probe": "decode-splits", "auto_splits": auto,
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "rows": [{"splits": n, "ms": times[n], "max_abs_err": errs[n]}
                     for n in DECODE_SPLITS]}


DECODE_VARIANTS = {
    "as built": [],
    "no score products": [("for (int d = 0; d < 8; ++d) a = __fmaf_rn(qf[d], kf[i][d], a);", ";")],
    "no P V products": [
        ("for (int d = 0; d < 8; ++d) o[r][d] = __fmaf_rn(pv[i], vf[i][d], o[r][d]);", ";")],
    "no tile loads": [
        ("if (s < units) load_unit(s, s);", ""),
        ("if (u + kStages - 1 < units) load_unit(u + kStages - 1, (u + kStages - 1) % kStages);",
         "")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "3 stages, 24 tiles a block (2 blocks an SM)": [
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
        ("constexpr int kMaxTiles = 16;", "constexpr int kMaxTiles = 24;"),
        ("__launch_bounds__(kThreads, 3)\ndecode_attention_kernel(",
         "__launch_bounds__(kThreads)\ndecode_attention_kernel(")],
}


DECODE_CHILD = """
import json, sys, torch
from repro_torch.kernels import decode_attention as b6
b, h, hkv, s, pos, hd, layers = 8, 28, 4, 8201, 8192, 128, 4
gen = torch.Generator(device="cuda").manual_seed(0)
kc, vc = (torch.randn((layers, b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
          for _ in range(2))
q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
qp = torch.tensor([pos], device="cuda")
torch.save(b6.decode_attention_kernel(q, kc[0], vc[0], qp, scale=hd ** -0.5).cpu(), sys.argv[1])
turn = [0]
def call():
    turn[0] += 1
    j = turn[0] % layers
    return b6.decode_attention_kernel(q, kc[j], vc[j], qp, scale=hd ** -0.5)
sys.path.insert(0, sys.argv[2])
from torch_kernel_probe import graph_ms
print(json.dumps({"ms": [graph_ms(call, 8 * layers) for _ in range(3)],
                  "splits": b6.decode_splits(b * hkv, s, b6._resident(q.device, hd, h // hkv))}))
"""


def decode_variants() -> dict:
    """Each variant in a process of its own, on a copy of ``src/`` with the
    edit applied, through the wrapper (its build included)."""
    import shutil

    src_tree = os.path.join(ROOT, "src")
    rows, outs = [], []
    for i, (name, edits) in enumerate(DECODE_VARIANTS.items()):
        tree = os.path.join(OUT, f"decode_variant_{i}")
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(src_tree, os.path.join(tree, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(tree, "src", "repro_torch", "kernels", "csrc", "decode_attention.cu")
        text = open(path).read()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(tree, "out.pt")
        proc = subprocess.run([sys.executable, "-c", DECODE_CHILD, out,
                               os.path.dirname(os.path.abspath(__file__))],
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": os.path.join(tree, "src")})
        if proc.returncode:
            rows.append({"variant": name, "error": proc.stderr[-2000:]})
            continue
        rows.append({"variant": name, **json.loads(proc.stdout.strip().splitlines()[-1])})
        outs.append((len(rows) - 1, torch.load(out)))
    want = outs[0][1].float() if outs and outs[0][0] == 0 else None
    for i, got in outs:
        if want is not None:
            rows[i]["max_abs_diff"] = float((got.float() - want).abs().max())
    return {"probe": "decode-variants", "rows": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probes", nargs="+", choices=(
        "wgmma-layout", "flash-variants", "flash-mla-variants", "flash-bwd-variants",
        "mamba-passes", "mcop-variants", "decode-splits", "decode-variants"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    print(gpu_line(), flush=True)
    run = {"wgmma-layout": wgmma_layout, "flash-variants": flash_variants,
           "flash-mla-variants": lambda: flash_variants("flash-mla-variants"),
           "flash-bwd-variants": flash_bwd_variants,
           "mamba-passes": mamba_passes, "mcop-variants": mcop_variants,
           "decode-splits": decode_splits, "decode-variants": decode_variants}
    for name in args.probes:
        print(json.dumps(run[name]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
