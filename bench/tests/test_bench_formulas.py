"""The yardstick's arithmetic: the frozen kernel formulas reproduce the
bounds of PERF.md's kernel table, the window counts all its work over all
its time, and the trace reduction counts overlapping work once."""

import pytest

from bench.harness import trace
from bench.harness.cell import load_module
from bench.harness.peaks import FLOP_PER_S, HBM_BYTES_PER_S
from bench.harness.window import Window


def bound_ms(kernel: str, shape: dict) -> tuple[float, str]:
    mod = load_module("kernels", kernel)
    by = mod.nbytes(shape) / HBM_BYTES_PER_S * 1e3
    op = mod.ops(shape) / FLOP_PER_S[mod.UNIT] * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


B4 = dict(b=4, h=32, hkv=32, sq=8192, sk=8192, hd=64, hd_v=64, causal=True, window=4096,
          elem=2)
B5 = dict(b=4, h=64, nc=32, q=256, p=64, n=64)


@pytest.mark.parametrize("kernel,shape,ms,by", [
    ("b4", B4, 0.834, "operations"),                 # bf16 4 x 32 x 8192 x 64, window 4096
    ("b4_bwd", dict(B4, b=2), 1.042, "operations"),  # bf16 2 x 32 x 8192 x 64
    ("b5", B5, 0.333, "bytes"),                      # f32 4 x 64 x 32 x 256 x 64, N 64
    ("b5_bwd", dict(B5, b=2), 0.2267, "operations"),  # TF32 rate
])
def test_kernel_bounds_are_perf_md_s(kernel, shape, ms, by):
    got, why = bound_ms(kernel, shape)
    assert why == by
    assert got == pytest.approx(ms, rel=2e-3)


@pytest.mark.parametrize("kernel,name,hit", [
    ("b4", "void repro_torch::tc::flash_attention_kernel_tc<64, 2>(...)", True),
    ("b4", "repro_torch_bwd::flash_attention_bwd_dq_kernel<float>", False),
    ("b4_bwd", "void repro_torch_bwd::tc::flash_attention_bwd_dkdv_tc<64, 64, 1>(...)", True),
    ("b5", "repro_torch_mamba::mamba_scan_kernel_states(float const*)", True),
    ("b5", "repro_torch_mamba_bwd::mamba_scan_bwd_kernel_main(float const*)", False),
    ("b5_bwd", "repro_torch_mamba_bwd::mamba_scan_bwd_kernel_main(float const*)", True),
])
def test_kernel_names_fall_to_their_family(kernel, name, hit):
    assert load_module("kernels", kernel).matches(name) is hit


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run_units(durations, stall_after=None, stall=0.0, work=10.0, seconds=5.0):
    clock = FakeClock()
    win = Window(seconds, clock=clock)
    win.start()
    for i, d in enumerate(durations):
        t0 = win.unit_start()
        clock.t += d
        if win.unit_end(t0, work):
            break
        if i == stall_after:
            clock.t += stall
    return win


def test_rate_counts_the_whole_window():
    win = run_units([1.0] * 10)
    assert win.elapsed == pytest.approx(5.0)        # closes at the first unit ending at 5 s
    assert win.rate() == pytest.approx(50.0 / 5.0)
    assert len(win.units) == 5


def test_a_stall_lowers_the_rate():
    steady = run_units([1.0] * 10).rate()
    stalled = run_units([1.0] * 10, stall_after=1, stall=2.0)
    assert stalled.rate() < steady
    assert stalled.rate() == pytest.approx(10.0 * len(stalled.units) / stalled.elapsed)


def test_window_waits_for_an_idle_system():
    clock = FakeClock()
    win = Window(1.0, clock=clock)
    win.start()
    closed = []
    for busy in (True, True, False):
        t0 = win.unit_start()
        clock.t += 1.0
        closed.append(win.unit_end(t0, 1.0, idle=not busy))
    assert closed == [False, False, True] and win.elapsed == pytest.approx(3.0)


def ev(name, kind, a, b):
    return trace.Event(name, kind, a, b)


def test_trace_counts_overlapping_work_once():
    events = [ev(trace.WINDOW_SPAN, "host", 0.0, 10.0), ev("host.step", "host", 0.0, 10.0),
              ev("aten::mm", "host", 4.5, 6.0), ev(trace.WINDOW_SPAN, "other", 0.0, 10.0),
              ev("k1", "kernel", 1.0, 3.0), ev("k2", "kernel", 2.0, 4.0),
              ev("Memcpy HtoD", "copy", 5.0, 5.5), ev("Command Buffer Full", "other", 6.0, 9.0)]
    s = trace.reduce(events, *trace.window_bounds(events))
    assert s.window_s == 10.0 and s.busy_s == pytest.approx(3.5)
    assert s.idle_share == pytest.approx(0.65)
    assert s.kernel_s == {"k1": 2.0, "k2": 2.0} and s.copy_s == pytest.approx(0.5)
    gaps = dict(map(tuple, s.top_gaps()))
    assert gaps["host.step"] == pytest.approx(1.0 + 4.5)   # [0,1] and [5.5,10]
    assert gaps["aten::mm"] == pytest.approx(1.0)          # [4,5], inside aten::mm


def test_matrix_products_are_recognised():
    assert trace.is_matmul("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT")
    assert trace.is_matmul("sm90_xmma_gemm_bf16bf16_bf16f32")
    assert not trace.is_matmul("void at::native::vectorized_elementwise_kernel<4>")
