"""The trace reader on a synthetic Chrome-trace export: busy time is the
union of device intervals inside the window, kernels go to the innermost
benchmark span open at their launch, and idle gaps are named by it."""
from pytest import approx

from bench_cuda.devtrace import WINDOW_SPAN, _parse


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", WINDOW_SPAN, 0, 1000),
    _x("user_annotation", "sweep.call", 0, 900),
    _x("user_annotation", "sweep.chain", 100, 300),
    _x("cpu_op", "aten::copy_", 600, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 5, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=2),
    _x("kernel", "gemm", 60, 100, correlation=1),
    _x("kernel", "fused_denoiser_mma_kernel<1, false>", 140, 200, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoH", 700, 100, correlation=3),
]


def test_busy_spans_and_gaps():
    t = _parse(EVENTS, {"sweep.call", "sweep.chain"})
    assert t.window_s == approx(1000e-6)
    assert t.busy_s == approx((280 + 100) * 1e-6)  # [60, 340] and [700, 800]
    assert t.span_device_s("sweep.chain") == approx(200e-6)
    assert t.span_device_s("sweep.call") == approx(100e-6)
    assert t.span_count("sweep.chain") == 1
    assert [o.name for o in t.kernels("fused_denoiser")] == ["fused_denoiser_mma_kernel<1, false>"]
    gaps = t.idle_gaps(3)
    # 340-700 inside the chain span, 800-1000 and 0-60 inside the call
    assert gaps == [["sweep.chain", approx(360e-6)], ["sweep.call", approx(200e-6)],
                    ["sweep.call", approx(60e-6)]]
    assert t.top_ops(1)[0][0].startswith("fused_denoiser")
