"""Shared by the ``<kernel>_roofline_pct`` readers: a step kernel's least
time by the frozen yardstick at the cell's chain rows and the card's highest
SM clock, over the kernel's mean device time by name in the trace, in %."""
from bench_cuda.yardstick import bound_ms


def share(ctx, kernel_name, work):
    ops = ctx.trace.kernels(kernel_name)
    if not ops or not ctx.sm_clock_hz:
        return None
    net = ctx.config["net"]
    mm = net.get("sampling_matmul_dtype", net.get("sampling_dtype", "bfloat16"))
    mean_ms = sum(o.dur for o in ops) / len(ops) * 1e-3
    least_ms, _ = bound_ms(*work(ctx.info["chain_rows"], net["dataset_nf"]), mm, ctx.sm_clock_hz)
    return 100.0 * least_ms / mean_ms
