"""The frozen yardstick equals the port's ``ops/kernels/roofline.py`` at the
cells' shapes (K1 at 4.8 M and 160,000 rows, and at the train step's
12,800 rows of two features; K3 at 3.6 M rows), and the FLOP counts hold
together."""
import pytest

from bench_cuda import spec, yardstick as Y

CLOCK = 1980e6  # the H100 SXM's highest SM clock


@pytest.mark.parametrize("kernel,rows,F", [("k1", 4_800_000, 1), ("k1", 160_000, 1),
                                           ("k1", 12_800, 2), ("k3", 3_600_000, 1)])
@pytest.mark.parametrize("mm", ["bfloat16", "float32"])
def test_copy_equals_the_port(kernel, rows, F, mm):
    from upgdm_tpu_torch.ops.kernels import roofline as R

    mine = getattr(Y, f"{kernel}_work")(rows, F)
    theirs = getattr(R, f"{kernel}_work")(rows, F)
    assert mine == theirs
    assert Y.bound_ms(*mine, mm, CLOCK) == R.bound_ms(*theirs, mm, CLOCK)
    assert (Y.PEAK_FLOPS, Y.PEAK_BYTES, Y.SFU_PER_CLOCK_PER_SM, Y.SM_COUNT) == \
        (R.PEAK_FLOPS, R.PEAK_BYTES, R.SFU_PER_CLOCK_PER_SM, R.SM_COUNT)


def test_k1_bound_at_the_sweep_shape():
    ms, by = Y.bound_ms(*Y.k1_work(4_800_000), "bfloat16", CLOCK)
    assert by == "special_functions" and ms == pytest.approx(1.181, abs=1e-3)


def test_chunk_flops_hold_the_chain():
    net = spec.find_cell("nsdiff_sweep").config["net"]
    chain = 20 * Y.k1_work(100 * 480 * 100)[0]
    total = Y.chunk_flops("nsdiff", net, 480, 100)
    assert chain < total < 1.5 * chain
    tm = spec.find_cell("tmdm_sweep").config["net"]
    steps = tm["diffusion_steps"]
    assert Y.chunk_flops("tmdm", tm, 240, 100) > steps * Y.k3_work(100 * 240 * 150)[0]
    tr = spec.find_cell("nsdiff_train").config["net"]
    assert Y.train_step_flops("nsdiff", tr, 64) == pytest.approx(
        3 * (Y.ns_transformer_flops(tr, 64) + Y.sigma_head_flops(tr, 64)
             + Y.k1_work(64 * tr["pred_len"], tr["dataset_nf"])[0]))
