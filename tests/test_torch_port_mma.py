"""Host side of the tensor-core step kernels (K1, K3) and their plain twins on
the inputs the CUDA kernels are judged on.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to the
twins there). Here, on the CPU: the host-side weight layout the kernels read, the three-term
bound, and the twins against the TPU kernels in Pallas interpret mode over
ragged row counts, feature widths and edge-case rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.ops.pallas.fused_denoiser import (
    fused_denoiser_rows as j_k1,
    fused_tmdm_rows as j_k3,
)
from upgdm_tpu_torch.ops.kernels import roofline
from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
    TILED_SHAPE,
    fused_denoiser_rows,
    kernel_weights,
    step_weights,
    tile_b_operand,
    untile_b_operand,
)
from upgdm_tpu_torch.ops.kernels.fused_tmdm import fused_tmdm_rows
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HID = 128


# ---------------------------------------------------------------- weight layout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_b_operand_round_trips_and_places_elements(dtype):
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.normal(size=(HID, HID)).astype(np.float32)).to(dtype)
    T = tile_b_operand(W)
    assert tuple(T.shape) == TILED_SHAPE and T.dtype == dtype and T.is_contiguous()
    assert torch.equal(untile_b_operand(T), W)
    # K-major rows of 64 k with the 128-byte swizzle: element (k, n) of the
    # flax matrix sits at this offset of the buffer the kernel copies
    flat = T.reshape(-1)
    for k, n in ((0, 0), (5, 3), (8, 1), (64, 1), (77, 9), (127, 127)):
        off = (k // 64) * 8192 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
        assert flat[off] == W[k, n], (k, n)
    with pytest.raises(ValueError):
        tile_b_operand(W[:64])
    with pytest.raises(ValueError):
        untile_b_operand(W)


def _weights(n_heads, in_dim, F_, rng, scale=0.1):
    """(W1, b1, W2, b2, W3, b3, head, bias, ...) float32, flax layout."""
    out = []
    for shape in ((in_dim, HID), (HID, HID), (HID, HID)) + ((HID, F_),) * n_heads:
        out.append(rng.normal(size=shape).astype(np.float32) * scale)
        out.append(rng.normal(size=shape[1]).astype(np.float32) * scale)
    return tuple(out)


@pytest.mark.parametrize("mm", [torch.float32, torch.bfloat16])
def test_step_weights_lays_out_once(mm):
    rng = np.random.default_rng(1)
    w = tuple(torch.from_numpy(a) for a in _weights(2, 3, 1, rng))
    sw = step_weights(w, mm)
    plain = kernel_weights(w, mm)
    if mm == torch.bfloat16:  # W2 and W3 tiled, the rest as kernel_weights leaves it
        assert tuple(sw[2].shape) == tuple(sw[4].shape) == TILED_SHAPE
        assert torch.equal(untile_b_operand(sw[2]), plain[2])
        assert torch.equal(untile_b_operand(sw[4]), plain[4])
    else:  # float32 keeps the flax layout
        assert torch.equal(sw[2], plain[2]) and torch.equal(sw[4], plain[4])
    for i in (0, 1, 3, 5, 6, 7, 8, 9):
        assert torch.equal(sw[i], plain[i])
    again = step_weights(sw, mm)  # weights already laid out come back as they are
    assert all(a is b for a, b in zip(again, sw))


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_laid_out_weights_hold_the_twins_operands(kernel):
    """What step_weights hands the card, untiled again, gives the twin the
    same outputs bit for bit as the flax-layout tuple: the layout moves
    elements and rounds them once, as the twin's own bf16 rounding does."""
    rng = np.random.default_rng(2)
    n_heads, cols, rows = (2, 3, fused_denoiser_rows) if kernel == "k1" else (1, 2, fused_tmdm_rows)
    w = tuple(torch.from_numpy(a) for a in _weights(n_heads, cols, 1, rng))
    g = tuple(torch.from_numpy(rng.uniform(0, 1, HID).astype(np.float32)) for _ in range(3))
    x = torch.from_numpy(rng.normal(size=(9, cols)).astype(np.float32))
    want = rows(x, g, w, matmul_dtype="bfloat16")
    sw = list(step_weights(w, torch.bfloat16))
    sw[2], sw[4] = untile_b_operand(sw[2]), untile_b_operand(sw[4])
    got = rows(x, g, tuple(t.float() for t in sw), matmul_dtype="bfloat16")
    for a, b in zip(got if kernel == "k1" else (got,), want if kernel == "k1" else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rows.launches == 0  # a CPU tensor never counts as a launch


# ---------------------------------------------------------------- the bound
def test_three_term_bound_on_hand_worked_numbers():
    # 989e12 FLOP at the bf16 peak = 1 s; 3.35e12 bytes = 1 s;
    # 16 x 132 x 1e9 special-function results at 1 GHz = 1 s
    sfu_per_s = 16 * 132 * 1e9
    assert roofline.bound_ms(989e12, 0, 0, "bfloat16", 1e9) == (1000.0, "operations")
    assert roofline.bound_ms(67e12, 3.35e12 * 2, 0, "float32", 1e9) == (2000.0, "bytes")
    ms, by = roofline.bound_ms(989e12, 3.35e12, sfu_per_s * 3, "bfloat16", 1e9)
    assert by == "special_functions" and ms == pytest.approx(3000.0)
    # twice the clock halves only the special-function term
    ms, by = roofline.bound_ms(0, 0, sfu_per_s * 3, "bfloat16", 2e9)
    assert by == "special_functions" and ms == pytest.approx(1500.0)


def test_kernel_work_counts():
    # K1, one row, F = 1: 2 x (3 x 128 + 2 x 128^2 + 2 x 128) FLOP, 5 floats
    # moved, 4 x 128 + 1 softplus of two results each and three rsqrt
    assert roofline.k1_work(1) == (2.0 * (384 + 32768 + 256), 20.0, 2 * 513 + 3)
    # K3: 2 x (2 x 128 + 2 x 128^2 + 128) FLOP, 3 floats, 3 x 128 softplus
    assert roofline.k3_work(1) == (2.0 * (256 + 32768 + 128), 12.0, 768.0)
    # K2 is T steps of K1's trunk and heads, plus seven special functions a
    # (row, step, feature) for the noise draw and the posterior, on rows that
    # are read and written once
    f1, _, s1 = roofline.k1_work(10)
    f2, b2, s2 = roofline.k2_work(10, T=20)
    assert s2 == 20 * (s1 + 7 * 10) and b2 == 4.0 * 10 * 3
    assert f2 == 2.0 * 10 * (256 + 20 * (128 + 32768 + 256))
    # at the sweeps' sizes the bf16 arms are bound by the special functions,
    # the float32 arms by operations
    for work in (roofline.k1_work(4_800_000), roofline.k3_work(3_600_000)):
        assert roofline.bound_ms(*work, "bfloat16", 1.98e9)[1] == "special_functions"
        assert roofline.bound_ms(*work, "float32", 1.98e9)[1] == "operations"


# ---------------------------------------------------------------- twins vs TPU kernels
def _case(kind, n_heads, cols, F_, seed, bias=14.0):
    """Numpy-seeded (gammas, weights) for one kind of row. ``random``: gates
    U(0, 1) as the modules initialise them. ``below`` / ``above``: every
    pre-activation of the three hidden layers below -8 / above +8 (biases
    -bias / +bias, gates in [0.9, 1.1], the three trunk matrices small so the
    products stay within ~3.5 of zero). The heads keep their scale, but for
    K3 ``above``: the bar is absolute and, without a norm, an activation in
    [8, 16) has a bf16 step of 2^-4, which one head weight of 0.3 would turn
    into 2e-2; there the head is scaled by 0.1."""
    rng = np.random.default_rng(seed)
    w = list(_weights(n_heads, cols, F_, rng))
    if kind == "random":
        return tuple(rng.uniform(0, 1, HID).astype(np.float32) for _ in range(3)), tuple(w)
    for i in (0, 2, 4):
        w[i] = w[i] * np.float32(0.1)
    for i in (1, 3, 5):
        w[i] = np.full(HID, -bias if kind == "below" else bias, np.float32)
    if kind == "above" and n_heads == 1:
        w[6] = w[6] * np.float32(0.1)
    g = tuple(rng.uniform(0.9, 1.1, HID).astype(np.float32) for _ in range(3))
    return g, tuple(w)


def _pre_activation_range(x, g, w):
    """(min, max) over the three hidden layers' pre-activations, float64, K3 form."""
    h, lo, hi = x.astype(np.float64), np.inf, -np.inf
    for i in range(3):
        pre = g[i] * (h @ w[2 * i] + w[2 * i + 1])
        lo, hi = min(lo, pre.min()), max(hi, pre.max())
        h = np.logaddexp(pre, 0.0)
    return lo, hi


# every M in {1, 63, 65} and F in {1, 2, 4} with every kind of row
COMBOS = [("below", 1, 1), ("below", 63, 2), ("below", 65, 4),
          ("above", 1, 2), ("above", 63, 4), ("above", 65, 1),
          ("random", 1, 4), ("random", 63, 1), ("random", 65, 2)]
# bars: 2e-5 in float32 (the JAX package's own); 2e-3 in bf16, where both
# sides round the same operands and sum in another order, so one bf16
# rounding of one of 128 terms may fall the other way
BARS = [("float32", 2e-5), ("bfloat16", 2e-3)]


@pytest.mark.parametrize("mm,atol", BARS)
@pytest.mark.parametrize("kind,M,F_", COMBOS)
def test_k1_twin_matches_pallas_kernel_on_edge_rows(kind, M, F_, mm, atol):
    g, w = _case(kind, 2, 3 * F_, F_, seed=M + F_)
    rng = np.random.default_rng(M)
    x = np.concatenate([rng.normal(size=(M, 2 * F_)),
                        rng.uniform(0.05, 1.0, size=(M, F_))], axis=1).astype(np.float32)
    want = j_k1(jnp.asarray(x), tuple(map(jnp.asarray, g)), tuple(map(jnp.asarray, w)),
                interpret=True, matmul_dtype=mm, tile_m=64)
    got = fused_denoiser_rows(torch.from_numpy(x), tuple(map(torch.from_numpy, g)),
                              tuple(map(torch.from_numpy, w)), matmul_dtype=mm)
    for a, b in zip(got, want):
        assert a.shape == (M, F_) and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("mm,atol", BARS)
@pytest.mark.parametrize("kind,M,F_", COMBOS)
def test_k3_twin_matches_pallas_kernel_on_edge_rows(kind, M, F_, mm, atol):
    g, w = _case(kind, 1, 2 * F_, F_, seed=M + F_)
    x = np.random.default_rng(M).normal(size=(M, 2 * F_)).astype(np.float32)
    lo, hi = _pre_activation_range(x, g, w)
    assert kind == "random" or (hi < -8 if kind == "below" else lo > 8)
    want = j_k3(jnp.asarray(x), tuple(map(jnp.asarray, g)), tuple(map(jnp.asarray, w)),
                interpret=True, matmul_dtype=mm, tile_m=64)
    got = fused_tmdm_rows(torch.from_numpy(x), tuple(map(torch.from_numpy, g)),
                          tuple(map(torch.from_numpy, w)), matmul_dtype=mm)
    assert got.shape == (M, F_) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("bias", [14.0, 20.0])
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_twins_keep_relative_accuracy_far_below_zero(kernel, bias):
    """Rows whose softplus is ~8e-7 (bias -14) or ~2e-9 (-20), read through an
    all-ones head with no bias: eps is the sum of the row's 128 activations
    as the product reads them (K1: of the normalised row), so a softplus that
    lost relative accuracy there would show. bf16 arm, rtol 1e-3: a bf16
    rounding of one of 128 terms that falls the other way is 2^-8 / 128 =
    3e-5. ``chip_smoke.py`` holds the CUDA kernels to the same bar."""
    n_heads, cols, rows, j_rows = ((2, 3, fused_denoiser_rows, j_k1) if kernel == "k1"
                                   else (1, 2, fused_tmdm_rows, j_k3))
    g, w = _case("below", n_heads, cols, 1, seed=7, bias=bias)
    w = w[:6] + (np.ones_like(w[6]), np.zeros_like(w[7])) + w[8:]
    x = np.random.default_rng(8).normal(size=(65, cols)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) + 0.05
    want = j_rows(jnp.asarray(x), tuple(map(jnp.asarray, g)), tuple(map(jnp.asarray, w)),
                  interpret=True, matmul_dtype="bfloat16", tile_m=64)
    got = rows(torch.from_numpy(x), tuple(map(torch.from_numpy, g)),
               tuple(map(torch.from_numpy, w)), matmul_dtype="bfloat16")
    if kernel == "k1":
        got, want = got[0], want[0]
    assert np.all(np.asarray(want) > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=0)
