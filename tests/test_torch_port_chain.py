"""Host side of the tensor-core chain kernel (K2) and its plain twin.

The CUDA kernel runs only on the card (``test_torch_port_card_kernels.py`` holds it to the twin
there). Here, on the CPU: the gate table and weight layout the kernel reads,
the plain Philox twin of its noise stream, the twin against the TPU kernel in
Pallas interpret mode over feature widths, ragged row counts, step counts and
edge-case rows, the first layer redone every step against the hoisted form,
and the kernel's work count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.ops.pallas.chain_resident import (
    _schedule_table as j_schedule_table,
    fused_chain_rows as j_chain_rows,
)
from upgdm_tpu.ops.schedules import NsDiffSchedule as JSchedule
from upgdm_tpu_torch.ops.kernels import roofline
from upgdm_tpu_torch.ops.kernels.chain_resident import (
    chain_operands,
    fused_chain_rows,
    fused_chain_rows_reference,
    gate_table,
    philox4x32_10,
    philox_normal_reference,
    schedule_table,
)
from upgdm_tpu_torch.ops.kernels.fused_denoiser import TILED_SHAPE, _dot, untile_b_operand
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HID = 128


def _weights(F_, rng, scale=0.1):
    """(W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs) float32, flax layout."""
    out = []
    for shape in ((3 * F_, HID), (HID, HID), (HID, HID), (HID, F_), (HID, F_)):
        out.append(rng.normal(size=shape).astype(np.float32) * scale)
        out.append(rng.normal(size=shape[1]).astype(np.float32) * scale)
    return tuple(out)


def _tables(T, rng):
    """(E1, E2, E3) [T, 128], U(0, 1) as the modules initialise them."""
    return tuple(rng.uniform(0, 1, size=(T, HID)).astype(np.float32) for _ in range(3))


# ---------------------------------------------------------------- gate table
@pytest.mark.parametrize("T", [2, 20])
def test_gate_table_holds_gate_pairs_element_by_element(T):
    """Entry (t, layer, p) is csrc/trunk_mma.cuh::gate_pair of that step's
    gates and the layer's bias: (g[2p], g[2p] b[2p], g[2p+1], g[2p+1] b[2p+1]),
    each product one float32 multiply."""
    rng = np.random.default_rng(T)
    E = _tables(T, rng)
    b = tuple(rng.normal(size=HID).astype(np.float32) for _ in range(3))
    tab = gate_table(tuple(map(torch.from_numpy, E)), *map(torch.from_numpy, b))
    assert tab.shape == (T, 3, 64, 4) and tab.dtype == torch.float32 and tab.is_contiguous()
    flat = tab.numpy().reshape(-1)  # as the kernel indexes it: float4 (t * 3 + layer) * 64 + p
    for t in range(T):
        for layer in range(3):
            g, bias = E[layer][t], b[layer]
            for p in range(64):
                at = ((t * 3 + layer) * 64 + p) * 4
                want = (g[2 * p], g[2 * p] * bias[2 * p], g[2 * p + 1],
                        g[2 * p + 1] * bias[2 * p + 1])
                assert tuple(flat[at:at + 4]) == want, (t, layer, p)


@pytest.mark.parametrize("mm", [torch.float32, torch.bfloat16])
def test_chain_operands_lays_out_once(mm):
    rng = np.random.default_rng(3)
    w = tuple(map(torch.from_numpy, _weights(2, rng)))
    E = tuple(map(torch.from_numpy, _tables(5, rng)))
    gates, kw = chain_operands(E, w, mm)
    if mm == torch.bfloat16:  # one table of pairs, W2 and W3 tiled
        assert torch.equal(gates, gate_table(E, w[1], w[3], w[5]))
        assert tuple(kw[2].shape) == tuple(kw[4].shape) == TILED_SHAPE
    else:  # float32 keeps the tables and the flax layout
        assert all(a is b for a, b in zip(gates, E))
        assert tuple(kw[2].shape) == (HID, HID)
    gates2, kw2 = chain_operands(gates, kw, mm)  # prepared operands come back as they are
    assert gates2 is gates and all(a is b for a, b in zip(kw2, kw))


def test_laid_out_operands_hold_the_twins_operands():
    """What chain_operands hands the card, taken apart again, gives the twin
    the same chain bit for bit: the layout moves elements and rounds the
    matrices to bf16 once, as the twin's own rounding does, and the gate
    table keeps every gate."""
    T, F_ = 4, 2
    rng = np.random.default_rng(4)
    w = tuple(map(torch.from_numpy, _weights(F_, rng)))
    E = tuple(map(torch.from_numpy, _tables(T, rng)))
    tab = torch.from_numpy(schedule_table(NsDiffSchedule.create("linear", T, 1e-4, 2e-2)))
    y0 = torch.from_numpy(rng.normal(size=(9, F_)).astype(np.float32))
    gx = torch.from_numpy(rng.uniform(0.05, 1, size=(9, F_)).astype(np.float32))
    want = fused_chain_rows_reference(y0, gx, tab, E, w, T, noise_mode="zero")
    gates, kw = chain_operands(E, w, torch.bfloat16)
    kw = list(kw)
    kw[2], kw[4] = untile_b_operand(kw[2]), untile_b_operand(kw[4])
    E_back = tuple(gates[:, layer, :, 0::2].reshape(T, HID) for layer in range(3))
    got = fused_chain_rows_reference(y0, gx, tab, E_back, tuple(t.float() for t in kw), T,
                                     noise_mode="zero")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------- Philox twin
def _np_philox4x32_10(counter, key):
    """Philox4x32-10 written out again with numpy's 64-bit products."""
    c = [np.uint64(x) for x in counter]
    k = [np.uint64(x) for x in key]
    mask, sh = np.uint64(0xFFFFFFFF), np.uint64(32)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> sh) ^ c[1] ^ k[0], p1 & mask, (p0 >> sh) ^ c[3] ^ k[1], p0 & mask]
        k = [(k[0] + np.uint64(0x9E3779B9)) & mask, (k[1] + np.uint64(0xBB67AE85)) & mask]
    return tuple(int(x) for x in c)


# Random123's known answers for philox4x32, 10 rounds
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_round_matches_known_answers(counter, key, want):
    one = lambda v: torch.tensor([v], dtype=torch.int64)
    got = philox4x32_10(tuple(map(one, counter)), tuple(map(one, key)))
    assert tuple(int(w) for w in got) == want
    assert _np_philox4x32_10(counter, key) == want


def test_philox_round_matches_numpy_write_up_on_random_words():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(64, 6), dtype=np.uint64)
    cols = tuple(torch.from_numpy(words[:, i].astype(np.int64)) for i in range(6))
    got = torch.stack(philox4x32_10(cols[:4], cols[4:]), dim=1).numpy()
    for row, out in zip(words, got):
        assert tuple(int(x) for x in out) == _np_philox4x32_10(row[:4], row[4:])


def _uniforms(seed, rows, step, pair):
    """(u1, u2) of the Box-Muller transform, from the numpy write-up."""
    u1, u2 = [], []
    for r in rows:
        b = _np_philox4x32_10((r & 0xFFFFFFFF, r >> 32, step, pair),
                              (seed & 0xFFFFFFFF, seed >> 32))
        u1.append(((b[0] >> 8) + 1) / 16777216.0)
        u2.append((b[1] >> 8) / 16777216.0)
    return np.array(u1), np.array(u2)


def test_philox_normals_are_box_muller_of_the_words():
    """Counter (row low, row high, step, f // 2), key (seed low, seed high);
    u1 in (0, 1]; cosine for even f, sine for odd f."""
    seed, step = 0x123456789ABCDEF, 7
    rows = [0, 1, 63, 2**32 + 5, 2**40]
    got = philox_normal_reference(seed, torch.tensor(rows), step, 3).numpy()
    assert got.shape == (5, 3) and got.dtype == np.float32
    for pair, cols in ((0, (0, 1)), (1, (2,))):
        u1, u2 = _uniforms(seed, rows, step, pair)
        assert np.all(u1 > 0) and np.all(u1 <= 1)
        rad = np.sqrt(-2.0 * np.log(u1))
        want = [rad * np.cos(2 * np.pi * u2), rad * np.sin(2 * np.pi * u2)]
        for c, w in zip(cols, want):
            np.testing.assert_allclose(got[:, c], w.astype(np.float32), rtol=1e-6, atol=1e-7)


def test_philox_u1_never_reaches_zero():
    """u1 = ((word >> 8) + 1) / 2^24 lies in (0, 1], so its log is finite: over
    1e5 draws every normal is finite and below sqrt(-2 log 2^-24) = 5.77."""
    n = philox_normal_reference(11, torch.arange(100_000), 0, 1)
    assert torch.isfinite(n).all() and n.abs().max() <= np.sqrt(-2 * np.log(2.0**-24))


@pytest.mark.parametrize("F_", [1, 2])
def test_philox_normals_have_unit_moments(F_):
    """1e5 draws a feature: mean within 4 / sqrt(n), variance within 4 sqrt(2 / n)."""
    n_rows = 100_000
    n = philox_normal_reference(7, torch.arange(n_rows), 3, F_).double()
    assert (n.mean(0).abs() < 4 / np.sqrt(n_rows)).all()
    assert ((n.var(0) - 1).abs() < 4 * np.sqrt(2 / n_rows)).all()
    if F_ == 2:  # cosine and sine of one angle: uncorrelated
        assert abs(float((n[:, 0] * n[:, 1]).mean())) < 4 / np.sqrt(n_rows)


def test_philox_normals_do_not_depend_on_the_launch_shape():
    """A value depends on (seed, row, step, f) only: any subset of rows, in
    any order, at any F gives the same numbers; seed and step change them."""
    full = philox_normal_reference(9, torch.arange(5000), 4, 4)
    some = torch.tensor([4999, 0, 77, 1024])
    assert torch.equal(philox_normal_reference(9, some, 4, 4), full[some])
    assert torch.equal(philox_normal_reference(9, torch.arange(100), 4, 1), full[:100, :1])
    assert torch.equal(philox_normal_reference(9, torch.arange(100), 4, 3), full[:100, :3])
    assert not torch.equal(philox_normal_reference(10, some, 4, 4), full[some])
    assert not torch.equal(philox_normal_reference(9, some, 5, 4), full[some])


def test_twin_with_philox_noise_is_stable_under_the_row_count():
    """The twin on the kernel's stream: the same seed gives the same rows for
    any M, another seed other rows, and the seam refuses an unknown source."""
    T, F_ = 3, 2
    rng = np.random.default_rng(6)
    w = tuple(map(torch.from_numpy, _weights(F_, rng)))
    E = tuple(map(torch.from_numpy, _tables(T, rng)))
    tab = torch.from_numpy(schedule_table(NsDiffSchedule.create("linear", T, 1e-4, 2e-2)))
    y0 = torch.from_numpy(rng.normal(size=(70, F_)).astype(np.float32))
    gx = torch.from_numpy(rng.uniform(0.05, 1, size=(70, F_)).astype(np.float32))
    run = lambda n, seed: fused_chain_rows_reference(
        y0[:n], gx[:n], tab, E, w, T, matmul_dtype="float32", noise="philox", seed=seed)
    a, b, c = run(70, 1), run(9, 1), run(70, 2)
    # the matrix products of 70 and of 9 rows may sum in another order
    torch.testing.assert_close(a[:9], b, rtol=1e-5, atol=1e-6)
    assert (a - c).abs().max() > 1e-2
    assert torch.isfinite(a).all() and (a - y0).abs().max() > 1e-3
    with pytest.raises(ValueError):
        fused_chain_rows_reference(y0, gx, tab, E, w, T, noise="curand")


# ---------------------------------------------------------------- twin vs the TPU kernel
# every F in {1, 2, 4} with every M in {1, 63, 65, 1025} and every T in {2, 20};
# use_gx_directly alternates so that each value meets each F, M and T
CHAIN_COMBOS = [(F_, M, T, (i + j + k) % 2 == 1)
                for i, F_ in enumerate((1, 2, 4))
                for j, M in enumerate((1, 63, 65, 1025))
                for k, T in enumerate((2, 20))]


@pytest.mark.parametrize("F_,M,T,use_gx", CHAIN_COMBOS)
def test_twin_matches_pallas_chain_on_ragged_and_edge_rows(F_, M, T, use_gx):
    """Noise-free float32 chain against the Pallas kernel in interpret mode at
    its own bar (rtol 2e-5, atol 2e-6: tests/test_chain_resident.py). Row 0
    has gx = 1e-6 and the last row gx = 10: the quadratic's discriminant clamp
    and a posterior far from the schedule's scale."""
    rng = np.random.default_rng(1000 * F_ + M + T)
    w, E = _weights(F_, rng), _tables(T, rng)
    y0 = rng.normal(size=(M, F_)).astype(np.float32)
    gx = rng.uniform(0.05, 1.0, size=(M, F_)).astype(np.float32)
    gx[0] = 1e-6
    if M > 1 or use_gx:
        gx[-1] = 10.0
    want = np.asarray(j_chain_rows(
        jnp.asarray(y0), jnp.asarray(gx), j_schedule_table(JSchedule.create("linear", T, 1e-4, 2e-2)),
        0, tuple(map(jnp.asarray, E)), tuple(map(jnp.asarray, w)), T, interpret=True,
        matmul_dtype="float32", noise_mode="zero", use_gx_directly=use_gx, tile_m=64))
    tab = schedule_table(NsDiffSchedule.create("linear", T, 1e-4, 2e-2))
    got = fused_chain_rows(torch.from_numpy(y0), torch.from_numpy(gx), tab, 0,
                           tuple(map(torch.from_numpy, E)), tuple(map(torch.from_numpy, w)), T,
                           matmul_dtype="float32", noise_mode="zero", use_gx_directly=use_gx)
    assert got.shape == (M, F_) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    assert fused_chain_rows.launches == 0  # a CPU tensor never counts as a launch


# ---------------------------------------------------------------- first layer
@pytest.mark.parametrize("F_", [1, 2, 4])
def test_first_layer_redone_every_step_equals_the_hoisted_form(F_):
    """The tensor-core arm keeps no [y0_hat, gx] . W1[F:] partial: it redoes
    acc = y . W1[:F] + (y0_hat . W1[F:2F] + gx . W1[2F:]) every step from
    operands rounded to bf16 one by one, with one FMA a term. Products of two
    bf16 values are exact in float32, so that is the twin's hoisted form to
    the bit at F = 1 and to float32 summation order otherwise, and K1's
    concatenated [y, y0_hat, gx] . W1 to the same."""
    rng = np.random.default_rng(F_)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    y, y0 = (rng.normal(size=(33, F_)).astype(np.float32) for _ in "ab")
    gx = rng.uniform(1e-6, 10, size=(33, F_)).astype(np.float32)
    W1 = rng.normal(size=(3 * F_, HID)).astype(np.float32)

    def chain(v, rows):  # sequential float32 FMAs on exact products
        acc = bf(v[:, :1]) * bf(rows[:1])
        for i in range(1, F_):
            acc = (acc.astype(np.float64) + bf(v[:, i:i + 1]).astype(np.float64)
                   * bf(rows[i:i + 1]).astype(np.float64)).astype(np.float32)
        return acc

    redone = chain(y, W1[:F_]) + (chain(y0, W1[F_:2 * F_]) + chain(gx, W1[2 * F_:]))
    t = torch.from_numpy
    mm = torch.bfloat16
    hoisted = _dot(t(y), t(W1[:F_]), mm) + (_dot(t(y0), t(W1[F_:2 * F_]), mm)
                                            + _dot(t(gx), t(W1[2 * F_:]), mm))
    concat = _dot(t(np.concatenate([y, y0, gx], axis=1)), t(W1), mm)
    if F_ == 1:
        np.testing.assert_array_equal(redone, hoisted.numpy())
    np.testing.assert_allclose(redone, hoisted.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(redone, concat.numpy(), rtol=1e-6, atol=2e-6)


# ---------------------------------------------------------------- the work count
def test_k2_work_on_hand_worked_numbers():
    # one row, one step, F = 1: the y0_hat/gx partials 2 x 128 multiply-adds,
    # the step 128 + 2 x 128^2 + 2 x 128; three floats moved; 513 softplus of
    # two results, three rsqrt, seven for the draw and the posterior
    assert roofline.k2_work(1, 1) == (2.0 * (256 + 128 + 32768 + 256), 12.0, 1026 + 3 + 7)
    # F = 4, three steps, five rows
    flops, nbytes, sfu = roofline.k2_work(5, 3, F=4)
    assert flops == 2.0 * 5 * (2 * 4 * 128 + 3 * (4 * 128 + 32768 + 2 * 128 * 4))
    assert nbytes == 4.0 * 5 * 3 * 4
    assert sfu == 3 * 5 * (2 * (512 + 4) + 3 + 28)
    # at the sweep's size the draw and the posterior move the bound by 0.7%
    work = roofline.k2_work(4_800_000, 20)
    ms, by = roofline.bound_ms(*work, "bfloat16", 1.98e9)
    assert by == "special_functions" and ms == pytest.approx(23.783, abs=1e-3)
    assert roofline.bound_ms(*work, "float32", 1.98e9)[1] == "operations"
    assert work[2] / (20 * roofline.k1_work(4_800_000)[2]) == pytest.approx(1036 / 1029)
