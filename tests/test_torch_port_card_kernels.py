"""The port's six CUDA kernels on the card, each against its plain twin.

The nvcc build with no register spill in the tensor-core kernels and the
attention kernel; K1 and K3
over ragged row counts, feature widths 1, 2 and 4, edge-case rows and, element
by element, at the sweeps' own row counts in both matmul types, with the
series branch of their softplus; the bf16-activation arms of K1 and K2; K2
noise-free in both matmul types and per sample on its own Philox normals,
against a chain of K1 launches, at 100 steps, at two launch shapes and at the
sweep's row count; the NsDiff chain's posterior update bit for bit against its
twin and the eager step it replaced, alone, at the sweep's row count and over
whole chains of K1 launches; the de-stationary attention against its twin at
the sweeps' calls, at longer windows and at every head width it is built
for, its launches in the f(x) of a sweep chunk and of a W/P 200/200 one and
none in a train step. K4 is held to its twin in
``test_torch_port_card_pipelines.py`` (data generation). Every case skips
without a CUDA device; on the card (see ``card_checks.py``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_kernels.py -m card

The checks run once, in the order that draws their inputs
(``kernel_checks``), and each case asserts its own results.
"""
import contextlib

import numpy as np
import pytest
import torch

from bench import make_windows
from card_checks import (
    CHUNK, M_MAIN, M_TMDM, N_Z, NET_PARAM, NODE, PRED_LEN, STEPS, T_STEPS, TOL, TRAIN_B,  # noqa: F401
    TRAIN_PARAM, WINDOWS, card, eager_nsdiff_chain, eager_nsdiff_step, train_losses,
)

# -- the step kernels K1 and K3 against their twins (bar: TOL) ---------------------
RAGGED_M = (1, 63, 64, 65, 65536, 65537)
WIDTHS = (1, 2, 4)
CASES = ("random", "below", "above")
N_STEPS = 20
GATE_STEPS = (0, 7, N_STEPS - 1)
# bar of check_series_branch, relative: see there
SERIES_RTOL = 1e-3

# -- the chain kernel K2 against its twin ------------------------------------------
# float32, noise-free: the JAX package's own bar for its chain kernel
# (tests/test_chain_resident.py). With noise, per sample on the same Philox
# normals: the K1 chain's bar against the plain chain (float32 on both sides,
# sums in another order, carried through the steps).
CHAIN_F32 = {"rtol": 2e-5, "atol": 2e-6}
CHAIN_NOISE = {"rtol": 1e-4, "atol": 1e-4}
# bf16 activations against float32 ones: the JAX package's own bars, K1
# (tests/test_pallas_denoiser.py:63-65) and the chain
# (tests/test_chain_resident.py:122-126)
ACT_EPS_ABS, ACT_SIGMA_REL, CHAIN_ACT_REL = 1e-2, 1e-2, 0.05
# bf16 activations against their twin, beyond the bar on max |d|: kernel and
# twin round the same operations, so an output differs only where ex2 / lg2 /
# rsqrt or a sum in another order put one of its row's roundings across a bf16
# boundary. On the H100 (NVIDIA H100 80GB HBM3, 700 W) at 65,537 and 4.8 M
# rows, 99.90% or more of eps, sigma (K1) and y_0 (K2, both matmul types, 20
# steps) equal the twin's within 1e-6 (1 + |twin|), and mean |d| is at most
# 0.013 of the mean distance to the float32-activation arm. A build without
# the bf16 rounding of 1 + e in the softplus leaves 0-11% of them on the twin
# and 0.21-49 of that distance (random rows and rows below zero; above +8 that
# rounding changes nothing), where on random rows its max |d| passes the bar.
# Bars: 99% on the twin, mean |d| at most 0.05 of the distance, from 65,536
# rows.
ACT_SAME_RTOL, ACT_SAME_FRAC, ACT_SEP, ACT_SEP_ROWS = 1e-6, 0.99, 0.05, 65536

# -- the NsDiff chain's posterior update (csrc/nsdiff_chain_update.cu) ----------------
# (rows, features, floats the operands sit into their buffers: 16-byte aligned
# when a multiple of 4, else the kernel takes every row one at a time)
UPDATE_SHAPES = ((1, 1, 0), (3, 1, 1), (5, 1, 0), (63, 1, 2), (64, 1, 0), (65, 2, 1),
                 (4097, 1, 3), (65537, 1, 0), (65537, 4, 1))
UPDATE_SCHEDULES = (("linear", N_STEPS, range(N_STEPS)), ("cosine", 100, (0, 1, 50, 99)))
UPDATE_CHAINS = ("drawn", "strided noise", "strided operands")

# -- the de-stationary attention (csrc/ds_attention.cu) --------------------------------
# the sweeps' calls, (name, L, S, causal): the encoder's, the decoder's causal
# self attention and its cross attention; at nsdiff_sweep's (B, H) for E 64 and
# tmdm_sweep's for E 16; each with tau and delta, either, or neither
ATTN_CALLS = (("encoder", 100, 100, False), ("decoder_self", 150, 150, True),
              ("cross", 150, 100, False))
ATTN_HEADS = {64: (480, 8), 16: (240, 4)}
ATTN_VARIANTS = {"tau_delta": (True, True), "tau": (True, False), "delta": (False, True),
                 "neither": (False, False)}
# past the sweeps, (E, B, H, name, L, S, causal), with tau and delta: the
# paper models' E 8 (d_model 16, 2 heads) at W/P 500/200 and 200/200, E 32,
# the SLBP grid's W/P 200/200 at E 64 (K and V staged beside the score rows),
# W/P 200/1000 (1,100 keys: K and V read from device memory), the edge of the
# one-tile path (160 and 161 keys) and the most keys the card takes (one warp
# a block)
ATTN_LONG = ((8, 120, 2, "w500_encoder", 500, 500, False),
             (8, 120, 2, "w200_decoder_self", 300, 300, True),
             (8, 120, 2, "w200_cross", 300, 200, False),
             (32, 120, 8, "decoder_self", 150, 150, True),
             (32, 60, 8, "w200_cross", 300, 200, False),
             (64, 60, 8, "w200_encoder", 200, 200, False),
             (64, 60, 8, "w200_decoder_self", 300, 300, True),
             (64, 60, 8, "w200_cross", 300, 200, False),
             (64, 8, 8, "p1000_decoder_self", 1100, 1100, True),
             (64, 8, 8, "p1000_cross", 1100, 200, False),
             (64, 60, 8, "tile", 160, 160, True),
             (64, 60, 8, "tile_plus_one", 161, 161, True),
             (64, 4, 8, "max_keys", 64, None, False))
# the repo's forward bar (tests/test_pallas_denoiser.py:26-27): float32 on both
# sides, the products and sums in another order
ATTN_ATOL = 2e-5
# f(x) of a sweep chunk with the kernel against the twin, through 6 layers: the
# JAX package's backbone bar, atol and rtol (tests/test_torch_parity.py:107)
FX_TOL = 1e-4
ATTN_CALLS_A_CHUNK = 8  # e4/d2: 4 encoder, 2 x (self + cross)
# f(x) at bench_cuda/configs/nsdiff_d512_slbp.json's widths (W/P 200/200, two
# state variables) over a few series: 200, 300 and 300 x 200 keys
SLBP_PARAM = dict(NET_PARAM, windows=200, pred_len=200, dataset_nf=2)
SLBP_SERIES = 32


class Checks:
    """Results of checks that run once, in one order (their inputs depend on
    it), recorded by case: a case that raises AssertionError keeps its first
    message and the run goes on."""

    def __init__(self):
        self.ran, self.failed = set(), {}

    @contextlib.contextmanager
    def case(self, key):
        self.ran.add(key)
        try:
            yield
        except AssertionError as exc:
            self.failed.setdefault(key, str(exc))

    def held(self, key):
        assert key in self.ran, f"{key}: not run"
        if key in self.failed:
            pytest.fail(f"{key}: {self.failed[key]}", pytrace=False)


def step_kernel(which):
    """(denoiser class, weights_of, wrapper, twin, outputs as a tuple) of K1 or K3."""
    from upgdm_tpu_torch.models.denoise import NsDiffDenoiser, TMDMDenoiser
    from upgdm_tpu_torch.ops.kernels import fused_denoiser as k1, fused_tmdm as k3

    if which == "k1":
        return (NsDiffDenoiser, k1.denoiser_weights, k1.fused_denoiser_rows,
                k1.fused_denoiser_rows_reference, tuple)
    return (TMDMDenoiser, k3.tmdm_weights, k3.fused_tmdm_rows, k3.fused_tmdm_rows_reference,
            lambda out: (out,))


def edge_case(which, case, weights, gammas, gen, bias=14.0):
    """(weights, gammas) for one kind of row. ``random`` keeps the module's
    own; ``below`` / ``above`` put every pre-activation of the three hidden
    layers below -8 / above +8: biases of -`bias` / +`bias`, gates in
    [0.9, 1.1] and the three trunk matrices scaled by 0.1, so that the
    products stay within ~3.5 of zero. The heads stay the module's own, with
    one exception, K3 ``above``: the bar is absolute and K3 has no norm, so
    an activation in [8, 16) has a bf16 step of 2^-4, and one that rounds the
    other way in kernel and twin moves eps by 2^-4 x |W4|, which is 5.5e-3 at
    the module's own |W4| <= 0.088; there W4 is scaled by 0.1 (5.5e-4)."""
    if case == "random":
        return weights, gammas
    w = list(weights)
    for i in (0, 2, 4):
        w[i] = w[i] * 0.1
    for i in (1, 3, 5):
        w[i] = torch.full_like(w[i], -bias if case == "below" else bias)
    if which == "k3" and case == "above":
        w[6] = w[6] * 0.1
    g = tuple(0.9 + 0.2 * torch.rand(x.shape, generator=gen, device=x.device) for x in gammas)
    return tuple(w), g


def step_rows(which, M, Fdim, gen, dev):
    """M rows of K1's [y_t, y0_hat, gx] (gx positive) or K3's [y_t, y0_hat]."""
    x = torch.randn(M, 2 * Fdim, generator=gen, device=dev)
    if which == "k1":
        x = torch.cat([x, torch.rand(M, Fdim, generator=gen, device=dev) * 0.95 + 0.05], dim=1)
    return x


def worst_err(name, got, want, tol, where):
    """AssertionError if an output has the wrong shape, is not finite or is
    further than `tol` from the twin's."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all().item():
            raise AssertionError(f"{name}: bad output at {where}")
        worst = max(worst, (a - b).abs().max().item())
    if worst > tol:
        raise AssertionError(f"{name}: max|err| {worst} > {tol} at {where}")


def arms_apart(name, got, twin, float32_act, where):
    """Hold a bf16-activation output to its twin closer than a bar on
    max |d| can: at least ACT_SAME_FRAC of the elements within ACT_SAME_RTOL
    (1 + |twin|) of the twin's, and mean |got - twin| at most ACT_SEP x mean
    |got - float32_act| (the same kernel's float32-activation output);
    AssertionError below either bar."""
    d = (got - twin).abs()
    same = (d <= ACT_SAME_RTOL * (1.0 + twin.abs())).float().mean().item()
    off, apart = d.mean().item(), (got - float32_act).abs().mean().item()
    ratio = off / apart if apart > 0 else (0.0 if off == 0 else float("inf"))
    if not (same >= ACT_SAME_FRAC and ratio <= ACT_SEP):
        raise AssertionError(f"{name}: {same:.4%} of the elements on the twin (bar "
                             f"{ACT_SAME_FRAC:.0%}), mean |d| {ratio:.4g} of the distance to "
                             f"the float32-activation arm (bar {ACT_SEP}), max |d| "
                             f"{d.max().item():.4g} at {where}")


def check_step_kernel(checks, which, dev, seed=2, act="float32"):
    """K1 (``which="k1"``) or K3 (``"k3"``) against its twin over RAGGED_M x
    WIDTHS x CASES (the module's own gates at GATE_STEPS for ``random``) in
    both matmul types, or for K1's ``act="bfloat16"`` in bf16 matmuls (the
    only type it takes), at TOL; a case is (which, act, F, case, matmul).
    The bf16-activation arm is held to TOL["bfloat16"] too: kernel and twin
    round the same operations, and an activation that the special-function
    unit's ex2 / lg2 / rsqrt or a sum in another order puts across a bf16
    rounding boundary moves eps by one bf16 step seen through the head, as in
    the float32-activation arm. That bar cannot tell the arm from one that
    rounds less, so at 65,536 rows and more it is also held apart from the
    float32-activation arm (``arms_apart``)."""
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_gammas, step_weights

    cls, weights_of, rows, ref, tup = step_kernel(which)
    acts = {"act_dtype": act} if which == "k1" else {}
    mms = TOL if act == "float32" else ("bfloat16",)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    with torch.no_grad():
        for Fdim in WIDTHS:
            den = cls(Fdim, N_STEPS).to(dev).eval()
            for case in CASES:
                for t in GATE_STEPS if case == "random" else (7,):
                    W, G = edge_case(which, case, weights_of(den), denoiser_gammas(den, t), gen)
                    kw = {mm: step_weights(W, getattr(torch, mm)) for mm in mms}
                    for M in RAGGED_M:
                        x = step_rows(which, M, Fdim, gen, dev)
                        for mm in mms:
                            where = f"F={Fdim} M={M} {case} t={t} {mm} act {act}"
                            with checks.case((which, act, Fdim, case, mm)):
                                got = tup(rows(x, G, kw[mm], matmul_dtype=mm, **acts))
                                want = tup(ref(x, G, W, matmul_dtype=mm, **acts))
                                worst_err(which.upper(), got, want, TOL[mm], where)
                                if act != "float32" and M >= ACT_SEP_ROWS:
                                    other = rows(x, G, kw[mm], matmul_dtype=mm)
                                    for name, a, b, c in zip(("eps", "sigma"), got, want, other):
                                        arms_apart(f"K1 {name}", a, b, c, where)


def check_series_branch(checks, which, dev, seed=4):
    """The bf16 arm's softplus on rows far below zero, held to a relative bar;
    a case is ("series", which, F).

    With every pre-activation at about -14 or -20 a softplus is e = 8e-7 or
    2e-9. ``lg2(1 + e)`` alone would quantise e to the 1.2e-7 steps of 1 + e
    (and give 0 at -20), which an absolute bar on eps cannot see; the series
    branch of ``softplus_fast`` keeps e to ~3e-5 relative. The head here is
    all ones with no bias, so eps is the sum of the row's 128 activations as
    the product reads them (K1: of the normalised row). Kernel and twin then
    differ by the softplus (3e-5), by float32 sums in another order (1e-6)
    and by a bf16 rounding that falls the other way in a few of the 128 terms
    (2^-8 / 128 = 3e-5 each): held to 1e-3 relative. A build without the
    series branch is 2.3e-2 (K1) and 7.1e-2 (K3) off at -14 on the H100."""
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_gammas, step_weights

    cls, weights_of, rows, ref, tup = step_kernel(which)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    with torch.no_grad():
        for Fdim in WIDTHS:
            den = cls(Fdim, N_STEPS).to(dev).eval()
            for bias in (14.0, 20.0):
                W, G = edge_case(which, "below", weights_of(den), denoiser_gammas(den, 7), gen,
                                 bias=bias)
                W = W[:6] + (torch.ones_like(W[6]), torch.zeros_like(W[7])) + W[8:]
                kw = step_weights(W, torch.bfloat16)
                x = step_rows(which, 65537, Fdim, gen, dev)
                with checks.case(("series", which, Fdim)):
                    got = tup(rows(x, G, kw, matmul_dtype="bfloat16"))[0]
                    want = tup(ref(x, G, W, matmul_dtype="bfloat16"))[0]
                    rel = ((got - want).abs() / want.abs()).max().item()
                    assert rel <= SERIES_RTOL, (  # also catches NaN
                        f"{which.upper()}: rows at -{bias:g}: eps off the twin by {rel} "
                        f"relative > {SERIES_RTOL} (F={Fdim})")


def main_path_step(checks, which, weights, g, x):
    """Wrapper against twin element by element on the main path's rows ``x``
    in both matmul types: a case is (which, "main", matmul)."""
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import step_weights

    _, _, rows, ref, tup = step_kernel(which)
    for mm in TOL:
        with checks.case((which, "main", mm)):
            got = tup(rows(x, g, step_weights(weights, getattr(torch, mm)), matmul_dtype=mm))
            want = tup(ref(x, g, weights, matmul_dtype=mm))
            worst_err(which.upper(), got, want, TOL[mm], f"the main path's {x.shape[0]} rows, {mm}")
            del got, want


def chain_error_weight(tab, gx_max):
    """sum over t of |d y_0 / d eps_t| for a noise-free chain on the [7, T]
    schedule table, at sigma_y0 = gx = gx_max (float64). eps_t enters y_{t-1}
    with weight gamma_0 sqrt(noise_var) / sqrt(abar_t) (sqrt(noise_var) /
    sqrt(abar_0) at t = 0), and y_{t-1} passes to y_{t-2} with gamma_0 /
    sqrt(abar) + gamma_1; the trunk's own dependence on y is left out.

    The bar of the bf16 arm follows from it: every step's eps may be off the
    twin's by K1's bar TOL["bfloat16"] (same trunk arithmetic: the same
    operands rounded to bf16, summed in another order, the approximate
    softplus), so y_0 is held to TOL["bfloat16"] x this weight: 0.86 at 20
    steps and 2.6 at 100 for gx <= 1, i.e. 1.7e-3 and 5.2e-3."""
    a, bt, bb, bt_m1, bb_m1, acp_prev, om = np.asarray(tab, np.float64)
    sqrt_abar = np.sqrt(1.0 - om * om)
    s1 = (1.0 - a) ** 2 * gx_max + a * (1.0 - a) * gx_max
    s2 = (bb_m1 - bt_m1) * gx_max + bt_m1 * gx_max
    denom = a * s2 + s1
    g0, g1 = np.sqrt(acp_prev) * s1 / denom, np.sqrt(a) * s2 / denom
    by_eps = np.sqrt(bb * gx_max) / sqrt_abar  # noise_var at sigma_y0 = gx is bb gx
    by_eps[1:] *= g0[1:]
    onward = g0 / sqrt_abar + g1
    onward[0] = 1.0
    return float(sum(by_eps[t] * np.prod(onward[1:t]) for t in range(len(a))))


def chain_setup(Fdim, T, dev):
    """(denoiser, flax-layout weights, gate tables, schedule, its [7, T] table on dev)."""
    from upgdm_tpu_torch.models.denoise import NsDiffDenoiser
    from upgdm_tpu_torch.ops.kernels.chain_resident import schedule_table
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_weights
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule

    den = NsDiffDenoiser(Fdim, T).to(dev).eval()
    tables = tuple(e.detach() for e in (den.lin1.embed, den.lin2.embed, den.lin3.embed))
    sched = NsDiffSchedule.create("linear", T, 1e-4, 2e-2)
    return den, denoiser_weights(den), tables, sched, torch.as_tensor(schedule_table(sched),
                                                                      device=dev)


def chain_rows(M, Fdim, gen, dev):
    """M rows of (y0_hat, gx) with gx in [0.05, 1]."""
    y0 = torch.randn(M, Fdim, generator=gen, device=dev) * 0.5 + 1.0
    return y0, torch.rand(M, Fdim, generator=gen, device=dev) * 0.95 + 0.05


def off_by(got, want, rtol, atol):
    """max of |got - want| - (atol + rtol |want|): positive when over the bar."""
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def held_chain(name, got, want, rtol, atol, where):
    """AssertionError unless K2's ``got`` is finite, of ``want``'s shape and
    within rtol / atol of it."""
    if got.shape != want.shape or not torch.isfinite(got).all().item():
        raise AssertionError(f"K2 {name}: bad output at {where}")
    over = off_by(got, want, rtol, atol)
    if over > 0:
        raise AssertionError(f"K2 {name}: off rtol {rtol} / atol {atol} by {over} at {where}")


def k1_chain_zero_noise(den, y0, gx, sched, mm):
    """The noise-free chain as T launches of K1 through ``nsdiff_p_sample_loop``
    (zeros through its ``noise`` seam): K2's trunk arithmetic, launch by launch."""
    from upgdm_tpu_torch.ops.diffusion import nsdiff_p_sample_loop, schedule_on
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, step_weights,
    )

    M, Fdim = y0.shape
    kw = step_weights(denoiser_weights(den), getattr(torch, mm))
    x = torch.cat([y0, y0, gx], dim=1)

    def model_fn(y, t):
        x[:, :Fdim] = y
        return fused_denoiser_rows(x, denoiser_gammas(den, t), kw, matmul_dtype=mm)

    zeros = [torch.zeros_like(y0)] * sched.num_timesteps
    return nsdiff_p_sample_loop(model_fn, y0, gx, schedule_on(sched, y0.device), noise=zeros)


def check_chain_kernel(checks, dev, seed=6, act="float32"):
    """K2 against its twin, ``fused_chain_rows_reference``. Noise-free over
    RAGGED_M x WIDTHS x ``use_gx_directly``: float32 at CHAIN_F32, bf16 at
    TOL["bfloat16"] x ``chain_error_weight``; a case is ("k2", act, T, F,
    matmul). At 65,537 rows: the float32 arm with noise on against the twin
    on the same Philox normals, per sample at CHAIN_NOISE; the bf16 arm
    likewise with the heads fixed, so that only its draws and posterior
    arithmetic show; both arms at two launch shapes under one seed (shared
    rows bit-equal); the bf16 arm against a chain of K1 launches at its bar;
    and a 100-step chain in both arms; a case is ("k2", act, F, what).

    ``act="bfloat16"``: both matmul types noise-free at the bf16 bar (the
    trunk rounds as K1's bf16-activation arm, carried by the chain). At
    65,537 rows: ``arms_apart`` against the float32-activation chain, which
    must differ within the JAX package's bar, mean |d| / mean |y| <
    CHAIN_ACT_REL; and with noise on, per sample on the Philox normals at
    the bf16 bar plus CHAIN_NOISE. Returns the bf16 bar at 20 steps."""
    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        fused_chain_rows, fused_chain_rows_reference,
    )

    bf = act == "bfloat16"
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    bars = {}
    with torch.no_grad():
        for T in (N_STEPS,) if bf else (N_STEPS, 100):
            for Fdim in WIDTHS if T == N_STEPS else (1,):
                den, W, tables, sched, tab = chain_setup(Fdim, T, dev)
                bar16 = bars[T] = TOL["bfloat16"] * chain_error_weight(tab.cpu().numpy(), 1.0)
                arms = (("float32", 0.0, bar16) if bf
                        else ("float32", CHAIN_F32["rtol"], CHAIN_F32["atol"]),
                        ("bfloat16", 0.0, bar16))
                for use_gx in (False, True):
                    for M in RAGGED_M if T == N_STEPS else (65537,):
                        y0, gx = chain_rows(M, Fdim, gen, dev)
                        where = f"F={Fdim} M={M} T={T} use_gx_directly={use_gx} act {act}"
                        for mm, rtol, atol in arms:
                            if T == 100 and mm == "float32":  # five times the steps
                                rtol, atol = CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"]
                            kw = dict(matmul_dtype=mm, noise_mode="zero", use_gx_directly=use_gx)
                            with checks.case(("k2", act, T, Fdim, mm)):
                                got = fused_chain_rows(y0, gx, tab, 0, tables, W, T,
                                                       act_dtype=act, **kw)
                                want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                                  act_dtype=act, **kw)
                                held_chain(f"{mm} noise-free", got, want, rtol, atol, where)
                                if bf and M >= ACT_SEP_ROWS:
                                    f32 = fused_chain_rows(y0, gx, tab, 0, tables, W, T, **kw)
                                    arms_apart(f"K2 {mm}", got, want, f32, where)
                                    rel = ((got - f32).abs().mean() / f32.abs().mean()).item()
                                    assert 0 < rel < CHAIN_ACT_REL, (
                                        f"K2 {mm}: act bf16 vs float32 act {rel} at {where}")
                if T != N_STEPS:
                    continue
                # y0, gx: the last 65,537 rows
                if bf:  # noise on, per sample
                    for mm in TOL:
                        with checks.case(("k2", act, Fdim, f"Philox {mm}")):
                            got = fused_chain_rows(y0, gx, tab, 5, tables, W, T,
                                                   matmul_dtype=mm, act_dtype=act)
                            want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                              matmul_dtype=mm, act_dtype=act,
                                                              noise="philox", seed=5)
                            held_chain(f"{mm} act bf16 with Philox noise", got, want,
                                       CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"] + bar16,
                                       f"F={Fdim}")
                    continue
                # noise on, per sample
                with checks.case(("k2", act, Fdim, "Philox float32")):
                    got = fused_chain_rows(y0, gx, tab, 5, tables, W, T, matmul_dtype="float32")
                    want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                      matmul_dtype="float32", noise="philox",
                                                      seed=5)
                    held_chain("float32 with Philox noise", got, want, CHAIN_NOISE["rtol"],
                               CHAIN_NOISE["atol"], f"F={Fdim}")
                # the bf16 arm's own draws, per sample: with W4, b4 and Ws at zero
                # eps is 0 and sigma is softplus(bs) whatever the trunk rounds, so
                # the chain is the posterior arithmetic on the normals alone
                with checks.case(("k2", act, Fdim, "bf16 noise stream")):
                    Wz = W[:6] + (torch.zeros_like(W[6]), torch.zeros_like(W[7]),
                                  torch.zeros_like(W[8]), W[9])
                    got = fused_chain_rows(y0, gx, tab, 5, tables, Wz, T)
                    want = fused_chain_rows_reference(y0, gx, tab, tables, Wz, T,
                                                      noise="philox", seed=5)
                    held_chain("bf16 noise stream", got, want, CHAIN_NOISE["rtol"],
                               CHAIN_NOISE["atol"], f"F={Fdim}")
                # one seed, two launch shapes: the rows they share are equal
                for mm in TOL:
                    with checks.case(("k2", act, Fdim, f"launch shapes {mm}")):
                        full = fused_chain_rows(y0, gx, tab, 5, tables, W, T, matmul_dtype=mm)
                        part = fused_chain_rows(y0[:1000].contiguous(), gx[:1000].contiguous(),
                                                tab, 5, tables, W, T, matmul_dtype=mm)
                        assert torch.equal(full[:1000], part), (
                            f"K2 {mm}: seed 5 gives other rows at M=1000 than at M=65537 "
                            f"(F={Fdim})")
                with checks.case(("k2", act, Fdim, "bf16 vs the K1 chain")):
                    got = fused_chain_rows(y0, gx, tab, 0, tables, W, T, noise_mode="zero")
                    want = k1_chain_zero_noise(den, y0, gx, sched, "bfloat16")
                    held_chain("bf16 against the K1 chain", got, want, 0.0, bar16, f"F={Fdim}")
    return bars[N_STEPS]


def same_bits(name, got, want, where):
    """AssertionError unless got and want hold the same float32 bits (NaN
    where the other has NaN)."""
    nan = torch.isnan(got)
    if got.shape != want.shape or not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{name}: shape or NaN rows differ at {where}")
    a, b = torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{name}: {(a != b).sum().item()} values differ, max "
                             f"{(a - b).abs().max().item()} at {where}")


def update_operands(M, Fdim, offset, gen, dev):
    """(y, y_T_mean, gx, eps, sigma, z) [M, Fdim] float32, each ``offset``
    floats into its own buffer, with edge rows first: sigma 50 (the
    discriminant's clamp), 1e-6, 3 and NaN, gx 1e-6, 1e-3, 2 and 7."""
    def one(uniform):
        x = torch.empty(M * Fdim + offset, device=dev)[offset:].view(M, Fdim)
        return x.uniform_(0.05, 1.0, generator=gen) if uniform else x.normal_(generator=gen)

    y, ytm, gx, eps, sig, z = (one(u) for u in (False, False, True, False, True, False))
    edges = torch.tensor([[50.0, 1e-6, 3.0, float("nan")], [1e-6, 1e-3, 2.0, 7.0]], device=dev)
    sig[:4, 0] = edges[0, :min(M, 4)]
    if M > 4:
        gx[4:8, 0] = edges[1, :min(M - 4, 4)]
    return y, ytm, gx, eps, sig, z


def check_chain_update_kernel(checks, dev, seed=8):
    """The posterior-update kernel bit for bit against its twin run on the
    card and against the eager step it replaced: over UPDATE_SHAPES (row
    counts not a multiple of 4, unaligned operands), both ``use_gx_directly``
    arms and the final step, on every t of a 20-step linear schedule and on
    four steps of a 100-step cosine one; a case is ("update", schedule, M, F,
    offset). Then whole chains of K1 launches through ``nsdiff_p_sample_loop``
    (the kernel, T launches a chain) against the same chain with the eager
    update: drawn from one seed, through a non-contiguous ``noise`` seam, and
    on strided y0_hat, gx, eps and sigma; a case is ("update chain", name)."""
    from upgdm_tpu_torch.ops.diffusion import nsdiff_p_sample_loop, schedule_on
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, fused_denoiser_rows, step_weights,
    )
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import (
        chain_table, nsdiff_chain_update, nsdiff_chain_update_reference,
    )
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule

    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, T, steps in UPDATE_SCHEDULES:
        sched = NsDiffSchedule.create(name, T, 1e-4, 2e-2)
        table, sched_dev = chain_table(sched, dev), schedule_on(sched, dev)
        for M, Fdim, offset in UPDATE_SHAPES:
            y, ytm, gx, eps, sig, z = update_operands(M, Fdim, offset, gen, dev)
            for direct in (False, True):
                for t in steps:
                    zt = None if t == 0 else z
                    where = f"{name} T={T} t={t} M={M} F={Fdim} offset={offset} direct={direct}"
                    with checks.case(("update", name, M, Fdim, offset)):
                        got = nsdiff_chain_update(y, ytm, gx, eps, sig, zt, table[t], direct)
                        same_bits("update vs twin", got, nsdiff_chain_update_reference(
                            y, ytm, gx, eps, sig, zt, table[t], direct), where)
                        same_bits("update vs eager step", got, eager_nsdiff_step(
                            sched_dev, t, y, ytm, gx, eps, sig, zt, direct), where)
    # whole chains through K1 (bf16), 4 members of 16,385 rows
    den, W, _, sched, _ = chain_setup(1, N_STEPS, dev)
    members, M = 4, 4 * 16385
    y0, gx = chain_rows(M, 1, gen, dev)
    kw = step_weights(W, torch.bfloat16)
    x = torch.cat([y0, y0, gx], dim=1)

    def model_fn(y, t):
        x[:, :1] = y
        return fused_denoiser_rows(x, denoiser_gammas(den, t), kw, matmul_dtype="bfloat16")

    def strided_fn(y, t):  # eps and sigma as strided views (NsDiff_spatial's layouts)
        eps, sig = model_fn(y, t)
        return torch.cat([eps, eps], 1)[:, :1], torch.cat([sig, sig], 1)[:, :1]

    strided = [torch.randn(M, 2, generator=gen, device=dev)[:, ::2] for _ in range(N_STEPS)]
    chains = (("drawn", model_fn, y0, gx, None), ("strided noise", model_fn, y0, gx, strided),
              ("strided operands", strided_fn, torch.cat([y0, y0], 1)[:, :1],
               torch.cat([gx, gx], 1)[:, :1], None))
    for direct in (False, True):
        for name, fn, y0c, gxc, noise in chains:
            where = f"chain M={M} direct={direct} {name}"
            with checks.case(("update chain", name)):
                before = nsdiff_chain_update.launches
                got = nsdiff_p_sample_loop(fn, y0c, gxc, sched, torch.Generator(
                    device=dev).manual_seed(3), direct, noise, members)
                assert nsdiff_chain_update.launches - before == N_STEPS, (
                    f"{nsdiff_chain_update.launches - before} launches a chain, expected "
                    f"{N_STEPS}, at {where}")
                want = eager_nsdiff_chain(fn, y0c, gxc, schedule_on(sched, dev), torch.Generator(
                    device=dev).manual_seed(3), direct, noise, members)
                assert torch.isfinite(got).all().item(), f"non-finite chain at {where}"
                same_bits("chain vs eager chain", got, want, where)


def main_shape_update(checks, dev, sched, gen):
    """The update kernel against the eager step at the main path's 4.8 M
    rows, where the grid-stride loop takes ~9 passes of the grid: both
    ``use_gx_directly`` arms, a step and the final one, 16-byte aligned, and
    three rows more one float into each buffer (the scalar loop); bit for
    bit. A case is ("update main", offset)."""
    from upgdm_tpu_torch.ops.diffusion import schedule_on
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import chain_table, nsdiff_chain_update

    table, sched_dev = chain_table(sched, dev), schedule_on(sched, dev)
    with torch.no_grad():
        for M, offset in ((M_MAIN, 0), (M_MAIN + 3, 1)):
            y, ytm, gx, eps, sig, z = update_operands(M, 1, offset, gen, dev)
            for direct in (False, True):
                for t in (7, 0):
                    zt = None if t == 0 else z
                    with checks.case(("update main", offset)):
                        same_bits("update vs eager step", nsdiff_chain_update(
                            y, ytm, gx, eps, sig, zt, table[t], direct),
                            eager_nsdiff_step(sched_dev, t, y, ytm, gx, eps, sig, zt, direct),
                            f"M={M} offset={offset} t={t} direct={direct}")
            del y, ytm, gx, eps, sig, z


def new_kernel_spills(build_log, marker="_mma_kernel"):
    """ptxas lines of the kernels whose entry names hold ``marker`` that
    report a spill."""
    bad, current = [], ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif ("spill" in line and marker in current
              and "0 bytes spill stores, 0 bytes spill loads" not in line):
            bad.append(f"{current.strip()} :: {line.strip()}")
    return bad


@pytest.fixture(scope="module")
def kernel_checks(card):
    """K1, K1's bf16-activation arm, K2, K2's bf16-activation arm, K3 and the
    posterior update, in this order: the global generator each check seeds
    and the denoisers built after it fix the later checks' inputs."""
    from upgdm_tpu_torch.models.denoise import NsDiffDenoiser, TMDMDenoiser
    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        fused_chain_rows, fused_chain_rows_reference, fused_nsdiff_chain, schedule_table,
    )
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, fused_denoiser_rows_reference,
        step_weights,
    )
    from upgdm_tpu_torch.ops.kernels.fused_tmdm import tmdm_gammas, tmdm_weights
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule

    dev, checks = card, Checks()
    # -- K1 -------------------------------------------------------------------------
    torch.manual_seed(0)
    den = NsDiffDenoiser(1, STEPS).to(dev).eval()
    W = denoiser_weights(den)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        x = step_rows("k1", M_MAIN, 1, gen, dev)
        check_step_kernel(checks, "k1", dev)
        check_series_branch(checks, "k1", dev)
        main_path_step(checks, "k1", W, denoiser_gammas(den, 7), x)
        # K1's bf16-activation arm: the twin over ragged M, widths and edge rows,
        # element by element on the same 4.8 M rows, and against the
        # float32-activation arm at the JAX package's bars
        g7, kw16 = denoiser_gammas(den, 7), step_weights(W, torch.bfloat16)
        act16 = dict(matmul_dtype="bfloat16", act_dtype="bfloat16")
        check_step_kernel(checks, "k1", dev, act="bfloat16")
        where = f"the main path's {M_MAIN} rows"
        with checks.case(("k1", "act main")):
            got = fused_denoiser_rows(x, g7, kw16, **act16)
            want = fused_denoiser_rows_reference(x, g7, W, **act16)
            worst_err("K1 act bf16", got, want, TOL["bfloat16"], where)
            f32 = fused_denoiser_rows(x, g7, kw16, matmul_dtype="bfloat16")
            for name, a, b, c in zip(("eps", "sigma"), got, want, f32):
                arms_apart(f"K1 {name}", a, b, c, where)
            del want
            d_eps = (got[0] - f32[0]).abs().max().item()
            d_sig = ((got[1] - f32[1]).abs() / f32[1].abs()).max().item()
            assert 0 < d_eps < ACT_EPS_ABS and 0 < d_sig < ACT_SIGMA_REL, (
                f"K1 act bf16 vs float32 act: eps {d_eps}, sigma {d_sig}")
            del got, f32
        del x

    # -- K2 -------------------------------------------------------------------------
    sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
    tab = torch.as_tensor(schedule_table(sched), device=dev)
    tables = tuple(e.detach() for e in (den.lin1.embed, den.lin2.embed, den.lin3.embed))
    bar16 = check_chain_kernel(checks, dev)
    with torch.no_grad():
        # the main path's own denoiser: noise-free bf16 chain within 5e-2 of the
        # mean |y_0| (a sanity bar beside check_chain_kernel's derived one)
        y0, gx = chain_rows(65537, 1, gen, dev)
        with checks.case(("k2", "main denoiser")):
            got = fused_chain_rows(y0, gx, tab, 0, tables, W, STEPS, noise_mode="zero")
            want = fused_chain_rows_reference(y0, gx, tab, tables, W, STEPS, noise_mode="zero")
            rel = ((got - want).abs().max() / want.abs().mean()).item()
            assert rel <= 5e-2, f"bf16 zero-noise chain off by {rel} of mean |y0|"
        # Philox ensemble vs the twin's torch.Generator ensemble: MPV within 1%
        yb = (torch.randn(CHUNK * NODE, PRED_LEN, 1, generator=gen, device=dev) * 0.3 + 1.0)
        gb = torch.rand(CHUNK * NODE, PRED_LEN, 1, generator=gen, device=dev) * 0.5 + 0.05
        ens_k = fused_nsdiff_chain(den, yb, gb, sched, seed=5, n_z_samples=N_Z)
        y0r = yb[None].expand(N_Z, -1, -1, -1).reshape(-1, 1).contiguous()
        gxr = gb[None].expand(N_Z, -1, -1, -1).reshape(-1, 1).contiguous()
        tgen = torch.Generator(device=dev).manual_seed(5)
        mpv_k = ens_k.var(dim=-1, correction=0).mean().item()
        with checks.case(("k2", "Philox MPV")):
            ens_p = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS, generator=tgen)
            ens_p = ens_p.reshape(N_Z, CHUNK * NODE, PRED_LEN, 1).permute(1, 2, 3, 0)
            mpv_p = ens_p.var(dim=-1, correction=0).mean().item()
            mpv_rel = abs(mpv_k - mpv_p) / mpv_p
            assert mpv_rel <= 0.01, f"Philox MPV {mpv_k} vs twin {mpv_p}: {mpv_rel:.4%}"
            del ens_p
        # bf16 arm against the float32 arm, same seed (the same normals): chunk
        # MPV within 1%, the bar of the K1 chain's two arms
        with checks.case(("k2", "arms MPV")):
            ens_32 = fused_nsdiff_chain(den, yb, gb, sched, seed=5, n_z_samples=N_Z,
                                        matmul_dtype="float32")
            mpv_32 = ens_32.var(dim=-1, correction=0).mean().item()
            mpv_rel_arms = abs(mpv_k - mpv_32) / mpv_32
            assert mpv_rel_arms <= 0.01, (
                f"bf16 K2 MPV {mpv_k} vs float32 K2 {mpv_32}: {mpv_rel_arms:.4%}")
            del ens_32
        del ens_k
        # the main path's own 4.8 M rows, element by element: noise-free in both
        # matmul types at check_chain_kernel's bars, then the float32 arm per
        # sample on the same Philox normals
        quiet = {"noise_mode": "zero"}
        for key, mm, kw, rtol, atol in (
                ("float32", "float32", quiet, CHAIN_F32["rtol"], CHAIN_F32["atol"]),
                ("bfloat16", "bfloat16", quiet, 0.0, bar16),
                ("float32_noise", "float32", {}, CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"])):
            with checks.case(("k2", "main", key)):
                got = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, matmul_dtype=mm, **kw)
                want = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS,
                                                  matmul_dtype=mm, noise="philox", seed=5, **kw)
                assert torch.isfinite(got).all().item(), f"non-finite {key} chain at {M_MAIN} rows"
                over = off_by(got, want, rtol, atol)
                assert over <= 0, (f"{key} chain off rtol {rtol} / atol {atol} by {over} "
                                   f"at the main path's {M_MAIN} rows")
                del got, want

        # K2's bf16-activation arm in both matmul types: the twin over ragged M,
        # widths, use_gx_directly and with Philox noise, and element by element
        # noise-free on the 4.8 M rows
        check_chain_kernel(checks, dev, seed=7, act="bfloat16")
        for mm in ("float32", "bfloat16"):
            where = f"{mm} at the main path's {M_MAIN} rows"
            with checks.case(("k2", "act main", mm)):
                kwa = dict(matmul_dtype=mm, act_dtype="bfloat16")
                got = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, noise_mode="zero",
                                       **kwa)
                want = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS,
                                                  noise_mode="zero", **kwa)
                over = off_by(got, want, 0.0, bar16)
                assert torch.isfinite(got).all().item() and over <= 0, (
                    f"act bf16 chain off {bar16} by {over}, {where}")
                f32 = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, matmul_dtype=mm,
                                       noise_mode="zero")
                arms_apart(f"K2 {mm}", got, want, f32, where)
                del got, want, f32
        del y0r, gxr

    # -- K3 -------------------------------------------------------------------------
    with torch.no_grad():
        tden = TMDMDenoiser(1, T_STEPS + 1).to(dev).eval()
        x = step_rows("k3", M_TMDM, 1, gen, dev)
        check_step_kernel(checks, "k3", dev)
        check_series_branch(checks, "k3", dev)
        main_path_step(checks, "k3", tmdm_weights(tden), tmdm_gammas(tden, 50), x)
        del x

    # -- the posterior update -------------------------------------------------------------
    check_chain_update_kernel(checks, dev)
    main_shape_update(checks, dev, sched, gen)
    return checks


@pytest.fixture(scope="module")
def attention_checks(card):
    """The attention kernel against its twin at every call of ATTN_CALLS and
    variant (a case is ("attention", E, call, variant)) and of ATTN_LONG
    (("attention", E, call)), each one launch and no fallback, its output
    contiguous; a query layout 4 bytes off 16 (("attention", "layout"));
    then f(x) of a sweep chunk at the bench geometry (("attention",
    "chunk")) and at the SLBP grid's W/P 200/200 (("attention", "w200")), 8
    launches and no fallback, against the same f(x) on the twin; then two
    train steps, which never launch it (("attention", "train"))."""
    from upgdm_tpu_torch.models.attention import DSAttention
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels.ds_attention import (
        ds_attention, ds_attention_reference, max_keys,
    )
    from upgdm_tpu_torch.utils.profiling import counters

    dev, checks = card, Checks()
    gen = torch.Generator(device=dev).manual_seed(11)

    def tally():
        c = counters()
        return c.get("ds_attention.launches", 0), c.get("ds_attention.fallbacks", 0)

    def operands(B, H, E, L, S):
        """q, k, v as views of [B, *, H E] (AttentionLayer's layout), tau, delta."""
        q = torch.randn(B, L, H * E, generator=gen, device=dev).view(B, L, H, E)
        k, v = (torch.randn(B, S, H * E, generator=gen, device=dev).view(B, S, H, E)
                for _ in range(2))
        return (q, k, v, torch.rand(B, 1, generator=gen, device=dev) + 0.5,
                torch.randn(B, S, generator=gen, device=dev))

    def held(q, k, v, t, d, causal, where):
        before = tally()
        got = ds_attention(q, k, v, t, d, causal)
        ran = tuple(a - b for a, b in zip(tally(), before))
        assert ran == (1, 0), f"(launches, fallbacks) {ran}, expected (1, 0)"
        assert got.shape == q.shape and got.is_contiguous()
        err = (got - ds_attention_reference(q, k, v, t, d, causal)).abs().max()
        assert torch.isfinite(got).all().item() and err.item() <= ATTN_ATOL, (
            f"off its twin by {err.item()} > {ATTN_ATOL} at {where}")

    def fx_held(param, x):
        """f(x) with the kernel: ATTN_CALLS_A_CHUNK launches, no fallback,
        within FX_TOL of f(x) on the twin; g(x) unmoved."""
        model = NsDiffModel(param, seed=0, device=dev)
        before = tally()
        y_k, g_k = model.f_and_g(x)
        ran = tuple(a - b for a, b in zip(tally(), before))
        assert ran == (ATTN_CALLS_A_CHUNK, 0), (
            f"f(x): (launches, fallbacks) {ran}, expected ({ATTN_CALLS_A_CHUNK}, 0)")
        for m in model.net.modules():
            if isinstance(m, DSAttention):
                m.use_kernel = False
        y_p, g_p = model.f_and_g(x)
        ran = tuple(a - b for a, b in zip(tally(), before))
        assert ran == (ATTN_CALLS_A_CHUNK, ATTN_CALLS_A_CHUNK), f"forced twin: {ran}"
        assert torch.equal(g_k, g_p), "g(x) moved with f(x)'s attention"
        over = off_by(y_k, y_p, FX_TOL, FX_TOL)
        assert over <= 0, f"f(x) with the kernel off the twin's by {over} over {FX_TOL}"

    with torch.no_grad():
        for E, (B, H) in ATTN_HEADS.items():
            for name, L, S, causal in ATTN_CALLS:
                q, k, v, tau, delta = operands(B, H, E, L, S)
                for variant, (use_tau, use_delta) in ATTN_VARIANTS.items():
                    t, d = tau if use_tau else None, delta if use_delta else None
                    with checks.case(("attention", E, name, variant)):
                        held(q, k, v, t, d, causal, f"E {E} {name} {variant}")
                del q, k, v

        for E, B, H, name, L, S, causal in ATTN_LONG:
            with checks.case(("attention", E, name)):
                S = S or max_keys(E)
                held(*operands(B, H, E, L, S), causal, f"E {E} {name} (L {L}, S {S})")

        with checks.case(("attention", "layout")):
            q, k, v, tau, delta = operands(60, 8, 64, 100, 100)
            flat = torch.empty(q.numel() + 1, device=dev)[1:]
            flat.copy_(q.reshape(-1))
            held(flat.view(q.shape), k, v, tau, delta, False, "a query layout 4 bytes off 16")
            del q, k, v, flat

        with checks.case(("attention", "chunk")):
            fx_held(NET_PARAM, torch.as_tensor(make_windows(CHUNK).reshape(-1, WINDOWS, 1),
                                               device=dev))

        with checks.case(("attention", "w200")):
            x = torch.randn(SLBP_SERIES, 200, 2, generator=gen, device=dev) * 0.3 + 1.0
            fx_held(SLBP_PARAM, x)

    with checks.case(("attention", "train")):
        rng = np.random.default_rng(3)
        batch = torch.as_tensor(rng.normal(size=(TRAIN_B, WINDOWS + PRED_LEN, 1)),
                                dtype=torch.float32, device=dev)
        before = tally()
        losses = train_losses(NsDiffModel(TRAIN_PARAM, seed=0, device=dev), None, batch, n=2)
        assert all(np.isfinite(losses)), f"train losses {losses}"
        assert tally()[0] == before[0], f"a train step launched it {tally()[0] - before[0]} times"
        assert tally()[1] > before[1], "a train step's attention counted no fallback"
    return checks


def case_id(key):
    return "-".join(str(p) for p in key).replace(" ", "_")


STEP_CASES = ([(w, "float32", F, c, mm) for w in ("k1", "k3") for F in WIDTHS for c in CASES
               for mm in TOL]
              + [("k1", "bfloat16", F, c, "bfloat16") for F in WIDTHS for c in CASES])
CHAIN_CASES = ([("k2", "float32", N_STEPS, F, mm) for F in WIDTHS for mm in TOL]
               + [("k2", "float32", 100, 1, mm) for mm in TOL]
               + [("k2", "bfloat16", N_STEPS, F, mm) for F in WIDTHS for mm in TOL]
               + [("k2", "float32", F, what) for F in WIDTHS
                  for what in ("Philox float32", "bf16 noise stream", "launch shapes float32",
                               "launch shapes bfloat16", "bf16 vs the K1 chain")]
               + [("k2", "bfloat16", F, f"Philox {mm}") for F in WIDTHS for mm in TOL])
MAIN_CASES = ([(w, "main", mm) for w in ("k1", "k3") for mm in TOL]
              + [("k1", "act main"), ("k2", "main denoiser"), ("k2", "Philox MPV"),
                 ("k2", "arms MPV")]
              + [("k2", "main", k) for k in ("float32", "bfloat16", "float32_noise")]
              + [("k2", "act main", mm) for mm in TOL])
UPDATE_CASES = ([("update", name, M, F, off) for name, _, _ in UPDATE_SCHEDULES
                 for M, F, off in UPDATE_SHAPES]
                + [("update chain", name) for name in UPDATE_CHAINS]
                + [("update main", off) for off in (0, 1)])


@pytest.mark.card
def test_no_spill_in_the_tensor_core_kernels(card, tmp_path, monkeypatch):
    from upgdm_tpu_torch.ops.kernels import _build

    _build.load_library()
    if not _build.build_log:  # a library built by an earlier process: build again to read ptxas
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        _build.build_library()
    assert "Compiling entry function" in _build.build_log
    spills = new_kernel_spills(_build.build_log)
    assert not spills, f"register spills in the tensor-core kernels: {spills}"


ATTENTION_CASES = ([("attention", E, name, variant) for E in ATTN_HEADS for name, *_ in ATTN_CALLS
                    for variant in ATTN_VARIANTS]
                   + [("attention", E, name) for E, _, _, name, *_ in ATTN_LONG]
                   + [("attention", w) for w in ("layout", "chunk", "w200", "train")])


@pytest.mark.card
def test_no_spill_in_the_attention_kernel(card, tmp_path, monkeypatch):
    from upgdm_tpu_torch.ops.kernels import _build

    _build.load_library()
    if not _build.build_log:  # a library built by an earlier process: build again to read ptxas
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        _build.build_library()
    assert "ds_attention_kernel" in _build.build_log
    assert "ds_attention_long_kernel" in _build.build_log
    spills = new_kernel_spills(_build.build_log, "ds_attention")
    assert not spills, f"register spills in the attention kernel: {spills}"


@pytest.mark.card
@pytest.mark.parametrize("key", ATTENTION_CASES, ids=case_id)
def test_attention_kernel_against_its_twin(attention_checks, key):
    attention_checks.held(key)


@pytest.mark.card
@pytest.mark.parametrize("key", STEP_CASES, ids=case_id)
def test_step_kernel_against_its_twin(kernel_checks, key):
    kernel_checks.held(key)


@pytest.mark.card
@pytest.mark.parametrize("key", [("series", w, F) for w in ("k1", "k3") for F in WIDTHS], ids=case_id)
def test_series_branch_of_the_bf16_softplus(kernel_checks, key):
    kernel_checks.held(key)


@pytest.mark.card
@pytest.mark.parametrize("key", CHAIN_CASES, ids=case_id)
def test_chain_kernel_against_its_twin(kernel_checks, key):
    kernel_checks.held(key)


@pytest.mark.card
@pytest.mark.parametrize("key", MAIN_CASES, ids=case_id)
def test_kernels_at_the_main_paths_rows(kernel_checks, key):
    kernel_checks.held(key)


@pytest.mark.card
@pytest.mark.parametrize("key", UPDATE_CASES, ids=case_id)
def test_chain_update_bit_for_bit(kernel_checks, key):
    kernel_checks.held(key)
