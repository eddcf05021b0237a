#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (upgdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--kernels]

Builds the port's three CUDA kernels from ``upgdm_tpu_torch/csrc/`` (into
``build/kernels/``) and fails on a register spill in the tensor-core kernels,
holds each kernel against its plain PyTorch twin on the card (K1 and K3 over
ragged row counts, feature widths 1, 2 and 4, edge-case rows and, element by
element, at the sweeps' own row counts in both matmul types; K2 over the same
row counts and widths with and without ``use_gx_directly``, noise-free in both
matmul types and per sample on its own Philox normals, against a chain of K1
launches, at 100 steps, at two launch shapes and, element by element, at the
sweep's own row count), drives the NsDiff sampling-MPV sweep at the bench geometry (``bench.py``: Node 30,
W/P 100/100, 20 steps, 100 samples, d_model 512, e4/d2) and the TMDM
sampling-MPV sweep at the model-comparison geometry (Node 30, W/P 100/100,
label 50, 100 steps, 100 samples, d_model 64, e2/d1) through the port's entry
points, holds each sweep's bf16 kernel chain to its float32 kernel chain at
the MPV level, runs the cache-first evaluation runner, and checks the trained
SIS model of ``demo_fig1``. Then training: the train step of every NsDiff
stage at the train-bench geometry (``bench_train.py``: B 64, W/P 100/100,
d_model 512, e4/d2) and of TMDM at its model-comparison geometry, timed in
float32 and ``train_dtype="bfloat16"``, with the card's loss and gradients
held to the port's CPU run on one batch; the demo's three-stage protocol
(``examples/slbp_demo.py``) on the committed SLBP trajectory through
``run_training``, each stage's score held to the committed JAX record; and
the checkpoint it wrote swept through K1. Every phase that fails exits
non-zero. Progress goes to
stdout as JSON lines; the line before the last holds the kernel table, the
last line is ``{"ok": true, "device": {...}}``. ``--kernels`` stops after the
kernel phases (build, K1, K2, K3 with their times): the short loop for work on
a kernel.

Imports nothing of JAX or of the JAX package.
"""
import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# bench geometry (bench.py:34-56)
NODE, WINDOWS, PRED_LEN, STEPS, N_Z = 30, 100, 100, 20, 100
N_WINDOWS, CHUNK = 64, 16
NET_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, rolling_length=50,
    diffusion_steps=STEPS, scaler_type="StandardScaler", d_model=512, n_heads=8,
    e_layers=4, d_layers=2, d_ff=256, p_hidden_dims=[64, 64], p_hidden_layers=2,
    n_z_samples=N_Z, task_model="NsDiff", diffusion_schedule="linear",
    beta_start=1e-4, beta_end=2e-2, activation="gelu",
)
M_MAIN = N_Z * CHUNK * NODE * PRED_LEN  # rows per denoiser call on the main path: 4.8 M

# TMDM geometry (benchmarks/ab_tmdm.py:48-53 and the demo_zoo TMDM yaml)
T_STEPS, T_LABEL, T_WINDOWS, T_CHUNK = 100, 50, 16, 8
TMDM_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, label_len=T_LABEL,
    diffusion_steps=T_STEPS, scaler_type="StandardScaler", d_model=64, n_heads=4,
    e_layers=2, d_layers=1, d_ff=128, p_hidden_dims=[64, 64], p_hidden_layers=2,
    n_z_samples=N_Z, task_model="TMDM", beta_schedule="linear", beta_start=1e-4,
    beta_end=2e-2, activation="gelu",
)
M_TMDM = N_Z * T_CHUNK * NODE * (T_LABEL + PRED_LEN)  # rows per K3 call: 3.6 M

# NsDiff train-bench geometry (bench_train.py:33-38) and TMDM's above, B 64
TRAIN_B, TRAIN_REPS = 64, 10
TRAIN_PARAM = dict(NET_PARAM, scaler_type=None, dropout=0.05)
TMDM_TRAIN_PARAM = dict(TMDM_PARAM, scaler_type=None, dropout=0.05)
# card against CPU on one batch, dropout off: float32 on both sides, sums in
# another order through the transformer and back. The attention key biases
# have a zero gradient in exact arithmetic (a shift shared by a query's
# scores leaves the softmax unchanged): only rounding is left in them, held
# below TRAIN_GRAD_ZERO of the model's largest gradient on both sides
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_ZERO = 1e-4, 1e-3, 1e-6

# the demo's protocol (examples/slbp_demo.py:69-130) and its committed records
DEMO = REPO / "demo_artifacts"
DEMO_EPOCHS, DEMO_BAR = 30, 0.25
DEMO_STAGES = (("pretrain_f", "pre_model_F"), ("pretrain_g", "pre_model_G"),
               ("NsDiff_model", "nsdiff"))

SIS_MODEL = REPO / "demo_fig1/ews_results/model_compare/NsDiff/SIS"
SIS_DATA = REPO / "demo_fig1/spdata_sde_SIS/barabasi_albert_12_0/SIS_dynamic_eta0.0001d0.5_increase.pt"


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(phase, msg):
    emit(phase=phase, failed=msg)
    sys.exit(1)


def require(ok, phase, msg):
    if not ok:
        fail(phase, msg)


def make_windows(n_windows):
    """bench.py::make_windows's recipe: [n, Node, W, F] float32."""
    import numpy as np

    rng = np.random.default_rng(0)
    T = WINDOWS + (n_windows - 1) * 5 + 1
    traj = (rng.normal(size=(NODE, T, 1)) * 0.05).astype(np.float32)
    traj += np.linspace(0.5, 1.5, T, dtype=np.float32)[None, :, None]
    idx = (np.arange(n_windows) * 5)[:, None] + np.arange(WINDOWS)[None, :]
    return np.ascontiguousarray(traj[:, idx, :].transpose(1, 0, 2, 3))


def host_s(fn):
    """Host wall time of fn() ended by a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


# -- the step kernels K1 and K3 against their twins ------------------------------
# bf16 bar: kernel and twin round the same operands to bf16 and sum exact
# products in float32 in different orders, and the tensor-core arm's softplus
# is good to ~3e-5 relative; an activation within that of a bf16 rounding
# boundary rounds the other way (a 2^-8 relative step in one of 128 terms),
# so the bf16 arm is held to 2e-3 and the float32 arm to 2e-5.
TOL = {"float32": 2e-5, "bfloat16": 2e-3}
RAGGED_M = (1, 63, 64, 65, 65536, 65537)
WIDTHS = (1, 2, 4)
CASES = ("random", "below", "above")
N_STEPS = 20
GATE_STEPS = (0, 7, N_STEPS - 1)
# bar of check_series_branch, relative: see there
SERIES_RTOL = 1e-3


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    import torch

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
    import torch

    x = torch.randn(M, 2 * Fdim, generator=gen, device=dev)
    if which == "k1":
        x = torch.cat([x, torch.rand(M, Fdim, generator=gen, device=dev) * 0.95 + 0.05], dim=1)
    return x


def worst_err(name, got, want, tol, where):
    """max |got - want| over the outputs; AssertionError if an output has the
    wrong shape, is not finite or is further than `tol` from the twin's."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all().item():
            raise AssertionError(f"{name}: bad output at {where}")
        worst = max(worst, (a - b).abs().max().item())
    if worst > tol:
        raise AssertionError(f"{name}: max|err| {worst} > {tol} at {where}")
    return worst


def check_step_kernel(which, dev, seed=2):
    """K1 (``which="k1"``) or K3 (``"k3"``) against its twin over RAGGED_M x
    WIDTHS x CASES (the module's own gates at GATE_STEPS for ``random``) in
    both matmul types; returns {mm: max|err|} or raises AssertionError naming
    the first case over TOL."""
    import torch

    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_gammas, step_weights

    cls, weights_of, rows, ref, tup = step_kernel(which)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    err = {"float32": 0.0, "bfloat16": 0.0}
    with torch.no_grad():
        for Fdim in WIDTHS:
            den = cls(Fdim, N_STEPS).to(dev).eval()
            for case in CASES:
                for t in GATE_STEPS if case == "random" else (7,):
                    W, G = edge_case(which, case, weights_of(den), denoiser_gammas(den, t), gen)
                    kw = {mm: step_weights(W, getattr(torch, mm)) for mm in TOL}
                    for M in RAGGED_M:
                        x = step_rows(which, M, Fdim, gen, dev)
                        for mm in TOL:
                            got = tup(rows(x, G, kw[mm], matmul_dtype=mm))
                            want = tup(ref(x, G, W, matmul_dtype=mm))
                            err[mm] = max(err[mm], worst_err(
                                which.upper(), got, want, TOL[mm],
                                f"F={Fdim} M={M} {case} t={t} {mm}"))
    return err


def check_series_branch(which, dev, seed=4):
    """The bf16 arm's softplus on rows far below zero, held to a relative bar.

    With every pre-activation at about -14 or -20 a softplus is e = 8e-7 or
    2e-9. ``lg2(1 + e)`` alone would quantise e to the 1.2e-7 steps of 1 + e
    (and give 0 at -20), which an absolute bar on eps cannot see; the series
    branch of ``softplus_fast`` keeps e to ~3e-5 relative. The head here is
    all ones with no bias, so eps is the sum of the row's 128 activations as
    the product reads them (K1: of the normalised row). Kernel and twin then
    differ by the softplus (3e-5), by float32 sums in another order (1e-6)
    and by a bf16 rounding that falls the other way in a few of the 128 terms
    (2^-8 / 128 = 3e-5 each): held to 1e-3 relative. A build without the
    series branch is 2.3e-2 (K1) and 7.1e-2 (K3) off at -14 on the H100.
    Returns the largest relative error; AssertionError over the bar."""
    import torch

    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_gammas, step_weights

    cls, weights_of, rows, ref, tup = step_kernel(which)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    worst = 0.0
    with torch.no_grad():
        for Fdim in WIDTHS:
            den = cls(Fdim, N_STEPS).to(dev).eval()
            for bias in (14.0, 20.0):
                W, G = edge_case(which, "below", weights_of(den), denoiser_gammas(den, 7), gen,
                                 bias=bias)
                W = W[:6] + (torch.ones_like(W[6]), torch.zeros_like(W[7])) + W[8:]
                kw = step_weights(W, torch.bfloat16)
                x = step_rows(which, 65537, Fdim, gen, dev)
                got = tup(rows(x, G, kw, matmul_dtype="bfloat16"))[0]
                want = tup(ref(x, G, W, matmul_dtype="bfloat16"))[0]
                rel = ((got - want).abs() / want.abs()).max().item()
                if not rel <= SERIES_RTOL:  # also catches NaN
                    raise AssertionError(f"{which.upper()}: rows at -{bias:g}: eps off the twin "
                                         f"by {rel} relative > {SERIES_RTOL} (F={Fdim})")
                worst = max(worst, rel)
    return worst


# -- the chain kernel K2 against its twin ------------------------------------------
# float32, noise-free: the JAX package's own bar for its chain kernel
# (tests/test_chain_resident.py). With noise, per sample on the same Philox
# normals: the K1 chain's bar against the plain chain (float32 on both sides,
# sums in another order, carried through the steps).
CHAIN_F32 = {"rtol": 2e-5, "atol": 2e-6}
CHAIN_NOISE = {"rtol": 1e-4, "atol": 1e-4}


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
    import numpy as np

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
    import torch

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
    import torch

    y0 = torch.randn(M, Fdim, generator=gen, device=dev) * 0.5 + 1.0
    return y0, torch.rand(M, Fdim, generator=gen, device=dev) * 0.95 + 0.05


def off_by(got, want, rtol, atol):
    """max of |got - want| - (atol + rtol |want|): positive when over the bar."""
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def k1_chain_zero_noise(den, y0, gx, sched, mm):
    """The noise-free chain as T launches of K1 through ``nsdiff_p_sample_loop``
    (zeros through its ``noise`` seam): K2's trunk arithmetic, launch by launch."""
    import torch

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


def check_chain_kernel(dev, seed=6):
    """K2 against its twin, ``fused_chain_rows_reference``. Noise-free over
    RAGGED_M x WIDTHS x ``use_gx_directly``: float32 at CHAIN_F32, bf16 at
    TOL["bfloat16"] x ``chain_error_weight``. At 65,537 rows: the float32 arm
    with noise on against the twin on the same Philox normals, per sample at
    CHAIN_NOISE; the bf16 arm likewise with the heads fixed, so that only its
    draws and posterior arithmetic show; both arms at two launch shapes under
    one seed (shared rows bit-equal); the bf16 arm against a chain of K1
    launches at its bar; and a 100-step chain in both arms. Returns the
    largest errors; AssertionError names the first case over its bar."""
    import torch

    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        fused_chain_rows, fused_chain_rows_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    err = {"float32": 0.0, "bfloat16": 0.0, "float32_noise": 0.0, "bfloat16_noise_stream": 0.0,
           "bfloat16_vs_k1_chain": 0.0, "float32_T100": 0.0, "bfloat16_T100": 0.0}

    def held(name, key, got, want, rtol, atol, where):
        if got.shape != want.shape or not torch.isfinite(got).all().item():
            raise AssertionError(f"K2 {name}: bad output at {where}")
        over = off_by(got, want, rtol, atol)
        if over > 0:
            raise AssertionError(f"K2 {name}: off rtol {rtol} / atol {atol} by {over} at {where}")
        err[key] = max(err[key], (got - want).abs().max().item())

    with torch.no_grad():
        for T in (N_STEPS, 100):
            for Fdim in WIDTHS if T == N_STEPS else (1,):
                den, W, tables, sched, tab = chain_setup(Fdim, T, dev)
                bar16 = TOL["bfloat16"] * chain_error_weight(tab.cpu().numpy(), 1.0)
                err[f"bfloat16_bar_T{T}"] = bar16
                sfx = "" if T == N_STEPS else "_T100"
                for use_gx in (False, True):
                    for M in RAGGED_M if T == N_STEPS else (65537,):
                        y0, gx = chain_rows(M, Fdim, gen, dev)
                        where = f"F={Fdim} M={M} T={T} use_gx_directly={use_gx}"
                        for mm, rtol, atol in (("float32", CHAIN_F32["rtol"], CHAIN_F32["atol"]),
                                               ("bfloat16", 0.0, bar16)):
                            if T == 100 and mm == "float32":  # five times the steps
                                rtol, atol = CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"]
                            got = fused_chain_rows(y0, gx, tab, 0, tables, W, T, matmul_dtype=mm,
                                                   noise_mode="zero", use_gx_directly=use_gx)
                            want = fused_chain_rows_reference(
                                y0, gx, tab, tables, W, T, matmul_dtype=mm, noise_mode="zero",
                                use_gx_directly=use_gx)
                            held(f"{mm} noise-free", mm + sfx, got, want, rtol, atol, where)
                if T != N_STEPS:
                    continue
                # y0, gx: the last 65,537 rows. Noise on, per sample
                got = fused_chain_rows(y0, gx, tab, 5, tables, W, T, matmul_dtype="float32")
                want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                  matmul_dtype="float32", noise="philox", seed=5)
                held("float32 with Philox noise", "float32_noise", got, want,
                     CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"], f"F={Fdim}")
                # the bf16 arm's own draws, per sample: with W4, b4 and Ws at zero
                # eps is 0 and sigma is softplus(bs) whatever the trunk rounds, so
                # the chain is the posterior arithmetic on the normals alone
                Wz = W[:6] + (torch.zeros_like(W[6]), torch.zeros_like(W[7]),
                              torch.zeros_like(W[8]), W[9])
                got = fused_chain_rows(y0, gx, tab, 5, tables, Wz, T)
                want = fused_chain_rows_reference(y0, gx, tab, tables, Wz, T, noise="philox",
                                                  seed=5)
                held("bf16 noise stream", "bfloat16_noise_stream", got, want,
                     CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"], f"F={Fdim}")
                # one seed, two launch shapes: the rows they share are equal
                for mm in TOL:
                    full = fused_chain_rows(y0, gx, tab, 5, tables, W, T, matmul_dtype=mm)
                    part = fused_chain_rows(y0[:1000].contiguous(), gx[:1000].contiguous(), tab,
                                            5, tables, W, T, matmul_dtype=mm)
                    if not torch.equal(full[:1000], part):
                        raise AssertionError(f"K2 {mm}: seed 5 gives other rows at M=1000 than "
                                             f"at M=65537 (F={Fdim})")
                got = fused_chain_rows(y0, gx, tab, 0, tables, W, T, noise_mode="zero")
                want = k1_chain_zero_noise(den, y0, gx, sched, "bfloat16")
                held("bf16 against the K1 chain", "bfloat16_vs_k1_chain", got, want, 0.0, bar16,
                     f"F={Fdim}")
    return err


# -- training ------------------------------------------------------------------------
def train_step_ms(model, select, batch, dtype):
    """(median ms of a train step by CUDA events over TRAIN_REPS steps after
    two of warm-up, the losses) for one stage in float32 or bf16."""
    import torch

    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    model.net_param["train_dtype"] = dtype
    opt = make_optimizer({"optimizer_name": "Adam", "lr": 1e-3}, model.net,
                         model.trainable_mask(select))
    step = make_train_step(model, opt, select)
    losses = [step(batch) for _ in range(2)]
    times = []
    for _ in range(TRAIN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), losses


def train_step_split(model, select, batch, dtype, reps=3, profiled=2):
    """Where a train step's time goes: host ms of its forward (the loss),
    backward and optimizer step, each ended by a synchronise (medians over
    ``reps`` steps after two), and, by ``torch.profiler`` (device activity
    only) over ``profiled`` unsynchronised steps, the device's summed kernel
    time and the kernels a step (None when the profiler sees no device
    activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    model.net_param["train_dtype"] = dtype
    opt = make_optimizer({"optimizer_name": "Adam", "lr": 1e-3}, model.net,
                         model.trainable_mask(select))
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(reps + 2):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.autocast(model.device.type, dtype=torch.bfloat16, enabled=dtype != "float32"):
            loss = model.loss_fn(batch, select=select, train=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.float().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    out = {k: statistics.median(v[2:]) for k, v in parts.items()}
    step = make_train_step(model, opt, select)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step(batch)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_ms_per_step"] = (sum(e.time_range.elapsed_us() for e in kernels)
                                 / (1e3 * profiled) if kernels else None)
    out["kernels_per_step"] = len(kernels) / profiled if kernels else None
    return out


def card_vs_cpu(card_model, cls, net_param, batch, seams):
    """The loss and gradients of ``card_model`` on one batch against the
    port's CPU run on the same weights and draws, dropout off. Returns
    (loss rel err, worst leaf err / its bar); AssertionError over a bar."""
    import numpy as np
    import torch

    from upgdm_tpu_torch.utils.weights import flax_flat_from_torch

    cpu = cls(net_param, device="cpu")
    cpu.load_state_dict(card_model.state_dict(), strict=True)
    out = []
    for m in (card_model, cpu):
        m.net.zero_grad(set_to_none=True)
        m.net.requires_grad_(True)
        kw = {k: v.to(m.device) if torch.is_tensor(v) else v for k, v in seams.items()}
        loss = m.loss_fn(batch.to(m.device), train=False, **kw)
        loss.backward()
        out.append((loss.item(), flax_flat_from_torch({
            k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in m.net.named_parameters()})))
    (l_card, g_card), (l_cpu, g_cpu) = out
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"loss on the card {l_card} vs CPU {l_cpu}: {rel} relative")
    top = max(np.abs(g).max() for g in g_cpu.values())
    worst = 0.0
    for k, g in g_cpu.items():
        if k.endswith(".key.bias"):
            size = float(max(np.abs(g).max(), np.abs(g_card[k]).max()))
            if not size <= TRAIN_GRAD_ZERO * top:
                raise AssertionError(f"gradient {k}: {size}, not zero beside {top}")
            continue
        bar = float(TRAIN_GRAD_REL * np.abs(g).max())
        err = float(np.abs(g_card[k] - g).max())
        if not err <= bar:
            raise AssertionError(f"gradient {k}: card off the CPU by {err} > {bar}")
        if bar:  # zero only where the loss does not read the leaf (TMDM's x embedding)
            worst = max(worst, err / bar)
    return rel, worst


def demo_split():
    """The demo's dataset and split: default_rng(0) permutation, n_train a
    multiple of 32 of 90% (examples/slbp_demo.py:75-84)."""
    import numpy as np

    from upgdm_tpu_torch.utils.data_prep import pre_dataset_timeseries

    dataset_param = dict(file_path=str(DEMO / "slbp_data"), filter="*", sampling_t=100,
                         windows=100, pred_len=100, interval_step=20, STG_exist=False)
    dataset = pre_dataset_timeseries(**dataset_param)
    n_train = (int(len(dataset) * 0.9) // 32) * 32
    perm = np.random.default_rng(0).permutation(len(dataset))
    return dataset[perm[:n_train]], dataset[perm[n_train:]], dataset_param


def new_kernel_spills(build_log):
    """ptxas lines of the tensor-core kernels that report a spill."""
    bad, current = [], ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif ("spill" in line and "_mma_kernel" in current
              and "0 bytes spill stores, 0 bytes spill loads" not in line):
            bad.append(f"{current.strip()} :: {line.strip()}")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one card.")
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel phases (build, K1, K2, K3)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not (REPO / "upgdm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    import numpy as np

    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.eval.uncertainty import (
        fast_mpv_sweep, load_dynamic_data, load_model_from_dir, mpv_reduce,
        run_evaluation_cache,
    )
    from upgdm_tpu_torch.models.denoise import NsDiffDenoiser, TMDMDenoiser
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels import _build
    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        chain_operands, fused_chain_rows, fused_chain_rows_reference, fused_nsdiff_chain,
        schedule_table,
    )
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, step_weights,
    )
    from upgdm_tpu_torch.ops.kernels.fused_tmdm import fused_tmdm_rows, tmdm_gammas, tmdm_weights
    from upgdm_tpu_torch.ops.kernels.roofline import bound_ms, k1_work, k2_work, k3_work
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
    from upgdm_tpu_torch.utils.io import load_tensor_list
    from upgdm_tpu_torch.ops.windows import sample_time_series, sliding_windows
    from upgdm_tpu_torch.utils.io import read_model_config

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # -- 1. device ------------------------------------------------------------
    def nvidia_smi(fields, fmt="csv,noheader"):
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        return out.splitlines()[0] if out else ""

    smi_line = nvidia_smi("name,power.limit") or f"{card}, power limit not reported"
    print(smi_line, flush=True)
    # the special-function term of the kernels' bounds runs at the SM clock
    clock = nvidia_smi("clocks.max.sm", "csv,noheader,nounits")
    require(clock.strip().isdigit(), "device", f"nvidia-smi gave no clocks.max.sm: {clock!r}")
    sm_clock_hz = float(clock) * 1e6
    emit(phase="device", card=card, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         sm_clock_mhz=float(clock), torch=torch.__version__, cuda=torch.version.cuda)

    def bound(work, mm):
        return bound_ms(*work, mm, sm_clock_hz)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit(phase="build", card=smi_line, seconds=time.perf_counter() - t0, library=lib_path.name, ptxas=ptxas)
    spills = new_kernel_spills(_build.build_log)
    require(not spills, "build", f"register spills in the tensor-core kernels: {spills}")

    def step_phase(which, weights, g, x):
        """One step kernel's phase: the twin over ragged M, widths and edge
        rows, the series branch, then wrapper against twin element by element
        on the main path's x in both matmul types, and the times of both."""
        _, _, rows, ref, tup = step_kernel(which)
        try:
            err = check_step_kernel(which, dev)
            series_rel = check_series_branch(which, dev)
            ms, plain_ms = {}, {}
            for mm in TOL:
                kw = step_weights(weights, getattr(torch, mm))
                got = tup(rows(x, g, kw, matmul_dtype=mm))
                want = tup(ref(x, g, weights, matmul_dtype=mm))
                err[mm] = max(err[mm], worst_err(which.upper(), got, want, TOL[mm],
                                                 f"the main path's {x.shape[0]} rows, {mm}"))
                del got, want
                ms[mm] = cuda_ms(lambda: rows(x, g, kw, matmul_dtype=mm))
                plain_ms[mm] = cuda_ms(lambda: ref(x, g, weights, matmul_dtype=mm))
        except AssertionError as exc:
            fail(which, str(exc))
        return err, series_rel, ms, plain_ms

    # -- 3. K1 against its plain twin ------------------------------------------
    torch.manual_seed(0)
    den = NsDiffDenoiser(1, STEPS).to(dev).eval()
    W = denoiser_weights(den)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        x = step_rows("k1", M_MAIN, 1, gen, dev)
        k1_err, k1_series, k1_ms, k1_plain_ms = step_phase("k1", W, denoiser_gammas(den, 7), x)
        del x
    k1_bound = {mm: bound(k1_work(M_MAIN), mm) for mm in TOL}
    emit(phase="k1", card=smi_line, max_abs_err=k1_err, tol=TOL, series_rel_err=k1_series,
         series_rtol=SERIES_RTOL, rows=M_MAIN, ms=k1_ms, plain_ms=k1_plain_ms,
         bound_ms={k: v[0] for k, v in k1_bound.items()},
         bound_by={k: v[1] for k, v in k1_bound.items()})

    # -- 4. K2 against its plain twin ------------------------------------------
    sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
    tab = torch.as_tensor(schedule_table(sched), device=dev)
    tables = tuple(e.detach() for e in (den.lin1.embed, den.lin2.embed, den.lin3.embed))
    try:
        k2_err = check_chain_kernel(dev)
    except AssertionError as exc:
        fail("k2", str(exc))
    with torch.no_grad():
        # the main path's own denoiser: noise-free bf16 chain within 5e-2 of the
        # mean |y_0| (a sanity bar beside check_chain_kernel's derived one)
        y0, gx = chain_rows(65537, 1, gen, dev)
        got = fused_chain_rows(y0, gx, tab, 0, tables, W, STEPS, noise_mode="zero")
        want = fused_chain_rows_reference(y0, gx, tab, tables, W, STEPS, noise_mode="zero")
        rel = ((got - want).abs().max() / want.abs().mean()).item()
        k2_err["bfloat16_rel"] = rel
        require(rel <= 5e-2, "k2", f"bf16 zero-noise chain off by {rel} of mean |y0|")
        # Philox ensemble vs the twin's torch.Generator ensemble: MPV within 1%
        yb = (torch.randn(CHUNK * NODE, PRED_LEN, 1, generator=gen, device=dev) * 0.3 + 1.0)
        gb = torch.rand(CHUNK * NODE, PRED_LEN, 1, generator=gen, device=dev) * 0.5 + 0.05
        ens_k = fused_nsdiff_chain(den, yb, gb, sched, seed=5, n_z_samples=N_Z)
        y0r = yb[None].expand(N_Z, -1, -1, -1).reshape(-1, 1).contiguous()
        gxr = gb[None].expand(N_Z, -1, -1, -1).reshape(-1, 1).contiguous()
        tgen = torch.Generator(device=dev).manual_seed(5)
        ens_p = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS, generator=tgen)
        ens_p = ens_p.reshape(N_Z, CHUNK * NODE, PRED_LEN, 1).permute(1, 2, 3, 0)
        mpv_k = ens_k.var(dim=-1, correction=0).mean().item()
        mpv_p = ens_p.var(dim=-1, correction=0).mean().item()
        mpv_rel = abs(mpv_k - mpv_p) / mpv_p
        require(mpv_rel <= 0.01, "k2", f"Philox MPV {mpv_k} vs twin {mpv_p}: {mpv_rel:.4%}")
        # bf16 arm against the float32 arm, same seed (the same normals): chunk
        # MPV within 1%, the bar of the K1 chain's two arms
        ens_32 = fused_nsdiff_chain(den, yb, gb, sched, seed=5, n_z_samples=N_Z,
                                    matmul_dtype="float32")
        mpv_32 = ens_32.var(dim=-1, correction=0).mean().item()
        mpv_rel_arms = abs(mpv_k - mpv_32) / mpv_32
        require(mpv_rel_arms <= 0.01, "k2",
                f"bf16 K2 MPV {mpv_k} vs float32 K2 {mpv_32}: {mpv_rel_arms:.4%}")
        del ens_p, ens_k, ens_32
        # the main path's own 4.8 M rows, element by element: noise-free in both
        # matmul types at check_chain_kernel's bars, then the float32 arm per
        # sample on the same Philox normals
        bar16 = k2_err[f"bfloat16_bar_T{STEPS}"]
        quiet = {"noise_mode": "zero"}
        for key, mm, kw, rtol, atol in (
                ("float32", "float32", quiet, CHAIN_F32["rtol"], CHAIN_F32["atol"]),
                ("bfloat16", "bfloat16", quiet, 0.0, bar16),
                ("float32_noise", "float32", {}, CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"])):
            got = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, matmul_dtype=mm, **kw)
            want = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS, matmul_dtype=mm,
                                              noise="philox", seed=5, **kw)
            require(torch.isfinite(got).all().item(), "k2",
                    f"non-finite {key} chain at {M_MAIN} rows")
            over = off_by(got, want, rtol, atol)
            require(over <= 0, "k2", f"{key} chain off rtol {rtol} / atol {atol} by {over} "
                    f"at the main path's {M_MAIN} rows")
            k2_err[key] = max(k2_err[key], (got - want).abs().max().item())
            del got, want
        k2_ms, k2_plain_ms, k2_bound = {}, {}, {}
        for mm in ("float32", "bfloat16"):
            ops = chain_operands(tables, W, getattr(torch, mm))  # laid out once
            call = lambda: fused_chain_rows(y0r, gxr, tab, 5, *ops, STEPS, matmul_dtype=mm)
            # ten timed calls where a call takes under 0.1 s, else three (the
            # float32 arm takes ~0.5 s, the twins ~1 s)
            t_one, _ = host_s(call)
            k2_ms[mm] = cuda_ms(call, reps=10 if t_one < 0.1 else 3, warmup=1)
            k2_plain_ms[mm] = cuda_ms(lambda: fused_chain_rows_reference(
                y0r, gxr, tab, tables, W, STEPS, matmul_dtype=mm, generator=tgen),
                reps=3, warmup=1)
            k2_bound[mm] = bound(k2_work(M_MAIN, STEPS), mm)
        del y0r, gxr
    emit(phase="k2", card=smi_line, max_abs_err=k2_err, mpv_kernel=mpv_k, mpv_twin=mpv_p,
         mpv_rel=mpv_rel, mpv_float32_arm=mpv_32, mpv_rel_bf16_vs_f32=mpv_rel_arms, rows=M_MAIN,
         ms=k2_ms, plain_ms=k2_plain_ms, bound_ms={k: v[0] for k, v in k2_bound.items()},
         bound_by={k: v[1] for k, v in k2_bound.items()})

    # -- 5. K3 against its plain twin ------------------------------------------
    with torch.no_grad():
        tden = TMDMDenoiser(1, T_STEPS + 1).to(dev).eval()
        x = step_rows("k3", M_TMDM, 1, gen, dev)
        k3_err, k3_series, k3_ms, k3_plain_ms = step_phase(
            "k3", tmdm_weights(tden), tmdm_gammas(tden, 50), x)
        del x
    k3_bound = {mm: bound(k3_work(M_TMDM), mm) for mm in TOL}
    emit(phase="k3", card=smi_line, max_abs_err=k3_err, tol=TOL, series_rel_err=k3_series,
         series_rtol=SERIES_RTOL, rows=M_TMDM, ms=k3_ms, plain_ms=k3_plain_ms,
         bound_ms={k: v[0] for k, v in k3_bound.items()},
         bound_by={k: v[1] for k, v in k3_bound.items()})
    if args.kernels:
        emit(stopped_after="k3")
        return

    def chunk_mpv(ens):
        """Ensemble variance over the members (last axis), averaged."""
        return ens.var(dim=-1, correction=0).mean().item()

    def zero_counts():
        fused_denoiser_rows.launches = 0
        fused_chain_rows.launches = 0
        fused_tmdm_rows.launches = 0

    # -- 6. the NsDiff main path at full width -----------------------------------
    model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
    mm_main = str(model.sampling_dtype()).replace("torch.", "")
    fast_mpv_sweep(model, make_windows(CHUNK), PRED_LEN, chunk_windows=CHUNK)  # warm-up
    wins = make_windows(N_WINDOWS)
    n_chunks = -(-N_WINDOWS // CHUNK)
    zero_counts()
    elapsed, (mpv, pmean) = host_s(
        lambda: fast_mpv_sweep(model, wins, PRED_LEN, chunk_windows=CHUNK))
    k1_launches = fused_denoiser_rows.launches
    require(k1_launches == STEPS * n_chunks, "main",
            f"K1 launched {k1_launches} times, expected {STEPS * n_chunks}")
    require(mpv.shape == (N_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all()
            and np.isfinite(pmean).all(), "main", f"bad MPV {mpv[:4]}")
    x0 = torch.as_tensor(model.scaler_transform(wins[:CHUNK].reshape(-1, WINDOWS, 1)),
                         dtype=torch.float32, device=dev)
    t_fg, (y0h, gxh) = host_s(lambda: model.f_and_g(x0))
    t_chain, ens = host_s(lambda: model.sample_chain(y0h, gxh, torch.Generator(
        device=dev).manual_seed(3), N_Z))
    std = torch.ones(1, device=dev)
    t_red, (mpv_k1, _) = host_s(lambda: mpv_reduce(ens, std, 0 * std, CHUNK, NODE, PRED_LEN))
    emit(phase="main", card=smi_line, windows=N_WINDOWS, chunk=CHUNK, seconds=elapsed,
         windows_per_hr=N_WINDOWS / elapsed * 3600.0, k1_launches=k1_launches,
         k1_matmul_dtype=mm_main, split_s={"f_g": t_fg, "chain": t_chain, "reduce": t_red},
         mpv_first=mpv[:4].tolist())
    # the same chunk's chain through K1 and through the plain denoiser, float32,
    # same generator seed (noise is drawn outside the kernel)
    model.net_param["sampling_dtype"] = "float32"
    a = model.sample_chain(y0h, gxh, torch.Generator(device=dev).manual_seed(9), N_Z,
                           use_kernel=True)
    b = model.sample_chain(y0h, gxh, torch.Generator(device=dev).manual_seed(9), N_Z,
                           use_kernel=False)
    model.net_param["sampling_dtype"] = mm_main
    # bar: float32 on both sides with sums in another order, carried through
    # 20 reverse steps (the CPU test holds the plain path to JAX at the same)
    excess = ((a - b).abs() - (1e-4 + 1e-4 * b.abs())).max().item()
    emit(phase="main_vs_plain", card=smi_line, max_abs_err=(a - b).abs().max().item(), tol="rtol 1e-4 atol 1e-4")
    require(excess <= 0, "main_vs_plain", f"K1 chain off the plain chain by {excess}")
    # the chunk's ensemble MPV from the bf16 kernel chain against the float32
    # kernel chain's, same generator seed: within 1% (the JAX package's bar
    # for its bf16 kernel, tests/test_pallas_denoiser.py::test_bf16_chain_mpv_parity)
    c = model.sample_chain(y0h, gxh, torch.Generator(device=dev).manual_seed(9), N_Z)
    mpv32, mpv16 = chunk_mpv(a), chunk_mpv(c)
    mpv_rel_main = abs(mpv16 - mpv32) / mpv32
    emit(phase="main_bf16_vs_f32", card=smi_line, mpv_float32=mpv32, mpv_bfloat16=mpv16,
         rel=mpv_rel_main, tol=0.01)
    require(mm_main == "bfloat16" and mpv_rel_main <= 0.01, "main_bf16_vs_f32",
            f"{mm_main} chain MPV {mpv16} vs float32 {mpv32}: {mpv_rel_main:.4%}")
    del a, b, c

    # -- 7. the K2 arm at full width ---------------------------------------------
    k2_arm = lambda: fused_nsdiff_chain(model.denoiser, y0h, gxh, model.sched, seed=11,
                                        n_z_samples=N_Z, matmul_dtype=mm_main)
    k2_arm()  # warm-up, as the K1 chain had its own
    zero_counts()
    t_k2, ens2 = host_s(k2_arm)
    k2_launches = fused_chain_rows.launches
    require(k2_launches == 1, "k2_arm", f"K2 launched {k2_launches} times, expected 1")
    mpv_k2, _ = mpv_reduce(ens2, std, 0 * std, CHUNK, NODE, PRED_LEN)
    m1, m2 = mpv_k1.mean().item(), mpv_k2.mean().item()
    rel = abs(m2 - m1) / m1
    emit(phase="k2_arm", card=smi_line, seconds=t_k2, k1_chain_seconds=t_chain,
         chunk_mpv_k1=m1, chunk_mpv_k2=m2,
         rel=rel, per_window_max_rel=((mpv_k2 - mpv_k1).abs() / mpv_k1).max().item(),
         k2_launches=k2_launches)
    require(rel <= 0.01, "k2_arm", f"K2 arm MPV {m2} vs K1 path {m1}: {rel:.4%}")
    del ens, ens2, y0h, gxh, model

    # -- 8. the TMDM path at full width -------------------------------------------
    tmdm = diffusion_models("TMDM", TMDM_PARAM, seed=0, device="cuda")
    fast_mpv_sweep(tmdm, make_windows(T_CHUNK), PRED_LEN, chunk_windows=T_CHUNK)  # warm-up
    twins = make_windows(T_WINDOWS)
    t_chunks = -(-T_WINDOWS // T_CHUNK)
    zero_counts()
    t_elapsed, (t_mpv, t_pmean) = host_s(
        lambda: fast_mpv_sweep(tmdm, twins, PRED_LEN, chunk_windows=T_CHUNK))
    k3_launches = fused_tmdm_rows.launches
    require(k3_launches == T_STEPS * t_chunks, "tmdm",
            f"K3 launched {k3_launches} times, expected {T_STEPS * t_chunks}")
    require(fused_denoiser_rows.launches == 0 and fused_chain_rows.launches == 0, "tmdm",
            "the TMDM path launched an NsDiff kernel")
    require(t_mpv.shape == (T_WINDOWS,) and np.isfinite(t_mpv).all() and (t_mpv > 0).all()
            and np.isfinite(t_pmean).all(), "tmdm", f"bad MPV {t_mpv[:4]}")
    x0 = torch.as_tensor(tmdm.scaler_transform(twins[:T_CHUNK].reshape(-1, WINDOWS, 1)),
                         dtype=torch.float32, device=dev)
    t_cond, (y0t, embt) = host_s(lambda: tmdm.cond_fn(x0))
    require(y0t.shape == (T_CHUNK * NODE, T_LABEL + PRED_LEN, 1), "tmdm",
            f"y_0_hat shape {tuple(y0t.shape)}")
    t_tchain, tens = host_s(lambda: tmdm.sample_chain(y0t, embt, torch.Generator(
        device=dev).manual_seed(3), N_Z))
    t_tred, _ = host_s(lambda: mpv_reduce(tens, std, 0 * std, T_CHUNK, NODE, PRED_LEN))
    emit(phase="tmdm", card=smi_line, windows=T_WINDOWS, chunk=T_CHUNK, seconds=t_elapsed,
         windows_per_hr=T_WINDOWS / t_elapsed * 3600.0, k3_launches=k3_launches,
         k3_matmul_dtype=mm_main, rows_per_launch=M_TMDM,
         split_s={"cond": t_cond, "chain": t_tchain, "reduce": t_tred},
         mpv_first=t_mpv[:4].tolist())
    del tens
    # the same chunk's chain through K3 and through the plain TMDMDenoiser,
    # float32, same generator seed
    tmdm.net_param["sampling_dtype"] = "float32"
    a = tmdm.sample_chain(y0t, embt, torch.Generator(device=dev).manual_seed(9), N_Z,
                          use_kernel=True)
    b = tmdm.sample_chain(y0t, embt, torch.Generator(device=dev).manual_seed(9), N_Z,
                          use_kernel=False)
    tmdm.net_param["sampling_dtype"] = mm_main
    # bar: float32 on both sides with sums in another order, carried through
    # 100 reverse steps
    excess = ((a - b).abs() - (1e-4 + 1e-4 * b.abs())).max().item()
    emit(phase="tmdm_vs_plain", card=smi_line, max_abs_err=(a - b).abs().max().item(),
         tol="rtol 1e-4 atol 1e-4")
    require(a.shape == (T_CHUNK * NODE, PRED_LEN, 1, N_Z) and excess <= 0, "tmdm_vs_plain",
            f"K3 chain off the plain chain by {excess}")
    # bf16 kernel chain against the float32 kernel chain, as for NsDiff
    c = tmdm.sample_chain(y0t, embt, torch.Generator(device=dev).manual_seed(9), N_Z)
    mpv32, mpv16 = chunk_mpv(a), chunk_mpv(c)
    mpv_rel_tmdm = abs(mpv16 - mpv32) / mpv32
    emit(phase="tmdm_bf16_vs_f32", card=smi_line, mpv_float32=mpv32, mpv_bfloat16=mpv16,
         rel=mpv_rel_tmdm, tol=0.01)
    require(mpv_rel_tmdm <= 0.01, "tmdm_bf16_vs_f32",
            f"bf16 chain MPV {mpv16} vs float32 {mpv32}: {mpv_rel_tmdm:.4%}")
    del a, b, c, y0t, embt

    # -- 9. the cache-first runner on the card -------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "pred_future.pt"
        zero_counts()
        t_cache, ens_list = host_s(lambda: run_evaluation_cache(
            tmdm, twins[:4], PRED_LEN, cache, chunk_windows=T_CHUNK, checkpoint_every=2))
        swept = fused_tmdm_rows.launches
        require(swept == 2 * T_STEPS, "cache", f"K3 launched {swept} times, expected {2 * T_STEPS}")
        loaded = load_tensor_list(cache)
        require(len(loaded) == len(ens_list) == 4
                and all(a.shape == (NODE, PRED_LEN, 1, N_Z) and np.isfinite(a).all()
                        for a in loaded), "cache", "the .pt cache does not hold 4 finite "
                f"[{NODE},{PRED_LEN},1,{N_Z}] arrays")
        left = sorted(p.name for p in Path(tmp).iterdir())
        require(left == ["pred_future.pt", "pred_future.pt.mpv.json"], "cache",
                f"left behind: {left}")
        again = run_evaluation_cache(tmdm, twins[:4], PRED_LEN, cache, chunk_windows=T_CHUNK)
        require(fused_tmdm_rows.launches == swept and len(again) == 4
                and all(np.array_equal(x, y) for x, y in zip(again, loaded)), "cache",
                "the second call did not return the cache as it was")
    emit(phase="cache", card=smi_line, windows=4, seconds=t_cache, k3_launches=swept,
         files=left)
    del tmdm

    # -- 10. trained weights ------------------------------------------------------
    cfg = read_model_config(SIS_MODEL)
    sis, _ = load_model_from_dir(SIS_MODEL, device="cuda")
    data = load_dynamic_data(SIS_DATA, dynamic_type="SIS")
    series, tdata = sample_time_series(data["torch_time_series"], data["time_data"],
                                       cfg["dataset"]["sampling_t"])
    sis_w, _ = sliding_windows(series, tdata, cfg["dataset"]["windows"],
                               cfg["dataset"]["interval_step"])
    sis_w = sis_w[:8]
    sis_mpv, _ = fast_mpv_sweep(sis, sis_w, cfg["dataset"]["pred_len"], chunk_windows=8)
    require(sis_mpv.shape == (8,) and np.isfinite(sis_mpv).all() and (sis_mpv > 0).all(),
            "trained", f"bad SIS MPV {sis_mpv}")
    # f(x), g(x) on the card against the port on the CPU, same weights
    cpu, _ = load_model_from_dir(SIS_MODEL, device="cpu")
    xs = sis.scaler_transform(sis_w.reshape(-1, sis_w.shape[2], 1)).astype(np.float32)
    f_c, g_c = sis.f_and_g(xs)
    f_h, g_h = cpu.f_and_g(xs)
    fg_err = max((f_c.cpu() - f_h).abs().max().item(), (g_c.cpu() - g_h).abs().max().item())
    emit(phase="trained", card=smi_line, mpv=sis_mpv.tolist(), fg_card_vs_cpu=fg_err)
    require(fg_err <= 1e-4, "trained", f"f/g on the card off the CPU by {fg_err}")
    del sis, cpu

    # -- 11. the train step at full width --------------------------------------------
    from upgdm_tpu_torch.models.tmdm import TMDMModel
    from upgdm_tpu_torch.train.loop import run_training

    t_train = time.perf_counter()
    rng = np.random.default_rng(0)
    batch = torch.as_tensor(rng.normal(size=(TRAIN_B, WINDOWS + PRED_LEN, 1)),
                            dtype=torch.float32, device=dev)
    train = {}
    for name, select, model in (
            ("pretrain_f", "pretrain_f",
             NsDiffModel(TRAIN_PARAM, "pretrain_f", seed=0, device="cuda")),
            ("pretrain_g", "pretrain_g",
             NsDiffModel(TRAIN_PARAM, "pretrain_g", seed=0, device="cuda")),
            ("NsDiff_model", None, NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")),
            ("TMDM", None, TMDMModel(TMDM_TRAIN_PARAM, seed=0, device="cuda"))):
        for dt in ("float32", "bfloat16"):  # the bf16 steps go on from the float32 ones
            ms, losses = train_step_ms(model, select, batch, dt)
            require(np.isfinite(losses).all(), "train", f"{name} {dt}: losses {losses}")
            train[f"{name}_{dt}"] = {"step_ms": ms, "samples_per_s": TRAIN_B / ms * 1e3,
                                     "loss_first": losses[0], "loss_last": losses[-1]}
            if name in ("NsDiff_model", "TMDM"):
                train[f"{name}_{dt}"]["split"] = train_step_split(model, select, batch, dt)
        del model
    # card against CPU on one batch of 16 at the same widths, dropout off
    seams_ns = dict(t=torch.arange(16) % STEPS,
                    noise=torch.as_tensor(rng.normal(size=(16, PRED_LEN, 1)), dtype=torch.float32))
    seams_tm = dict(t=torch.arange(16) * 6 % T_STEPS,
                    noise=torch.as_tensor(rng.normal(size=(16, T_LABEL + PRED_LEN, 1)),
                                          dtype=torch.float32))
    try:
        for name, cls, param, seams in (
                ("NsDiff_model", NsDiffModel, dict(TRAIN_PARAM, dropout=0.0), seams_ns),
                ("TMDM", TMDMModel, dict(TMDM_TRAIN_PARAM, dropout=0.0), seams_tm)):
            rel, worst = card_vs_cpu(cls(param, seed=1, device="cuda"), cls, param,
                                     batch[:16], seams)
            train[f"{name}_card_vs_cpu"] = {"loss_rel": rel, "worst_grad_err_over_bar": worst}
    except AssertionError as exc:
        fail("train", str(exc))
    emit(phase="train", card=smi_line, seconds=time.perf_counter() - t_train, batch=TRAIN_B,
         reps=TRAIN_REPS, **train,
         bars={"loss_rtol": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_REL,
               "key_bias_grad_below": TRAIN_GRAD_ZERO})
    del batch

    with tempfile.TemporaryDirectory() as tmp:
        # -- 12. the demo's three-stage protocol through run_training -----------------
        tr, va, dataset_param = demo_split()
        net = dict(read_model_config(DEMO / "pre_model_F/trained_model")["net"],
                   load_pretrain=False)
        opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
        base = dict(train_batch_size=32, val_batch_size=len(va), test_set=True, ckpt=False,
                    ckpt_period=10, train_epochs=DEMO_EPOCHS)
        stages = {}
        for select, ref in DEMO_STAGES:
            out = Path(tmp) / ref
            stage_net = net
            if select == "NsDiff_model":  # g from its stage, f from scratch
                stage_net = dict(net, load_pretrain=True,
                                 pretrain_f_path=str(Path(tmp) / "pre_model_F"),
                                 pretrain_g_path=str(Path(tmp) / "pre_model_G"))
            t_stage, rs = host_s(lambda: run_training(
                tr, va, dict(base, train_model_select=select), dict(stage_net),
                {"loss_metric": "KL divergence"}, opt, out, dataset_param=dataset_param,
                device="cuda"))
            (out / "model_trained").write_bytes((out / "trained_model/model_trained").read_bytes())
            jax_rs = json.loads((DEMO / ref / "train_trace/record_scores.json").read_text())
            got, want = float(np.mean(rs["train_scores"][-3:])), float(
                np.mean(jax_rs["train_scores"][-3:]))
            stages[select] = {"seconds": t_stage, "train_last3": got, "jax_train_last3": want,
                              "rel": got / want - 1.0,
                              "val_last3": float(np.mean(rs["val_scores"][-3:])),
                              "jax_val_last3": float(np.mean(jax_rs["val_scores"][-3:]))}
        emit(phase="train_demo", card=smi_line, epochs=DEMO_EPOCHS, windows=len(tr) + len(va),
             train=len(tr), val=len(va), bar=DEMO_BAR, **stages)
        for select, st in stages.items():
            require(abs(st["rel"]) <= DEMO_BAR, "train_demo",
                    f"{select}: last-3-epoch train score {st['train_last3']} vs the JAX "
                    f"record's {st['jax_train_last3']}")

        # -- 13. the checkpoint the demo wrote, swept through K1 ----------------------
        trained, _ = load_model_from_dir(Path(tmp) / "nsdiff/trained_model", device="cuda")
        cfg = read_model_config(Path(tmp) / "nsdiff/trained_model")
        slbp = load_dynamic_data(next((DEMO / "slbp_data").rglob("*.pt")), dynamic_type="SLBP")
        series, tdata = sample_time_series(slbp["torch_time_series"], slbp["time_data"],
                                           cfg["dataset"]["sampling_t"])
        slbp_w, _ = sliding_windows(series, tdata, cfg["dataset"]["windows"], 200)
        zero_counts()
        t_sweep, (demo_mpv, _) = host_s(lambda: fast_mpv_sweep(
            trained, slbp_w, cfg["dataset"]["pred_len"], chunk_windows=4))
        demo_k1 = fused_denoiser_rows.launches
        n_steps = trained.diffusion_steps * -(-len(slbp_w) // 4)
        emit(phase="train_then_sweep", card=smi_line, windows=len(slbp_w), seconds=t_sweep,
             mpv=demo_mpv.tolist(), k1_launches=demo_k1)
        require(demo_k1 == n_steps, "train_then_sweep",
                f"K1 launched {demo_k1} times, expected {n_steps}")
        require(demo_mpv.shape == (len(slbp_w),) and np.isfinite(demo_mpv).all()
                and (demo_mpv > 0).all(), "train_then_sweep", f"bad MPV {demo_mpv}")

    def row(name, src, replaces, launches, err, ms, plain, bound):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms[mm_main],
                "plain_ms": plain[mm_main], "bound_ms": bound[mm_main][0],
                "bound_by": bound[mm_main][1], "library_ms": None,
                "matmul_dtype": mm_main, "ms_float32": ms["float32"],
                "plain_ms_float32": plain["float32"], "bound_ms_float32": bound["float32"][0]}

    print(smi_line, flush=True)
    print(json.dumps({"kernels": [
        row("fused_denoiser", "upgdm_tpu_torch/csrc/fused_denoiser.cu",
            "upgdm_tpu/ops/pallas/fused_denoiser.py:152", k1_launches, k1_err[mm_main],
            k1_ms, k1_plain_ms, k1_bound),
        row("chain_resident", "upgdm_tpu_torch/csrc/chain_resident.cu",
            "upgdm_tpu/ops/pallas/chain_resident.py:188", k2_launches,
            k2_err[mm_main], k2_ms, k2_plain_ms, k2_bound),
        row("fused_tmdm", "upgdm_tpu_torch/csrc/fused_tmdm.cu",
            "upgdm_tpu/ops/pallas/fused_denoiser.py:250", k3_launches, k3_err[mm_main],
            k3_ms, k3_plain_ms, k3_bound),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
