#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (upgdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--kernels]

Builds the port's five CUDA kernels from ``upgdm_tpu_torch/csrc/`` (into
``build/kernels/``) and fails on a register spill in the tensor-core kernels,
holds each kernel against its plain PyTorch twin on the card (K1 and K3 over
ragged row counts, feature widths 1, 2 and 4, edge-case rows and, element by
element, at the sweeps' own row counts in both matmul types; K2 over the same
row counts and widths with and without ``use_gx_directly``, noise-free in both
matmul types and per sample on its own Philox normals, against a chain of K1
launches, at 100 steps, at two launch shapes and, element by element, at the
sweep's own row count; the NsDiff chain's posterior update bit for bit
against its twin and the eager step it replaced, alone, at the sweep's own
row count and over whole chains of K1 launches, and its time), drives the
NsDiff sampling-MPV sweep at the bench geometry (``bench.py``: Node 30,
W/P 100/100, 20 steps, 100 samples, d_model 512, e4/d2) and the TMDM
sampling-MPV sweep at the model-comparison geometry (Node 30, W/P 100/100,
label 50, 100 steps, 100 samples, d_model 64, e2/d1) through the port's entry
points, holds the NsDiff float32 kernel chain to a chain with no kernel (the
plain denoiser and the eager update), holds each sweep's bf16 kernel chain to
its float32 kernel chain at the MPV level, counts the update's launches (T a
chain) on every NsDiff path, runs the cache-first evaluation runner, and checks the trained
SIS model of ``demo_fig1``. Then training: the train step of every NsDiff
stage at the train-bench geometry (``bench_train.py``: B 64, W/P 100/100,
d_model 512, e4/d2) and of TMDM at its model-comparison geometry, timed in
float32 and ``train_dtype="bfloat16"``, with the card's loss and gradients
held to the port's CPU run on one batch; the demo's three-stage protocol
(``examples/slbp_demo.py``) on the committed SLBP trajectory through
``run_training``, each stage's score held to the committed JAX record; and
the checkpoint it wrote swept through K1. The bf16-activation arms
(``act_dtype="bfloat16"``) of K1 and K2 are held to their twins like the
other arms, against the float32-activation arms at the JAX package's bars,
and timed; the ``uncertainty_ews`` facade runs the trained SIS model from its
checkpoint directory and trajectory file, straight from the device, through
its cache and sidecar, and with bf16 activations (K1's act arm); a seeded
pretrain_f of the demo runs twice with equal records, and the float32 step
is timed with and without deterministic cuDNN. Last, DiffSTG at the published
model-comparison width on the tracked 30-node graph (no hand-written kernel
is on its path): the cache runner over 16 windows (timed, one window
profiled, the UGnet forward in bf16 and float32 and in two formulations of
the transposed time conv, the card's float32 ensemble per sample against the
CPU's, bf16 against float32 MPV), the card's loss and gradients against the
CPU's, the train step, training through the ``adj`` path on a seeded corpus
of the tracked 30- and 50-node graphs with the checkpoint swept, and the
DiffSTG branch of ``uncertainty_ews`` (written, a cache hit, the sidecar).
Then NsDiff_spatial at the spdata grid's width over the same windows one
graph at a time (timed, one window profiled, card against CPU per sample,
bf16 against float32 MPV), each stage's step, the card's loss and gradients
against the CPU's, and its three stages trained and swept; and DiffusionTS at
the model-comparison width through ``uncertainty_ews`` (written, a cache hit;
forwards and Langevin gradients counted), a profiled round at 32 rows with
its peak memory, the card against the CPU on every forward of a chain, bf16
against float32 MPV, and its train step. Neither family has a hand-written
denoiser kernel on its path (NsDiff_spatial's chain takes the posterior
update's). Then the SLBP analyses at the trained demo model's full
width (``demo_artifacts/model`` over the tracked trajectory, 191 windows, K1
at 160,000 rows and F 2): the sensitivity sweep timed with its 240 K1
launches and a profiled chunk, the sampling, gx, MPV, direct and raw-variance
analyses (cache hits with no launch), gx and the float32 ensemble against
the CPU, K1 at that shape against its twin, and the demo's scan through the
facade held to ``demo_artifacts/summary.json`` over two seeds; and the
figure layer's loaders on the card (fig1 and ``mpv_collapse`` over
``demo_fig1``, fig4-fig9 over the tracked SLBP model and trajectory under
every name they read), rendered when matplotlib is installed. Last, data
generation (``datagen``): K4, the Euler-Maruyama segment kernel, against its
twin over the four systems at 12 to 300 nodes and two segmentations, timed;
the JAX package's default SLBP corpus (4 x 10,010,000 steps); the demo corpus
over five seeds, its transition held to ``demo_artifacts/summary.json``; one
generated trajectory through the facade with the demo model (K1); the network
CLI's defaults on the tracked 100-node graph; a generated SIS record through
the facade with the trained ``demo_fig1`` model; the graph library and the
Bury corpus on the host. Last, the real-data pipeline (``real_data``) on a
temporary copy of ``demo_real``, with no kernel on its path: the Bury CLI's
``run_one`` with all 20 classifiers (torch modules read from the tracked
``.keras`` archives, one forward each over the stacked prefixes) against the
CPU run, the signal stage of ``real_data.run_one`` with the five default
signals against the CPU run and again as a cache hit, a reference-format
NsDiff checkpoint through ``load_state_dict``, a ``PhaseTimer`` and the
device's memory statistics. Last, the experiment drivers of ``examples/``
through the port (``examples``): the SLBP demo at its defaults (K4, K1), the
Fig-1, network and real-data demos at their defaults against the tracked
trees' files, the zoo's Fig-1 chain at full width and cut depth (K1 and K3
through the arm driver, one figure job through the zoo's figure stage), the
100-node and paper-figure demos at cut depth;
each cut is printed on a ``reduced`` line. Every phase that fails exits
non-zero. Progress goes to stdout as JSON lines; the line before the last
holds the kernel table, the last line is ``{"ok": true, "device": {...}}``.
``--kernels`` stops after the kernel phases (build, K1, K2, K3 and the
chain's update with their times): the short loop for work on a kernel; ``--examples`` runs the
``examples`` phase alone after the build; ``--paper-runs N`` runs the
paper-figure demo whole N times, each in a fresh process with its graphs
unpinned, and counts the runs that fail (a measurement, no result line).

Imports nothing of JAX or of the JAX package.
"""
import argparse
import contextlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
FACADE_REPS = 7  # timed uncertainty_ews calls; the median is reported, with min and max

# DiffSTG at the published model-comparison width
# (demo_zoo/ews_results/model_compare/DiffSTG/SIS/model_trained.yaml): ResGatedGraphConv,
# d_h 4, multipliers [2, 2], 2 blocks, Td_h 10, T_h = T_p = 100, 200 training steps,
# 20 DDIM cosine steps, 10 x 10 samples; on the tracked 30-node BA graph
# (benchmarks/ab_diffstg.py:24), 16 windows at the interval step 50
STG_PARAM = dict(
    T_h=WINDOWS, T_p=PRED_LEN, F=1, windows=WINDOWS, pred_len=PRED_LEN, dataset_nf=1, d_h=4,
    Td_h=10, channel_multipliers=[2, 2], n_blocks=2, gnn_name="ResGatedGraphConv",
    gnn_param={"bias": True, "root_weight": True}, diffusion_steps=200,
    diffusion_schedule="linear", inference_diffusion_steps=20, inference_trick="ddim",
    inference_schedule="cosine", loss_weight_schedule="constant", mask_ratio=0.0,
    parallel_sampling=10, sequential_sampling=10, scaler_type="StandardScaler",
    task_model="DiffSTG",
)
STG_GRAPHS = (REPO / "dataset/train_dataset_graph/barabasi_albert_30_0.graphml",
              REPO / "dataset/train_dataset_graph/barabasi_albert_50_0.graphml")
STG_WINDOWS, STG_STEP, STG_TRAIN_B = 16, 50, 16
# the JAX package's bars: a sampled chain against its plain twin
# (tests/test_torch_parity.py) and bf16 against float32 sampling
# (tests/test_models_e2e.py:171)
STG_RTOL, STG_ATOL, STG_MPV_REL = 2e-4, 2e-5, 0.01

# NsDiff_spatial at the spdata grid's width
# (configs/grid_search/diffusion_model_NsDiff_spdata.yaml): GCNConv with self
# loops in f and the denoiser, d_model 64 e2/d1, d_ff 128, d_h 4, [1, 2], 2
# blocks, fT_h = Td_h = 10, W/P 100/100, 20 steps, n_z 100; swept one graph
# at a time (examples/n100_scale_demo.py:108-127) over the DiffSTG windows,
# trained at the grid's batch of 16 graphs
SP_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, rolling_length=50, diffusion_steps=STEPS,
    diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2, scaler_type="StandardScaler",
    d_model=64, n_heads=4, e_layers=2, d_layers=1, d_ff=128, dropout=0.05, activation="gelu",
    p_hidden_dims=[64, 64], p_hidden_layers=2, spatial_layers=1, fT_h=10, d_h=4, Td_h=10,
    channel_multipliers=[1, 2], n_blocks=2, gnn_name="GCNConv",
    gnn_param={"add_self_loops": True}, f_gnn_name="GCNConv",
    f_gnn_param={"add_self_loops": True}, n_z_samples=N_Z, parallel_sample=10,
    task_model="NsDiff_spatial",
)
SP_TRAIN_B = 16
SP_BOUNDED = 100.0  # largest |sample| of a chain that stays bounded (scaled units)

# DiffusionTS at the published model-comparison width
# (demo_zoo/ews_results/model_compare/DiffusionTS/SIS/model_trained.yaml): d_model 64,
# enc 3 / dec 6, 4 heads, mlp x 4, W/P 100/100, 100 timesteps, 100 DDIM steps,
# eta 0, n_z 100 in rounds of 10, trained at its batch of 256; the facade over
# DTS_WINDOWS windows of a seeded SIS record on the tracked 30-node graph
DTS_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, timesteps=100, diffusion_steps=100,
    beta_schedule="cosine", n_layer_enc=3, n_layer_dec=6, d_model=64, n_heads=4,
    mlp_hidden_times=4, attn_pd=0.0, resid_pd=0.0, eta=0.0, infill_coef=0.1,
    infill_learning_rate=0.05, loss_type="l2", use_ff=True, n_z_samples=N_Z,
    parallel_sample=10, scaler_type="StandardScaler", task_model="DiffusionTS",
)
DTS_WINDOWS, DTS_TRAIN_B, DTS_ROWS = 1, 256, 32
# the port's module bar (tests/test_torch_port_dts.py: atol 1e-5 of the output's
# scale) on every forward; bf16 against float32 MPV at the JAX package's own
# DiffusionTS bar (tests/test_models_e2e.py:174-210: the chain is chaotic)
DTS_FWD_REL, DTS_MPV_REL = 1e-5, 0.05


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


def check_step_kernel(which, dev, seed=2, act="float32"):
    """K1 (``which="k1"``) or K3 (``"k3"``) against its twin over RAGGED_M x
    WIDTHS x CASES (the module's own gates at GATE_STEPS for ``random``) in
    both matmul types, or for K1's ``act="bfloat16"`` in bf16 matmuls (the
    only type it takes); returns {mm: max|err|} or raises AssertionError
    naming the first case over TOL. The bf16-activation arm is held to
    TOL["bfloat16"] too: kernel and twin round the same operations, and an
    activation that the special-function unit's ex2 / lg2 / rsqrt or a sum
    in another order puts across a bf16 rounding boundary moves eps by one
    bf16 step seen through the head, as in the float32-activation arm. That
    bar cannot tell the arm from one that rounds less, so at 65,536 rows and
    more it is also held apart from the float32-activation arm
    (``arms_apart``)."""
    import torch

    from upgdm_tpu_torch.ops.kernels.fused_denoiser import denoiser_gammas, step_weights

    cls, weights_of, rows, ref, tup = step_kernel(which)
    acts = {"act_dtype": act} if which == "k1" else {}
    mms = TOL if act == "float32" else ("bfloat16",)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    err = {mm: 0.0 for mm in mms}
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
                            got = tup(rows(x, G, kw[mm], matmul_dtype=mm, **acts))
                            want = tup(ref(x, G, W, matmul_dtype=mm, **acts))
                            err[mm] = max(err[mm], worst_err(which.upper(), got, want, TOL[mm],
                                                             where))
                            if act != "float32" and M >= ACT_SEP_ROWS:
                                other = rows(x, G, kw[mm], matmul_dtype=mm)
                                for name, a, b, c in zip(("eps", "sigma"), got, want, other):
                                    arms_apart(f"K1 {name}", err, a, b, c, where)
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


def arms_apart(name, stats, got, twin, float32_act, where):
    """Hold a bf16-activation output to its twin closer than a bar on
    max |d| can: at least ACT_SAME_FRAC of the elements within ACT_SAME_RTOL
    (1 + |twin|) of the twin's, and mean |got - twin| at most ACT_SEP x mean
    |got - float32_act| (the same kernel's float32-activation output). Keeps
    the smallest share and the largest ratio in ``stats``; AssertionError
    below either bar."""
    d = (got - twin).abs()
    same = (d <= ACT_SAME_RTOL * (1.0 + twin.abs())).float().mean().item()
    off, apart = d.mean().item(), (got - float32_act).abs().mean().item()
    ratio = off / apart if apart > 0 else (0.0 if off == 0 else float("inf"))
    if not (same >= ACT_SAME_FRAC and ratio <= ACT_SEP):
        raise AssertionError(f"{name}: {same:.4%} of the elements on the twin (bar "
                             f"{ACT_SAME_FRAC:.0%}), mean |d| {ratio:.4g} of the distance to "
                             f"the float32-activation arm (bar {ACT_SEP}), max |d| "
                             f"{d.max().item():.4g} at {where}")
    stats["same_share_min"] = min(stats.get("same_share_min", 1.0), same)
    stats["mean_ratio_max"] = max(stats.get("mean_ratio_max", 0.0), ratio)


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


def check_chain_kernel(dev, seed=6, act="float32"):
    """K2 against its twin, ``fused_chain_rows_reference``. Noise-free over
    RAGGED_M x WIDTHS x ``use_gx_directly``: float32 at CHAIN_F32, bf16 at
    TOL["bfloat16"] x ``chain_error_weight``. At 65,537 rows: the float32 arm
    with noise on against the twin on the same Philox normals, per sample at
    CHAIN_NOISE; the bf16 arm likewise with the heads fixed, so that only its
    draws and posterior arithmetic show; both arms at two launch shapes under
    one seed (shared rows bit-equal); the bf16 arm against a chain of K1
    launches at its bar; and a 100-step chain in both arms.

    ``act="bfloat16"``: both matmul types noise-free at the bf16 bar (the
    trunk rounds as K1's bf16-activation arm, carried by the chain). At
    65,537 rows: ``arms_apart`` against the float32-activation chain, which
    must differ within the JAX package's bar, mean |d| / mean |y| <
    CHAIN_ACT_REL; and with noise on, per sample on the Philox normals at
    the bf16 bar plus CHAIN_NOISE.

    Returns the largest errors; AssertionError names the first case over its
    bar."""
    import torch

    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        fused_chain_rows, fused_chain_rows_reference,
    )

    bf = act == "bfloat16"
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.manual_seed(seed)
    if bf:
        err = {"float32": 0.0, "bfloat16": 0.0, "float32_noise": 0.0, "bfloat16_noise": 0.0,
               "rel_vs_float32_act": 0.0}
    else:
        err = {"float32": 0.0, "bfloat16": 0.0, "float32_noise": 0.0,
               "bfloat16_noise_stream": 0.0, "bfloat16_vs_k1_chain": 0.0, "float32_T100": 0.0,
               "bfloat16_T100": 0.0}

    def held(name, key, got, want, rtol, atol, where):
        if got.shape != want.shape or not torch.isfinite(got).all().item():
            raise AssertionError(f"K2 {name}: bad output at {where}")
        over = off_by(got, want, rtol, atol)
        if over > 0:
            raise AssertionError(f"K2 {name}: off rtol {rtol} / atol {atol} by {over} at {where}")
        err[key] = max(err[key], (got - want).abs().max().item())

    with torch.no_grad():
        for T in (N_STEPS,) if bf else (N_STEPS, 100):
            for Fdim in WIDTHS if T == N_STEPS else (1,):
                den, W, tables, sched, tab = chain_setup(Fdim, T, dev)
                bar16 = TOL["bfloat16"] * chain_error_weight(tab.cpu().numpy(), 1.0)
                err[f"bfloat16_bar_T{T}"] = bar16
                sfx = "" if T == N_STEPS else "_T100"
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
                            got = fused_chain_rows(y0, gx, tab, 0, tables, W, T, act_dtype=act,
                                                   **kw)
                            want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                              act_dtype=act, **kw)
                            held(f"{mm} noise-free", mm + sfx, got, want, rtol, atol, where)
                            if bf and M >= ACT_SEP_ROWS:
                                f32 = fused_chain_rows(y0, gx, tab, 0, tables, W, T, **kw)
                                arms_apart(f"K2 {mm}", err, got, want, f32, where)
                                rel = ((got - f32).abs().mean() / f32.abs().mean()).item()
                                if not 0 < rel < CHAIN_ACT_REL:
                                    raise AssertionError(f"K2 {mm}: act bf16 vs float32 act "
                                                         f"{rel} at {where}")
                                err["rel_vs_float32_act"] = max(err["rel_vs_float32_act"], rel)
                if T != N_STEPS:
                    continue
                # y0, gx: the last 65,537 rows
                if bf:  # noise on, per sample
                    for mm in TOL:
                        got = fused_chain_rows(y0, gx, tab, 5, tables, W, T, matmul_dtype=mm,
                                               act_dtype=act)
                        want = fused_chain_rows_reference(y0, gx, tab, tables, W, T,
                                                          matmul_dtype=mm, act_dtype=act,
                                                          noise="philox", seed=5)
                        held(f"{mm} act bf16 with Philox noise", mm + "_noise", got, want,
                             CHAIN_NOISE["rtol"], CHAIN_NOISE["atol"] + bar16, f"F={Fdim}")
                    continue
                # noise on, per sample
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


# -- the NsDiff chain's posterior update (csrc/nsdiff_chain_update.cu) ----------------
# (rows, features, floats the operands sit into their buffers: 16-byte aligned
# when a multiple of 4, else the kernel takes every row one at a time)
UPDATE_SHAPES = ((1, 1, 0), (3, 1, 1), (5, 1, 0), (63, 1, 2), (64, 1, 0), (65, 2, 1),
                 (4097, 1, 3), (65537, 1, 0), (65537, 4, 1))


def eager_nsdiff_step(sched_dev, t, y, y_T_mean, gx, eps_theta, sigma_theta, z,
                      use_gx_directly):
    """A step of ``nsdiff_p_sample_loop`` as the eager tensor arithmetic it
    was before the update became one kernel: 0-d gathers of the schedule on
    the data's device, ~50 launches. ``z=None`` is the final step."""
    import torch

    from upgdm_tpu_torch.ops.diffusion import nsdiff_gather

    c = nsdiff_gather(sched_dev, t, y)
    sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
    if use_gx_directly:
        sigma_y0, noise_var = gx, c.betas_bar_t * gx
    else:
        a, bt_m1, bb_m1 = c.alpha_t, c.betas_tilde_m_1_t, c.betas_bar_m_1_t
        lam0 = a * (1.0 - a) * bt_m1
        lam1 = ((1.0 - a) ** 2 * bt_m1 + a * (1.0 - a) * (bb_m1 - bt_m1)) * gx - sigma_theta * (
            a * bt_m1 + a * (1.0 - a))
        lam2 = gx ** 2 * (1.0 - a) ** 2 * (bb_m1 - bt_m1) - sigma_theta * gx * (
            a * bb_m1 - a * bt_m1 + (1.0 - a) ** 2)
        disc = torch.clamp(lam1 ** 2 - 4.0 * lam0 * lam2, min=0.0)
        sigma_y0 = (-lam1 + torch.sqrt(disc)) / (2.0 * lam0)
        noise_var = (c.betas_bar_t - c.betas_tilde_t) * gx + c.betas_tilde_t * sigma_y0
    y0_reparam = (y - (1.0 - sqrt_abar) * y_T_mean
                  - eps_theta * torch.sqrt(noise_var)) / sqrt_abar
    if z is None:
        return y0_reparam
    a = c.alpha_t
    s1 = (1.0 - a) ** 2 * gx + a * (1.0 - a) * sigma_y0
    s2 = (c.betas_bar_m_1_t - c.betas_tilde_m_1_t) * gx + c.betas_tilde_m_1_t * sigma_y0
    sqrt_a, sqrt_abar_prev = torch.sqrt(a), torch.sqrt(c.alphas_cumprod_prev_t)
    denom = a * s2 + s1
    g0, g1 = sqrt_abar_prev * s1 / denom, sqrt_a * s2 / denom
    g2 = ((sqrt_a * (a - 1.0)) * s2 + (1.0 - sqrt_abar_prev) * s1) / denom
    y_mean = g0 * y0_reparam + g1 * y + g2 * y_T_mean
    return y_mean + torch.sqrt(sigma_theta) * z


def eager_nsdiff_chain(model_fn, y0, gx, sched_dev, generator, use_gx_directly, noise,
                       members):
    """``nsdiff_p_sample_loop`` with ``eager_nsdiff_step`` for its update:
    the same draws in the same order."""
    import torch

    from upgdm_tpu_torch.ops.diffusion import _chain_draw

    draw = _chain_draw(y0, generator, noise, members)
    y = torch.sqrt(gx) * draw(0) + y0
    for i, t in enumerate(range(sched_dev.num_timesteps - 1, 0, -1)):
        eps, sig = model_fn(y, t)
        y = eager_nsdiff_step(sched_dev, t, y, y0, gx, eps, sig, draw(i + 1), use_gx_directly)
    eps, sig = model_fn(y, 0)
    return eager_nsdiff_step(sched_dev, 0, y, y0, gx, eps, sig, None, use_gx_directly)


def same_bits(name, got, want, where):
    """AssertionError unless got and want hold the same float32 bits (NaN
    where the other has NaN). Returns the largest absolute difference of
    the values that are not NaN, as measured."""
    import torch

    nan = torch.isnan(got)
    if got.shape != want.shape or not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{name}: shape or NaN rows differ at {where}")
    a, b = torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)
    err = (a - b).abs().max().item()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{name}: {(a != b).sum().item()} values differ, max {err} "
                             f"at {where}")
    return err


# launches of the chain's posterior-update kernel in the windows each path
# checks (``counted_updates``), by path: the kernel table's row
UPDATE_BY_PATH = {}


def counted_updates(path, what, expected):
    """The posterior-update kernel's launches since the last ``zero_counts``,
    added to ``UPDATE_BY_PATH[path]``; fails the phase unless they are
    ``expected``. A chain of T steps takes T launches (one a step and one for
    t = 0), so a flat NsDiff chain takes one a K1 launch and NsDiff_spatial's
    one a denoiser forward."""
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import nsdiff_chain_update

    n = nsdiff_chain_update.launches
    require(n == expected, path, f"{what}: the chain's update launched {n} times, "
                                 f"expected {expected}")
    if n:
        UPDATE_BY_PATH[path] = UPDATE_BY_PATH.get(path, 0) + n
    return n


def main_shape_update_err(dev, sched, gen):
    """The update kernel against the eager step at the main path's 4.8 M
    rows, where the grid-stride loop takes ~9 passes of the grid: both
    ``use_gx_directly`` arms, a step and the final one, 16-byte aligned, and
    three rows more one float into each buffer (the scalar loop). Returns
    the largest difference measured (AssertionError unless bit for bit)."""
    import torch

    from upgdm_tpu_torch.ops.diffusion import schedule_on
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import chain_table, nsdiff_chain_update

    table, sched_dev, err = chain_table(sched, dev), schedule_on(sched, dev), 0.0
    with torch.no_grad():
        for M, offset in ((M_MAIN, 0), (M_MAIN + 3, 1)):
            y, ytm, gx, eps, sig, z = update_operands(M, 1, offset, gen, dev)
            for direct in (False, True):
                for t in (7, 0):
                    zt = None if t == 0 else z
                    err = max(err, same_bits(
                        "update vs eager step", nsdiff_chain_update(
                            y, ytm, gx, eps, sig, zt, table[t], direct),
                        eager_nsdiff_step(sched_dev, t, y, ytm, gx, eps, sig, zt, direct),
                        f"M={M} offset={offset} t={t} direct={direct}"))
            del y, ytm, gx, eps, sig, z
    return err


def update_operands(M, Fdim, offset, gen, dev):
    """(y, y_T_mean, gx, eps, sigma, z) [M, Fdim] float32, each ``offset``
    floats into its own buffer, with edge rows first: sigma 50 (the
    discriminant's clamp), 1e-6, 3 and NaN, gx 1e-6, 1e-3, 2 and 7."""
    import torch

    def one(uniform):
        x = torch.empty(M * Fdim + offset, device=dev)[offset:].view(M, Fdim)
        return x.uniform_(0.05, 1.0, generator=gen) if uniform else x.normal_(generator=gen)

    y, ytm, gx, eps, sig, z = (one(u) for u in (False, False, True, False, True, False))
    edges = torch.tensor([[50.0, 1e-6, 3.0, float("nan")], [1e-6, 1e-3, 2.0, 7.0]], device=dev)
    sig[:4, 0] = edges[0, :min(M, 4)]
    if M > 4:
        gx[4:8, 0] = edges[1, :min(M - 4, 4)]
    return y, ytm, gx, eps, sig, z


def check_chain_update_kernel(dev, seed=8):
    """The posterior-update kernel bit for bit against its twin run on the
    card and against the eager step it replaced: over UPDATE_SHAPES (row
    counts not a multiple of 4, unaligned operands), both ``use_gx_directly``
    arms and the final step, on every t of a 20-step linear schedule and on
    four steps of a 100-step cosine one. Then whole chains of K1 launches
    through ``nsdiff_p_sample_loop`` (the kernel, T launches a chain) against
    the same chain with the eager update: drawn from one seed, through a
    non-contiguous ``noise`` seam, and on strided y0_hat, gx, eps and sigma.
    Returns the number of cases."""
    import torch

    from upgdm_tpu_torch.ops.diffusion import nsdiff_p_sample_loop, schedule_on
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, fused_denoiser_rows, step_weights,
    )
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import (
        chain_table, nsdiff_chain_update, nsdiff_chain_update_reference,
    )
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule

    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = 0
    for name, T, steps in (("linear", N_STEPS, range(N_STEPS)), ("cosine", 100, (0, 1, 50, 99))):
        sched = NsDiffSchedule.create(name, T, 1e-4, 2e-2)
        table, sched_dev = chain_table(sched, dev), schedule_on(sched, dev)
        for M, Fdim, offset in UPDATE_SHAPES:
            y, ytm, gx, eps, sig, z = update_operands(M, Fdim, offset, gen, dev)
            for direct in (False, True):
                for t in steps:
                    zt = None if t == 0 else z
                    where = f"{name} T={T} t={t} M={M} F={Fdim} offset={offset} direct={direct}"
                    got = nsdiff_chain_update(y, ytm, gx, eps, sig, zt, table[t], direct)
                    same_bits("update vs twin", got, nsdiff_chain_update_reference(
                        y, ytm, gx, eps, sig, zt, table[t], direct), where)
                    same_bits("update vs eager step", got, eager_nsdiff_step(
                        sched_dev, t, y, ytm, gx, eps, sig, zt, direct), where)
                    cases += 1
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
            before = nsdiff_chain_update.launches
            got = nsdiff_p_sample_loop(fn, y0c, gxc, sched, torch.Generator(
                device=dev).manual_seed(3), direct, noise, members)
            if nsdiff_chain_update.launches - before != N_STEPS:
                raise AssertionError(f"{nsdiff_chain_update.launches - before} launches a "
                                     f"chain, expected {N_STEPS}, at {where}")
            want = eager_nsdiff_chain(fn, y0c, gxc, schedule_on(sched, dev), torch.Generator(
                device=dev).manual_seed(3), direct, noise, members)
            if not torch.isfinite(got).all().item():
                raise AssertionError(f"non-finite chain at {where}")
            same_bits("chain vs eager chain", got, want, where)
            cases += 1
    return cases


# -- training ------------------------------------------------------------------------
def train_step_ms(model, select, batch, dtype, **step_kw):
    """(median ms of a train step by CUDA events over TRAIN_REPS steps after
    two of warm-up, the losses) for one stage in float32 or bf16;
    ``step_kw`` go to the step (a graph batch's ``adj``)."""
    import torch

    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    model.net_param["train_dtype"] = dtype
    opt = make_optimizer({"optimizer_name": "Adam", "lr": 1e-3}, model.net,
                         model.trainable_mask(select))
    step = make_train_step(model, opt, select)
    losses = [step(batch, **step_kw) for _ in range(2)]
    times = []
    for _ in range(TRAIN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch, **step_kw))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), losses


def train_step_split(model, select, batch, dtype, reps=3, profiled=2):
    """Where a train step's time goes: host ms of its forward (the loss),
    backward and optimizer step, each ended by a synchronise (medians over
    ``reps`` steps after two), and, by ``torch.profiler`` (device activity
    only) over ``profiled`` unsynchronised steps of ``make_train_step``
    after its first, the device's summed kernel time and the kernels a step
    (None when the profiler sees no device activity)."""
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
        if dtype == "float32":
            loss = model.loss_fn(batch, select=select, train=True)
        else:
            loss = model.cast_loss(batch, torch.bfloat16, select=select, train=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    out = {k: statistics.median(v[2:]) for k, v in parts.items()}
    # the last loss holds its autograd graph, whose gradient accumulators a
    # capture's backward would tie to the default stream
    del loss
    step = make_train_step(model, opt, select)
    step(batch)  # the first call warms up and captures the step's graph
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step(batch)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_ms_per_step"] = (sum(e.time_range.elapsed_us() for e in kernels)
                                 / (1e3 * profiled) if kernels else None)
    out["kernels_per_step"] = len(kernels) / profiled if kernels else None
    return out


# the train step as one CUDA graph a shape, every family through run_training:
# an epoch of two full batches (a capture, two replays) and a ragged one (the
# eager body), against the same run with the step eager. Both runs take the
# same kernels, so their records agree to the last bits
GRAPH_B, GRAPH_V = 8, 6
GRAPH_REL = 1e-5
GRAPH_COUNTERS = ("train.graph_captures", "train.graph_replays", "train.graph_fallbacks")


def graph_cases():
    """(name, net_param, train_model_select, nodes or None) of each family's
    loss: every NsDiff stage, bf16 through ``cast_loss``, TMDM, DiffSTG and
    NsDiff_spatial with ``adj``, DiffusionTS."""
    return (("NsDiff pretrain_f", TRAIN_PARAM, "pretrain_f", None),
            ("NsDiff pretrain_g", TRAIN_PARAM, "pretrain_g", None),
            ("NsDiff_model", TRAIN_PARAM, "NsDiff_model", None),
            ("NsDiff_model bf16", dict(TRAIN_PARAM, train_dtype="bfloat16"), "NsDiff_model",
             None),
            ("TMDM", TMDM_TRAIN_PARAM, None, None),
            ("TMDM bf16", dict(TMDM_TRAIN_PARAM, train_dtype="bfloat16"), None, None),
            ("DiffSTG", STG_PARAM, None, GRAPH_V),
            ("NsDiff_spatial pretrain_f", SP_PARAM, "pretrain_f", GRAPH_V),
            ("NsDiff_spatial pretrain_g", SP_PARAM, "pretrain_g", GRAPH_V),
            ("NsDiff_spatial NsDiff_model", SP_PARAM, "NsDiff_model", GRAPH_V),
            ("DiffusionTS", dict(DTS_PARAM, scaler_type=None), None, None))


def graph_counts():
    from upgdm_tpu_torch.utils import profiling

    c = profiling.counters()
    return {k[len("train.graph_"):]: c.get(k, 0) for k in GRAPH_COUNTERS}


def train_graph_phase(smi_line):
    """Phase ``train_graph``: each family's loss trained for an epoch through
    ``run_training`` with the step replayed and with it eager; the replays,
    captures and fallbacks of each and the records' largest relative gap.
    Then a loss that reads the host inside, which a graph cannot hold:
    counted as a fallback, the step goes on eagerly with the eager step's
    losses, and the next step captures as before."""
    from unittest import mock

    import numpy as np
    import torch

    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.train import loop
    from upgdm_tpu_torch.train.optimizers import make_optimizer
    from upgdm_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    ring = np.roll(np.eye(GRAPH_V, dtype=np.float32), 1, axis=1)
    adj = ring + ring.T
    opt = dict(optimizer_name="Adam", lr=1e-4, weight_decay=1e-5)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, net, select, nodes in graph_cases():
            L = net["windows"] + net["pred_len"]
            shape = (2 * GRAPH_B + 3,) + ((nodes,) if nodes else ()) + (L, 1)
            data = (1.0 + (rng.normal(size=shape) * 0.05).cumsum(axis=-2)).astype(np.float32)
            train = dict(train_model_select=select, train_batch_size=GRAPH_B,
                         val_batch_size=GRAPH_B, train_epochs=1, test_set=True, ckpt=False)
            runs = {}
            for route in ("graph", "eager"):
                profiling.phase_timer().reset()
                off = (mock.patch.object(loop, "_on_card", lambda o: False) if route == "eager"
                       else contextlib.nullcontext())
                with off:
                    rs = loop.run_training(data, data[:GRAPH_B], train, dict(net), {}, opt,
                                           Path(tmp) / name / route,
                                           adj=adj if nodes else None, seed=0, device="cuda")
                runs[route] = (rs, graph_counts())
            (rs_g, c_g), (rs_e, c_e) = runs["graph"], runs["eager"]
            require(rs_g["epoch"] == rs_e["epoch"] == [0], "train_graph",
                    f"{name}: an epoch did not end (records {rs_g}, {rs_e})")
            got = np.array(rs_g["train_scores"] + rs_g["val_scores"])
            want = np.array(rs_e["train_scores"] + rs_e["val_scores"])
            rel = float(np.max(np.abs(got - want) / np.abs(want)))
            rows[name] = {"graph": c_g, "eager": c_e, "records_max_rel": rel,
                          "train_score": rs_g["train_scores"][-1]}
            require(np.isfinite(got).all(), "train_graph", f"{name}: records {rs_g}")
            require(c_g == {"captures": 1, "replays": 2, "fallbacks": 0}
                    and c_e == {"captures": 0, "replays": 0, "fallbacks": 0}, "train_graph",
                    f"{name}: graph route {c_g}, eager route {c_e}")
            require(rel <= GRAPH_REL, "train_graph",
                    f"{name}: replayed records {rel} off the eager ones")

        # a loss that reads the host: the step falls back to eager
        batches = torch.as_tensor((1.0 + (rng.normal(size=(4, GRAPH_B, WINDOWS + PRED_LEN, 1))
                                          * 0.05).cumsum(axis=-2)).astype(np.float32),
                                  device="cuda")
        losses = {}
        for route in ("fallback", "eager"):
            profiling.phase_timer().reset()
            model = NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")
            loss_fn = model.loss_fn

            def reads_host(batch, **kw):
                out = loss_fn(batch, **kw)
                return out * (1.0 if float(out) > -1.0 else 0.0)

            model.loss_fn = reads_host
            off = (mock.patch.object(loop, "_on_card", lambda o: False) if route == "eager"
                   else contextlib.nullcontext())
            with off:
                step = loop.make_train_step(model, make_optimizer(
                    opt, model.net, model.trainable_mask()), None)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                losses[route] = [step(b) for b in batches]
            losses[route + "_counts"] = graph_counts()
        # and the next step captures as before
        profiling.phase_timer().reset()
        model = NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")
        step = loop.make_train_step(model, make_optimizer(opt, model.net,
                                                          model.trainable_mask()), None)
        losses["after"] = [step(b) for b in batches]
        losses["after_counts"] = graph_counts()
        torch.cuda.synchronize()
        rows["host_read_in_the_loss"] = losses
        require(losses["fallback_counts"] == {"captures": 0, "replays": 0, "fallbacks": 1}
                and losses["fallback"] == losses["eager"], "train_graph",
                f"a loss that reads the host: {losses}")
        require(losses["after_counts"] == {"captures": 1, "replays": 4, "fallbacks": 0}
                and np.isfinite(losses["after"]).all(), "train_graph",
                f"the step after a fallback: {losses}")
    profiling.phase_timer().reset()
    emit(phase="train_graph", card=smi_line, seconds=time.perf_counter() - t0, batch=GRAPH_B,
         bar_rel=GRAPH_REL, **rows)


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


def determinism_cost(model, select, batch):
    """The float32 train step's median ms without and with deterministic
    cuDNN (``run_training``'s setting), in turns: off, on, on, off; each the
    mean of its two."""
    import contextlib

    from upgdm_tpu_torch.train.loop import deterministic_cudnn

    times = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        with deterministic_cudnn() if mode == "on" else contextlib.nullcontext():
            times[mode].append(train_step_ms(model, select, batch, "float32")[0])
    return {k: statistics.mean(v) for k, v in times.items()}


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


def stg_trajectory(n_nodes, T, seed=0):
    """A seeded positive random walk [n_nodes, T] float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    walk = (rng.normal(size=(n_nodes, T)) * 0.01).cumsum(axis=1)
    return (0.3 + walk + np.linspace(0.0, 0.4, T)[None]).astype(np.float32)


def real_nodes(bundle):
    """The node count of each graph of a padded (adjs, graph_ids) bundle:
    the nodes with an edge (every node of the tracked BA graphs has one)."""
    return [int(n) for n in (bundle[0].sum(axis=2) > 0).sum(axis=1)]


def write_stg_corpus(root):
    """A seeded spdata directory on the tracked 30- and 50-node BA graphs:
    <root>/spdata/<g>/rec.pt (ys_dynamic [T, V]) with <root>/graphs/<g>.graphml."""
    import numpy as np

    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.utils.io import save_pt

    for i, src in enumerate(STG_GRAPHS):
        name = src.stem
        (root / "graphs").mkdir(parents=True, exist_ok=True)
        (root / "graphs" / src.name).write_bytes(src.read_bytes())
        n = graphml_to_adjacency(src).num_nodes
        # 8 windows of W + P at STG_STEP, each emitted flipped and original
        ys = stg_trajectory(n, WINDOWS + PRED_LEN + 7 * STG_STEP, seed=10 + i).T
        save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(len(ys), dtype=np.float32) * 0.1,
                 "tp_values": np.zeros(len(ys), np.float32)}, root / "spdata" / name / "rec.pt")


class Forwards:
    """Counts the forwards of every module of class ``cls`` (a global forward
    pre-hook); ``remove()`` takes the hook out."""

    def __init__(self, cls):
        import torch

        self.n = 0

        def hook(module, args):
            if isinstance(module, cls):
                self.n += 1

        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)

    def remove(self):
        self.handle.remove()


def ugnet_forwards():
    """A counter of the graph U-Net forwards (DiffSTG's UGnet and
    NsDiff_spatial's denoiser)."""
    from upgdm_tpu_torch.models.ugnet import GraphUNet

    return Forwards(GraphUNet)


def idle_share(fn, top=8):
    """From one ``torch.profiler`` trace of fn() (device activity): host
    seconds ended by a synchronise, summed kernel seconds, 1 - kernel / host,
    the kernel count and the ``top`` kernel names by summed ms (the device
    numbers None when the profiler sees no device time)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, _ = host_s(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"host_s": wall, "kernel_s": None, "idle_share": None, "kernels": 0}
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:90]] += e.time_range.elapsed_us() * 1e-3
    busy = sum(by_name.values()) * 1e-3
    return {"host_s": wall, "kernel_s": busy, "idle_share": 1.0 - busy / wall,
            "kernels": len(kernels), "top_ms": by_name.most_common(top)}


def stg_train_step(batch, adj):
    """(median ms of a float32 DiffSTG train step at the published width,
    ``train_step_ms``, a profile of one more step) under ``run_training``'s
    deterministic cuDNN."""
    import numpy as np
    import torch

    from upgdm_tpu_torch.models.diffstg import DiffSTGModel
    from upgdm_tpu_torch.train.loop import deterministic_cudnn, make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    model = DiffSTGModel(STG_PARAM, seed=2, device="cuda")
    batch = torch.as_tensor(batch, device="cuda")
    adj = torch.as_tensor(np.stack([adj] * len(batch)), device="cuda")
    with deterministic_cudnn():
        ms, losses = train_step_ms(model, None, batch, "float32", adj=adj)
        step = make_train_step(model, make_optimizer({"optimizer_name": "Adam", "lr": 1e-3},
                                                     model.net, model.trainable_mask()), None)
        profiled = idle_share(lambda: step(batch, adj=adj))
    require(np.isfinite(losses).all(), "diffstg_train", f"step losses {losses}")
    return ms, profiled


def ugnet_forward_ms(adj, S):
    """Median ms (CUDA events, 5 after 2) of one UGnet forward at the
    published width over S samples, in bf16 and float32, with the port's
    TimeConvTranspose (the transposed conv of the flipped kernel) and with
    the correlation over the zero-stuffed, padded input it replaces."""
    import torch
    import torch.nn.functional as F

    from upgdm_tpu_torch.models import ugnet
    from upgdm_tpu_torch.models.diffstg import DiffSTGModel
    from upgdm_tpu_torch.models.layers import promote

    def padded(self, x):
        def fn(h):
            if self.s > 1:
                stuffed = h.new_zeros(h.shape[:-1] + ((h.shape[-1] - 1) * self.s + 1,))
                stuffed[..., :: self.s] = h
                h = stuffed
            return F.conv1d(*promote(h, self.weight, self.bias), padding=self.k - 1 - self.p)

        return ugnet._over_time(x, fn)

    model = DiffSTGModel(STG_PARAM, seed=0, device="cuda")
    transposed = ugnet.TimeConvTranspose.forward
    V = adj.shape[-1]
    out = {}
    try:
        for dt in (torch.bfloat16, torch.float32):
            net = model._cast("model", dt)
            x = torch.randn(S, V, WINDOWS + PRED_LEN, 1, device="cuda").to(dt)
            t = torch.full((S,), 57.0, device="cuda")
            a = torch.as_tensor(adj, device="cuda")[None].to(dt)
            for name, fwd in (("transposed", transposed), ("padded_conv1d", padded)):
                ugnet.TimeConvTranspose.forward = fwd
                with torch.inference_mode():
                    out[f"{str(dt)[6:]}_{name}"] = cuda_ms(lambda: net(x, t, x, a), reps=5)
    finally:
        ugnet.TimeConvTranspose.forward = transposed
    return out


def stg_off_by(got, want, rtol, atol):
    """Largest |got - want| - (atol + rtol |want|): <= 0 within the bar."""
    import numpy as np

    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def diffstg_phases(smi_line, zero_counts, kernel_counts):
    """DiffSTG on the card: the cache runner over STG_WINDOWS windows
    (``diffstg``), training through the ``adj`` path and the swept checkpoint
    (``diffstg_train``), and the DiffSTG branch of ``uncertainty_ews``
    (``diffstg_facade``). No hand-written kernel is on this path (the JAX
    package runs DiffSTG in plain XLA): ``kernel_counts()`` stays zero."""
    import numpy as np
    import torch

    from upgdm_tpu_torch.cli.train_driver import hold_out_score
    from upgdm_tpu_torch.cli.train_spdata import build_dataset
    from upgdm_tpu_torch.eval.uncertainty import (
        load_model_from_dir, run_diffstg_evaluation_cache, summarize_pred_future_list,
        uncertainty_ews,
    )
    from upgdm_tpu_torch.models.diffstg import DiffSTGModel
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.utils.io import save_checkpoint, save_config_yaml, save_pt

    forwards = ugnet_forwards()
    graph = graphml_to_adjacency(STG_GRAPHS[0])
    V = graph.num_nodes
    traj = stg_trajectory(V, WINDOWS + (STG_WINDOWS - 1) * STG_STEP)  # STG_WINDOWS windows
    idx = (np.arange(STG_WINDOWS) * STG_STEP)[:, None] + np.arange(WINDOWS)[None]
    wins = np.ascontiguousarray(traj[:, idx].transpose(1, 0, 2))[..., None]  # [n, V, W, 1]
    steps = STG_PARAM["inference_diffusion_steps"]
    S = STG_PARAM["parallel_sampling"] * STG_PARAM["sequential_sampling"]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- diffstg: the cache runner at full width --------------------------------
        model = DiffSTGModel(STG_PARAM, seed=0, device="cuda")
        model.scaler_fit(wins.reshape(-1, WINDOWS, 1))
        run_diffstg_evaluation_cache(model, wins[:1], PRED_LEN, graph, tmp / "warm.pt",
                                     device="cuda")
        zero_counts()
        forwards.n = 0
        t_sweep, ens = host_s(lambda: run_diffstg_evaluation_cache(
            model, wins, PRED_LEN, graph, tmp / "sweep.pt", device="cuda"))
        n_fwd, launched = forwards.n, kernel_counts()
        _, mpv = summarize_pred_future_list(ens, model=model)
        mpv = np.asarray(mpv)
        profiled = idle_share(lambda: model.evaluation_step(
            {"x": model.scaler_transform(wins[0]), "adj": graph.adj}))
        forward_ms = ugnet_forward_ms(graph.adj, S)
        # card against CPU, float32 on both, the same weights and draws: 2 samples
        rng = np.random.default_rng(1)
        hist = np.asarray(model.scaler_transform(wins[0]), np.float32)
        f32 = dict(STG_PARAM, sampling_dtype="float32")
        card32 = DiffSTGModel(f32, seed=0, device="cuda")
        cpu32 = DiffSTGModel(f32, seed=0, device="cpu")
        draws = (rng.normal(size=(2, V, 2 * WINDOWS, 1)).astype(np.float32),
                 rng.normal(size=(steps, 2, V, 2 * WINDOWS, 1)).astype(np.float32))
        e_card = card32.sample_fn(hist, graph.adj, n_samples=2, noise=draws).cpu().numpy()
        e_cpu = cpu32.sample_fn(hist, graph.adj, n_samples=2, noise=draws).numpy()
        card_cpu = stg_off_by(e_card, e_cpu, STG_RTOL, STG_ATOL)
        # bf16 (the default) against float32 sampling on the card, the same draws
        draws = (rng.normal(size=(S, V, 2 * WINDOWS, 1)).astype(np.float32),
                 rng.normal(size=(steps, S, V, 2 * WINDOWS, 1)).astype(np.float32))
        m32 = card32.sample_fn(hist, graph.adj, n_samples=S, noise=draws).var(dim=-1).mean()
        card32.net_param["sampling_dtype"] = "bfloat16"
        m16 = card32.sample_fn(hist, graph.adj, n_samples=S, noise=draws).var(dim=-1).mean()
        bf16_rel = abs(m16.item() / m32.item() - 1.0)
        del card32, cpu32
        emit(phase="diffstg", card=smi_line, windows=STG_WINDOWS, nodes=V, samples=S,
             steps=steps, seconds=t_sweep, windows_per_hr=STG_WINDOWS / t_sweep * 3600.0,
             ugnet_forwards_per_window=n_fwd / STG_WINDOWS, kernel_launches=launched,
             mpv=mpv.tolist(), window_profiled=profiled, ugnet_forward_ms=forward_ms,
             card_vs_cpu_float32_off_bar=card_cpu, bf16_vs_float32_mpv_rel=bf16_rel,
             bars={"rtol": STG_RTOL, "atol": STG_ATOL, "mpv_rel": STG_MPV_REL})
        require(n_fwd == steps * STG_WINDOWS and not any(launched), "diffstg",
                f"{n_fwd} UGnet forwards for {STG_WINDOWS} windows, kernels {launched}")
        require(mpv.shape == (STG_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all(),
                "diffstg", f"bad MPV {mpv}")
        require(card_cpu <= 0, "diffstg", f"card off the CPU by {card_cpu} over the bar")
        require(bf16_rel <= STG_MPV_REL, "diffstg", f"bf16 MPV {bf16_rel:.4%} off float32")

        # -- diffstg_train: loss and gradients, run_training, the swept checkpoint ----
        seams = dict(adj=torch.as_tensor(np.stack([graph.adj] * 4)),
                     t=torch.tensor([1, 57, 133, 200]),
                     noise=torch.as_tensor(rng.normal(size=(4, V, 2 * WINDOWS, 1)),
                                           dtype=torch.float32))
        batch = torch.as_tensor(rng.normal(size=(4, V, 2 * WINDOWS, 1)), dtype=torch.float32)
        try:
            rel, worst = card_vs_cpu(DiffSTGModel(STG_PARAM, seed=1, device="cuda"),
                                     DiffSTGModel, STG_PARAM, batch, seams)
        except AssertionError as exc:
            fail("diffstg_train", str(exc))
        step_ms, step_profile = stg_train_step(
            rng.normal(size=(STG_TRAIN_B, V, WINDOWS + PRED_LEN, 1)).astype(np.float32),
            graph.adj)
        write_stg_corpus(tmp / "corpus")
        dataset_param = dict(spdata_file_path=str(tmp / "corpus/spdata"),
                             graph_file_path=str(tmp / "corpus/graphs"), filter="*",
                             sampling_t=0.1, windows=WINDOWS, pred_len=PRED_LEN,
                             interval_step=STG_STEP)
        x, bundle, nf = build_dataset(dataset_param)
        train_param = dict(train_model_select=None, train_batch_size=STG_TRAIN_B,
                           val_batch_size=STG_TRAIN_B, train_epochs=2, test_set=True,
                           ckpt=False, traindata_size=0.75, model_evaluation="hold_out")
        opt = dict(optimizer_name="Adam", lr=1e-4, weight_decay=1e-5, scheduler_set=False)
        zero_counts()
        t_train, rs = host_s(lambda: hold_out_score(
            x, train_param, dict(STG_PARAM), {"loss_metric": "KL divergence"}, opt,
            tmp / "train", adj_bundle=bundle, dataset_param=dataset_param, device="cuda"))
        n_steps = 2 * -(-int(len(x) * 0.75) // STG_TRAIN_B)
        trained, _ = load_model_from_dir(tmp / "train/hold_out/trained_model", device="cuda")
        forwards.n = 0
        t_tsweep, tens = host_s(lambda: run_diffstg_evaluation_cache(
            trained, wins[:2], PRED_LEN, graph, tmp / "trained.pt", device="cuda"))
        _, tmpv = summarize_pred_future_list(tens, model=trained)
        tmpv = np.asarray(tmpv)
        emit(phase="diffstg_train", card=smi_line, card_vs_cpu={"loss_rel": rel,
                                                              "worst_grad_err_over_bar": worst},
             windows=len(x), nodes=int(x.shape[1]), real_nodes=real_nodes(bundle),
             batch=STG_TRAIN_B, step_ms=step_ms, step_profiled=step_profile, steps=n_steps,
             seconds=t_train, train_scores=rs["train_scores"],
             val_scores=rs["val_scores"], kernel_launches=kernel_counts(),
             swept={"windows": 2, "seconds": t_tsweep, "ugnet_forwards": forwards.n,
                    "mpv": tmpv.tolist()})
        require(np.isfinite(rs["train_scores"]).all() and np.isfinite(rs["val_scores"]).all()
                and len(rs["train_scores"]) == 2, "diffstg_train", f"records {rs}")
        require(x.shape[1] == 50 and sorted(real_nodes(bundle)) == [30, 50],
                "diffstg_train", f"padding: {x.shape}, real nodes {real_nodes(bundle)}")
        require(forwards.n == 2 * steps and np.isfinite(tmpv).all() and (tmpv > 0).all(),
                "diffstg_train", f"swept checkpoint: {forwards.n} forwards, MPV {tmpv}")

        # -- diffstg_facade: uncertainty_ews from a checkpoint directory -------------
        model_dir = tmp / "facade_model"
        save_checkpoint(model_dir, "model_trained", model.state_dict(), STG_PARAM)
        save_config_yaml(model_dir / "model_trained.yaml", {
            "dataset": {"windows": WINDOWS, "pred_len": PRED_LEN, "sampling_t": 0.1,
                        "interval_step": STG_STEP},
            "train": {"train_model_select": None}, "net": STG_PARAM})
        data_file = tmp / "SIS_dynamic_increase.pt"
        save_pt({"ys_dynamic": traj.T.copy(),
                 "ts_dynamic": np.arange(traj.shape[1], dtype=np.float32) * 0.1,
                 "tp_values": np.zeros(traj.shape[1], np.float32)}, data_file)

        def facade():
            forwards.n = 0
            zero_counts()
            t, r = host_s(lambda: uncertainty_ews(
                model_save_file=model_dir, data_file=data_file, dynamic_type="SIS",
                graph_file=STG_GRAPHS[0], cache_path=tmp / "facade", device="cuda",
                cache_mode="write"))
            return t, r, forwards.n, kernel_counts()

        (tmp / "facade").mkdir()
        t_write, r_write, f_write, l_write = facade()
        t_hit, r_hit, f_hit, l_hit = facade()
        cache = Path(r_write["cache_path"])
        side = json.loads(cache.with_name(cache.name + ".mpv.json").read_text())
        n_fw = len(r_write["ews"])
        ews = np.asarray(r_write["ews"])
        emit(phase="diffstg_facade", card=smi_line, windows=n_fw,
             sample_window_step=r_write["sample_window_step"],
             diffusion_steps=r_write["loaded_net_param"]["diffusion_steps"],
             samples=r_write["pred_future_list"][0].shape[-1], seconds_write=t_write,
             windows_per_hr=n_fw / t_write * 3600.0, seconds_cache_hit=t_hit,
             ugnet_forwards={"write": f_write, "cache_hit": f_hit},
             kernel_launches={"write": l_write, "cache_hit": l_hit}, mpv=ews.tolist(),
             sidecar={"complete": side["complete"], "n_windows_done": side["n_windows_done"]})
        require(n_fw == STG_WINDOWS and np.isfinite(ews).all() and (ews > 0).all()
                and f_write == 20 * n_fw, "diffstg_facade",
                f"{n_fw} windows, MPV {ews}, {f_write} UGnet forwards")
        require(f_hit == 0 and r_hit["ews"] == r_write["ews"], "diffstg_facade",
                f"cache hit: {f_hit} forwards, MPV {r_hit['ews']} vs {r_write['ews']}")
        require(side["complete"] and side["n_windows_done"] == n_fw
                and side["ews"] == [float(v) for v in ews], "diffstg_facade",
                f"sidecar {side}")
    forwards.remove()

def nsdiff_spatial_phase(smi_line, zero_counts, kernel_counts):
    """NsDiff_spatial on the card (``nsdiff_spatial``): the per-graph sweep
    through ``run_diffstg_evaluation_cache`` at the grid's width (timed, one
    window profiled), the card's float32 ensemble per sample against the
    CPU's on the same normals, bf16 against float32 MPV on the same draws;
    then the three stages through ``cli.train_spdata``'s dataset and
    ``hold_out_score`` (pretrain_f -> pretrain_g -> NsDiff_model with
    ``load_pretrain``), the step timed at the grid's batch, the card's loss
    and gradients against the CPU's, and the trained checkpoint swept. No
    hand-written denoiser kernel is on this path (the JAX package's chain
    drives a UGnet in plain XLA): ``kernel_counts()`` stays zero, while the
    chain's posterior update is ``nsdiff_chain_update``'s kernel, as every
    NsDiff chain's on the card, T launches a window's chain."""
    import numpy as np
    import torch

    from upgdm_tpu_torch.cli.train_driver import hold_out_score
    from upgdm_tpu_torch.cli.train_spdata import build_dataset
    from upgdm_tpu_torch.eval.uncertainty import (
        load_model_from_dir, run_diffstg_evaluation_cache, summarize_pred_future_list,
    )
    from upgdm_tpu_torch.models.nsdiff_spatial import NsDiffSpatialModel
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.train.loop import deterministic_cudnn

    forwards = ugnet_forwards()
    graph = graphml_to_adjacency(STG_GRAPHS[0])
    V = graph.num_nodes
    traj = stg_trajectory(V, WINDOWS + (STG_WINDOWS - 1) * STG_STEP)
    idx = (np.arange(STG_WINDOWS) * STG_STEP)[:, None] + np.arange(WINDOWS)[None]
    wins = np.ascontiguousarray(traj[:, idx].transpose(1, 0, 2))[..., None]  # [n, V, W, 1]
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model = NsDiffSpatialModel(SP_PARAM, seed=0, device="cuda")
        model.scaler_fit(wins.reshape(-1, WINDOWS, 1))  # per feature, as run_training
        run_diffstg_evaluation_cache(model, wins[:1], PRED_LEN, graph, tmp / "warm.pt",
                                     device="cuda")
        zero_counts()
        forwards.n = 0
        t_sweep, ens = host_s(lambda: run_diffstg_evaluation_cache(
            model, wins, PRED_LEN, graph, tmp / "sweep.pt", device="cuda"))
        n_fwd, launched = forwards.n, kernel_counts()
        counted_updates("nsdiff_spatial", "the sweep", STEPS * STG_WINDOWS)
        mpv = np.asarray(summarize_pred_future_list(ens, model=model)[1])
        hist = np.asarray(model.scaler_transform(wins[0]), np.float32)
        profiled = idle_share(lambda: model.evaluation_step({"x": hist, "adj": graph.adj}))
        # The checks need a chain that stays bounded: with random weights at this
        # width about half the draws give a chain that diverges (to 1e6-1e10 in
        # both packages' arithmetic; the card equals the CPU there at the MPV
        # level), where bf16 against float32 is chaos, not precision. They take
        # the first seed whose float32 chain stays within SP_BOUNDED.
        f32 = dict(SP_PARAM, sampling_dtype="float32")
        screened = {}
        for seed in range(8):
            card32 = NsDiffSpatialModel(f32, seed=seed, device="cuda")
            top = card32.sample_fn(hist[None], graph.adj, torch.Generator(device="cuda")
                                   .manual_seed(0), n_z_samples=8).abs().max().item()
            screened[seed] = top
            if top <= SP_BOUNDED:
                break
        require(top <= SP_BOUNDED, "nsdiff_spatial", f"no seed with a bounded chain: {screened}")
        # card against CPU, float32 on both, the same weights and normals: 2 samples
        cpu32 = NsDiffSpatialModel(f32, seed=seed, device="cpu")
        noise = [rng.normal(size=(2, 1, V, PRED_LEN, 1)).astype(np.float32)
                 for _ in range(STEPS)]
        e_card = card32.sample_fn(hist[None], graph.adj, n_z_samples=2, noise=noise)
        e_cpu = cpu32.sample_fn(hist[None], graph.adj, n_z_samples=2, noise=noise)
        card_cpu = stg_off_by(e_card.cpu().numpy(), e_cpu.numpy(), STG_RTOL, STG_ATOL)
        # bf16 (the default) against float32 on the card, the same draws
        draws = lambda: torch.Generator(device="cuda").manual_seed(5)
        m32 = card32.sample_fn(hist[None], graph.adj, draws()).var(dim=-1).mean().item()
        card32.net_param["sampling_dtype"] = "bfloat16"
        m16 = card32.sample_fn(hist[None], graph.adj, draws()).var(dim=-1).mean().item()
        bf16_rel = abs(m16 / m32 - 1.0)
        del card32, cpu32
        emit(phase="nsdiff_spatial", card=smi_line, windows=STG_WINDOWS, nodes=V, samples=N_Z,
             steps=STEPS, seconds=t_sweep, windows_per_hr=STG_WINDOWS / t_sweep * 3600.0,
             denoiser_forwards_per_window=n_fwd / STG_WINDOWS, kernel_launches=launched,
             mpv=mpv.tolist(), window_profiled=profiled, card_vs_cpu_float32_off_bar=card_cpu,
             bf16_vs_float32_mpv_rel=bf16_rel, mpv_float32=m32, checked_seed=seed,
             screened_max_abs=screened,
             bars={"rtol": STG_RTOL, "atol": STG_ATOL, "mpv_rel": STG_MPV_REL})
        require(n_fwd == STEPS * STG_WINDOWS and not any(launched), "nsdiff_spatial",
                f"{n_fwd} denoiser forwards for {STG_WINDOWS} windows, kernels {launched}")
        require(mpv.shape == (STG_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all(),
                "nsdiff_spatial", f"bad MPV {mpv}")
        require(card_cpu <= 0, "nsdiff_spatial", f"card off the CPU by {card_cpu} over the bar")
        require(bf16_rel <= STG_MPV_REL, "nsdiff_spatial",
                f"bf16 MPV {bf16_rel:.4%} off float32")

        # -- the three stages, the step, card against CPU, the swept checkpoint ------
        seams = dict(adj=torch.as_tensor(np.stack([graph.adj] * 4)),
                     t=torch.tensor([0, 7, 12, 19]),
                     noise=torch.as_tensor(rng.normal(size=(4, V, PRED_LEN, 1)),
                                           dtype=torch.float32))
        batch = torch.as_tensor(rng.normal(size=(4, V, WINDOWS + PRED_LEN, 1)),
                                dtype=torch.float32)
        try:
            rel, worst = card_vs_cpu(NsDiffSpatialModel(SP_PARAM, seed=1, device="cuda"),
                                     NsDiffSpatialModel, SP_PARAM, batch, seams)
        except AssertionError as exc:
            fail("nsdiff_spatial_train", str(exc))
        step_model = NsDiffSpatialModel(SP_PARAM, seed=2, device="cuda")
        b16 = torch.as_tensor(rng.normal(size=(SP_TRAIN_B, V, WINDOWS + PRED_LEN, 1)),
                              dtype=torch.float32, device="cuda")
        a16 = torch.as_tensor(np.stack([graph.adj] * SP_TRAIN_B), device="cuda")
        with deterministic_cudnn():
            step_ms = {s: train_step_ms(step_model, s, b16, "float32", adj=a16)[0]
                       for s in ("pretrain_f", "pretrain_g", None)}
        write_stg_corpus(tmp / "corpus")
        dataset_param = dict(spdata_file_path=str(tmp / "corpus/spdata"),
                             graph_file_path=str(tmp / "corpus/graphs"), filter="*",
                             sampling_t=0.1, windows=WINDOWS, pred_len=PRED_LEN,
                             interval_step=STG_STEP)
        x, bundle, _ = build_dataset(dataset_param)
        train_param = dict(train_batch_size=SP_TRAIN_B, val_batch_size=SP_TRAIN_B,
                           train_epochs=1, test_set=True, ckpt=False, traindata_size=0.75,
                           model_evaluation="hold_out")
        opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
        stages, net = {}, dict(SP_PARAM)
        zero_counts()
        for select in ("pretrain_f", "pretrain_g", "NsDiff_model"):
            if select == "NsDiff_model":
                net.update(load_pretrain=True, load_pretrain_f=True,
                           pretrain_f_path=str(tmp / "sp/pretrain_f/hold_out/trained_model"),
                           pretrain_g_path=str(tmp / "sp/pretrain_g/hold_out/trained_model"))
            t_stage, rs = host_s(lambda: hold_out_score(
                x, dict(train_param, train_model_select=select), dict(net),
                {"loss_metric": "KL divergence"}, opt, tmp / "sp" / select, adj_bundle=bundle,
                dataset_param=dataset_param, device="cuda"))
            stages[select] = {"seconds": t_stage, "train_scores": rs["train_scores"],
                              "val_scores": rs["val_scores"]}
            require(np.isfinite(rs["train_scores"]).all() and np.isfinite(rs["val_scores"]).all(),
                    "nsdiff_spatial_train", f"{select} records {rs}")
        trained, _ = load_model_from_dir(tmp / "sp/NsDiff_model/hold_out/trained_model",
                                         device="cuda")
        forwards.n = 0
        t_tsweep, tens = host_s(lambda: run_diffstg_evaluation_cache(
            trained, wins[:2], PRED_LEN, graph, tmp / "trained.pt", device="cuda"))
        tmpv = np.asarray(summarize_pred_future_list(tens, model=trained)[1])
        emit(phase="nsdiff_spatial_train", card=smi_line,
             card_vs_cpu={"loss_rel": rel, "worst_grad_err_over_bar": worst},
             batch=SP_TRAIN_B, step_ms={k or "NsDiff_model": v for k, v in step_ms.items()},
             windows=len(x), nodes=int(x.shape[1]), real_nodes=real_nodes(bundle),
             stages=stages, kernel_launches=kernel_counts(),
             swept={"windows": 2, "seconds": t_tsweep, "denoiser_forwards": forwards.n,
                    "mpv": tmpv.tolist()})
        require(forwards.n == 2 * STEPS and np.isfinite(tmpv).all() and (tmpv > 0).all(),
                "nsdiff_spatial_train",
                f"swept checkpoint: {forwards.n} forwards, MPV {tmpv}")
    forwards.remove()


class GradCalls:
    """Counts ``torch.autograd.grad`` calls (the Langevin corrector's
    gradients) while it is installed; ``remove()`` restores the function."""

    def __init__(self):
        import torch

        self.n, self._orig = 0, torch.autograd.grad

        def counting(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)

        torch.autograd.grad = counting

    def remove(self):
        import torch

        torch.autograd.grad = self._orig


def diffusionts_phase(smi_line, zero_counts, kernel_counts):
    """DiffusionTS on the card (``diffusionts``): ``uncertainty_ews`` on a
    seeded SIS record over the 30-node graph, written then hit (0 forwards),
    with the forwards and Langevin gradients a window counted; one sampling
    round at ``eval_rows_per_call`` rows (its peak memory) and one profiled;
    the card's float32 ensemble per sample against the CPU's with the
    corrector off (the same normals, the DFT-matmul route on both); bf16
    against float32 MPV on the same draws; the train step at the yaml's
    batch and the card's loss and gradients against the CPU's. No
    hand-written kernel is on this path (plain XLA in the JAX package)."""
    import numpy as np
    import torch

    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel
    from upgdm_tpu_torch.models.diffusionts_net import DTSTransformer, FourierLayer
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.utils.io import save_checkpoint, save_config_yaml, save_pt

    V = graphml_to_adjacency(STG_GRAPHS[0]).num_nodes
    traj = stg_trajectory(V, WINDOWS + (DTS_WINDOWS + 1) * STG_STEP, seed=4)
    rng = np.random.default_rng(4)
    model = DiffusionTSModel(DTS_PARAM, seed=0, device="cuda")
    model.scaler_fit(traj.reshape(-1, 1))
    _, rows = model.ddim_step_table()
    per_round = {"forwards": len(rows) + 1, "grads": sum(r[4] for r in rows)}
    per_round["forwards"] += per_round["grads"]
    rounds = -(-model.n_z_samples // model.parallel_sample)
    forwards, grads = Forwards(DTSTransformer), GradCalls()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            model_dir = tmp / "model"
            save_checkpoint(model_dir, "model_trained", model.state_dict(), DTS_PARAM)
            save_config_yaml(model_dir / "model_trained.yaml", {
                "dataset": {"windows": WINDOWS, "pred_len": PRED_LEN, "sampling_t": 0.1},
                "train": {"train_model_select": None}, "net": DTS_PARAM})
            data_file = tmp / "SIS_dynamic_increase.pt"
            save_pt({"ys_dynamic": traj.T.copy(),
                     "ts_dynamic": np.arange(traj.shape[1], dtype=np.float32) * 0.1,
                     "tp_values": np.zeros(traj.shape[1], np.float32)}, data_file)
            (tmp / "facade").mkdir()

            def facade():
                forwards.n = grads.n = 0
                zero_counts()
                t, r = host_s(lambda: uncertainty_ews(
                    model_save_file=model_dir, data_file=data_file, dynamic_type="SIS",
                    cache_path=tmp / "facade", device="cuda", cache_mode="write",
                    max_windows=DTS_WINDOWS))
                return t, r, forwards.n, grads.n, kernel_counts()

            t_write, r_write, f_write, g_write, l_write = facade()
            t_hit, r_hit, f_hit, g_hit, l_hit = facade()
            ews = np.asarray(r_write["ews"])
            n_fw = len(ews)

            # one round at eval_rows_per_call rows under the profiler, with its
            # peak memory
            rows32 = torch.as_tensor(rng.normal(size=(DTS_ROWS, WINDOWS, 1)),
                                     dtype=torch.float32, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            profiled = idle_share(lambda: model.sample_fn(rows32,
                                                          n_z_samples=model.parallel_sample))
            peak = torch.cuda.max_memory_allocated()

            # card against CPU, float32, corrector off, 2 rows x 2 draws: every
            # forward of the CPU's chain fed to the card's transformer on the same
            # state and timestep (the DFT-matmul route on both), at the module bar.
            # The whole chains are compared too, for the record only: a top-k
            # selection of the FourierLayer that a last-bit difference flips, or
            # the +-1 clamp, sends a sample elsewhere (the JAX package calls the
            # chain chaotic, tests/test_models_e2e.py:178-183)
            f32 = dict(DTS_PARAM, sampling_dtype="float32", infill_learning_rate=0.0)
            card32 = DiffusionTSModel(f32, seed=0, device="cuda")
            cpu32 = DiffusionTSModel(f32, seed=0, device="cpu")
            for m in cpu32.net.modules():  # the card's route on the CPU too
                if isinstance(m, FourierLayer):
                    m.use_dft_matmul = True
            T = WINDOWS + PRED_LEN
            hist = rows32[:2].cpu().numpy()
            noise = (rng.normal(size=(2, 2, T, 1)).astype(np.float32),
                     rng.normal(size=(len(rows), 2, 2, T, 1)).astype(np.float32),
                     rng.normal(size=(len(rows), 2, 2, T, 1)).astype(np.float32))
            calls, plain_output = [], cpu32._output

            def recorded(net, x, t, gen=None):
                y = plain_output(net, x, t, gen)
                calls.append((x, t, y))
                return y

            cpu32._output = recorded
            e_cpu = cpu32.sample_fn(hist, n_z_samples=2, noise=noise).numpy()
            fwd_rel = []
            with torch.no_grad():
                for x, t, y in calls:
                    yc = card32._output(card32.net["model"], x.to("cuda"), t.to("cuda")).cpu()
                    fwd_rel.append(((yc - y).abs().max() / y.abs().max()).item())
            e_card = card32.sample_fn(hist, n_z_samples=2, noise=noise).cpu().numpy()
            chain_within = float((np.abs(e_card - e_cpu)
                                  <= STG_ATOL + STG_RTOL * np.abs(e_cpu)).mean())
            # bf16 (the default) against float32, corrector on, 8 rows x 100 draws
            # in one call each, the same draws
            rows8 = torch.as_tensor(model.scaler_transform(traj[:8, :WINDOWS, None]),
                                    dtype=torch.float32, device="cuda")
            mpvs = {}
            for dt in ("float32", "bfloat16"):
                model.net_param.update(sampling_dtype=dt, sample_chunk=N_Z)
                gen = torch.Generator(device="cuda").manual_seed(11)
                mpvs[dt] = model.sample_fn(rows8, gen, N_Z).var(dim=-1).mean().item()
            del model.net_param["sample_chunk"]
            bf16_rel = abs(mpvs["bfloat16"] / mpvs["float32"] - 1.0)

            # the train step at the yaml's batch; card against CPU on 4 rows
            tb = torch.as_tensor(rng.normal(size=(DTS_TRAIN_B, T, 1)), dtype=torch.float32,
                                 device="cuda")
            step_ms, losses = train_step_ms(DiffusionTSModel(DTS_PARAM, seed=1, device="cuda"),
                                            None, tb, "float32")
            n_t = DTS_PARAM["timesteps"]
            seams = dict(t=torch.tensor([0, n_t // 3, 2 * n_t // 3, n_t - 1]),
                         noise=torch.as_tensor(rng.normal(size=(4, T, 1)), dtype=torch.float32))
            try:
                rel, worst = card_vs_cpu(DiffusionTSModel(DTS_PARAM, seed=1, device="cuda"),
                                         DiffusionTSModel, DTS_PARAM, tb[:4].cpu(), seams)
            except AssertionError as exc:
                fail("diffusionts", str(exc))
    finally:
        forwards.remove()
        grads.remove()
    emit(phase="diffusionts", card=smi_line, windows=n_fw, nodes=V, samples=N_Z,
         ddim_steps=len(rows) + 1, seconds_write=t_write, windows_per_hr=n_fw / t_write * 3600.0,
         seconds_cache_hit=t_hit, forwards_per_window=f_write / max(n_fw, 1),
         langevin_grads_per_window=g_write / max(n_fw, 1), expected_per_round=per_round,
         rounds_per_window=rounds, forwards_cache_hit=f_hit,
         kernel_launches={"write": l_write, "cache_hit": l_hit}, mpv=ews.tolist(),
         round_rows=DTS_ROWS, peak_bytes_round=peak,
         peak_bytes_over_base=peak - base, round_profiled=profiled,
         card_vs_cpu_forwards={"forwards": len(fwd_rel), "worst_rel": max(fwd_rel),
                               "over_bar": sum(r > DTS_FWD_REL for r in fwd_rel)},
         card_vs_cpu_chain_within_bar=chain_within, bf16_vs_float32_mpv_rel=bf16_rel,
         mpv_dtypes=mpvs,
         train_batch=DTS_TRAIN_B, step_ms=step_ms,
         card_vs_cpu={"loss_rel": rel, "worst_grad_err_over_bar": worst},
         bars={"forward_rel": DTS_FWD_REL, "rtol": STG_RTOL, "atol": STG_ATOL,
               "mpv_rel": DTS_MPV_REL})
    require(n_fw == DTS_WINDOWS and np.isfinite(ews).all() and (ews > 0).all()
            and f_write == n_fw * rounds * per_round["forwards"]
            and g_write == n_fw * rounds * per_round["grads"] and not any(l_write),
            "diffusionts", f"{n_fw} windows, MPV {ews}, {f_write} forwards, {g_write} grads")
    require(f_hit == 0 and g_hit == 0 and r_hit["ews"] == r_write["ews"], "diffusionts",
            f"cache hit: {f_hit} forwards, MPV {r_hit['ews']} vs {r_write['ews']}")
    require(len(fwd_rel) == len(rows) + 1, "diffusionts",
            f"{len(fwd_rel)} forwards in a chain of {len(rows) + 1} steps, corrector off")
    require(max(fwd_rel) <= DTS_FWD_REL, "diffusionts",
            f"card off the CPU on a forward by {max(fwd_rel)} of its scale")
    require(bf16_rel <= DTS_MPV_REL, "diffusionts", f"bf16 MPV {bf16_rel:.4%} off float32")
    require(np.isfinite(losses).all(), "diffusionts", f"step losses {losses}")


# The SLBP analyses at the trained demo model's full width: demo_artifacts/model
# (NsDiff, d_model 64 e2/d1, d_ff 128, F 2, W/P 100/100, 20 steps, n_z 100) over the
# tracked trajectory (2,000,000 x 2, sampling_t 100 -> 2,000 points: 191 windows at
# the step 10, 181 targets), in chunks of 16 windows: 12 chunks of 20 K1 launches
# at 16 x 100 x 100 = 160,000 rows (examples/slbp_demo.py:146-156)
SLBP_MODEL = DEMO / "model"
SLBP_NAME = "dataset__w100p100st100"
SLBP_WINDOWS, SLBP_TARGETS, SLBP_CHUNK, SLBP_ROWS = 191, 181, 16, 16 * 100 * 100
SLBP_K1 = STEPS * -(-SLBP_WINDOWS // SLBP_CHUNK)  # 240 launches a sweep
SLBP_GX_WINDOWS, SLBP_SAMPLE_WINDOWS = 8, 2
# g(x) on the card against the CPU (tests/test_torch_parity.py); the demo
# scan's gx metrics against demo_artifacts/summary.json (both packages on
# the CPU reproduce them within 0.1%: tests/test_torch_port_slbp.py::
# test_gx_metrics_reproduce_the_demo_record); its sampling metrics (statistics of
# 100 draws a window, on another RNG stream than the record's) against the
# same record at 3%: two card seeds gave 0.64% and 1.06% at most, 0.8% apart
SLBP_GX_TOL, SLBP_GX_REL, SLBP_SAMPLING_REL = 1e-4, 0.01, 0.03
SLBP_METRICS = ("baseline_mpv", "pre_transition_drop_percent", "global_drop_percent")
# the figures' SLBP tree: the tracked model under every name fig4-fig9 read, the
# tracked trajectory under every record name (examples/paper_figures_demo.py's
# layout at the demo's total time)
FIG_TT, FIG_D, FIG_NOISES = "200000.0", "1e-05", ("1e-05", "5e-06")
# mpv_collapse over demo_fig1: each row's skip reason and gx baseline MPV as the
# JAX package gives them on the CPU (python -m upgdm_tpu.figures.mpv_collapse
# --ews-root demo_fig1/ews_results --source-root demo_fig1 --model-name NsDiff;
# tests/test_torch_port_figures.py::test_mpv_collapse_on_demo_fig1_matches_jax
# holds the port's CPU rows to JAX's); the neuronal record's transition
# (t = 5.01) leaves too few MPV points before it
MC_EXPECTED = {"biomass": ("", 0.04759270538176809),
               "neuronal": ("too_few_pre_transition_mpv_points", None),
               "SIS": ("", 0.7768259048461914)}


IMAGES = (".png", ".svg", ".pdf")


def _ignored(rel, patterns):
    """Whether a .gitignore's ``patterns`` (negations left out) drop the
    relative path ``rel``: a pattern with a slash before its end is anchored
    and matched segment by segment, one ending in a slash names a directory,
    any other matches a name at any depth."""
    from fnmatch import fnmatchcase

    parts = rel.split("/")
    for pat in patterns:
        is_dir = pat.endswith("/")
        pat = pat.rstrip("/")
        segs = pat.lstrip("/").split("/")
        if "/" in pat:
            n = len(segs)
            if (len(parts) > n if is_dir else len(parts) == n) and all(
                    fnmatchcase(a, b) for a, b in zip(parts, segs)):
                return True
        elif any(fnmatchcase(a, pat) for a in (parts[:-1] if is_dir else parts)):
            return True
    return False


def artifact_names(root, like=None):
    """The relative paths of the files under ``root`` that are not images,
    .gitignore files, MPV sidecars (``.mpv.json``: the facade of either
    package writes one beside each `.pt` cache, which the trees' .gitignore
    drop) or paths the .gitignore of the tree ``like`` (default ``root``)
    drops: the names a driver's output tree shares with a tracked tree."""
    like = Path(like or root)
    gi = like / ".gitignore"
    patterns = [ln.strip() for ln in (gi.read_text().splitlines() if gi.exists() else [])
                if ln.strip() and not ln.startswith(("#", "!"))]
    root = Path(root)
    return sorted(r for r in (str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
                  if not r.endswith(IMAGES + (".mpv.json",)) and Path(r).name != ".gitignore"
                  and not _ignored(r, patterns))


def _install_slbp_model(models_dir, name):
    """The tracked SLBP model as ``models_dir/<name>`` + ``<name>.yaml``."""
    import shutil

    models_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(SLBP_MODEL / "model_trained", models_dir / name)
    shutil.copy(SLBP_MODEL / "model_trained.yaml", models_dir / f"{name}.yaml")


def _finite(values, n=None, positive=True):
    import numpy as np

    v = np.asarray(values, float)
    return ((n is None or v.shape == (n,)) and v.size > 0 and np.isfinite(v).all()
            and (not positive or (v > 0).all()))


def slbp_phase(smi_line, zero_counts, kernel_counts, bound):
    """The six SLBP analyses on the card over the 191 windows of the tracked
    model and trajectory (``slbp``): the sensitivity sweep timed with its K1
    launches and a profiled chunk; the sampling analysis served from its
    cache and the gx analysis, 0 launches each, gx against the CPU; the MPV
    analysis written then hit; the direct analysis on gx then on sampling
    with the prediction error; the raw window variance; the card's float32
    ensemble per sample against the CPU's on shared noise; K1 at this path's
    shape against its twin; then the demo's scan through the facade, held
    to ``demo_artifacts/summary.json`` over two seeds. Returns the K1
    launches of the analyses' sweeps."""
    import contextlib
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.figures.mpv_collapse import locate_transition, metric_row_from_mpv
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, fused_denoiser_rows_reference,
        step_weights,
    )
    from upgdm_tpu_torch.ops.kernels.roofline import k1_work
    from upgdm_tpu_torch.ops.windows import slbp_sensitivity_windows
    from upgdm_tpu_torch.utils.io import load_pt

    data_file = next((DEMO / "slbp_data").rglob("*.pt"))
    rec = load_pt(data_file)
    series, tdata = np.asarray(rec["ys_dynamic"]), np.asarray(rec["ts_dynamic"])
    record = json.loads((DEMO / "summary.json").read_text())
    out, launches = {}, {}

    def counted(name, fn):
        zero_counts()
        t, r = host_s(fn)
        launches[name] = kernel_counts()
        counted_updates("slbp", name, launches[name][0])
        out[f"{name}_s"] = t
        return r

    # the model's yaml loads its pretrain stages from paths under the repo root
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        tmp = Path(tmp)
        root, cpu_root, model_dir = tmp / "card", tmp / "cpu", tmp / "model"
        for r in (root, cpu_root):
            _install_slbp_model(r / "models", SLBP_NAME)
        shutil.copytree(SLBP_MODEL, model_dir)
        args = (SLBP_NAME, series, tdata)

        # -- the sensitivity sweep (a chunk into a cache of its own first, to warm up)
        U.slbp_sensitivity_ews(root, *args, data_trend="warm", max_windows=SLBP_CHUNK,
                               device="cuda")
        sens = counted("sensitivity", lambda: U.slbp_sensitivity_ews(root, *args, device="cuda"))
        n_sens = len(sens["mpv"])
        model, _, _ = U.load_sensitivity_model(root, SLBP_NAME, device="cuda")
        win, targets, _ = slbp_sensitivity_windows(series, tdata, 100, 100, 100, 10)
        prof = idle_share(lambda: U.batched_window_ensemble(
            model, win[:SLBP_CHUNK, None], model.pred_len, chunk_windows=SLBP_CHUNK,
            device="cuda"))
        require(n_sens == SLBP_WINDOWS and _finite(sens["mpv"], SLBP_WINDOWS)
                and _finite(sens["prediction_error"], SLBP_TARGETS)
                and launches["sensitivity"] == (SLBP_K1, 0, 0), "slbp",
                f"sensitivity: {n_sens} windows, K1/K2/K3 launches {launches['sensitivity']}")

        # -- sampling: the sensitivity sweep's cache; gx: no kernel
        samp = counted("sampling", lambda: U.slbp_sampling_analysis(
            root, *args, device="cuda", allow_unavailable=False))
        require(samp["available"] and samp["cache_path"] == sens["cache_path"]
                and samp["mpv"] == [float(v) for v in sens["mpv"]]
                and len(samp["intrinsic_dimension"]) == SLBP_WINDOWS
                and launches["sampling"] == (0, 0, 0), "slbp",
                f"sampling: {samp['reason']!r}, launches {launches['sampling']}")
        gx = counted("gx", lambda: U.slbp_gx_analysis(root, *args, device="cuda"))
        gx_cpu = U.slbp_gx_analysis(cpu_root, *args, device="cpu", max_windows=SLBP_GX_WINDOWS)
        a, b = np.asarray(gx["gx_mpv"][:SLBP_GX_WINDOWS]), np.asarray(gx_cpu["gx_mpv"])
        gx_over = float(np.max(np.abs(a - b) - (SLBP_GX_TOL + SLBP_GX_TOL * np.abs(b))))
        require(_finite(gx["gx_mpv"], SLBP_WINDOWS) and launches["gx"] == (0, 0, 0)
                and gx_over <= 0, "slbp", f"gx: card off the CPU by {gx_over} over the bar, "
                f"launches {launches['gx']}")

        # -- MPV analysis written then hit; the direct analysis on gx, then sampling
        cache = tmp / "trends" / "D_1e-05_increase.pt"
        mpv_w = counted("mpv_write", lambda: U.slbp_mpv_analysis(root, *args, cache,
                                                                 device="cuda"))
        mpv_h = counted("mpv_hit", lambda: U.slbp_mpv_analysis(root, *args, cache,
                                                               device="cuda"))
        require(launches["mpv_write"] == (SLBP_K1, 0, 0) and launches["mpv_hit"] == (0, 0, 0)
                and mpv_h["mpv"] == mpv_w["mpv"] and _finite(mpv_w["mpv"], SLBP_WINDOWS)
                and mpv_h["sample_window_step"] == 10
                and mpv_h["uncertainty_source"] == "sampling", "slbp",
                f"mpv analysis: launches {launches['mpv_write']} / {launches['mpv_hit']}")
        d_gx = counted("direct_gx", lambda: U.slbp_direct_model_cache_analysis(
            model_dir, series, tdata, tmp / "direct/gx.pt", cache_kind="gx", device="cuda"))
        d_gx_rel = float(np.max(np.abs(np.asarray(d_gx["mpv"]) - gx["gx_mpv"])
                                / np.asarray(gx["gx_mpv"])))
        d_s = counted("direct_sampling", lambda: U.slbp_direct_model_cache_analysis(
            model_dir, series, tdata, tmp / "direct/samp.pt", cache_kind="sampling",
            compute_prediction_error=True, device="cuda"))
        require(d_gx["uncertainty_source"] == "gx" and d_gx_rel <= 1e-6
                and launches["direct_gx"] == (0, 0, 0)
                and d_s["uncertainty_source"] == "sampling" and _finite(d_s["mpv"], SLBP_WINDOWS)
                and _finite(d_s["prediction_error"], SLBP_TARGETS)
                and launches["direct_sampling"] == (SLBP_K1, 0, 0), "slbp",
                f"direct: gx {d_gx_rel} off the gx analysis, launches "
                f"{launches['direct_gx']} / {launches['direct_sampling']}")
        raw = U.slbp_raw_window_variance(series, tdata, windows=100, sampling_t=100,
                                         device="cuda")
        raw_cpu = U.slbp_raw_window_variance(series, tdata, windows=100, sampling_t=100,
                                             device="cpu")
        raw_d = float(np.max(np.abs(raw["variance"] - raw_cpu["variance"])))
        require(_finite(raw["variance"], SLBP_WINDOWS) and raw_d == 0.0, "slbp",
                f"raw window variance: card off the CPU by {raw_d}")

        # -- the card's float32 ensemble against the CPU's, per sample, shared noise
        f32 = {"sampling_dtype": "float32"}
        mc, _, _ = U.load_sensitivity_model(root, SLBP_NAME, device="cuda", infer_params=f32)
        mh, _, _ = U.load_sensitivity_model(cpu_root, SLBP_NAME, device="cpu", infer_params=f32)
        x = np.asarray(mc.scaler_transform(win[:SLBP_SAMPLE_WINDOWS]), np.float32)
        rng = np.random.default_rng(9)
        noise = [rng.standard_normal((mc.n_z_samples,) + x.shape[:1] + (mc.pred_len, 2))
                 .astype(np.float32) for _ in range(mc.diffusion_steps)]
        ens_c = mc.sample_chain(*mc.f_and_g(x), noise=noise).cpu()
        ens_h = mh.sample_chain(*mh.f_and_g(x), noise=noise)
        ens_over = ((ens_c - ens_h).abs() - (STG_ATOL + STG_RTOL * ens_h.abs())).max().item()
        require(torch.isfinite(ens_c).all().item() and ens_over <= 0, "slbp",
                f"float32 ensemble: card off the CPU by {ens_over} over rtol {STG_RTOL} "
                f"atol {STG_ATOL}")

        # -- K1 at this path's shape (160,000 rows, F 2, bf16 matmuls) against its twin
        with torch.no_grad():
            den = model.denoiser
            W = denoiser_weights(den)
            gen = torch.Generator(device="cuda").manual_seed(3)
            xk = torch.randn(SLBP_ROWS, 6, generator=gen, device="cuda")
            xk[:, 4:] = xk[:, 4:].abs() + 0.05  # gx > 0
            g7, kw16 = denoiser_gammas(den, 7), step_weights(W, torch.bfloat16)
            got = fused_denoiser_rows(xk, g7, kw16, matmul_dtype="bfloat16")
            want = fused_denoiser_rows_reference(xk, g7, W, matmul_dtype="bfloat16")
            k1_err = max((p - q).abs().max().item() for p, q in zip(got, want))
            k1_ms = cuda_ms(lambda: fused_denoiser_rows(xk, g7, kw16, matmul_dtype="bfloat16"))
            k1_plain = cuda_ms(lambda: fused_denoiser_rows_reference(
                xk, g7, W, matmul_dtype="bfloat16"))
            k1_bound = bound(k1_work(SLBP_ROWS, 2), "bfloat16")
        require(k1_err <= TOL["bfloat16"], "slbp",
                f"K1 at {SLBP_ROWS} rows, F 2: off its twin by {k1_err}")

        # -- the demo's scan through the facade (examples/slbp_demo.py:146-156), two seeds
        ts = np.asarray(tdata, float)[::1000]
        transition = locate_transition(ts, np.asarray(series, float)[::1000, 0], "SLBP",
                                       "increase")["transition_time"]
        orig_load = U.load_model_from_dir
        scans = {}
        for seed in (0, 1):
            def seeded(*a, **k):
                m, p = orig_load(*a, **k)
                m.generator.manual_seed(seed)
                return m, p

            sub = tmp / f"scan{seed}"
            with mock.patch.object(U, "load_model_from_dir", seeded):
                r = counted(f"scan{seed}", lambda: U.uncertainty_ews(
                    model_save_file=model_dir, data_file=data_file, dynamic_type="SLBP",
                    cache_path=sub / "mpv_cache.pt", nsdiff_g_path=sub / "mpv_cache_gx.pt",
                    sample_window_step=10, uncertainty_method="both", chunk_windows=16,
                    load_model_when_cached=True, device="cuda"))
            m_s = metric_row_from_mpv(r["time_points"], r["ews"], transition,
                                      slope_window_points=10)
            m_g = metric_row_from_mpv(r["nsdiff_g"]["time_points"], r["nsdiff_g"]["ews"],
                                      transition, slope_window_points=10)
            scans[seed] = {
                "windows": len(r["ews"]), "seconds": out[f"scan{seed}_s"],
                "k1_launches": launches[f"scan{seed}"][0],
                "sampling": {k: m_s.get(k) for k in SLBP_METRICS},
                "gx": {k: m_g.get(k) for k in SLBP_METRICS},
                "sampling_rel": {k: m_s[k] / record["sampling_mpv"][k] - 1 for k in SLBP_METRICS},
                "gx_rel": {k: m_g[k] / record["gx_mpv"][k] - 1 for k in SLBP_METRICS},
            }
            require(m_s.get("skip_reason") == "" and m_g.get("skip_reason") == ""
                    and len(r["ews"]) == SLBP_WINDOWS and _finite(r["ews"], SLBP_WINDOWS)
                    and launches[f"scan{seed}"] == (SLBP_K1, 0, 0), "slbp",
                    f"scan seed {seed}: {len(r['ews'])} windows, launches "
                    f"{launches[f'scan{seed}']}, skips {m_s.get('skip_reason')!r} / "
                    f"{m_g.get('skip_reason')!r}")
        rendered = None
        if importlib.util.find_spec("matplotlib") is not None:
            png = tmp / "slbp_mpv_collapse.png"
            U.plot_single_model_check(r, title="SLBP NsDiff MPV", save_path=png)
            rendered = png.exists() and png.stat().st_size > 0
            require(rendered, "slbp", "plot_single_model_check wrote no PNG")
    emit(phase="slbp", card=smi_line, windows=n_sens, chunk=SLBP_CHUNK,
         seconds_sensitivity=out["sensitivity_s"],
         windows_per_hr=n_sens / out["sensitivity_s"] * 3600.0,
         k1_launches_sensitivity=launches["sensitivity"][0], rows_per_launch=SLBP_ROWS,
         profiled_chunk=prof, seconds={k[:-2]: v for k, v in out.items()},
         launches_k1_k2_k3=launches, gx_card_vs_cpu_over_bar=gx_over,
         direct_gx_vs_gx_rel=d_gx_rel, float32_ensemble_card_vs_cpu_over_bar=ens_over,
         k1_slbp_shape={"rows": SLBP_ROWS, "F": 2, "ms": k1_ms, "plain_ms": k1_plain,
                        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                        "max_abs_err": k1_err},
         transition_time=transition, record_transition_time=record["transition_time_state"],
         scans=scans, plot_single_model_check=rendered or "skipped: no matplotlib",
         bars={"gx_card_vs_cpu": SLBP_GX_TOL, "gx_vs_record": SLBP_GX_REL,
               "sampling_vs_record": SLBP_SAMPLING_REL, "ensemble": [STG_RTOL, STG_ATOL]})
    require(transition == record["transition_time_state"], "slbp",
            f"transition {transition} vs the record's {record['transition_time_state']}")
    for seed, s in scans.items():
        gx_rel = max(abs(v) for v in s["gx_rel"].values())
        s_rel = max(abs(v) for v in s["sampling_rel"].values())
        require(gx_rel <= SLBP_GX_REL and s_rel <= SLBP_SAMPLING_REL, "slbp",
                f"scan seed {seed} against demo_artifacts/summary.json: gx {gx_rel:.4%} "
                f"(bar {SLBP_GX_REL:.0%}), sampling {s_rel:.4%} (bar {SLBP_SAMPLING_REL:.0%})")
    return sum(launches[k][0] for k in ("sensitivity", "mpv_write", "direct_sampling",
                                        "scan0", "scan1"))


def figures_phase(smi_line, zero_counts, kernel_counts):
    """The figure layer on the card (``figures``), over temporary copies of
    the tracked trees: fig1's data over ``demo_fig1`` (the NsDiff arm of each
    dynamics, swept through K1), ``mpv_collapse`` over the same tree (every
    row valid), and fig4-fig9's loaders over a tree with the tracked SLBP
    model under every name they read and the tracked trajectory under every
    record name. Each loader's MPVs are checked finite and its K1 launches
    counted; with matplotlib each figure is rendered too (this phase needs
    none). Returns the K1 launches of the loaders."""
    import contextlib
    import csv
    import shutil

    import numpy as np

    from upgdm_tpu_torch.figures import (
        fig1_model_compare as F1, fig4_model_sensitivity as F4, fig5_tipping_types as F5,
        fig6_slbp_model_analysis as F6, fig7_train_analysis as F7, fig8_train_source as F8,
        fig9_smoothing as F9, mpv_collapse as MC,
    )
    from upgdm_tpu_torch.figures.common import TRENDS, load_dynamic_record, slbp_source_path

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    t_phase = time.perf_counter()
    launches, seconds = {}, {}

    def counted(name, fn):
        zero_counts()
        seconds[name], r = host_s(fn)
        k1, k2, k3 = kernel_counts()
        require(k2 == 0 and k3 == 0, "figures", f"{name}: K2/K3 launched {k2}/{k3} times")
        counted_updates("figures", name, k1)
        launches[name] = k1
        return r

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        tmp = Path(tmp)
        outdir = tmp / "out"
        # -- fig1 and the MPV-collapse statistics over demo_fig1
        f1 = tmp / "demo_fig1"
        shutil.copytree(REPO / "demo_fig1", f1, ignore=shutil.ignore_patterns("figures"))
        base1 = ["--ews-root", str(f1 / "ews_results"), "--source-root", str(f1)]
        fig1 = counted("fig1", lambda: F1.collect_fig1_data(
            f1 / "ews_results", f1, "increase", "barabasi_albert_12_0", ("NsDiff",),
            device="cuda"))
        ok1 = all(_finite(d["models"]["NsDiff"]["ews"]) for d in fig1.values())
        require(len(fig1) == 3 and ok1 and launches["fig1"] > 0, "figures",
                f"fig1: finite MPVs {ok1}, K1 launches {launches['fig1']}")
        mc_out = outdir / "mpv_collapse"
        counted("mpv_collapse", lambda: MC.main(
            base1 + ["--output-dir", str(mc_out), "--model-name", "NsDiff", "--device", "cuda"]
            + (["--plot-checks"] if have_mpl else [])))
        with open(mc_out / "mpv_collapse_samples.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        got_mc = {r["dynamic_type"]: (r["skip_reason"], float(r["baseline_mpv"] or "nan"))
                  for r in rows}
        mc_ok = len(rows) == 3 and all(
            got_mc[k][0] == skip and (base is None or abs(got_mc[k][1] / base - 1) <= SLBP_GX_TOL)
            for k, (skip, base) in MC_EXPECTED.items())
        require(mc_ok, "figures", f"mpv_collapse rows (skip reason, baseline MPV) {got_mc}, "
                f"the JAX package's {MC_EXPECTED}")

        # -- fig4-fig9: the SLBP tree
        ews, src = tmp / "slbp/ews_results", tmp / "slbp/dataset"
        for bank, names in (
                ("NsDiff_pred/models", [f"dataset__w200p{p}st100" for p in F4.PRED_LENS]),
                ("NsDiff_windows/models", [f"dataset__w{w}p200st100" for w in F4.WINDOW_LENS]),
                ("NsDiff_trends/models", [F5.MODEL_NAME]),
                ("NsDiff_machine/NsDiff/models", [F6.DIFFUSION_MODEL_NAME, F9.MODEL_NAME]),
                ("NsDiff_machine/preg/models", [F6.PREG_MODEL_NAME])):
            for name in names:
                _install_slbp_model(ews / bank, name)
        dirs = ([ews / "NsDiff_dataset_contant" / f for f, _ in F7.TRAIN_D_PANELS + F7.TRAIN_N_PANELS]
                + [ews / "NsDiff_machine" / f for f, _ in F7.ABLATION_PANELS]
                + [ews / "NsDiff_dataset" / f for f, _, _ in F8.MODEL_PANELS])
        for d in dirs:
            shutil.copytree(SLBP_MODEL, d)
        tracked = next((DEMO / "slbp_data").rglob("*.pt"))
        stand_ins = []
        for trend in TRENDS:
            for d in FIG_NOISES:
                path = slbp_source_path(src, FIG_TT, trend, d)
                path.parent.mkdir(parents=True, exist_ok=True)
                path.symlink_to(tracked)
                if (trend, d) != ("increase", FIG_D):
                    stand_ins.append(str(path.relative_to(src)))
        emit(phase="figures", stand_in_records=stand_ins,
             note="the repo tracks one SLBP record (increase, D 1e-05); the tracked "
                  "trajectory stands in under these names")
        series_t = load_dynamic_record(slbp_source_path(src, FIG_TT, "increase", FIG_D))
        dev = {"device": "cuda"}
        f4 = counted("fig4", lambda: F4.load_sensitivity_data(
            ews, src, "increase", "mpv", total_time=FIG_TT, d_value=FIG_D, **dev))
        f5 = counted("fig5", lambda: [F5.load_panel_data(ews, src, trend, FIG_TT, "t2e5",
                                                         FIG_D, 10, **dev) for trend in TRENDS])
        f6 = counted("fig6", lambda: [F6.load_panel_data(ews, src, trend, total_time=FIG_TT,
                                                         d_value=FIG_D, **dev)
                                      for trend in TRENDS])
        f7 = counted("fig7", lambda: (
            [F7.load_gx_panel(ews, series_t[1], series_t[0], "increase", f, t, FIG_TT, FIG_D,
                              **dev) for f, t in F7.TRAIN_D_PANELS + F7.TRAIN_N_PANELS]
            + [F7.load_ablation_panel(ews, series_t[1], series_t[0], "increase", f, t, FIG_TT,
                                      FIG_D, **dev) for f, t in F7.ABLATION_PANELS]))
        recs8 = {trend: F8.load_slbp_record(src, trend, FIG_TT, FIG_D) for trend in TRENDS}
        f8 = counted("fig8", lambda: [
            F8.load_mpv(ews / "NsDiff_dataset" / f, recs8[trend], trend, FIG_TT, FIG_D, **dev)
            for trend in TRENDS for f, _, _ in F8.MODEL_PANELS])
        f9 = counted("fig9", lambda: [F9.load_signal(ews, src, noise, "increase", smooth, FIG_TT,
                                                     **dev)
                                      for noise in FIG_NOISES for smooth in (False, True)])
        unavailable = [p["sampling"]["reason"] for p in f6 if not p["sampling"].get("available")]
        require(not unavailable, "figures", f"fig6: sampling unavailable: {unavailable}")
        checks = {
            "fig4": all(_finite(v, SLBP_WINDOWS) for k in ("pred_ews", "win_ews")
                        for v in f4[k].values()),
            "fig5": all(_finite(p["mpv"], SLBP_WINDOWS) for p in f5),
            "fig6": all(_finite(p["sampling"]["mpv"], SLBP_WINDOWS)
                        and _finite(p["diffusion_gx"]["gx_mpv"], SLBP_WINDOWS)
                        and _finite(p["preg_gx"]["gx_mpv"], SLBP_WINDOWS)
                        and _finite(p["raw_variance"]["variance"], positive=False)
                        for p in f6),
            "fig7": all(_finite(p["mpv"], SLBP_WINDOWS)
                        and ("error" not in p or _finite(p["error"], SLBP_TARGETS)) for p in f7),
            "fig8": all(_finite(s["mpv"], SLBP_WINDOWS) for s in f8),
            "fig9": all(_finite(s["gx_mpv"], SLBP_WINDOWS) for s in f9),
        }
        sweeps = {"fig4": len(F4.PRED_LENS) + len(F4.WINDOW_LENS), "fig5": len(TRENDS),
                  "fig6": len(TRENDS), "fig7": len(F7.ABLATION_PANELS), "fig8": 0, "fig9": 0}
        wrong = {k: launches[k] for k, n in sweeps.items() if launches[k] != n * SLBP_K1}
        require(all(checks.values()) and not wrong, "figures",
                f"finite MPVs {checks}; K1 launches off {SLBP_K1} a sweep: {wrong}")

        render = "skipped: no matplotlib"
        if have_mpl:  # every loader above left its caches: the renders sweep nothing
            slbp_base = ["--ews-root", str(ews), "--source-root", str(src)]
            for mod, argv in (
                    (F1, base1 + ["--graph", "barabasi_albert_12_0", "--models", "NsDiff"]),
                    (F4, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F5, slbp_base + ["--d-values", FIG_D, "--time-rows", f"{FIG_TT}:t2e5:10"]),
                    (F6, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F7, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F8, slbp_base + ["--total-time", FIG_TT, "--d-value", FIG_D]),
                    (F9, slbp_base + ["--total-time", FIG_TT])):
                name = mod.__name__.rsplit(".", 1)[1]
                counted(f"render_{name}", lambda: mod.main(
                    argv + ["--output-dir", str(outdir / name), "--device", "cuda"]))
                pngs = list((outdir / name).glob("*.png"))
                require(len(pngs) == 1 and launches[f"render_{name}"] == 0, "figures",
                        f"{name}: PNGs {pngs}, K1 launches {launches[f'render_{name}']}")
            render = "rendered"
    emit(phase="figures", card=smi_line, seconds=time.perf_counter() - t_phase,
         loader_seconds=seconds, k1_launches=launches, render=render,
         mpv_collapse_rows=[{k: r[k] for k in ("dynamic_type", "transition_time", "baseline_mpv",
                                                "global_drop_percent", "skip_reason")}
                            for r in rows])
    return sum(v for k, v in launches.items() if not k.startswith("render_"))


# -- data generation on the card: K4 and the data layer (phase `datagen`) ------------
# K4 against its twin on the same Philox normals, element by element, over 1,000
# steps: SLBP bit for bit (the kernel rounds the twin's operations one by one in
# the same order, and both take the normals' Box-Muller transform in float64);
# the networks within K4_REL of the run's largest |state|: the product A v sums by
# FMA in node order in the kernel and in the BLAS's order in the twin (a few
# roundings of a state a step), and the neuronal sigmoid's expf is not PyTorch's
# exp; on these stable runs a step's difference decays instead of growing
# (measured on the H100: at most 5 roundings, 4.9e-7 of the scale). 2^-18 is 64
# roundings.
K4_REL = 2.0 ** -18
K4_STEPS = 1000
# the control's ramp, the initial states and the parameters of the checks: SIS
# with d 0.1 on its endemic branch at every N (eps lambda_max > d: near the
# disease-free state a state pushed below 0 runs away, which is why the
# simulators retry) and every Euler step stable (eps deg_max dt < 2; the tracked
# 100-node graph has a hub of degree 63)
K4_RAMP = {"SIS": (0.1, 0.2), "biomass": (0.0, 2.0), "neuronal": (0.0, 0.4),
           "SLBP": (0.0, 2.6)}
K4_INIT = {"SIS": (0.2, 1.0), "biomass": (5.0, 10.0), "neuronal": (0.0, 3.0)}
K4_PARAMS = {"biomass": {"r": 0.7, "k": 10.0, "d": 0.05}, "SIS": {"d": 0.1},
             "neuronal": {"tau": 2.0, "mu": 1.5}}
GRAPH_DIR = REPO / "dataset/train_dataset_graph"
NET_GRAPH = "barabasi_albert_100_0"  # the tracked 100-node graph (demo_n100's too)
# the demo corpus (examples/slbp_demo.py:37, 58-61) over DEMO_SEEDS seeds; its
# transition (every 1000th bream state) against demo_artifacts/summary.json's,
# which is one draw (the JAX package's seed 0): the record must lie in the 99%
# prediction interval of the seeds, mean +- t(0.995, n-1) s sqrt(1 + 1/n), widened
# by the locator's grid (1000 steps of 0.1): the noise moves an SLBP
# transition by thousands of time units from seed to seed.
DEMO_TT, DEMO_SEEDS, DG_GRID = 2e5, range(8), 1000 * 0.1
# examples/fig1_demo.py's SIS physics and settings (total 40, burn 20, dt 0.1, seed 3)
FIG1_SIS = dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4, total_time=40.0,
                burn_time=20.0, dt=0.1, seed=3)


def datagen_phase(smi_line, zero_counts, kernel_counts, bound):
    """The data layer on the card (``datagen``): K4 against its twin (every
    system, N 12/30/100/300, both noise modes, save_every 1 and 10, noise-free,
    two segmentations) and the simulators against their CPU runs, K4 timed
    against its bound; the JAX package's default SLBP
    corpus (4 x 10,010,000 steps); the demo corpus over five seeds, its
    transition held to ``demo_artifacts/summary.json``; one of those
    trajectories through the facade with the demo model (K1); the network CLI's
    defaults on the tracked 100-node graph for the three systems; a generated
    SIS record through the facade with the trained ``demo_fig1`` model; the
    graph library and the Bury corpus on the host. Returns (K1 launches, the
    kernels line's K4 row)."""
    import contextlib
    import io
    import random
    import shutil

    import numpy as np
    import torch
    from scipy.stats import t as student_t

    from upgdm_tpu_torch.data import bury_sim, generate, graphs, sde
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.figures.mpv_collapse import locate_transition, metric_row_from_mpv
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.ops.kernels.roofline import k4_work
    from upgdm_tpu_torch.ops.kernels.sde_scan import STREAM_RUN, sde_scan, sde_scan_reference
    from upgdm_tpu_torch.utils.io import load_pt, save_pt

    dev = torch.device("cuda")
    out, launches = {}, {}
    t_phase = time.perf_counter()

    def counted(name, fn):
        zero_counts()
        t, r = host_s(fn)
        launches[name] = kernel_counts() + (sde_scan.launches,)
        counted_updates("datagen", name, launches[name][0])
        out[f"{name}_s"] = t
        return r

    # -- K4 against its twin ------------------------------------------------------
    rng = np.random.default_rng(0)
    random.seed(0)
    adjs = {12: graphs.gen_graph("barabasi_albert", 12, 12, rng=random.Random(0)).adj,
            30: graphml_to_adjacency(GRAPH_DIR / "barabasi_albert_30_0.graphml").adj,
            100: graphml_to_adjacency(GRAPH_DIR / f"{NET_GRAPH}.graphml").adj,
            300: graphs.generate_network("BA", 300, m=3, seed=0).adj}
    slbp = sde.SystemDrift("SLBP")
    sig_slbp = np.array([(2e-5) ** 0.5, (2e-6) ** 0.5], np.float32)
    checks = {}

    def check(name, drift, y0, sig, save_every, noise, steps=K4_STEPS):
        d = drift.to(dev)
        eps = torch.linspace(*K4_RAMP[drift.system], steps, device=dev)
        args = (d, torch.as_tensor(y0, device=dev), eps, torch.as_tensor(sig, device=dev), 0.1,
                7, STREAM_RUN, 0, save_every, noise)
        y_k, ys_k = sde_scan(*args)
        y_t, ys_t = sde_scan_reference(*args)
        err = max((ys_k - ys_t).abs().max().item(), (y_k - y_t).abs().max().item())
        scale = ys_t.abs().max().item()
        ok = (ys_k.shape == (steps // save_every, len(y0)) and bool(torch.isfinite(ys_k).all())
              and (torch.equal(ys_k, ys_t) if drift.system == "SLBP" else err <= K4_REL * scale))
        checks[name] = {"max_abs_err": err, "scale": scale, "bit_equal": bool(torch.equal(ys_k, ys_t))}
        require(ok, "datagen", f"K4 {name}: off its twin by {err} (scale {scale}, bar "
                f"{'bit for bit' if drift.system == 'SLBP' else K4_REL})")

    y_slbp = np.array([30.0, 2.0], np.float32)
    for noise in ("additive", "scale_mixture"):
        for se in (1, 10):
            check(f"SLBP_{noise}_save{se}", slbp, y_slbp, sig_slbp, se, noise)
    check("SLBP_noise_free", slbp, y_slbp, 0 * sig_slbp, 1, "additive")
    for N, adj in adjs.items():
        for system, bp in K4_PARAMS.items():
            drift = sde.SystemDrift(system, adj, **bp)
            y0 = rng.uniform(*K4_INIT[system], N).astype(np.float32)
            check(f"{system}_N{N}", drift, y0, np.full(N, 0.01, np.float32), 1, "scale_mixture")
            if N == 100:
                check(f"{system}_N{N}_noise_free", drift, y0, np.zeros(N, np.float32), 1,
                      "scale_mixture")
                check(f"{system}_N{N}_additive_save10", drift, y0, np.full(N, 0.01, np.float32),
                      10, "additive")
    # two segmentations of one trajectory: equal bit for bit
    seg_equal = {}
    for system, N in (("SLBP", 2), ("SIS", 100), ("neuronal", 300)):
        d = (slbp if system == "SLBP" else sde.SystemDrift(system, adjs[N], **K4_PARAMS[system])).to(dev)
        noise = "additive" if system == "SLBP" else "scale_mixture"
        y0 = torch.as_tensor(rng.uniform(0.2, 1.0, N).astype(np.float32), device=dev)
        sg = torch.full((N,), 0.01, device=dev)
        eps = torch.linspace(*K4_RAMP[system], 3000, device=dev)
        y_one, ys_one = sde_scan(d, y0, eps, sg, 0.1, 5, STREAM_RUN, 0, 1, noise)
        y, parts = y0, []
        for a, b in ((0, 1000), (1000, 1777), (1777, 3000)):
            y, ys = sde_scan(d, y, eps[a:b], sg, 0.1, 5, STREAM_RUN, a, 1, noise)
            parts.append(ys)
        cat = torch.cat(parts)
        diff = (cat != ys_one).any(dim=1).nonzero()
        seg_equal[system] = {"equal": bool(torch.equal(cat, ys_one) and torch.equal(y, y_one)),
                             "first_step_apart": int(diff[0]) if len(diff) else None}
    require(all(v["equal"] for v in seg_equal.values()), "datagen",
            f"K4: two segmentations of one trajectory differ: {seg_equal}")
    # the simulators on the card against the same calls on the CPU (the twin, the
    # same Philox stream): SLBP bit for bit, a network within K4's bar
    slbp_kw = dict(total_time=300.0, burn_time=20.0, seed=3)
    on_card = sde.simulate_slbp(device="cuda", **slbp_kw)["ys_dynamic"]
    on_cpu = sde.simulate_slbp(device="cpu", **slbp_kw)["ys_dynamic"]
    net_kw = dict(trend="decrease", control_range=(0.0, 0.4), base_params=K4_PARAMS["neuronal"],
                  eta=0.01, total_time=40.0, burn_time=5.0, seed=2)
    net_card = sde.simulate_network_system("neuronal", adjs[30], device="cuda", **net_kw)
    net_cpu = sde.simulate_network_system("neuronal", adjs[30], device="cpu", **net_kw)
    card_vs_cpu = {"SLBP_bit_equal": bool(np.array_equal(on_card, on_cpu)),
                   "neuronal_N30_max_abs": float(np.abs(net_card["ys_dynamic"]
                                                        - net_cpu["ys_dynamic"]).max())}
    require(card_vs_cpu["SLBP_bit_equal"] and card_vs_cpu["neuronal_N30_max_abs"]
            <= K4_REL * np.abs(net_cpu["ys_dynamic"]).max(), "datagen",
            f"the simulators on the card against the CPU: {card_vs_cpu}")
    k4_err = max(c["max_abs_err"] for c in checks.values())

    # -- K4's time: the default corpus's burn-in launch (SLBP, 10,000 steps) against
    # its twin and the bound; a 1,000,000-step segment; a network step at N 100
    def k4_args(drift, N, steps, noise, sig):
        eps = torch.linspace(*K4_RAMP[drift.system], steps, device=dev)
        return (drift.to(dev), torch.rand(N, device=dev) * 0.8 + 0.2, eps, torch.full((N,), sig, device=dev),
                0.1, 1, STREAM_RUN, 0, 1, noise)

    burn = k4_args(slbp, 2, 10_000, "additive", 1e-3)
    k4_ms = cuda_ms(lambda: sde_scan(*burn))
    k4_plain = cuda_ms(lambda: sde_scan_reference(*burn), reps=1, warmup=0)
    k4_bound = bound(k4_work(10_000, 2), "float32")
    seg = k4_args(slbp, 2, 1_000_000, "additive", 1e-3)
    seg_ms = cuda_ms(lambda: sde_scan(*seg), reps=3, warmup=1)
    seg_bound = bound(k4_work(1_000_000, 2), "float32")
    net = k4_args(sde.SystemDrift("SIS", adjs[100], **K4_PARAMS["SIS"]), 100, 100_000,
                  "scale_mixture", 1e-4)
    net_ms = cuda_ms(lambda: sde_scan(*net), reps=3, warmup=1)
    net_bound = bound(k4_work(100_000, 100, 1, "SIS", "scale_mixture"), "float32")

    record = json.loads((DEMO / "summary.json").read_text())
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        tmp = Path(tmp)
        # -- the JAX package's default SLBP corpus: 2 trends x D (1e-5, 5e-6), 1e6 / 0.1
        written = counted("slbp_default", lambda: generate.generate_slbp_dataset(tmp / "slbp"))
        n_default = len(written)
        rec = load_pt(written[0])
        default_ok = (rec["ys_dynamic"].shape == (10_000_000, 2)
                      and np.isfinite(rec["ys_dynamic"]).all() and rec["ts_dynamic"].shape == (10_000_000,))
        del rec
        shutil.rmtree(tmp / "slbp")
        require(n_default == 4 and default_ok and launches["slbp_default"][3] == 4 * 11, "datagen",
                f"default SLBP corpus: {n_default} records, K4 launches {launches['slbp_default']}")

        # -- the demo corpus over seeds; the transition against the record
        def demo_seeds():
            recs, times = {}, []
            for s in DEMO_SEEDS:
                r = sde.simulate_slbp(params={"D": 1e-5}, trend="increase", total_time=DEMO_TT,
                                      burn_time=1000.0, dt=0.1, seed=s, device="cuda")
                ts = np.asarray(r["ts_dynamic"], float)[::1000]
                times.append(locate_transition(ts, np.asarray(r["ys_dynamic"], float)[::1000, 0],
                                               "SLBP", "increase")["transition_time"])
                if s == 0:
                    recs = r
            return recs, times

        rec0, transitions = counted("demo_seeds", demo_seeds)
        demo_mean, demo_sd = float(np.mean(transitions)), float(np.std(transitions, ddof=1))
        demo_gap = abs(record["transition_time_state"] - demo_mean)
        n_demo = len(transitions)
        demo_bar = (float(student_t.ppf(0.995, n_demo - 1)) * demo_sd * (1 + 1 / n_demo) ** 0.5
                    + DG_GRID)

        # -- one of them through the facade, as the slbp phase runs the demo's scan
        data_file = (tmp / "slbp_data" / f"SLBP_dynamic_total_time_{DEMO_TT}_N_increase"
                     / "SLBP_dynamic_D_1e-05.pt")
        save_pt(rec0, data_file)
        model_dir = tmp / "model"
        shutil.copytree(SLBP_MODEL, model_dir)
        scan = counted("demo_scan", lambda: U.uncertainty_ews(
            model_save_file=model_dir, data_file=data_file, dynamic_type="SLBP",
            cache_path=tmp / "scan/mpv_cache.pt", nsdiff_g_path=tmp / "scan/mpv_cache_gx.pt",
            sample_window_step=10, uncertainty_method="both", chunk_windows=16,
            load_model_when_cached=True, device="cuda"))
        ts0 = np.asarray(rec0["ts_dynamic"], float)[::1000]
        tr0 = locate_transition(ts0, np.asarray(rec0["ys_dynamic"], float)[::1000, 0], "SLBP",
                                "increase")["transition_time"]
        m_s = metric_row_from_mpv(scan["time_points"], scan["ews"], tr0, slope_window_points=10)
        m_g = metric_row_from_mpv(scan["nsdiff_g"]["time_points"], scan["nsdiff_g"]["ews"], tr0,
                                  slope_window_points=10)
        scan_metrics = {"sampling": {k: m_s.get(k) for k in SLBP_METRICS},
                        "gx": {k: m_g.get(k) for k in SLBP_METRICS},
                        "record_sampling": {k: record["sampling_mpv"][k] for k in SLBP_METRICS},
                        "record_gx": {k: record["gx_mpv"][k] for k in SLBP_METRICS}}
        require(len(scan["ews"]) == SLBP_WINDOWS and _finite(scan["ews"], SLBP_WINDOWS)
                and launches["demo_scan"][:3] == (SLBP_K1, 0, 0), "datagen",
                f"generated trajectory through the facade: {len(scan['ews'])} windows, "
                f"launches {launches['demo_scan']}")
        del rec0

        # -- the network CLI at its defaults on the tracked 100-node graph. biomass and
        # neuronal give their records; SIS diverges on every one of its 10 attempts and
        # raises, as the JAX package's CLI does on this graph (its hub of degree 63
        # makes Euler at dt 0.1 unstable on the endemic branch: eps deg dt > 2), so SIS
        # runs at examples/n100_scale_demo.py's settings (dt 0.01, every 10th step)
        nets = {}
        for system in ("biomass", "neuronal", "SIS"):
            def cli():
                try:
                    with contextlib.redirect_stdout(io.StringIO()):
                        generate.main([system, "--out-dir", str(tmp / "net"), "--graph-dir",
                                       str(GRAPH_DIR), "--graph-filter", NET_GRAPH])
                except RuntimeError as exc:
                    return str(exc)
                return None

            raised = counted(f"net_{system}", cli)
            files = sorted((tmp / "net" / NET_GRAPH).glob(f"{system}_dynamic_*.pt"))
            recs = [load_pt(f)["ys_dynamic"] for f in files]
            ok = all(r.shape == (100_000, 100) and np.isfinite(r).all() for r in recs)
            del recs
            k4n = launches[f"net_{system}"][3]
            nets[system] = {"seconds": out[f"net_{system}_s"], "records": len(files),
                            "k4_launches": k4n, "attempts": k4n // 2, "raised": raised}
            if system == "SIS":
                require(raised == "simulation diverged after 10 retries (SIS)" and k4n == 20
                        and not files, "datagen", f"network CLI SIS: {nets[system]}")
            else:
                require(raised is None and len(files) == 2 and ok, "datagen",
                        f"network CLI {system}: {nets[system]}")
        shutil.rmtree(tmp / "net")
        sis100 = counted("net_SIS_n100_demo", lambda: sde.simulate_network_system(
            "SIS", adjs[100], trend="increase", total_time=150.0, burn_time=20.0, dt=0.01,
            save_every=10, seed=7, control_range=(1e-4, 0.075), base_params={"d": 0.5},
            eta=1e-4, device="cuda"))
        k4n = launches["net_SIS_n100_demo"][3]
        nets["SIS_n100_demo"] = {"seconds": out["net_SIS_n100_demo_s"], "k4_launches": k4n,
                                 "attempts": k4n // 2, "shape": list(sis100["ys_dynamic"].shape)}
        require(sis100["ys_dynamic"].shape == (1500, 100)
                and np.isfinite(sis100["ys_dynamic"]).all(), "datagen",
                f"SIS at the n100 demo's settings: {nets['SIS_n100_demo']}")

        # -- a generated SIS record through the facade with the trained demo_fig1 model
        random.seed(0)
        adj12 = graphs.gen_graph("barabasi_albert", 12, 12, rng=random.Random(0)).adj
        sis_file = tmp / "sis" / "SIS_dynamic_eta0.0001d0.5_increase.pt"
        save_pt(counted("sis_record", lambda: sde.simulate_network_system(
            "SIS", adj12, trend="increase", device="cuda", **FIG1_SIS)), sis_file)
        (tmp / "sis_cache").mkdir()
        sis = counted("sis_facade", lambda: U.uncertainty_ews(
            model_save_file=SIS_MODEL, data_file=sis_file, dynamic_type="SIS",
            cache_path=tmp / "sis_cache", cache_mode="none", device="cuda"))
        require(_finite(sis["ews"]) and launches["sis_facade"][0] > 0, "datagen",
                f"generated SIS record through the facade: launches {launches['sis_facade']}")

        # -- host work: the graph library (read back) and the Bury corpus
        t_lib, _ = host_s(lambda: graphs.generate_graph_library(tmp / "lib"))
        lib = sorted((tmp / "lib").glob("*.graphml"))
        lib_ok = all(graphs.graph_properties(a, np.ones(len(a), bool), "LCC") == len(a)
                     == int(p.stem.split("_")[-2])
                     for p in lib for a in [graphml_to_adjacency(p).adj])
        t_bury, bury = host_s(lambda: bury_sim.generate_bury_training_corpus(tmp / "bury"))
        require(len(lib) == 120 and lib_ok and len(bury) == 96, "datagen",
                f"graph library {len(lib)} files (connected, sized: {lib_ok}), Bury corpus "
                f"{len(bury)}")

    steps_default = 4 * 10_010_000
    emit(phase="datagen", card=smi_line, seconds=time.perf_counter() - t_phase,
         k4_checks=checks, k4_bar_rel=K4_REL,
         segmentations=seg_equal, simulators_card_vs_cpu=card_vs_cpu,
         k4_burn_in_launch={"steps": 10_000, "ms": k4_ms, "plain_ms": k4_plain,
                            "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                            "ns_per_step": k4_ms * 1e6 / 10_000},
         k4_segment={"steps": 1_000_000, "ms": seg_ms, "ns_per_step": seg_ms * 1e6 / 1e6,
                     "bound_ms": seg_bound[0], "bound_by": seg_bound[1]},
         k4_network_n100={"steps": 100_000, "ms": net_ms, "ns_per_step": net_ms * 1e6 / 1e5,
                          "bound_ms": net_bound[0], "bound_by": net_bound[1]},
         slbp_default={"records": n_default, "seconds": out["slbp_default_s"],
                       "seconds_per_record": out["slbp_default_s"] / n_default,
                       "steps_per_s": steps_default / out["slbp_default_s"],
                       "k4_launches": launches["slbp_default"][3]},
         demo={"seeds": list(DEMO_SEEDS), "transitions": transitions, "mean": demo_mean,
               "sd": demo_sd, "record": record["transition_time_state"], "gap": demo_gap,
               "bar": demo_bar, "seconds": out["demo_seeds_s"],
               "k4_launches": launches["demo_seeds"][3]},
         demo_scan={"seconds": out["demo_scan_s"], "windows": len(scan["ews"]),
                    "k1_launches": launches["demo_scan"][0], "transition": tr0, **scan_metrics},
         networks=nets,
         sis_facade={"record_seconds": out["sis_record_s"], "seconds": out["sis_facade_s"],
                     "windows": len(sis["ews"]), "k1_launches": launches["sis_facade"][0],
                     "mpv_first": [float(v) for v in sis["ews"][:4]]},
         graph_library={"seconds": t_lib, "files": len(lib)},
         bury={"seconds": t_bury, "files": len(bury)})
    require(demo_gap <= demo_bar, "datagen",
            f"demo corpus transition: mean {demo_mean} over seeds {transitions} is {demo_gap} "
            f"from the record's {record['transition_time_state']} (bar {demo_bar})")
    k4_launches = sum(launches[k][3] for k in ("slbp_default", "demo_seeds", "net_biomass",
                                               "net_neuronal", "net_SIS", "net_SIS_n100_demo",
                                               "sis_record"))
    row = {"name": "sde_scan", "route": "cuda", "source": "upgdm_tpu_torch/csrc/sde_scan.cu",
           "replaces": "upgdm_tpu/data/sde.py:110 (_segment_scan: a lax.scan, no Pallas site)",
           "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
           "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
           "shape": "SLBP, 10,000 steps (the default corpus's burn-in launch)",
           "ms_segment_1M": seg_ms, "bound_ms_segment_1M": seg_bound[0]}
    return launches["demo_scan"][0] + launches["sis_facade"][0], row


# the real-data pipeline (eval/real_data.py, eval/bury.py) on the tracked demo_real
# record and model; the Bury classifiers' bar against the CPU is the CPU's against
# Keras (tests/test_torch_port_bury.py); g(x)'s is the JAX package's
REAL_NAME = "slbp_empirical_demo"
BURY_ATOL, REAL_GX_TOL = 1e-5, 1e-4
# the reference layout of a Linear, Conv1d and 1x1-conv FFN weight, and of a copy
# (utils/torch_import.py::_T inverted)
TO_REFERENCE = {
    "linear": lambda a: a.T.copy(),
    "conv1d": lambda a: a.transpose(2, 1, 0).copy(),
    "ffn_conv": lambda a: a.T[..., None].copy(),
    "copy": lambda a: a.copy(),
}


def _csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def real_data_phase(smi_line, zero_counts, kernel_counts):
    """The real-data pipeline on the card (``real_data``), over a temporary
    copy of ``demo_real``: (a) the Bury CLI's ``run_one`` on the record with
    all 20 classifiers, held to the CPU run at 1e-5 with every row summing to
    1; (b) the signal stage of ``real_data.run_one`` (``build_signal_data``
    and the CSV) with the five default signals, the model rows held to the
    CPU run within g(x)'s bar and the other rows exactly, then again as a
    cache hit with no g(x) forward (renders and ``real_systems`` where
    matplotlib is installed); (c) a reference-format NsDiff dict built from
    the demo model, loaded through ``load_state_dict`` on the card, its g(x)
    equal to the native model's; (d) a ``PhaseTimer`` over the phase and
    ``device_memory_stats``. No kernel of the port is on this path: the
    counts stay 0."""
    import contextlib
    import shutil
    from types import SimpleNamespace

    import numpy as np
    import torch

    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.eval import bury as B
    from upgdm_tpu_torch.eval import real_data as R
    from upgdm_tpu_torch.eval.uncertainty import load_model_from_dir
    from upgdm_tpu_torch.models.sigma_estimation import SigmaEstimation
    from upgdm_tpu_torch.ops.kernels.sde_scan import sde_scan
    from upgdm_tpu_torch.utils import io as pio
    from upgdm_tpu_torch.utils.profiling import PhaseTimer, device_memory_stats
    from upgdm_tpu_torch.utils.torch_import import nsdiff_reference_key_map

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    timer = PhaseTimer()
    report = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        tmp = Path(tmp)
        demo = tmp / "demo_real"
        shutil.copytree(REPO / "demo_real", demo, ignore=shutil.ignore_patterns("figures"))

        # -- (a) the Bury classifiers: card against CPU
        def bury_args(device, tag=""):
            return SimpleNamespace(
                data_root=demo / "data", model_root=B.DEFAULT_MODEL_ROOT,
                output_root=tmp / f"bury_{device}{tag}", pred_dim=0, classifier_len=None,
                max_models=None, inc_points=10, detrend_method="lowess", detrend_span=0.2,
                detrend_bandwidth=0.2, full_prefix=False, device=device)

        fwd = Forwards(B.BuryClassifier)
        with timer.phase("bury_card"):
            bury_s, paths = host_s(lambda: B.run_one(bury_args("cuda"), REAL_NAME))
        card_forwards, fwd.n = fwd.n, 0
        bury_root = Path(paths[0]).parents[1]
        with timer.phase("bury_cpu"):
            cpu_paths = B.run_one(bury_args("cpu"), REAL_NAME)
        fwd.remove()
        bury_idle = idle_share(lambda: B.run_one(bury_args("cuda", "_profiled"), REAL_NAME), 4)
        got, want = _csv_rows(paths[0]), _csv_rows(cpu_paths[0])
        require(got[0] == want[0] == B.TABLE_COLUMNS and len(got) == len(want) > 1,
                "real_data", f"Bury CSV header {got[0]} / {len(got)} rows, CPU {len(want)}")
        g, w = np.asarray(got[1:], float), np.asarray(want[1:], float)
        bury_err = float(np.abs(g[:, 1:] - w[:, 1:]).max())
        row_sum = float(np.abs(g[:, 1:5].sum(1) - 1).max())
        require(np.array_equal(g[:, 0], w[:, 0]) and bury_err <= BURY_ATOL
                and row_sum <= BURY_ATOL, "real_data",
                f"Bury probabilities: card off the CPU by {bury_err}, rows off 1 by {row_sum} "
                f"(bar {BURY_ATOL})")
        clf = B.load_keras_model(next((B.DEFAULT_MODEL_ROOT / "len500").glob("*.keras")), "cuda")
        meta = json.loads(paths[2].read_text())
        prefixes = len(g)
        x = torch.from_numpy(B.prefix_windows(np.linspace(-1, 1, 500), 10, 500)).cuda()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: clf(x))
        report["bury"] = {
            "seconds": bury_s, "prefixes": prefixes, "classifiers": meta["num_classifiers"],
            "classifier_forwards": card_forwards,
            "jax_keras_calls": meta["num_classifiers"] * prefixes,
            "max_abs_err_vs_cpu": bury_err, "bar": BURY_ATOL, "max_row_sum_err": row_sum,
            "widths": {"conv1d_filters": clf.body[0].out_channels, "conv1d_kernel":
                       clf.body[0].weight.shape[-1], "lstm_units": [clf.body[3].units,
                                                                    clf.body[5].units]},
            "forward_ms_50_prefixes": fwd_ms, "profiled_run": bury_idle}
        require(card_forwards == meta["num_classifiers"] == 20, "real_data",
                f"{card_forwards} classifier forwards for {meta['num_classifiers']} classifiers")

        # -- (b) the signal stage: card against CPU, then a cache hit
        record = pio.load_pt(R.resolve_real_data_path(REAL_NAME, demo / "data"))

        def signals(device, tag):
            args = R.default_args(
                data_root=str(demo / "data"), real_data_result_root=str(tmp / f"res_{tag}"),
                bury_prob_root=str(bury_root), output_root=str(tmp / f"fig_{tag}"),
                model_dir=str(demo / "model"), device=device)
            rows = R.build_signal_data(dict(record), REAL_NAME, args)[3]
            stem = R.output_stem(REAL_NAME, args)
            return args, R.write_signal_table(rows, f"{stem}_signals.csv")

        gfwd = Forwards(SigmaEstimation)
        with timer.phase("signals_card"):
            sig_s, (args_card, csv_card) = host_s(lambda: signals("cuda", "card"))
        fresh_forwards, gfwd.n = gfwd.n, 0
        with timer.phase("signals_card_cache_hit"):
            hit_s, (_a, csv_hit) = host_s(lambda: signals("cuda", "card"))
        hit_forwards = gfwd.n
        with timer.phase("signals_cpu"):
            _args_cpu, csv_cpu = signals("cpu", "cpu")
        gfwd.remove()
        signals_idle = idle_share(lambda: signals("cuda", "profiled"), 4)
        got, want = _csv_rows(csv_card), _csv_rows(csv_cpu)
        require(got == _csv_rows(csv_hit), "real_data", "the cache hit wrote other rows")
        require(got[0] == want[0] == R.SIGNAL_COLUMNS and len(got) == len(want), "real_data",
                f"signal CSV header {got[0]}, {len(got)} rows against the CPU's {len(want)}")
        counts, model_err, exact = {}, 0.0, True
        for a, b in zip(got[1:], want[1:]):
            require(a[:4] == b[:4], "real_data", f"signal rows differ: {a} / {b}")
            counts[a[1]] = counts.get(a[1], 0) + 1
            if a[1] in ("model_uncertainty", "model_trend"):
                va, vb = float(a[4]), float(b[4])
                model_err = max(model_err, abs(va - vb) / (REAL_GX_TOL + REAL_GX_TOL * abs(vb)))
            else:
                exact = exact and a[4] == b[4]
        windows = counts.get("model_uncertainty", 0)
        require(model_err <= 1.0 and exact and windows > 0 and
                set(counts) == {"trajectory", "model_uncertainty", "model_trend", "ar1",
                                "variance", "bury_ml"}, "real_data",
                f"signals: model rows at {model_err} of the bar (atol = rtol = {REAL_GX_TOL}), "
                f"other rows equal: {exact}, rows {counts}")
        require(fresh_forwards > 0 and hit_forwards == 0, "real_data",
                f"g(x) forwards: {fresh_forwards} fresh, {hit_forwards} on the cache hit")
        renders = "skipped: matplotlib is not installed"
        if have_mpl:
            from upgdm_tpu_torch.figures import real_systems

            with timer.phase("renders"):
                real_systems.main([
                    "--data-real-names", REAL_NAME, "--output-dir", str(tmp / "composite"),
                    "--data-root", str(demo / "data"),
                    "--real-data-result-root", args_card.real_data_result_root,
                    "--bury-prob-root", str(bury_root),
                    "--model-dir", str(demo / "model"), "--device", "cuda"])
            renders = "rendered: real_systems_figure.png"
        report["signals"] = {
            "seconds": sig_s, "cache_hit_seconds": hit_s, "gx_windows": windows,
            "windows_per_hr": windows * 3600.0 / sig_s, "gx_forwards": fresh_forwards,
            "gx_forwards_cache_hit": hit_forwards, "rows": counts,
            "model_err_of_bar": model_err, "bar": REAL_GX_TOL, "other_rows_equal": exact,
            "renders": renders, "profiled_run": signals_idle}

        # -- (c) a reference-format checkpoint through load_state_dict
        native, net_param = load_model_from_dir(demo / "model", device="cuda", use_cache=False)
        flat = native.state_dict()
        key_map = nsdiff_reference_key_map(
            int(net_param.get("e_layers", 2)), int(net_param.get("d_layers", 1)),
            int(net_param.get("p_hidden_layers", 2)))
        ref = {tk: TO_REFERENCE[tf](flat[fk]) for tk, (fk, tf) in key_map.items()}
        ref.update(scaler_mean=flat["scaler_mean"], scaler_std=flat["scaler_std"])
        imported = diffusion_models(task_model="NsDiff", net_param=net_param, seed=1,
                                    device="cuda")
        imported.load_state_dict(ref)
        series = np.asarray(record["ys_dynamic"], np.float32)[:, :1].T[:, :, None]
        wins = np.stack([series[:, i : i + 100] for i in range(0, 300, 10)])  # [30, 1, 100, 1]
        xw = torch.from_numpy(wins.reshape(-1, 100, 1)).cuda()
        with torch.no_grad():
            gx_native, gx_imported = native.gx_fn(xw), imported.gx_fn(xw)
        same_keys = sorted(imported.state_dict()) == sorted(flat)
        require(same_keys and torch.equal(gx_native, gx_imported), "real_data",
                f"reference checkpoint: keys equal {same_keys}, g(x) off by "
                f"{(gx_native - gx_imported).abs().max().item()}")
        report["reference_checkpoint"] = {"keys": len(ref), "gx_equal": True,
                                          "windows": len(wins)}

    k1, k2, k3 = kernel_counts()
    counted_updates("real_data", "the phase", 0)
    require((k1, k2, k3, sde_scan.launches) == (0, 0, 0, 0), "real_data",
            f"kernel launches K1-K4 {(k1, k2, k3, sde_scan.launches)}: none is on this path")
    stats = device_memory_stats() or {}
    emit(phase="real_data", card=smi_line, seconds=time.perf_counter() - t_phase, **report,
         kernel_launches={"K1": k1, "K2": k2, "K3": k3, "K4": sde_scan.launches},
         phase_timer=timer.as_dict(),
         device_memory={k: stats.get(k) for k in ("allocated_bytes.all.peak",
                                                  "reserved_bytes.all.peak",
                                                  "num_alloc_retries", "num_ooms")})
    print(timer.report(), flush=True)


# -- multi_gpu: the port's torch.distributed layer on the one card ------------------
MG_SEED, MG_STEPS, MG_TRAIN_B = 5, 3, 64
MG_SGD = dict(optimizer_name="SGD", lr=1e-3, momentum=0.9, weight_decay=0.0)
MG_REPS = 3  # timed sweeps of each kind; the median is reported
MG_CHUNK_2 = 8  # chunk_windows of each of the two gloo ranks: the same 16-window blocks
MG_DEADLINE_S = 300.0
# two gloo ranks on one card against one NCCL rank: the card's f/g matmuls run
# at other row counts, so per-window MPV at the bar of the kernel chains' two
# arms (1%); the step at the card-vs-CPU bars of PERF.md §2
MG_MPV_REL = 0.01


def dp_train_steps(mesh, batch):
    """(model, step, losses, first step's gradients) of MG_STEPS data-parallel
    steps at the train-bench geometry (NsDiff_model, float32, SGD with
    momentum: its update is linear in the gradient, so two runs' weights part
    only by their gradients' rounding), or the plain step with ``mesh`` None."""
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.parallel.data_parallel import make_dp_train_step
    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer
    from upgdm_tpu_torch.utils.weights import flax_flat_from_torch

    model = NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")
    opt = make_optimizer(MG_SGD, model.net, model.trainable_mask())
    step = (make_train_step(model, opt, None) if mesh is None
            else make_dp_train_step(model, opt, mesh))
    losses, grads = [], None
    for _ in range(MG_STEPS):
        losses.append(step(batch))
        grads = grads or flax_flat_from_torch(
            {k: p.grad for k, p in model.net.named_parameters() if p.grad is not None})
    return model, step, losses, grads


def two_rank_check(rank, batch, n_windows):
    """(g), one of two gloo ranks on cuda:0: the NsDiff sweep over the
    phase's windows in blocks of 2 x MG_CHUNK_2 (K1 counted, timed from a
    common start), then the data-parallel step on ``batch``."""
    import torch
    import torch.distributed as dist

    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import fused_denoiser_rows
    from upgdm_tpu_torch.parallel.data_parallel import sharded_fast_mpv_sweep
    from upgdm_tpu_torch.parallel.mesh import make_mesh
    from upgdm_tpu_torch.train.loop import deterministic_cudnn

    mesh = make_mesh(2)
    model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
    sharded_fast_mpv_sweep(model, make_windows(2 * MG_CHUNK_2), PRED_LEN, mesh, MG_CHUNK_2)
    model.generator.manual_seed(MG_SEED)
    dist.barrier()
    fused_denoiser_rows.launches = 0
    seconds, (mpv, pm) = host_s(lambda: sharded_fast_mpv_sweep(
        model, make_windows(n_windows), PRED_LEN, mesh, MG_CHUNK_2))
    launches = fused_denoiser_rows.launches
    del model
    with deterministic_cudnn():
        _, _, losses, grads = dp_train_steps(mesh, batch)
    return dict(mpv=mpv, pred_mean=pm, seconds=seconds, k1_launches=launches, losses=losses,
                grads=grads)


def grid_dataset(dataset_param):
    """(h)'s dataset, the demo corpus (module level: the grid's spawned
    processes import it)."""
    from upgdm_tpu_torch.utils.data_prep import pre_dataset_timeseries

    x = pre_dataset_timeseries(**dataset_param)
    return x, None, x.shape[-1]


def multi_gpu_phase(smi_line, zero_counts, kernel_counts):
    """The port's ``torch.distributed`` layer on the one card (``multi_gpu``):
    (a) a process group of one NCCL rank at a file store; (b) the NsDiff
    sweep at the bench geometry through ``sharded_fast_mpv_sweep`` bit for bit
    equal to ``fast_mpv_sweep`` from the same seed, 80 K1 launches each,
    both timed; (c) ``sharded_window_ensemble`` equal to
    ``batched_window_ensemble``; (d) TMDM through the sharded sweep equal to
    ``fast_mpv_sweep`` with its K3 launches; (e) the data-parallel step at
    the train-bench geometry over NCCL bit for bit equal to the plain step,
    timed with the all-reduce's share; (f) ``run_training`` with
    ``dataparallel`` under the group equal to the plain run; (g) two gloo
    ranks on cuda:0 (NCCL refuses two ranks on one card) against (b) and (e);
    (h) ``parallel_grid_search`` over a 2-configuration grid against
    ``grid_search``. Returns the K1 and K3 launches of the sharded sweeps."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.cli.train_driver import grid_search, parallel_grid_search
    from upgdm_tpu_torch.eval.uncertainty import batched_window_ensemble, fast_mpv_sweep
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.parallel.data_parallel import (
        sharded_fast_mpv_sweep, sharded_window_ensemble,
    )
    from upgdm_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed, spawn_ranks
    from upgdm_tpu_torch.train.loop import deterministic_cudnn, run_training
    from upgdm_tpu_torch.utils.io import load_checkpoint, read_model_config

    t_phase = time.perf_counter()
    report = {}
    tmp = Path(tempfile.mkdtemp(prefix="multi_gpu_"))
    try:
        # -- (a) the group
        started = maybe_init_distributed(init_method=f"file://{tmp / 'store'}", world_size=1,
                                         rank=0)
        mesh = make_mesh()
        require(started and dist.get_backend() == "nccl" and mesh.world_size == 1
                and mesh.device.type == "cuda", "multi_gpu",
                f"group: started {started}, backend {dist.get_backend()}, mesh {mesh}")
        report["group"] = {"backend": dist.get_backend(), "world_size": mesh.world_size,
                           "device": str(mesh.device)}

        # -- (b) the NsDiff sweep at world size 1 against fast_mpv_sweep
        model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
        wins = make_windows(N_WINDOWS)
        n_blocks = -(-N_WINDOWS // CHUNK)
        runs = {"sharded": [], "fast": []}
        sweeps = {"sharded": lambda: sharded_fast_mpv_sweep(model, wins, PRED_LEN, mesh, CHUNK),
                  "fast": lambda: fast_mpv_sweep(model, wins, PRED_LEN, chunk_windows=CHUNK,
                                                 device="cuda")}
        for _ in range(MG_REPS):
            for kind in ("sharded", "fast"):
                model.generator.manual_seed(MG_SEED)
                zero_counts()
                secs, out = host_s(sweeps[kind])
                runs[kind].append((secs, out, kernel_counts()[0]))
                counted_updates("multi_gpu", f"the {kind} sweep", runs[kind][-1][2])
        k1_main = runs["sharded"][-1][2]
        mpv_b = runs["fast"][0][1][0]
        for kind, rs in runs.items():
            require(all(r[2] == STEPS * n_blocks for r in rs), "multi_gpu",
                    f"{kind} sweep: K1 launched {[r[2] for r in rs]}, expected {STEPS * n_blocks}")
            require(all(np.array_equal(r[1][0], mpv_b) and np.array_equal(r[1][1],
                                                                          runs["fast"][0][1][1])
                        for r in rs), "multi_gpu",
                    f"{kind} sweep at world size 1 not bit for bit the fast sweep's")
        require(mpv_b.shape == (N_WINDOWS,) and np.isfinite(mpv_b).all() and (mpv_b > 0).all(),
                "multi_gpu", f"bad MPV {mpv_b[:4]}")
        report["nsdiff_sweep"] = {
            kind: {"windows_per_hr": N_WINDOWS * 3600.0 / statistics.median(r[0] for r in rs),
                   "seconds": [r[0] for r in rs], "k1_launches": rs[-1][2]}
            for kind, rs in runs.items()}
        report["nsdiff_sweep"]["bit_equal"] = True

        # -- (c) the window ensemble
        ens = {}
        for kind, fn in (("sharded", lambda: sharded_window_ensemble(
                model, wins[:CHUNK], PRED_LEN, mesh, CHUNK)),
                         ("batched", lambda: batched_window_ensemble(
                model, wins[:CHUNK], PRED_LEN, chunk_windows=CHUNK, device="cuda"))):
            model.generator.manual_seed(MG_SEED + 1)
            ens[kind] = fn()
        require(len(ens["sharded"]) == len(ens["batched"]) == CHUNK
                and all(a.shape == (NODE, PRED_LEN, 1, N_Z) and np.array_equal(a, b)
                        for a, b in zip(ens["sharded"], ens["batched"])), "multi_gpu",
                "sharded_window_ensemble is not batched_window_ensemble bit for bit")
        report["window_ensemble"] = {"windows": CHUNK, "bit_equal": True}
        del ens, model

        # -- (d) TMDM through the sharded sweep
        tmdm = diffusion_models("TMDM", TMDM_PARAM, seed=0, device="cuda")
        twins = make_windows(T_WINDOWS)
        tm = {}
        for kind, fn in (("sharded", lambda: sharded_fast_mpv_sweep(
                tmdm, twins, PRED_LEN, mesh, T_CHUNK)),
                         ("fast", lambda: fast_mpv_sweep(tmdm, twins, PRED_LEN,
                                                         chunk_windows=T_CHUNK, device="cuda"))):
            tmdm.generator.manual_seed(MG_SEED)
            zero_counts()
            secs, out = host_s(fn)
            tm[kind] = (secs, out, kernel_counts()[2])
        k3_main = tm["sharded"][2]
        want_k3 = T_STEPS * -(-T_WINDOWS // T_CHUNK)
        require(tm["sharded"][2] == tm["fast"][2] == want_k3
                and all(np.array_equal(a, b) for a, b in zip(tm["sharded"][1], tm["fast"][1])),
                "multi_gpu", f"TMDM: K3 {tm['sharded'][2]} / {tm['fast'][2]} (expected "
                f"{want_k3}), bit for bit {[np.array_equal(a, b) for a, b in zip(tm['sharded'][1], tm['fast'][1])]}")
        report["tmdm_sweep"] = {k: {"seconds": v[0], "windows_per_hr": T_WINDOWS * 3600.0 / v[0],
                                    "k3_launches": v[2]} for k, v in tm.items()}
        report["tmdm_sweep"]["bit_equal"] = True
        del tmdm

        # -- (e) the data-parallel step at world size 1 against the plain step
        batch = np.random.default_rng(3).normal(size=(MG_TRAIN_B, WINDOWS + PRED_LEN, 1)).astype(
            np.float32)
        tb = torch.as_tensor(batch, device="cuda")
        with deterministic_cudnn():
            plain, plain_step, plain_losses, _ = dp_train_steps(None, tb)
            dp, dp_step, dp_losses, dp_grads = dp_train_steps(mesh, tb)
            same_w = all(np.array_equal(a, b) for a, b in zip(
                plain.state_dict().values(), dp.state_dict().values()))
            require(plain_losses == dp_losses and same_w, "multi_gpu",
                    f"dp step at world size 1: losses {dp_losses} vs {plain_losses}, weights "
                    f"equal {same_w}")
            step_ms = {"plain": cuda_ms(lambda: plain_step(tb), reps=5, warmup=1),
                       "dp": cuda_ms(lambda: dp_step(tb), reps=5, warmup=1)}
            flat = torch.zeros(sum(int(np.prod(g.shape)) for g in dp_grads.values()) + 1,
                               device="cuda")
            ar_ms = cuda_ms(lambda: mesh.all_reduce_mean(flat), reps=10, warmup=2)
        report["dp_step"] = {"batch": MG_TRAIN_B, "losses": dp_losses, "bit_equal": True,
                             "step_ms": step_ms, "all_reduce_ms": ar_ms,
                             "all_reduce_share": ar_ms / step_ms["dp"],
                             "gradient_floats": flat.numel() - 1}
        del plain, dp, plain_step, dp_step, flat

        # -- (f) run_training with the flag under the group
        tr, va, dataset_param = demo_split()
        net = dict(read_model_config(DEMO / "pre_model_F/trained_model")["net"],
                   load_pretrain=False)
        opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
        base = dict(train_model_select="pretrain_f", train_batch_size=32, val_batch_size=len(va),
                    test_set=True, ckpt=False, train_epochs=3)
        recs = {}
        for kind, extra in (("plain", {}), ("dataparallel", {"dataparallel": True})):
            recs[kind] = run_training(tr, va, dict(base, **extra), dict(net),
                                      {"loss_metric": "KL divergence"}, opt, tmp / kind,
                                      dataset_param=dataset_param, device="cuda")
        ckpts = [load_checkpoint(tmp / k / "trained_model/model_trained")[1] for k in recs]
        same_ckpt = ckpts[0].keys() == ckpts[1].keys() and all(
            np.array_equal(ckpts[0][k], ckpts[1][k]) for k in ckpts[0])
        require(recs["plain"] == recs["dataparallel"] and same_ckpt, "multi_gpu",
                f"run_training with the flag: records equal {recs['plain'] == recs['dataparallel']}"
                f", checkpoint equal {same_ckpt}")
        report["run_training"] = {"epochs": base["train_epochs"], "records_equal": True,
                                  "checkpoint_equal": True,
                                  "train_last": recs["plain"]["train_scores"][-1]}

        # -- (g) two gloo ranks on the one card
        torch.cuda.empty_cache()  # the ranks' memory comes from the same card
        ranks = spawn_ranks(two_rank_check, 2, (batch, N_WINDOWS), backend="gloo",
                            device="cuda", deadline_s=MG_DEADLINE_S)
        mpv_g = ranks[0]["mpv"]
        same_ranks = all(np.array_equal(r["mpv"], mpv_g) and r["losses"] == ranks[0]["losses"]
                         for r in ranks)
        gap = float(np.max(np.abs(mpv_g - mpv_b) / mpv_b))
        loss_rel = float(np.max(np.abs(np.subtract(ranks[0]["losses"], dp_losses))
                                / np.abs(dp_losses)))
        worst = 0.0
        top = max(np.abs(g).max() for g in dp_grads.values())
        for k, g in dp_grads.items():
            err = float(np.abs(ranks[0]["grads"][k] - g).max())
            if k.endswith(".key.bias"):  # zero in exact arithmetic: rounding only
                require(max(np.abs(g).max(), np.abs(ranks[0]["grads"][k]).max())
                        <= TRAIN_GRAD_ZERO * top, "multi_gpu", f"gradient {k} not zero")
                continue
            bar = float(TRAIN_GRAD_REL * np.abs(g).max())
            require(err <= bar, "multi_gpu", f"2 ranks: gradient {k} off by {err} > {bar}")
            worst = max(worst, err / bar if bar else 0.0)
        want_k1 = STEPS * -(-N_WINDOWS // (2 * MG_CHUNK_2))
        require(same_ranks and gap <= MG_MPV_REL and loss_rel <= TRAIN_LOSS_RTOL
                and all(r["k1_launches"] == want_k1 for r in ranks), "multi_gpu",
                f"2 ranks: ranks agree {same_ranks}, MPV gap {gap}, loss rel {loss_rel}, K1 "
                f"{[r['k1_launches'] for r in ranks]} (expected {want_k1} each)")
        slowest = max(r["seconds"] for r in ranks)
        report["two_gloo_ranks"] = {
            "windows": N_WINDOWS, "chunk_windows": MG_CHUNK_2, "seconds": [r["seconds"] for r in ranks],
            "windows_per_hr": N_WINDOWS * 3600.0 / slowest, "mpv_max_rel_gap": gap,
            "mpv_bar": MG_MPV_REL, "k1_launches": [r["k1_launches"] for r in ranks],
            "dp_loss_rel": loss_rel, "dp_worst_grad_err_over_bar": worst,
            "bars": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_REL}}

        # -- (h) the process-parallel grid search
        grid_data = {k: [v] for k, v in dataset_param.items()}
        grid_train = {k: [v] for k, v in dict(base, traindata_size=0.9,
                                              model_evaluation="hold_out").items()}
        grid_net = {k: [v] for k, v in net.items()}
        grid_opt = dict({k: [v] for k, v in opt.items()}, lr=[1e-3, 5e-4])
        sections = (grid_data, grid_train, grid_net, {"loss_metric": ["KL divergence"]},
                    grid_opt)
        t_par, par = host_s(lambda: parallel_grid_search(*sections, tmp / "par", grid_dataset,
                                                         processes=2, device="cuda"))
        t_seq, _ = host_s(lambda: grid_search(*sections, tmp / "seq", grid_dataset,
                                              hp_analysis_root=tmp / "hp", device="cuda"))
        seq = json.loads(next((tmp / "seq").rglob("configs_record_scores.json")).read_text())
        require(sorted(par) == ["config_0", "config_1"] and par == seq, "multi_gpu",
                f"parallel_grid_search records {par} vs grid_search {seq}")
        report["grid_search"] = {"configs": 2, "processes": 2, "seconds_parallel": t_par,
                                 "seconds_sequential": t_seq, "records_equal": True}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="multi_gpu", card=smi_line, seconds=time.perf_counter() - t_phase, **report)
    return k1_main, k3_main


# -- the experiment drivers of examples/ through the port (phase `examples`) ---------
# the transitions of eight seeds of the SLBP demo corpus that phase `datagen`
# measured on the H100 (PERF.md): the transition of a freshly generated demo
# trajectory lies in their 99% prediction interval, mean +- t(0.995, 7) sd
# sqrt(1 + 1/8)
EX_DEMO_MEAN, EX_DEMO_SD, EX_DEMO_N = 178012.6, 3823.0, 8
EX_DROP_MIN = 50.0  # both arms' pre-transition MPV drop (the record: 71.4 and 72.0)
# the zoo's Fig-1 chain at full width, cut in depth: one BA-30 graph a dynamics,
# one epoch, at most 64 windows a flat family; the DiffSTG and DiffusionTS arms
# on their trajectory's first chunk of windows (a window: the cache runner's
# unit, and DiffusionTS's 32-row chunk holds one 30-node window), DiffusionTS
# with its published ensemble of 100 samples
EX_GRAPH = "barabasi_albert_30_0"
EX_MAX_WINDOWS, EX_SLOW_ARM_WINDOWS = 64, 1
# the zoo's one figure job that the Fig-1 tree schedules besides fig1 itself
# (whose DiffusionTS arms sweep every window): fig3 over the three d512 NsDiffs
EX_ZOO_FIGURE = "upgdm_tpu_torch.figures.fig3_dynamics_transfer"
EX_RANDOM_SEED = 0  # the global `random` state each driver starts from
# statistics tables with a row a valid sample's group or slope: their rows
# follow the run's noise, and are held to the tracked tables' only when as
# many samples are valid as in the tracked run
EX_BY_VALID = ("mpv_collapse_summary.csv", "mpv_slope_lead_time.csv")


@contextlib.contextmanager
def module_cut(module, **values):
    """Set ``module``'s attributes to ``values`` for a block, and restore them."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _csv_head_and_rows(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], len(lines) - 1


def _valid_samples(path):
    """The rows of an ``mpv_collapse`` samples CSV with no skip reason."""
    import csv

    with open(path, newline="") as f:
        return sum(1 for r in csv.DictReader(f) if not r["skip_reason"])


def examples_phase(smi_line, zero_counts, counts):
    """The port's experiment drivers (``upgdm_tpu_torch/examples``) on the
    card, in a temporary directory (``examples``): (a) the SLBP demo at its
    defaults, stage by stage, its summary held to the demo record's keys, the
    transition to the demo corpus's seeds and both arms' pre-transition drop; (b) the
    Fig-1, network-statistics and real-data demos at their defaults, their
    trees (every file that is not an image) held to the tracked
    ``demo_fig1``, ``demo_network`` and ``demo_real``, the empirical record and
    the trajectory and classic-EWS rows to the tracked ones; (c) the zoo's
    Fig-1 chain at full width and cut depth: data, the d512 NsDiffs, the
    TMDM/DiffusionTS/DiffSTG compare models, the arm driver over the NsDiff and
    TMDM SIS arms (K1, K3), the DiffSTG and DiffusionTS SIS arms on the first
    window, the corpus statistics, ``summarize`` and the fig3 job through the
    zoo's figure stage (a subprocess); (d) the 100-node demo
    and the paper-figure demo at cut depth. ``counts()`` gives the (K1, K2,
    K3, K4, update) launches; every NsDiff chain here takes T update
    launches (``counted_updates``). Returns the launches of K1, K3 and K4 in the phase."""
    import random

    import numpy as np
    from scipy.stats import t as student_t

    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.examples import (
        fig1_arm_driver, fig1_demo, n100_scale_demo, network_stats_demo, paper_figures_demo,
        real_data_demo, reference_zoo, slbp_demo,
    )
    from upgdm_tpu_torch.figures.common import dynamics_filename, graph_file, spdata_source_path
    from upgdm_tpu_torch.utils.io import load_pt

    t_phase = time.perf_counter()
    total = np.zeros(5, np.int64)
    seconds, launches = {}, {}
    reduced = []

    def counted(name, fn):
        # the drivers draw their graphs' edges from the global `random`, as the
        # JAX drivers do (networkx's seed=None): pinned here so that a run
        # repeats whatever ran before it (the paper demo's SIS at dt 0.1 on its
        # 70-node small-world graph is at the edge of Euler's stability, 0.5 x
        # lambda_max 44.1 x 0.1 = 2.2: it diverged in 2 of 10 unpinned whole
        # runs of the demo on the H100, `--paper-runs 10`)
        random.seed(EX_RANDOM_SEED)
        zero_counts()
        seconds[name], r = host_s(fn)
        launches[name] = tuple(int(c) for c in counts())
        total[:] += launches[name]
        # one update launch a chain step: a K1 launch on the flat NsDiff
        # paths; the 100-node demo's NsDiff_spatial chains (its 20 steps a
        # scanned window) are the one chain here with no K1
        spatial = 20 * r["NsDiff_spatial"]["n_scan_windows"] if name == "n100_scale_demo" else 0
        counted_updates("examples", name, launches[name][0] + spatial)
        return r

    cuda = ["--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as cuts:
        tmp = Path(tmp)
        # -- (a) the SLBP demo at its defaults, one stage a call
        slbp = tmp / "slbp"
        for stage in ("data", "train", "scan"):
            summary = counted(f"slbp_{stage}", lambda: slbp_demo.main(
                ["--out-dir", str(slbp), "--stage", stage] + cuda))
        record = json.loads((REPO / "demo_artifacts/summary.json").read_text())
        half = (float(student_t.ppf(0.995, EX_DEMO_N - 1)) * EX_DEMO_SD
                * (1 + 1 / EX_DEMO_N) ** 0.5)
        tr = summary["transition_time_state"]
        drops = {arm: summary[arm]["pre_transition_drop_percent"]
                 for arm in ("sampling_mpv", "gx_mpv")}
        keys_ok = (summary.keys() == record.keys() and all(
            summary[a].keys() == record[a].keys() for a in ("sampling_mpv", "gx_mpv")))
        emit(phase="examples", part="slbp_demo", card=smi_line,
             seconds={k: seconds[f"slbp_{k}"] for k in ("data", "train", "scan")},
             k4_launches=launches["slbp_data"][3], k1_launches_scan=launches["slbp_scan"][0],
             windows=summary["n_windows"], transition=tr,
             interval=[EX_DEMO_MEAN - half, EX_DEMO_MEAN + half], drops=drops,
             scan_windows_per_hr=summary["windows_per_hr"], keys_as_record=keys_ok)
        require(summary["n_windows"] == 191 and abs(tr - EX_DEMO_MEAN) <= half
                and all(d >= EX_DROP_MIN for d in drops.values()) and keys_ok
                and launches["slbp_data"][3] > 0 and launches["slbp_scan"][0] > 0,
                "examples", f"slbp_demo: {summary['n_windows']} windows, transition {tr} "
                f"(interval {EX_DEMO_MEAN} +- {half}), drops {drops}, keys {keys_ok}, "
                f"launches {launches}")

        # -- (b) the Fig-1, network and real-data demos at their defaults
        trees = {}
        for name, mod, tracked in (("fig1_demo", fig1_demo, "demo_fig1"),
                                   ("network_stats_demo", network_stats_demo, "demo_network"),
                                   ("real_data_demo", real_data_demo, "demo_real")):
            out = tmp / name
            counted(name, lambda: mod.main(["--out-dir", str(out)] + cuda))
            got, want = artifact_names(out, like=REPO / tracked), artifact_names(REPO / tracked)
            csvs = {r: (_csv_head_and_rows(out / r), _csv_head_and_rows(REPO / tracked / r))
                    for r in want if r.endswith(".csv") and (out / r).exists()}
            valid = {k: _valid_samples(root / r) for k, root in (("port", out),
                                                                 ("tracked", REPO / tracked))
                     for r in want if r.endswith("mpv_collapse_samples.csv")}
            held = {r: v for r, v in csvs.items()
                    if valid.get("port") == valid.get("tracked") or not r.endswith(EX_BY_VALID)}
            trees[name] = {"files": len(got), "tracked": len(want), "same": got == want,
                           "csv_headers_same": all(a[0] == b[0] for a, b in csvs.values()),
                           "csv_rows": {r: [a[1], b[1]] for r, (a, b) in csvs.items()},
                           "valid_samples": valid or None}
            require(got == want and trees[name]["csv_headers_same"]
                    and all(a[1] == b[1] for a, b in held.values()), "examples",
                    f"{name}: files {got} against the tracked {want}; CSV (header, rows) "
                    f"{ {r: v for r, v in csvs.items() if v[0] != v[1]} }")
        rec = load_pt(tmp / "real_data_demo/data/slbp_empirical_demo.pt")
        ref = load_pt(REPO / "demo_real/data/slbp_empirical_demo.pt")
        rec_same = sorted(rec) == sorted(ref) and all(
            np.array_equal(rec[k], ref[k]) if isinstance(ref[k], np.ndarray) else rec[k] == ref[k]
            for k in ref)
        csv_rel = "figures/slbp_empirical_demo/slbp_empirical_demo_real_data_ews_signals.csv"
        rows = {k: [r for r in (root / csv_rel).read_text().splitlines()
                    if r.split(",")[1] in ("trajectory", "ar1", "variance")]
                for k, root in (("port", tmp / "real_data_demo"), ("tracked", REPO / "demo_real"))}
        emit(phase="examples", part="demos", card=smi_line, trees=trees,
             seconds={k: seconds[k] for k in trees}, launches={k: launches[k] for k in trees},
             empirical_record_equal=rec_same, classic_rows=len(rows["port"]),
             classic_rows_equal=rows["port"] == rows["tracked"])
        require(rec_same and rows["port"] == rows["tracked"] and len(rows["port"]) > 0
                and launches["fig1_demo"][0] > 0 and launches["fig1_demo"][3] > 0
                and launches["network_stats_demo"][3] > 0, "examples",
                f"real_data_demo: record equal {rec_same}, classic rows equal "
                f"{rows['port'] == rows['tracked']}; launches {launches}")

        # -- (c) the zoo's Fig-1 chain, full width, cut depth
        zoo = tmp / "zoo"
        cuts.enter_context(module_cut(
            reference_zoo, CORPUS_GRAPHS=[EX_GRAPH],
            COMPARE_TRAIN={fam: dict(tp, epochs=1, **({"max_windows": EX_MAX_WINDOWS}
                                                      if "max_windows" in tp else {}))
                           for fam, tp in reference_zoo.COMPARE_TRAIN.items()}))
        reduced.append({"zoo": f"corpus: {EX_GRAPH} only, each dynamics; 1 epoch a model; "
                               f"at most {EX_MAX_WINDOWS} windows a TMDM/DiffusionTS model; "
                               f"DiffSTG and DiffusionTS arms: {EX_SLOW_ARM_WINDOWS} window; "
                               "figure stage: the fig3 job only"})
        counted("zoo_data", lambda: reference_zoo.gen_data(zoo, fig1_only=True, device="cuda"))
        counted("zoo_models", lambda: reference_zoo.train_models(
            zoo, 1, generalization_only=True, device="cuda"))
        counted("zoo_compare", lambda: reference_zoo.train_compare_models(zoo, device="cuda"))
        ews, src = zoo / "ews_results", zoo / "dataset"
        counted("zoo_arms", lambda: fig1_arm_driver.main(
            ["--ews-root", str(ews), "--source-root", str(src), "--graph", EX_GRAPH,
             "--arms", "NsDiff:SIS", "TMDM:SIS"] + cuda))
        sis = spdata_source_path(src, "SIS", EX_GRAPH, dynamics_filename("SIS", "increase"))
        arms = {}
        for fam in ("DiffSTG", "DiffusionTS"):
            model_dir = ews / "model_compare" / fam / "SIS"
            r = counted(f"zoo_{fam}", lambda: uncertainty_ews(
                model_save_file=model_dir, data_file=sis, dynamic_type="SIS",
                task_model=fam if fam == "DiffSTG" else None,
                graph_file=graph_file(src, EX_GRAPH) if fam == "DiffSTG" else None,
                cache_path=model_dir, max_windows=EX_SLOW_ARM_WINDOWS, device="cuda"))
            arms[fam] = [float(v) for v in np.asarray(r["ews"])]
        counted("zoo_stats", lambda: reference_zoo.run_stats(zoo, attempts=1, device="cuda"))
        corpus = reference_zoo.summarize(zoo)
        jobs = [j for j in reference_zoo.figure_jobs(zoo)
                if j[0] == EX_ZOO_FIGURE and "increase" in j[1]]
        failed = counted("zoo_figure", lambda: reference_zoo.render_figures(
            zoo, jobs, attempts=1, device="cuda"))
        fig_log = zoo / "figures" / (EX_ZOO_FIGURE.rsplit(".", 1)[-1] + ".log")
        fig_log = fig_log.read_text() if fig_log.exists() else ""
        figure_done = failed == 0 and ("the render is skipped" in fig_log
                                       or "saved: " in fig_log)
        arm_sidecars = {arm: fig1_arm_driver.arm_complete(ews, arm, "SIS", "increase")
                        for arm in ("NsDiff", "TMDM")}
        emit(phase="examples", part="zoo_fig1", card=smi_line,
             seconds={k: seconds[k] for k in seconds if k.startswith("zoo_")},
             launches={k: launches[k] for k in launches if k.startswith("zoo_")},
             arms_complete=arm_sidecars, slow_arms_mpv=arms,
             corpus_files=corpus["n_files"], corpus_transitions=corpus["n_transition"],
             lead_time_positive_frac=corpus["lead_time_positive_frac_overall"],
             figure_job=[jobs[0][0], jobs[0][1]] if jobs else None, figure_done=figure_done)
        require(all(arm_sidecars.values()) and launches["zoo_arms"][0] > 0
                and launches["zoo_arms"][2] > 0 and launches["zoo_data"][3] > 0
                and all(len(v) == EX_SLOW_ARM_WINDOWS and _finite(v) for v in arms.values())
                and corpus["n_files"] == 2 * len(reference_zoo.SYSTEMS)
                and len(jobs) == 1 and figure_done, "examples",
                f"zoo: arms complete {arm_sidecars}, launches {launches}, slow arms {arms}, "
                f"corpus files {corpus['n_files']}, figure jobs {jobs} (failed {failed}; "
                f"log tail {fig_log[-600:]!r})")

        # -- (d) the 100-node demo and the paper-figure demo, cut in depth
        n100 = counted("n100_scale_demo", lambda: n100_scale_demo.main(
            ["--out-dir", str(tmp / "n100"), "--epochs", "1", "--scan-step", "100"] + cuda))
        reduced.append({"n100_scale_demo": "1 epoch a model (default 3), a scan window every "
                                           "100 points (default 50)"})
        paper = tmp / "paper"
        paper_cut = dict(SLBP_TOTALS=("200000.0",), SLBP_MAIN_TOTAL="200000.0",
                         FIG5_TIME_ROWS=("200000.0:t2e5:10",))
        cuts.enter_context(module_cut(paper_figures_demo, **paper_cut))
        reduced.append({"paper_figures_demo": "SLBP records of 200,000 time units only "
                                              "(default 200k/300k/400k, figures on 400k)"})
        for stage in ("data", "models", "figures"):
            counted(f"paper_{stage}", lambda: paper_figures_demo.main(
                ["--out-dir", str(paper), "--stage", stage] + cuda))
        n_models = len(list((paper / "ews_results").rglob("*.yaml")))
        emit(phase="examples", part="n100_and_paper", card=smi_line,
             seconds={k: seconds[k] for k in seconds if k.startswith(("n100", "paper_"))},
             launches={k: launches[k] for k in launches if k.startswith(("n100", "paper_"))},
             n100={k: n100[k] for k in ("NsDiff_spatial", "DiffSTG", "transition_time")},
             paper_models=n_models)
        require(all(n100[t]["n_scan_windows"] > 0 for t in ("NsDiff_spatial", "DiffSTG"))
                and launches["n100_scale_demo"][3] > 0 and launches["paper_data"][3] > 0
                and launches["paper_figures"][0] > 0, "examples",
                f"n100/paper: {n100}, launches {launches}")
    emit(phase="examples", card=smi_line, seconds=time.perf_counter() - t_phase,
         reduced=reduced, launches={"K1": int(total[0]), "K2": int(total[1]),
                                    "K3": int(total[2]), "K4": int(total[3]),
                                    "update": int(total[4])})
    require(total[1] == 0, "examples", f"K2 launched {total[1]} times: not on these paths")
    return int(total[0]), int(total[2]), int(total[3])



def paper_runs(smi_line, n):
    """The paper-figure demo whole at its defaults, ``n`` times, each run a
    fresh process as a user starts it: its global ``random`` (which draws the
    graphs' edges) seeded by the OS, not pinned. Prints each run's exit code,
    seconds and, for a failed run, its last lines; then how many failed."""
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            out = Path(tmp) / f"run{i}"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "upgdm_tpu_torch.examples.paper_figures_demo",
                 "--out-dir", str(out)], cwd=REPO, capture_output=True, text=True,
                timeout=900)
            failed += proc.returncode != 0
            emit(phase="paper_runs", card=smi_line, run=i, rc=proc.returncode,
                 seconds=time.perf_counter() - t0,
                 tail=(proc.stdout[-800:] + proc.stderr[-1500:]) if proc.returncode else None)
            shutil.rmtree(out, ignore_errors=True)
    emit(phase="paper_runs", card=smi_line, runs=n, failed=failed)

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
                    help="stop after the kernel phases (build, K1, K2, K3, the update)")
    ap.add_argument("--examples", action="store_true",
                    help="after the build, run the phase `examples` alone")
    ap.add_argument("--train-graph", action="store_true",
                    help="after the build, run the phase `train_graph` alone")
    ap.add_argument("--paper-runs", type=int, default=0, metavar="N",
                    help="after the build, run the paper-figure demo whole N times, each "
                         "in a fresh process with its graphs unpinned, and count failures")
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
        run_evaluation_cache, uncertainty_ews,
    )
    from upgdm_tpu_torch.models.denoise import NsDiffDenoiser, TMDMDenoiser
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels import _build
    from upgdm_tpu_torch.ops.kernels.chain_resident import (
        chain_operands, fused_chain_rows, fused_chain_rows_reference, fused_nsdiff_chain,
        schedule_table,
    )
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows, fused_denoiser_rows_reference,
        step_weights,
    )
    from upgdm_tpu_torch.ops.diffusion import schedule_on
    from upgdm_tpu_torch.ops.kernels.fused_tmdm import fused_tmdm_rows, tmdm_gammas, tmdm_weights
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import (
        chain_table, chain_update_bytes, nsdiff_chain_update,
    )
    from upgdm_tpu_torch.ops.kernels.sde_scan import sde_scan
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

    def zero_counts():
        fused_denoiser_rows.launches = fused_denoiser_rows.launches_act_bf16 = 0
        fused_chain_rows.launches = fused_chain_rows.launches_act_bf16 = 0
        fused_tmdm_rows.launches = 0
        sde_scan.launches = 0
        nsdiff_chain_update.launches = 0

    def all_counts():
        return (fused_denoiser_rows.launches, fused_chain_rows.launches,
                fused_tmdm_rows.launches, sde_scan.launches, nsdiff_chain_update.launches)

    if args.paper_runs:  # a measurement, not the smoke: no result line
        paper_runs(smi_line, args.paper_runs)
        return
    if args.train_graph:  # the short loop for work on the train step
        train_graph_phase(smi_line)
        print(json.dumps({"ok": True}), flush=True)
        return
    if args.examples:  # the short loop for work on the drivers: no kernel table
        examples_phase(smi_line, zero_counts, all_counts)
        print(smi_line, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return

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
        k1_bound = {mm: bound(k1_work(M_MAIN), mm) for mm in TOL}
        emit(phase="k1", card=smi_line, max_abs_err=k1_err, tol=TOL, series_rel_err=k1_series,
             series_rtol=SERIES_RTOL, rows=M_MAIN, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms={k: v[0] for k, v in k1_bound.items()},
             bound_by={k: v[1] for k, v in k1_bound.items()})

        # -- 3b. K1's bf16-activation arm: the twin over ragged M, widths and
        # edge rows, element by element on the same 4.8 M rows, against the
        # float32-activation arm at the JAX package's bars, and its time
        g7, kw16 = denoiser_gammas(den, 7), step_weights(W, torch.bfloat16)
        act16 = dict(matmul_dtype="bfloat16", act_dtype="bfloat16")
        try:
            k1a = check_step_kernel("k1", dev, act="bfloat16")
            where = f"the main path's {M_MAIN} rows"
            got = fused_denoiser_rows(x, g7, kw16, **act16)
            want = fused_denoiser_rows_reference(x, g7, W, **act16)
            k1a["bfloat16"] = max(k1a["bfloat16"], worst_err("K1 act bf16", got, want,
                                                             TOL["bfloat16"], where))
            f32 = fused_denoiser_rows(x, g7, kw16, matmul_dtype="bfloat16")
            for name, a, b, c in zip(("eps", "sigma"), got, want, f32):
                arms_apart(f"K1 {name}", k1a, a, b, c, where)
            del want
            d_eps = (got[0] - f32[0]).abs().max().item()
            d_sig = ((got[1] - f32[1]).abs() / f32[1].abs()).max().item()
            if not (0 < d_eps < ACT_EPS_ABS and 0 < d_sig < ACT_SIGMA_REL):
                raise AssertionError(f"K1 act bf16 vs float32 act: eps {d_eps}, sigma {d_sig}")
            del got, f32
        except AssertionError as exc:
            fail("k1_act_bf16", str(exc))
        k1a_ms = cuda_ms(lambda: fused_denoiser_rows(x, g7, kw16, **act16))
        k1a_plain_ms = cuda_ms(lambda: fused_denoiser_rows_reference(x, g7, W, **act16),
                               reps=3, warmup=1)
        del x
    k1a_err = k1a["bfloat16"]
    emit(phase="k1_act_bf16", card=smi_line, max_abs_err=k1a_err, tol=TOL["bfloat16"],
         vs_twin={"same_share_min": k1a["same_share_min"], "mean_ratio_max": k1a["mean_ratio_max"],
                  "bars": [ACT_SAME_RTOL, ACT_SAME_FRAC, ACT_SEP]},
         vs_float32_act={"eps_max_abs": d_eps, "sigma_max_rel": d_sig,
                         "bars": [ACT_EPS_ABS, ACT_SIGMA_REL]},
         rows=M_MAIN, ms=k1a_ms, ms_float32_act=k1_ms["bfloat16"], plain_ms=k1a_plain_ms,
         bound_ms=k1_bound["bfloat16"][0], bound_by=k1_bound["bfloat16"][1])

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

        # -- 4b. K2's bf16-activation arm in both matmul types: the twin over
        # ragged M, widths, use_gx_directly and with Philox noise, element by
        # element noise-free on the 4.8 M rows, and its time
        k2a_ms, k2a_plain_ms = {}, {}
        try:
            k2a_err = check_chain_kernel(dev, seed=7, act="bfloat16")
            for mm in ("float32", "bfloat16"):
                kwa = dict(matmul_dtype=mm, act_dtype="bfloat16")
                got = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, noise_mode="zero",
                                       **kwa)
                want = fused_chain_rows_reference(y0r, gxr, tab, tables, W, STEPS,
                                                  noise_mode="zero", **kwa)
                over = off_by(got, want, 0.0, bar16)
                where = f"{mm} at the main path's {M_MAIN} rows"
                if not torch.isfinite(got).all().item() or over > 0:
                    raise AssertionError(f"act bf16 chain off {bar16} by {over}, {where}")
                k2a_err[mm] = max(k2a_err[mm], (got - want).abs().max().item())
                f32 = fused_chain_rows(y0r, gxr, tab, 5, tables, W, STEPS, matmul_dtype=mm,
                                       noise_mode="zero")
                arms_apart(f"K2 {mm}", k2a_err, got, want, f32, where)
                del got, want, f32
        except AssertionError as exc:
            fail("k2_act_bf16", str(exc))
        for mm in ("float32", "bfloat16"):
            kwa = dict(matmul_dtype=mm, act_dtype="bfloat16")
            ops = chain_operands(tables, W, getattr(torch, mm), "bfloat16")
            call = lambda: fused_chain_rows(y0r, gxr, tab, 5, *ops, STEPS, **kwa)
            t_one, _ = host_s(call)
            k2a_ms[mm] = cuda_ms(call, reps=10 if t_one < 0.1 else 3, warmup=1)
            k2a_plain_ms[mm] = cuda_ms(lambda: fused_chain_rows_reference(
                y0r, gxr, tab, tables, W, STEPS, generator=tgen, **kwa), reps=3, warmup=1)
        del y0r, gxr
    emit(phase="k2", card=smi_line, max_abs_err=k2_err, mpv_kernel=mpv_k, mpv_twin=mpv_p,
         mpv_rel=mpv_rel, mpv_float32_arm=mpv_32, mpv_rel_bf16_vs_f32=mpv_rel_arms, rows=M_MAIN,
         ms=k2_ms, plain_ms=k2_plain_ms, bound_ms={k: v[0] for k, v in k2_bound.items()},
         bound_by={k: v[1] for k, v in k2_bound.items()})
    emit(phase="k2_act_bf16", card=smi_line, max_abs_err=k2a_err, bar_noise_free=bar16,
         bar_vs_float32_act=CHAIN_ACT_REL, rows=M_MAIN, steps=STEPS, ms=k2a_ms,
         ms_float32_act=k2_ms, plain_ms=k2a_plain_ms,
         bound_ms={k: v[0] for k, v in k2_bound.items()},
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

    # -- 5b. the NsDiff chain's posterior update: bit for bit against its twin
    # and the eager step it replaced, at the main path's rows too, then its
    # time there
    try:
        upd_cases = check_chain_update_kernel(dev)
        upd_err = main_shape_update_err(dev, sched, gen)
    except AssertionError as exc:
        fail("chain_update", str(exc))
    with torch.no_grad():
        ops = update_operands(M_MAIN, 1, 0, gen, dev)
        upd_tab, upd_sched = chain_table(sched, dev), schedule_on(sched, dev)
        upd_ms = {"step": cuda_ms(lambda: nsdiff_chain_update(*ops, upd_tab[7])),
                  "final": cuda_ms(lambda: nsdiff_chain_update(*ops[:5], None, upd_tab[0]))}
        eager_ms = {"step": cuda_ms(lambda: eager_nsdiff_step(upd_sched, 7, *ops, False)),
                    "final": cuda_ms(lambda: eager_nsdiff_step(upd_sched, 0, *ops[:5], None,
                                                               False))}
        del ops
    upd_bound = {k: bound_ms(0.0, chain_update_bytes(M_MAIN, k == "final"), 0.0, "float32",
                             sm_clock_hz)[0] for k in upd_ms}
    emit(phase="chain_update", card=smi_line, cases=upd_cases, rows=M_MAIN,
         max_abs_err=upd_err, ms=upd_ms, eager_ms=eager_ms, bound_ms=upd_bound, bound_by="bytes",
         roofline_pct={k: 100.0 * upd_bound[k] / upd_ms[k] for k in upd_ms})
    if args.kernels:
        emit(stopped_after="chain_update")
        return

    def chunk_mpv(ens):
        """Ensemble variance over the members (last axis), averaged."""
        return ens.var(dim=-1, correction=0).mean().item()

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
    upd_main = counted_updates("nsdiff_main", "the sweep", k1_launches)
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
         update_launches=upd_main,
         k1_matmul_dtype=mm_main, split_s={"f_g": t_fg, "chain": t_chain, "reduce": t_red},
         mpv_first=mpv[:4].tolist())
    # the same chunk's chain through K1 and the update kernel, and through the
    # plain denoiser and the eager update, float32, same generator seed (noise
    # is drawn outside the kernels)
    model.net_param["sampling_dtype"] = "float32"
    zero_counts()
    a = model.sample_chain(y0h, gxh, torch.Generator(device=dev).manual_seed(9), N_Z,
                           use_kernel=True)
    counted_updates("main_vs_plain", "the K1 chain", fused_denoiser_rows.launches)
    with torch.inference_mode():
        rows = lambda v: v[None].expand(N_Z, *v.shape).reshape(-1, *v.shape[1:]).contiguous()
        y0r, gxr = rows(y0h), rows(gxh)
        zero_counts()
        b = eager_nsdiff_chain(model.denoiser_fn(y0r, gxr, use_kernel=False), y0r, gxr,
                               schedule_on(model.sched, dev),
                               torch.Generator(device=dev).manual_seed(9), False, None, N_Z)
        b = b.reshape(N_Z, *y0h.shape).permute(1, 2, 3, 0)
        require(fused_denoiser_rows.launches == 0, "main_vs_plain", "K1 in the plain chain")
        counted_updates("main_vs_plain", "the plain chain", 0)
        del y0r, gxr
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
    require(k2_launches == 1 and fused_chain_rows.launches_act_bf16 == 0, "k2_arm",
            f"K2 launched {k2_launches} times, expected 1, with float32 activations")
    mpv_k2, _ = mpv_reduce(ens2, std, 0 * std, CHUNK, NODE, PRED_LEN)
    m1, m2 = mpv_k1.mean().item(), mpv_k2.mean().item()
    rel = abs(m2 - m1) / m1
    emit(phase="k2_arm", card=smi_line, seconds=t_k2, k1_chain_seconds=t_chain,
         chunk_mpv_k1=m1, chunk_mpv_k2=m2,
         rel=rel, per_window_max_rel=((mpv_k2 - mpv_k1).abs() / mpv_k1).max().item(),
         k2_launches=k2_launches)
    require(rel <= 0.01, "k2_arm", f"K2 arm MPV {m2} vs K1 path {m1}: {rel:.4%}")
    # the same arm with bf16 activations, same seed (the same normals): chunk
    # MPV within 1% of the float32-activation arm's, window by window
    k2a_arm = lambda: fused_nsdiff_chain(model.denoiser, y0h, gxh, model.sched, seed=11,
                                         n_z_samples=N_Z, matmul_dtype=mm_main,
                                         act_dtype="bfloat16")
    k2a_arm()
    zero_counts()
    t_k2a, ens2a = host_s(k2a_arm)
    k2a_launches = fused_chain_rows.launches_act_bf16
    mpv_k2a, _ = mpv_reduce(ens2a, std, 0 * std, CHUNK, NODE, PRED_LEN)
    rel_a = ((mpv_k2a - mpv_k2).abs() / mpv_k2).max().item()
    emit(phase="k2_arm_act_bf16", card=smi_line, seconds=t_k2a, k2_launches_act_bf16=k2a_launches,
         chunk_mpv=mpv_k2a.mean().item(), per_window_max_rel_vs_float32_act=rel_a)
    require(k2a_launches == fused_chain_rows.launches == 1 and 0 < rel_a <= 0.01,
            "k2_arm_act_bf16", f"{k2a_launches} bf16-activation launches, per-window MPV "
            f"{rel_a:.4%} off the float32-act arm")
    del ens, ens2, ens2a, y0h, gxh, model

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

    # -- 10b. the uncertainty_ews facade on the card ----------------------------------
    # The trained SIS model over its whole trajectory, as a figure calls it:
    # the MPV straight from the device, then through the `.pt` cache and its
    # sidecar (the second call served from them, no launch), then with bf16
    # activations through infer_params: K1's other arm, on the same normals
    # (each call builds its model afresh from the seed), within 1% window by
    # window of the float32-activation MPV.
    with tempfile.TemporaryDirectory() as tmp:
        def facade(sub, **kw):
            Path(tmp, sub).mkdir(exist_ok=True)
            zero_counts()
            t, r = host_s(lambda: uncertainty_ews(
                model_save_file=SIS_MODEL, data_file=SIS_DATA, dynamic_type="SIS",
                cache_path=Path(tmp, sub), device="cuda", **kw))
            counted_updates("facade", sub, fused_denoiser_rows.launches)
            return t, r, (fused_denoiser_rows.launches, fused_denoiser_rows.launches_act_bf16)

        facade("warm", cache_mode="none")
        # the facade's time: FACADE_REPS calls, model build included, as a
        # figure makes one; each into a directory of its own, since a call
        # leaves the `.mpv.json` sidecar that serves the next one
        runs = [facade(f"none{i}", cache_mode="none") for i in range(FACADE_REPS)]
        t_none = statistics.median(r[0] for r in runs)
        _, r_none, l_none = runs[-1]
        t_write, r_write, l_write = facade("write")
        t_hit, r_hit, l_hit = facade("write")
        t_act, r_act, l_act = facade("act", cache_mode="none", infer_params={
            "sampling_act_dtype": "bfloat16", "sampling_matmul_dtype": "bfloat16"})
        files = sorted(p.name for p in Path(tmp, "write").iterdir())
    n_fw = len(r_none["ews"])
    ews = {k: np.asarray(r["ews"]) for k, r in (("none", r_none), ("write", r_write),
                                                ("hit", r_hit), ("act", r_act))}
    act_rel = float(np.max(np.abs(ews["act"] - ews["none"]) / ews["none"]))
    write_rel = float(np.max(np.abs(ews["write"] - ews["none"]) / ews["none"]))
    k1a_launches = l_act[1]
    emit(phase="facade", card=smi_line, windows=n_fw, calls=FACADE_REPS,
         seconds_none={"median": t_none, "min": min(r[0] for r in runs),
                       "max": max(r[0] for r in runs)},
         windows_per_hr=n_fw / t_none * 3600.0, seconds_write=t_write, seconds_cache_hit=t_hit,
         seconds_act_bf16=t_act,
         k1_launches_all_and_act_bf16={"none": l_none, "write": l_write, "cache_hit": l_hit,
                                       "act_bf16": l_act},
         mpv=ews["none"].tolist(), mpv_act_bf16=ews["act"].tolist(),
         act_bf16_max_rel=act_rel, write_vs_none_max_rel=write_rel, files=files)
    require(n_fw > 0 and np.isfinite(ews["none"]).all() and (ews["none"] > 0).all()
            and l_none[0] > 0 and l_none[1] == 0, "facade",
            f"bad MPV {ews['none']} or K1 launches {l_none} (all, act bf16)")
    require(l_hit == (0, 0) and np.array_equal(ews["hit"], ews["write"]) and write_rel <= 0.01,
            "facade", f"cache hit: {l_hit} launches; write vs none {write_rel:.4%}")
    require(l_act[1] == l_act[0] > 0 and 0 < act_rel <= 0.01, "facade",
            f"act bf16: K1 launches {l_act} (all, act bf16), MPV {act_rel:.4%} off the "
            "float32-act arm")

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
        stages, records = {}, {}
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
            records[select] = rs
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

        # -- 12b. a seeded run repeats: pretrain_f once more, records equal ------------
        t_again, rs_again = host_s(lambda: run_training(
            tr, va, dict(base, train_model_select="pretrain_f"), dict(net),
            {"loss_metric": "KL divergence"}, opt, Path(tmp) / "pre_model_F_again",
            dataset_param=dataset_param, device="cuda"))
        same = rs_again == records["pretrain_f"]
        cost = {}
        det_batch = torch.as_tensor(np.random.default_rng(1).normal(
            size=(TRAIN_B, WINDOWS + PRED_LEN, 1)), dtype=torch.float32, device=dev)
        for name, select in (("pretrain_f", "pretrain_f"), ("NsDiff_model", None)):
            cost[name] = determinism_cost(
                NsDiffModel(TRAIN_PARAM, select or "NsDiff_model", seed=0, device="cuda"),
                select, det_batch)
        emit(phase="train_determinism", card=smi_line, identical=same, seconds=t_again,
             train_last=[records["pretrain_f"]["train_scores"][-1],
                         rs_again["train_scores"][-1]],
             float32_step_ms_deterministic_cudnn=cost,
             bf16_step_ms={k: train[f"{k}_bfloat16"]["step_ms"] for k in ("NsDiff_model", "TMDM")},
             bf16_step_ms_before={"NsDiff_model": 73.973, "TMDM": 54.081})
        require(same, "train_determinism", "two seeded pretrain_f runs gave other records")

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
        counted_updates("train_then_sweep", "the sweep", demo_k1)
        n_steps = trained.diffusion_steps * -(-len(slbp_w) // 4)
        emit(phase="train_then_sweep", card=smi_line, windows=len(slbp_w), seconds=t_sweep,
             mpv=demo_mpv.tolist(), k1_launches=demo_k1)
        require(demo_k1 == n_steps, "train_then_sweep",
                f"K1 launched {demo_k1} times, expected {n_steps}")
        require(demo_mpv.shape == (len(slbp_w),) and np.isfinite(demo_mpv).all()
                and (demo_mpv > 0).all(), "train_then_sweep", f"bad MPV {demo_mpv}")

    # -- 13b. the train step as a CUDA graph, every family ----------------------------
    train_graph_phase(smi_line)

    # -- 14-16. DiffSTG: the cache runner, training, the facade ------------------------
    kernel_counts = lambda: (fused_denoiser_rows.launches, fused_chain_rows.launches,
                             fused_tmdm_rows.launches)
    diffstg_phases(smi_line, zero_counts, kernel_counts)

    # -- 17-18. NsDiff_spatial and DiffusionTS ----------------------------------------
    nsdiff_spatial_phase(smi_line, zero_counts, kernel_counts)
    diffusionts_phase(smi_line, zero_counts, kernel_counts)

    # -- 19-20. the SLBP analyses and the figure layer, through K1 ---------------------
    k1_by_path = {"nsdiff_main": k1_launches,
                  "slbp": slbp_phase(smi_line, zero_counts, kernel_counts, bound),
                  "figures": figures_phase(smi_line, zero_counts, kernel_counts)}

    # -- 21. data generation on the card (K4), fed into K1's paths ---------------------
    k1_by_path["datagen"], k4_row = datagen_phase(smi_line, zero_counts, kernel_counts, bound)

    # -- 22. the real-data pipeline: the Bury classifiers and g(x), no kernel -----------
    real_data_phase(smi_line, zero_counts, kernel_counts)

    # -- 23. torch.distributed: the sharded sweeps through K1 and K3, the dp step --------
    k1_by_path["multi_gpu"], k3_multi_gpu = multi_gpu_phase(smi_line, zero_counts,
                                                            kernel_counts)

    # -- 24. the experiment drivers of examples/: K1, K3 and K4 on their paths ------------
    k1_by_path["examples"], k3_examples, k4_examples = examples_phase(smi_line, zero_counts,
                                                                      all_counts)
    require(k3_examples > 0, "examples", "K3 was not launched on the drivers' paths")
    k4_row["launches_by_path"] = {"datagen": k4_row["launches"], "examples": k4_examples}
    k4_row["launches"] += k4_examples

    def row(name, src, replaces, launches, err, ms, plain, bound, act=None):
        out = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches, "max_abs_err": err, "ms": ms[mm_main],
               "plain_ms": plain[mm_main], "bound_ms": bound[mm_main][0],
               "bound_by": bound[mm_main][1], "library_ms": None,
               "matmul_dtype": mm_main, "ms_float32": ms["float32"],
               "plain_ms_float32": plain["float32"], "bound_ms_float32": bound["float32"][0]}
        if act is not None:  # the act_dtype="bfloat16" arm, bf16 matmuls
            a_launches, a_err, a_ms, a_plain = act
            out.update(launches_act_bf16=a_launches, max_abs_err_act_bf16=a_err,
                       ms_act_bf16=a_ms, plain_ms_act_bf16=a_plain,
                       bound_ms_act_bf16=bound["bfloat16"][0])
        return out

    print(smi_line, flush=True)
    k2_row = row("chain_resident", "upgdm_tpu_torch/csrc/chain_resident.cu",
                 "upgdm_tpu/ops/pallas/chain_resident.py:188", k2_launches, k2_err[mm_main],
                 k2_ms, k2_plain_ms, k2_bound,
                 (k2a_launches, k2a_err["bfloat16"], k2a_ms["bfloat16"],
                  k2a_plain_ms["bfloat16"]))
    k2_row.update(ms_act_bf16_float32=k2a_ms["float32"],
                  plain_ms_act_bf16_float32=k2a_plain_ms["float32"],
                  max_abs_err_act_bf16_float32=k2a_err["float32"])
    k1_row = row("fused_denoiser", "upgdm_tpu_torch/csrc/fused_denoiser.cu",
                 "upgdm_tpu/ops/pallas/fused_denoiser.py:152", sum(k1_by_path.values()),
                 k1_err[mm_main], k1_ms, k1_plain_ms, k1_bound,
                 (k1a_launches, k1a_err, k1a_ms, k1a_plain_ms))
    k1_row["launches_by_path"] = k1_by_path
    k3_by_path = {"tmdm_main": k3_launches, "multi_gpu": k3_multi_gpu,
                  "examples": k3_examples}
    k3_row = row("fused_tmdm", "upgdm_tpu_torch/csrc/fused_tmdm.cu",
                 "upgdm_tpu/ops/pallas/fused_denoiser.py:250", sum(k3_by_path.values()),
                 k3_err[mm_main], k3_ms, k3_plain_ms, k3_bound)
    k3_row["launches_by_path"] = k3_by_path
    upd_row = {"name": "nsdiff_chain_update", "route": "cuda",
               "source": "upgdm_tpu_torch/csrc/nsdiff_chain_update.cu",
               "replaces": "upgdm_tpu/ops/diffusion.py::nsdiff_p_sample_loop (XLA-fused jnp)",
               "launches": sum(UPDATE_BY_PATH.values()),
               "launches_by_path": dict(UPDATE_BY_PATH), "max_abs_err": upd_err,
               "ms": upd_ms["step"], "plain_ms": eager_ms["step"],
               "bound_ms": upd_bound["step"], "bound_by": "bytes", "library_ms": None}
    print(json.dumps({"kernels": [
        k1_row,
        k2_row,
        k3_row,
        k4_row,
        upd_row,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
