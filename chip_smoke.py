#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (upgdm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from ``upgdm_tpu_torch/csrc/`` (into
``build/kernels/``), holds each kernel against its plain PyTorch twin on the
card, drives the NsDiff sampling-MPV sweep at the bench geometry
(``bench.py``: Node 30, W/P 100/100, 20 steps, 100 samples, d_model 512,
e4/d2) and the TMDM sampling-MPV sweep at the model-comparison geometry
(Node 30, W/P 100/100, label 50, 100 steps, 100 samples, d_model 64, e2/d1)
through the port's entry points, runs the cache-first evaluation runner, and
checks the trained SIS model of ``demo_fig1``. Every phase that fails exits
non-zero. Progress goes to
stdout as JSON lines; the line before the last holds the kernel table, the
last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
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

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

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


def host_s(fn):
    """Host wall time of fn() ended by a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bound_ms(flops, nbytes, mm):
    t_ops = flops / PEAK_FLOPS[mm] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_flops(M, F=1, H=128):
    return 2.0 * M * (3 * F * H + 2 * H * H + 2 * H * F)


def k2_flops(M, T, F=1, H=128):
    return 2.0 * M * (2 * F * H + T * (F * H + 2 * H * H + 2 * H * F))


def k3_flops(M, F=1, H=128):
    return 2.0 * M * (2 * F * H + 2 * H * H + H * F)


def main():
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
        fused_chain_rows, fused_chain_rows_reference, fused_nsdiff_chain, schedule_table,
    )
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
        denoiser_gammas, denoiser_weights, fused_denoiser_rows,
        fused_denoiser_rows_reference, kernel_weights,
    )
    from upgdm_tpu_torch.ops.kernels.fused_tmdm import (
        fused_tmdm_rows, fused_tmdm_rows_reference, tmdm_gammas, tmdm_weights,
    )
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
    from upgdm_tpu_torch.utils.io import load_tensor_list
    from upgdm_tpu_torch.ops.windows import sample_time_series, sliding_windows
    from upgdm_tpu_torch.utils.io import read_model_config

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else f"{card}, power limit not reported"
    print(smi_line, flush=True)
    emit(phase="device", card=card, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit(phase="build", card=smi_line, seconds=time.perf_counter() - t0, library=lib_path.name, ptxas=ptxas)

    # -- 3. K1 against its plain twin ------------------------------------------
    torch.manual_seed(0)
    den = NsDiffDenoiser(1, STEPS).to(dev).eval()
    W = denoiser_weights(den)
    k1_err = {"float32": 0.0, "bfloat16": 0.0}
    # bf16 bar: kernel and twin round the same operands to bf16 and sum exact
    # products in float32 in different orders; an activation within an ulp of
    # a bf16 rounding boundary may round the other way (a 2^-8 step in one of
    # 128 terms), so the bf16 arm is held to 2e-3 (float32 arm: 2e-5).
    k1_tol = {"float32": 2e-5, "bfloat16": 2e-3}
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for M in (65536, 65537):
            x = torch.cat([torch.randn(M, 2, generator=gen, device=dev),
                           torch.rand(M, 1, generator=gen, device=dev) * 0.95 + 0.05], dim=1)
            for t in (0, 7, 19):
                g = denoiser_gammas(den, t)
                for mm in ("float32", "bfloat16"):
                    e, s = fused_denoiser_rows(x, g, W, matmul_dtype=mm)
                    e_r, s_r = fused_denoiser_rows_reference(x, g, W, matmul_dtype=mm)
                    torch.cuda.synchronize()
                    err = max((e - e_r).abs().max().item(), (s - s_r).abs().max().item())
                    k1_err[mm] = max(k1_err[mm], err)
                    require(torch.isfinite(e).all().item() and torch.isfinite(s).all().item(),
                            "k1", f"non-finite output M={M} t={t} {mm}")
                    require(err <= k1_tol[mm], "k1",
                            f"max|err| {err} > {k1_tol[mm]} at M={M} t={t} {mm}")
        x = torch.cat([torch.randn(M_MAIN, 2, generator=gen, device=dev),
                       torch.rand(M_MAIN, 1, generator=gen, device=dev) * 0.95 + 0.05], dim=1)
        g = denoiser_gammas(den, 7)
        k1_ms, k1_plain_ms, k1_bound = {}, {}, {}
        for mm in ("float32", "bfloat16"):
            kw = kernel_weights(W, torch.bfloat16 if mm == "bfloat16" else torch.float32)
            k1_ms[mm] = cuda_ms(lambda: fused_denoiser_rows(x, g, kw, matmul_dtype=mm))
            k1_plain_ms[mm] = cuda_ms(
                lambda: fused_denoiser_rows_reference(x, g, W, matmul_dtype=mm))
            k1_bound[mm] = bound_ms(k1_flops(M_MAIN), 4 * M_MAIN * (3 + 2), mm)
        del x
    emit(phase="k1", card=smi_line, max_abs_err=k1_err, tol=k1_tol, rows=M_MAIN,
         ms=k1_ms, plain_ms=k1_plain_ms,
         bound_ms={k: v[0] for k, v in k1_bound.items()},
         bound_by={k: v[1] for k, v in k1_bound.items()})

    # -- 4. K2 against its plain twin ------------------------------------------
    sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
    tab = torch.as_tensor(schedule_table(sched), device=dev)
    tables = tuple(e.detach() for e in (den.lin1.embed, den.lin2.embed, den.lin3.embed))
    k2_err = {}
    with torch.no_grad():
        M = 65537
        y0 = torch.randn(M, 1, generator=gen, device=dev) * 0.5 + 1.0
        gx = torch.rand(M, 1, generator=gen, device=dev) * 0.95 + 0.05
        for use_gx in (False, True):
            got = fused_chain_rows(y0, gx, tab, 0, tables, W, STEPS, matmul_dtype="float32",
                                   noise_mode="zero", use_gx_directly=use_gx)
            want = fused_chain_rows_reference(y0, gx, tab, tables, W, STEPS,
                                              matmul_dtype="float32", noise_mode="zero",
                                              use_gx_directly=use_gx)
            torch.cuda.synchronize()
            excess = ((got - want).abs() - (2e-6 + 2e-5 * want.abs())).max().item()
            k2_err[f"float32_gx{int(use_gx)}"] = (got - want).abs().max().item()
            require(torch.isfinite(got).all().item(), "k2", f"non-finite chain gx={use_gx}")
            require(excess <= 0, "k2", f"zero-noise chain off rtol 2e-5/atol 2e-6 "
                    f"by {excess} (use_gx_directly={use_gx})")
        # bf16 matmuls, noise-free: boundary flips (see K1) compound over the
        # 20 steps; held to 5e-2 of the mean |y_0| as a sanity bar only
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
        k2_ms, k2_plain_ms, k2_bound = {}, {}, {}
        for mm in ("float32", "bfloat16"):
            k2_ms[mm] = cuda_ms(lambda: fused_chain_rows(
                y0r, gxr, tab, 5, tables, W, STEPS, matmul_dtype=mm))
            k2_plain_ms[mm] = cuda_ms(lambda: fused_chain_rows_reference(
                y0r, gxr, tab, tables, W, STEPS, matmul_dtype=mm, generator=tgen))
            k2_bound[mm] = bound_ms(k2_flops(M_MAIN, STEPS), 4 * M_MAIN * 3, mm)
        del y0r, gxr, ens_p, ens_k
    emit(phase="k2", card=smi_line, max_abs_err=k2_err, mpv_kernel=mpv_k, mpv_twin=mpv_p,
         mpv_rel=mpv_rel, rows=M_MAIN, ms=k2_ms, plain_ms=k2_plain_ms,
         bound_ms={k: v[0] for k, v in k2_bound.items()},
         bound_by={k: v[1] for k, v in k2_bound.items()})

    # -- 5. K3 against its plain twin ------------------------------------------
    k3_err = {"float32": 0.0, "bfloat16": 0.0}
    k3_tol = k1_tol  # the same two bars, for the reason given at K1
    with torch.no_grad():
        for Fdim in (1, 2):
            tden = TMDMDenoiser(Fdim, T_STEPS + 1).to(dev).eval()
            TW = tmdm_weights(tden)
            for M in (65536, 65537):
                x = torch.randn(M, 2 * Fdim, generator=gen, device=dev)
                for t in (0, 50, 100):
                    g = tmdm_gammas(tden, t)
                    for mm in ("float32", "bfloat16"):
                        e = fused_tmdm_rows(x, g, TW, matmul_dtype=mm)
                        e_r = fused_tmdm_rows_reference(x, g, TW, matmul_dtype=mm)
                        torch.cuda.synchronize()
                        err = (e - e_r).abs().max().item()
                        k3_err[mm] = max(k3_err[mm], err)
                        require(e.shape == (M, Fdim) and torch.isfinite(e).all().item(), "k3",
                                f"bad output F={Fdim} M={M} t={t} {mm}")
                        require(err <= k3_tol[mm], "k3",
                                f"max|err| {err} > {k3_tol[mm]} at F={Fdim} M={M} t={t} {mm}")
        tden = TMDMDenoiser(1, T_STEPS + 1).to(dev).eval()
        TW = tmdm_weights(tden)
        x = torch.randn(M_TMDM, 2, generator=gen, device=dev)
        g = tmdm_gammas(tden, 50)
        k3_ms, k3_plain_ms, k3_bound = {}, {}, {}
        for mm in ("float32", "bfloat16"):
            kw = kernel_weights(TW, torch.bfloat16 if mm == "bfloat16" else torch.float32)
            k3_ms[mm] = cuda_ms(lambda: fused_tmdm_rows(x, g, kw, matmul_dtype=mm))
            k3_plain_ms[mm] = cuda_ms(
                lambda: fused_tmdm_rows_reference(x, g, TW, matmul_dtype=mm))
            k3_bound[mm] = bound_ms(k3_flops(M_TMDM), 4 * M_TMDM * 3, mm)
        del x
    emit(phase="k3", card=smi_line, max_abs_err=k3_err, tol=k3_tol, rows=M_TMDM,
         ms=k3_ms, plain_ms=k3_plain_ms,
         bound_ms={k: v[0] for k, v in k3_bound.items()},
         bound_by={k: v[1] for k, v in k3_bound.items()})

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
    del a, b

    # -- 7. the K2 arm at full width ---------------------------------------------
    zero_counts()
    t_k2, ens2 = host_s(lambda: fused_nsdiff_chain(
        model.denoiser, y0h, gxh, model.sched, seed=11, n_z_samples=N_Z, matmul_dtype=mm_main))
    k2_launches = fused_chain_rows.launches
    require(k2_launches == 1, "k2_arm", f"K2 launched {k2_launches} times, expected 1")
    mpv_k2, _ = mpv_reduce(ens2, std, 0 * std, CHUNK, NODE, PRED_LEN)
    m1, m2 = mpv_k1.mean().item(), mpv_k2.mean().item()
    rel = abs(m2 - m1) / m1
    emit(phase="k2_arm", card=smi_line, seconds=t_k2, chunk_mpv_k1=m1, chunk_mpv_k2=m2,
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
    del a, b, y0t, embt

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
            k2_err["float32_gx0"], k2_ms, k2_plain_ms, k2_bound),
        row("fused_tmdm", "upgdm_tpu_torch/csrc/fused_tmdm.cu",
            "upgdm_tpu/ops/pallas/fused_denoiser.py:250", k3_launches, k3_err[mm_main],
            k3_ms, k3_plain_ms, k3_bound),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
