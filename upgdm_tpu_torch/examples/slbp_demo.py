"""End-to-end SLBP demo on the port (counterpart of ``examples/slbp_demo.py``).

Generates an SLBP lake-model trajectory with a ramped nutrient level (K4 on
the card), trains NsDiff through the reference's three-stage protocol
(pretrain_f -> pretrain_g -> NsDiff_model with load_pretrain), then runs
``uncertainty_ews`` with both uncertainty pathways (the 100-member ensemble
MPV through K1, and the closed-form g(x)) over the rolling windows of the same
trajectory, and writes ``summary.json`` and, when matplotlib is installed, the
MPV-collapse figure.

    python -m upgdm_tpu_torch.examples.slbp_demo [--out-dir demo_artifacts_torch]
        [--stage all|data|train|scan] [--device cpu]

Without ``--device`` every stage runs on the card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("demo_artifacts_torch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--total-time", type=float, default=2e5)
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--pred-len", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-z-samples", type=int, default=100)
    ap.add_argument("--stage", choices=["all", "data", "train", "scan"], default="all",
                    help="run one phase: data generation / 3-stage training / MPV scan")
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    from ..data.generate import generate_slbp_dataset
    from ..train.loop import run_training
    from ..utils.data_prep import pre_dataset_timeseries
    from ..utils.io import load_pt

    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    t_start = time.time()

    # ---- 1. data ---------------------------------------------------------
    data_dir = out / "slbp_data"
    if not data_dir.exists():
        print("simulating SLBP trajectory...", flush=True)
        generate_slbp_dataset(
            data_dir, trends=("increase",), total_times=(args.total_time,),
            d_values=(1e-5,), burn_time=1000.0, dt=0.1, seed=0, device=args.device,
        )
    data_file = next(data_dir.rglob("*.pt"))
    if args.stage == "data":
        print("data stage done")
        return
    record = load_pt(data_file)
    print(f"trajectory: {record['ys_dynamic'].shape} points", flush=True)

    dataset_param = dict(
        file_path=str(data_dir), filter="*", sampling_t=100, windows=args.windows,
        pred_len=args.pred_len, interval_step=20, STG_exist=False,
    )
    dataset = pre_dataset_timeseries(**dataset_param)
    print(f"windows dataset: {dataset.shape}", flush=True)
    batch = 32
    n_train = (int(len(dataset) * 0.9) // batch) * batch
    perm = np.random.default_rng(0).permutation(len(dataset))
    train, val = dataset[perm[:n_train]], dataset[perm[n_train:]]

    # ---- 2. three-stage training ----------------------------------------
    net_param = dict(
        dataset_nf=2, windows=args.windows, pred_len=args.pred_len, rolling_length=50,
        diffusion_steps=20, diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2,
        scaler_type="StandardScaler", d_model=64, n_heads=4, e_layers=2, d_layers=1,
        d_ff=128, dropout=0.05, activation="gelu", p_hidden_dims=[64, 64],
        p_hidden_layers=2, n_z_samples=args.n_z_samples, parallel_sample=10,
        task_model="NsDiff", load_pretrain=False, freeze_pretrain=False,
        output_attention=False, factor=3,
    )
    opt_param = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
    base_train = dict(train_batch_size=batch, val_batch_size=len(val), test_set=True,
                      ckpt=False, ckpt_period=10)

    model_dir = out / "model"
    if args.stage == "scan":
        if not (model_dir / "model_trained").exists():
            raise SystemExit("run --stage train first")
        return run_scan(args, out, model_dir, data_file, record, t_start)

    stages = [
        ("pretrain_f", out / "pre_model_F", args.epochs),
        ("pretrain_g", out / "pre_model_G", args.epochs),
    ]
    for select, path, epochs in stages:
        print(f"stage {select} ...", flush=True)
        t0 = time.time()
        rs = run_training(
            train, val, dict(base_train, train_model_select=select, train_epochs=epochs),
            dict(net_param), {"loss_metric": "KL divergence"}, opt_param, path,
            dataset_param=dataset_param, device=args.device,
        )
        print(f"  {select}: final train {rs['train_scores'][-1]:.4f} "
              f"val {rs['val_scores'][-1]:.4f} ({time.time()-t0:.0f}s)", flush=True)
        # the stage checkpoint where load_pretrain expects it
        shutil.copy(path / "trained_model/model_trained", path / "model_trained")

    print("stage NsDiff_model ...", flush=True)
    t0 = time.time()
    main_net = dict(net_param, load_pretrain=True,
                    pretrain_f_path=str(out / "pre_model_F"),
                    pretrain_g_path=str(out / "pre_model_G"))
    rs = run_training(
        train, val,
        dict(base_train, train_model_select="NsDiff_model", train_epochs=args.epochs),
        main_net, {"loss_metric": "KL divergence"}, opt_param, out / "nsdiff",
        dataset_param=dataset_param, device=args.device,
    )
    print(f"  main: final train {rs['train_scores'][-1]:.4f} "
          f"val {rs['val_scores'][-1]:.4f} ({time.time()-t0:.0f}s)", flush=True)

    model_dir.mkdir(exist_ok=True)
    shutil.copy(out / "nsdiff/trained_model/model_trained", model_dir / "model_trained")
    shutil.copy(out / "nsdiff/trained_model/model_trained.yaml",
                model_dir / "model_trained.yaml")
    if args.stage == "train":
        print("train stage done")
        return
    return run_scan(args, out, model_dir, data_file, record, t_start)


def run_scan(args, out, model_dir, data_file, record, t_start):
    """The MPV scan (sampling and g(x)) and the summary; returns it."""
    from ..eval.uncertainty import plot_single_model_check, uncertainty_ews
    from ..figures.mpv_collapse import locate_transition, metric_row_from_mpv

    print("running uncertainty_ews (sampling + gx) ...", flush=True)
    t0 = time.time()
    result = uncertainty_ews(
        model_save_file=model_dir,
        data_file=data_file,
        dynamic_type="SLBP",
        cache_path=out / "cache/mpv_cache.pt",
        nsdiff_g_path=out / "cache/mpv_cache_gx.pt",
        sample_window_step=10,
        uncertainty_method="both",
        chunk_windows=16,
        load_model_when_cached=True,  # summaries inverse-transformed on reruns
        device=args.device,
    )
    scan_s = time.time() - t0
    n_windows = len(result["ews"])
    print(f"  {n_windows} windows in {scan_s:.1f}s "
          f"({n_windows/scan_s*3600:.0f} windows/hr)", flush=True)

    figure = out / "slbp_mpv_collapse.png"
    if importlib.util.find_spec("matplotlib") is not None:
        plot_single_model_check(result, title="SLBP NsDiff MPV", save_path=figure)
    # the transition is the state's regime shift (the largest windowed change
    # of the bream state): in a ramped run the tip lags the static threshold
    ts = np.asarray(record["ts_dynamic"], float)[::1000]
    xstate = np.asarray(record["ys_dynamic"], float)[::1000, 0]
    transition = locate_transition(ts, xstate, "SLBP", "increase")
    transition_time = float(transition["transition_time"])
    metrics = metric_row_from_mpv(result["time_points"], result["ews"],
                                  transition_time, slope_window_points=10)
    gx_metrics = metric_row_from_mpv(
        result["nsdiff_g"]["time_points"], result["nsdiff_g"]["ews"],
        transition_time, slope_window_points=10,
    )
    summary = {
        "n_windows": n_windows,
        "scan_seconds": scan_s,
        "windows_per_hr": n_windows / scan_s * 3600,
        "transition_time_state": transition_time,
        "sampling_mpv": {k: v for k, v in metrics.items()
                         if not isinstance(v, np.ndarray)},
        "gx_mpv": {k: v for k, v in gx_metrics.items()
                   if not isinstance(v, np.ndarray)},
        "total_seconds": time.time() - t_start,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2, default=float))
    print(json.dumps(summary, indent=2, default=float))
    if figure.exists():
        print(f"figure: {figure}")
    return summary


if __name__ == "__main__":
    main()
