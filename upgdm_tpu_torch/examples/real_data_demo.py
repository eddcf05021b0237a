"""Real-data EWS pipeline demo on the port (counterpart of
``examples/real_data_demo.py``).

Builds an "empirical" record from the tracked SLBP demo trajectory
(``demo_artifacts/``, subsampled to a few hundred points, the located state
transition stamped into the record), trains a small univariate NsDiff on the
detrended windows, then runs the real-data analysis CLI: linear interpolation
to the model window, Lowess detrending for the model input, the g(x)
uncertainty signal and its trend slope, classic EWS (rolling variance, AR1)
and the per-record CSV (and, when matplotlib is installed, the PNG/SVG
subfigure). No kernel is on this path: g(x) only.

    python -m upgdm_tpu_torch.examples.real_data_demo [--out-dir demo_real_torch]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("demo_real_torch")
SOURCE_TRACE = (Path(__file__).resolve().parents[2]
                / "demo_artifacts/slbp_data/SLBP_dynamic_total_time_200000.0_N_increase"
                / "SLBP_dynamic_D_1e-05.pt")


def build_empirical_record(out_path: Path, n_points: int = 500) -> Path:
    """Subsample the SLBP demo trajectory into a sparse 'empirical' record:
    the pre-transition run-up and a short post-transition tail."""
    from ..figures.mpv_collapse import locate_transition
    from ..utils.io import load_pt, save_pt

    rec = load_pt(SOURCE_TRACE)
    ys = np.asarray(rec["ys_dynamic"], np.float32)
    ts = np.asarray(rec["ts_dynamic"], np.float32).ravel()
    if ys.ndim == 1:
        ys = ys[:, None]
    transition = locate_transition(ts, ys[:, 0], "SLBP", "increase")
    t_end = float(transition["transition_time"]) + 0.1 * (ts[-1] - ts[0])
    keep = ts <= t_end
    ys, ts = ys[keep], ts[keep]
    stride = max(1, len(ts) // n_points)
    ys, ts = ys[::stride], ts[::stride]
    record = {
        "name": "slbp_empirical_demo",
        "ys_dynamic": ys,
        "ts_dynamic": ts,
        "transition_time": float(transition["transition_time"]),
        "data_type": "demo_slbp",
    }
    save_pt(record, out_path)
    print(f"empirical record: {out_path} ({len(ts)} points, "
          f"transition at t={record['transition_time']:.0f})")
    return out_path


def train_demo_model(data_path: Path, model_dir: Path, windows: int,
                     pred_len: int, epochs: int, device=None) -> None:
    """Small univariate NsDiff on the empirical series' detrended windows."""
    from ..eval.ews_classic import detrend
    from ..train.loop import run_training
    from ..utils.io import load_pt

    record = load_pt(data_path)
    ys = np.asarray(record["ys_dynamic"], np.float32)
    if ys.ndim == 1:
        ys = ys[:, None]
    series = detrend(ys[:, 0], method="Lowess", span=0.2).astype(np.float32)
    L = windows + pred_len
    starts = np.arange(0, len(series) - L + 1, 2)
    flat = series[starts[:, None] + np.arange(L)[None, :]][:, :, None]  # [n, L, 1]
    batch = 32
    n_train = max(batch, (int(len(flat) * 0.9) // batch) * batch)
    perm = np.random.default_rng(0).permutation(len(flat))
    dataset_param = dict(file_path=str(data_path), windows=windows,
                         pred_len=pred_len, sampling_t=0.1, interval_step=2)
    net_param = dict(
        dataset_nf=1, windows=windows, pred_len=pred_len, rolling_length=50,
        diffusion_steps=20, diffusion_schedule="linear", beta_start=1e-4,
        beta_end=2e-2, scaler_type="StandardScaler", d_model=32, n_heads=2,
        e_layers=1, d_layers=1, d_ff=64, dropout=0.05, p_hidden_dims=[32, 32],
        p_hidden_layers=2, n_z_samples=100, parallel_sample=10,
        task_model="NsDiff", load_pretrain=False, freeze_pretrain=False,
        output_attention=False, factor=3, activation="gelu",
    )
    run_training(
        flat[perm[:n_train]], flat[perm[n_train:]],
        dict(train_model_select="NsDiff_model", train_batch_size=batch,
             val_batch_size=max(1, len(flat) - n_train), train_epochs=epochs,
             test_set=True, ckpt=False),
        net_param, {"loss_metric": "KL divergence"},
        dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5),
        model_dir.parent / "train", dataset_param=dataset_param, device=device,
    )
    model_dir.mkdir(parents=True, exist_ok=True)
    trained = model_dir.parent / "train" / "trained_model"
    shutil.copy(trained / "model_trained", model_dir / "model_trained")
    shutil.copy(trained / "model_trained.yaml", model_dir / "model_trained.yaml")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--n-points", type=int, default=500)
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--pred-len", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of the training and g(x) (default: the card)")
    args = ap.parse_args(argv)
    from ..eval import real_data

    out = args.out_dir
    t0 = time.time()

    data_path = out / "data" / "slbp_empirical_demo.pt"
    if not data_path.exists():
        data_path.parent.mkdir(parents=True, exist_ok=True)
        build_empirical_record(data_path, args.n_points)

    model_dir = out / "model"
    if not (model_dir / "model_trained").exists():
        train_demo_model(data_path, model_dir, args.windows, args.pred_len,
                         args.epochs, args.device)
        print(f"model trained ({time.time()-t0:.0f}s)", flush=True)

    cli = [
        "--data-root", str(out / "data"),
        "--real-data-result-root", str(out / "ews_results"),
        "--output-root", str(out / "figures"),
        "--data-real-names", "slbp_empirical_demo",
        "--model-dir", str(model_dir),
        # bury_ml left out, as in the JAX driver
        "--signals", "model_uncertainty", "model_trend", "ar1", "variance",
    ]
    if args.device is not None:
        cli += ["--device", str(args.device)]
    real_data.main(cli)
    print(f"total {time.time() - t0:.0f}s")
    for p in sorted((out / "figures").rglob("*")):
        if p.is_file():
            print("artifact:", p)


if __name__ == "__main__":
    main()
