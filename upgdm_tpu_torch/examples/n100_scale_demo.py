"""Reference-scale (100-node) training and MPV proof on the port (counterpart
of ``examples/n100_scale_demo.py``).

Generates a 100-node BA graph and an SIS trajectory (K4 on the card), trains
NsDiff_spatial and DiffSTG on it at windows/pred 200/200, sweeps the sampling
MPV over the trajectory for both, and writes the MPV curves, the metric rows
and the sweep throughput (``summary.json``).

    python -m upgdm_tpu_torch.examples.n100_scale_demo [--out-dir demo_n100_torch]
        [--epochs 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import random
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("demo_n100_torch")
GRAPH = "barabasi_albert_100_0"
W = P = 200
T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:6.0f}s] {msg}", flush=True)


def gen_data(out: Path, device=None) -> Path:
    from ..data.graphs import gen_graph, save_graphml
    from ..data.sde import simulate_network_system
    from ..ops.graph import graphml_to_adjacency
    from ..utils.io import save_pt

    gpath = out / "test_graph" / f"{GRAPH}.graphml"
    if not gpath.exists():
        g = gen_graph("barabasi_albert", 100, 100, rng=random.Random(0))
        save_graphml(g, gpath)
    data_path = out / "spdata_sde_SIS" / GRAPH / "SIS_dynamic_eta0.0001d0.5_increase.pt"
    if not data_path.exists():
        adj = graphml_to_adjacency(gpath).adj
        # dt 0.01 (Euler is marginal at 0.1 on the hubs), every 10th step
        # stored; the control tops out near the epidemic threshold so the
        # transition lands in the scanned second half
        rec = simulate_network_system(
            "SIS", adj, trend="increase", total_time=150.0, burn_time=20.0,
            dt=0.01, save_every=10, seed=7, control_range=(1e-4, 0.075),
            base_params={"d": 0.5}, eta=1e-4, device=device,
        )
        save_pt(rec, data_path)
        log(f"SIS N=100: {rec['ys_dynamic'].shape}")
    return data_path


def build_windows(data_path: Path, stride: int):
    """([n, V, W+P, 1] windows, ts, ys [T, V]) of the record."""
    from ..utils.io import load_pt

    rec = load_pt(data_path)
    ys = np.asarray(rec["ys_dynamic"], np.float32)  # [T, 100]
    ts = np.asarray(rec["ts_dynamic"], np.float32)
    L = W + P
    starts = np.arange(0, ys.shape[0] - L + 1, stride)
    wins = ys[starts[:, None] + np.arange(L)[None, :]]  # [n, L, V]
    return wins.transpose(0, 2, 1)[..., None], ts, ys  # [n, V, L, 1]


def train_one(task_model: str, wins, adj, out_dir: Path, epochs: int, device=None):
    from ..train.loop import run_training

    n = len(wins)
    if task_model == "NsDiff_spatial":
        net = dict(
            dataset_nf=1, windows=W, pred_len=P, rolling_length=50,
            diffusion_steps=20, scaler_type="StandardScaler", d_model=16,
            n_heads=2, e_layers=1, d_layers=1, d_ff=32, p_hidden_dims=[8, 8],
            p_hidden_layers=2, n_z_samples=20, parallel_sample=10,
            task_model="NsDiff_spatial", gnn_name="GCNConv", gnn_param={},
            d_h=4, channel_multipliers=[1, 2], n_blocks=1, Td_h=8,
        )
        select = "NsDiff_model"
    else:
        net = dict(
            T_h=W, T_p=P, F=1, diffusion_steps=100, inference_diffusion_steps=10,
            inference_trick="ddim", inference_schedule="cosine",
            diffusion_schedule="linear", scaler_type="StandardScaler", d_h=4,
            Td_h=8, channel_multipliers=[1, 2], n_blocks=1, gnn_name="GCNConv",
            gnn_param={}, mask_ratio=0.2, loss_weight_schedule="none",
            parallel_sampling=10, sequential_sampling=2, init_num_nodes=100,
            task_model="DiffSTG",
        )
        select = None
    run_training(
        wins[: max(2, n - 2)], wins[-2:],
        dict(train_model_select=select, train_batch_size=2, val_batch_size=2,
             train_epochs=epochs, test_set=True, ckpt=False),
        net, {"loss_metric": "KL divergence"},
        dict(optimizer_name="Adam", lr=1e-3, weight_decay=0.0),
        out_dir, adj=adj,
        dataset_param=dict(windows=W, pred_len=P, sampling_t=0.1), device=device,
    )
    return out_dir / "trained_model"


def mpv_sweep(trained, adj, ys, ts, step: int, device=None):
    """(times, MPV a window, seconds) of the sampling sweep, one window at a
    time through the model's ``evaluation_step``."""
    from ..eval.uncertainty import load_model_from_dir

    model, _np_ = load_model_from_dir(trained.parent / "model", device=device)
    starts = np.arange(0, ys.shape[0] - W + 1, step)
    t_sweep0 = time.time()
    mpvs = []
    for s in starts:
        win = ys[s : s + W].T[..., None]  # [V, W, 1]
        if model.scaler is not None:
            win = model.scaler_transform(win)
        outs, _ = model.evaluation_step({"x": win, "adj": adj})
        outs = outs.float().cpu().numpy()
        if model.scaler is not None:
            outs = outs * float(np.asarray(model.scaler_std).ravel()[0]) + float(
                np.asarray(model.scaler_mean).ravel()[0])
        mpvs.append(float(np.var(outs, axis=-1).mean()))
    elapsed = time.time() - t_sweep0
    times = ts[starts + W - 1]
    return np.asarray(times), np.asarray(mpvs), elapsed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--train-stride", type=int, default=100)
    ap.add_argument("--scan-step", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    from ..figures.mpv_collapse import locate_transition, metric_row_from_mpv
    from ..ops.graph import graphml_to_adjacency

    out = args.out_dir
    data_path = gen_data(out, args.device)
    wins, ts, ys = build_windows(data_path, args.train_stride)
    adj = graphml_to_adjacency(out / "test_graph" / f"{GRAPH}.graphml").adj
    log(f"{len(wins)} training windows of [100, {W+P}, 1]")

    summary = {"graph": GRAPH, "nodes": 100, "windows": W, "pred_len": P}
    tr = locate_transition(ts, ys.mean(axis=1), "SIS", "increase")
    for task in ("NsDiff_spatial", "DiffSTG"):
        mdir = out / task
        if not (mdir / "model/model_trained").exists():
            trained = train_one(task, wins, adj, mdir, args.epochs, args.device)
            (mdir / "model").mkdir(parents=True, exist_ok=True)
            shutil.copy(trained / "model_trained", mdir / "model/model_trained")
            shutil.copy(trained / "model_trained.yaml", mdir / "model/model_trained.yaml")
            log(f"{task}: trained")
        times, mpvs, elapsed = mpv_sweep(
            mdir / "trained_model", adj, ys, ts, args.scan_step, args.device)
        row = metric_row_from_mpv(times, mpvs, tr["transition_time"])
        np.savetxt(out / f"{task}_mpv.csv",
                   np.stack([times, mpvs], axis=1), delimiter=",",
                   header="time,mpv", comments="")
        summary[task] = {
            "n_scan_windows": int(len(mpvs)),
            "sweep_s": round(elapsed, 2),
            "windows_per_hr": round(len(mpvs) / elapsed * 3600.0, 1),
            "pre_transition_drop_percent": row.get("pre_transition_drop_percent"),
            "lead_time": row.get("lead_time"),
            "skip_reason": row.get("skip_reason", ""),
        }
        log(f"{task}: sweep {len(mpvs)} windows in {elapsed:.1f}s "
            f"({len(mpvs)/elapsed*3600:.0f} windows/hr)")
    summary["transition_time"] = tr["transition_time"]
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    log(f"summary: {out / 'summary.json'}")
    return summary


if __name__ == "__main__":
    main()
