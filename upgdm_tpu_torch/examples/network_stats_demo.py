"""Network-dynamics statistics demo on the port (counterpart of
``examples/network_stats_demo.py``).

Generates a mini SIS dataset over four topologies and two trends (K4 on the
card), trains an NsDiff on one trajectory's per-node windows, lays out the
``ews_results/model_compare/NsDiff/SIS`` checkpoint, and runs the
MPV-collapse statistics CLI over the whole dataset through the g(x)
pathway: the per-sample CSV and the mean +- std summary tables (the check
plots and relation figures when matplotlib is installed).

    python -m upgdm_tpu_torch.examples.network_stats_demo [--out-dir demo_network_torch]
        [--device cpu]

The graphs are drawn from ``random.Random(seed + hash(g_type) % 1000)`` as in
the JAX driver: ``hash`` of a string is salted per process, so the graphs
(and the records) repeat only under a fixed ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import argparse
import random
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("demo_network_torch")
TOPOLOGIES = [("barabasi_albert", 12, 0), ("barabasi_albert", 12, 1),
              ("erdos_renyi", 14, 0), ("small-world", 14, 0)]


def graph_rng(g_type: str, seed: int) -> random.Random:
    """The generator of one topology's graph (salted ``hash``: fixed only
    under a fixed ``PYTHONHASHSEED``)."""
    return random.Random(seed + hash(g_type) % 1000)


def gen_data(out: Path, total_time: float, device=None):
    """Four graphs and their SIS records, both trends."""
    from ..data.graphs import gen_graph, save_graphml
    from ..data.sde import simulate_network_system
    from ..ops.graph import graphml_to_adjacency
    from ..utils.io import save_pt

    graph_dir = out / "test_graph"
    data_dir = out / "spdata_sde_SIS"
    for g_type, n, seed in TOPOLOGIES:
        name = f"{g_type}_{n}_{seed}"
        g = gen_graph(g_type, n, n, rng=graph_rng(g_type, seed))
        save_graphml(g, graph_dir / f"{name}.graphml")
        adj = graphml_to_adjacency(graph_dir / f"{name}.graphml").adj
        for trend in ("increase", "decrease"):
            rec = simulate_network_system(
                "SIS", adj, trend=trend, control_range=(1e-4, 0.8),
                base_params={"d": 1.0}, eta=0.01,
                total_time=total_time, burn_time=20.0, dt=0.1,
                seed=seed * 7 + (trend == "increase"), device=device,
            )
            save_pt(rec, data_dir / name / f"SIS_dynamic_eta0.01d1.0_{trend}.pt")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--total-time", type=float, default=600.0)
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--pred-len", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    from ..figures import mpv_collapse
    from ..train.loop import run_training
    from ..utils.data_prep import pre_dataset_spdata

    out = args.out_dir
    t0 = time.time()

    # ---- 1. graphs + SIS trajectories -------------------------------------
    graph_dir = out / "test_graph"
    data_dir = out / "spdata_sde_SIS"
    if not data_dir.exists():
        gen_data(out, args.total_time, args.device)
        print(f"dataset generated ({time.time()-t0:.0f}s)", flush=True)

    # ---- 2. train NsDiff on one topology's per-node windows ---------------
    ews_root = out / "ews_results"
    model_dir = ews_root / "model_compare" / "NsDiff" / "SIS"
    if not (model_dir / "model_trained").exists():
        dataset_param = dict(
            spdata_file_path=str(data_dir), graph_file_path=str(graph_dir),
            windows=args.windows, pred_len=args.pred_len, interval_step=50,
            sampling_t=0.1, filter="barabasi_albert_12_0",
        )
        x, _adjs, _gids = pre_dataset_spdata(**dataset_param)
        flat = x.reshape(-1, x.shape[2], x.shape[3])  # per-node univariate rows
        print(f"train windows: {flat.shape}", flush=True)
        batch = 64
        n_train = (int(len(flat) * 0.9) // batch) * batch
        perm = np.random.default_rng(0).permutation(len(flat))
        net_param = dict(
            dataset_nf=1, windows=args.windows, pred_len=args.pred_len,
            rolling_length=50, diffusion_steps=20, diffusion_schedule="linear",
            beta_start=1e-4, beta_end=2e-2, scaler_type="StandardScaler",
            d_model=32, n_heads=2, e_layers=1, d_layers=1, d_ff=64, dropout=0.05,
            activation="gelu", p_hidden_dims=[32, 32], p_hidden_layers=2,
            n_z_samples=100, parallel_sample=10, task_model="NsDiff",
            load_pretrain=False, freeze_pretrain=False, output_attention=False,
            factor=3,
        )
        run_training(
            flat[perm[:n_train]], flat[perm[n_train:]],
            dict(train_model_select="NsDiff_model", train_batch_size=batch,
                 val_batch_size=max(1, len(flat) - n_train), train_epochs=args.epochs,
                 test_set=True, ckpt=False),
            net_param, {"loss_metric": "KL divergence"},
            dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5),
            out / "train", dataset_param=dataset_param, device=args.device,
        )
        model_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(out / "train/trained_model/model_trained", model_dir / "model_trained")
        shutil.copy(out / "train/trained_model/model_trained.yaml",
                    model_dir / "model_trained.yaml")
        print(f"model trained ({time.time()-t0:.0f}s)", flush=True)

    # ---- 3. MPV-collapse statistics over the whole dataset ----------------
    stats_argv = [
        "--ews-root", str(ews_root),
        "--source-root", str(out),
        "--output-dir", str(out / "statistics"),
        "--model-name", "NsDiff",
        "--dynamics", "SIS",
        "--plot-checks",
        "--plot-summary-relations",
    ]
    if args.device is not None:
        stats_argv += ["--device", str(args.device)]
    mpv_collapse.main(stats_argv)
    print(f"total {time.time()-t0:.0f}s")
    for p in sorted((out / "statistics").glob("*.csv")):
        print("table:", p)


if __name__ == "__main__":
    main()
