"""Paper-Figure-1 demo on the port (counterpart of ``examples/fig1_demo.py``).

Generates the three networked dynamics (biomass, neuronal, SIS) on a BA-12
graph with the paper's file names (``figures/common.py::dynamics_filename``),
K4 on the card, trains one small NsDiff a dynamics, and runs Fig. 1 (raw mean
state and relative sampling MPV with the transition marked) through the
port's figure CLI, whose loaders sweep through ``uncertainty_ews``'s sampling
pathway (K1) and write the `.pt` ensemble caches. The render needs
matplotlib; without it the CLI stops after the sweeps.

    python -m upgdm_tpu_torch.examples.fig1_demo [--out-dir demo_fig1_torch] [--device cpu]
"""
from __future__ import annotations

import argparse
import random
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("demo_fig1_torch")
GRAPH = "barabasi_albert_12_0"
# physics matching the paper's Fig-1 file names
SYSTEMS = {
    "biomass": dict(control_range=(0.0, 4.0),
                    base_params={"r": 0.7, "k": 10.0, "d": 0.05}, eta=0.005),
    "neuronal": dict(control_range=(0.0, 1.0),
                     # mu 1.5 as the reference generator: 3.0 kills the bistability
                     base_params={"tau": 2.0, "mu": 1.5}, eta=0.01),
    "SIS": dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--total-time", type=float, default=40.0)
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--pred-len", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n-z-samples", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    from ..data.graphs import gen_graph, save_graphml
    from ..data.sde import simulate_network_system
    from ..figures import fig1_model_compare
    from ..figures.common import dynamics_filename
    from ..ops.graph import graphml_to_adjacency
    from ..train.loop import run_training
    from ..utils.data_prep import pre_dataset_spdata
    from ..utils.io import save_pt

    out = args.out_dir
    t0 = time.time()

    # ---- 1. graph + the three dynamics with paper file names --------------
    graph_path = out / "test_graph" / f"{GRAPH}.graphml"
    if not graph_path.exists():
        g = gen_graph("barabasi_albert", 12, 12, rng=random.Random(0))
        save_graphml(g, graph_path)
    adj = graphml_to_adjacency(graph_path).adj
    for system, cfg in SYSTEMS.items():
        data_path = (out / f"spdata_sde_{system}" / GRAPH
                     / dynamics_filename(system, "increase"))
        if data_path.exists():
            continue
        rec = simulate_network_system(
            system, adj, trend="increase", total_time=args.total_time,
            burn_time=20.0, dt=0.1, seed=3, device=args.device, **cfg,
        )
        save_pt(rec, data_path)
        print(f"{system}: simulated ({time.time()-t0:.0f}s)", flush=True)

    # ---- 2. one small NsDiff per dynamics ----------------------------------
    for system in SYSTEMS:
        model_dir = out / "ews_results" / "model_compare" / "NsDiff" / system
        if (model_dir / "model_trained").exists():
            continue
        dataset_param = dict(
            spdata_file_path=str(out / f"spdata_sde_{system}"),
            graph_file_path=str(out / "test_graph"),
            windows=args.windows, pred_len=args.pred_len, interval_step=2,
            sampling_t=0.1, filter=GRAPH,
        )
        x, _adjs, _gids = pre_dataset_spdata(**dataset_param)
        flat = x.reshape(-1, x.shape[2], x.shape[3])
        batch = 32
        n_train = max(batch, (int(len(flat) * 0.9) // batch) * batch)
        perm = np.random.default_rng(0).permutation(len(flat))
        net_param = dict(
            dataset_nf=1, windows=args.windows, pred_len=args.pred_len,
            rolling_length=50, diffusion_steps=20, diffusion_schedule="linear",
            beta_start=1e-4, beta_end=2e-2, scaler_type="StandardScaler",
            d_model=32, n_heads=2, e_layers=1, d_layers=1, d_ff=64,
            dropout=0.05, p_hidden_dims=[32, 32], p_hidden_layers=2,
            n_z_samples=args.n_z_samples, parallel_sample=10,
            task_model="NsDiff", load_pretrain=False, freeze_pretrain=False,
            output_attention=False, factor=3, activation="gelu",
        )
        run_training(
            flat[perm[:n_train]], flat[perm[n_train:]],
            dict(train_model_select="NsDiff_model", train_batch_size=batch,
                 val_batch_size=max(1, len(flat) - n_train),
                 train_epochs=args.epochs, test_set=True, ckpt=False),
            net_param, {"loss_metric": "KL divergence"},
            dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5),
            out / "train" / system, dataset_param=dataset_param, device=args.device,
        )
        model_dir.mkdir(parents=True, exist_ok=True)
        trained = out / "train" / system / "trained_model"
        shutil.copy(trained / "model_trained", model_dir / "model_trained")
        shutil.copy(trained / "model_trained.yaml", model_dir / "model_trained.yaml")
        print(f"{system}: model trained ({time.time()-t0:.0f}s)", flush=True)

    # ---- 3. Figure 1 through the figure CLI --------------------------------
    fig1_argv = [
        "--ews-root", str(out / "ews_results"),
        "--source-root", str(out),
        "--output-dir", str(out / "figures"),
        "--trend", "increase",
        "--graph", GRAPH,
        "--models", "NsDiff",
    ]
    if args.device is not None:
        fig1_argv += ["--device", str(args.device)]
    fig1_model_compare.main(fig1_argv)
    print(f"total {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
