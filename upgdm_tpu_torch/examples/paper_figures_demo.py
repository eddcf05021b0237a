"""Paper figures 2-9 and real-systems, every figure CLI end to end, on the
port (counterpart of ``examples/paper_figures_demo.py``).

Lays down the ``ews_results`` tree the paper-figure scripts read (the
generalization models, the SLBP sensitivity banks, the ablation variants,
the constant-dataset g(x) models, the training-source models, the
machine/NsDiff + preg pair) at a reduced but honest scale (every model
trained on simulated data under the reference's names), then runs each figure
through its CLI.

Stages (idempotent; each skips the work whose outputs exist):

    python -m upgdm_tpu_torch.examples.paper_figures_demo --stage data     # SDEs (K4)
    python -m upgdm_tpu_torch.examples.paper_figures_demo --stage models   # ~20 trainings
    python -m upgdm_tpu_torch.examples.paper_figures_demo --stage figures  # the figure CLIs
    python -m upgdm_tpu_torch.examples.paper_figures_demo                  # all of them

``--device cpu`` runs every stage on the CPU (default: the card). Figs 4-7
sweep sampling panels through K1. Without matplotlib each figure CLI runs
its loaders (its sweeps and caches) and renders nothing.
"""
from __future__ import annotations

import argparse
import random
import shutil
import time
import zlib
from pathlib import Path

import numpy as np

from ..figures.common import dynamics_filename, graph_name, slbp_source_path
from ..utils.io import load_pt, save_pt

DEFAULT_OUT = Path("demo_paper_torch")
T0 = time.time()

# ---- SLBP scale (reference names; totals reduced) ---------------------------
SLBP_TOTALS = ("200000.0", "300000.0", "400000.0")
SLBP_MAIN_TOTAL = "400000.0"          # figs 4, 6, 7, 8, 9
SLBP_D_VALUES = ("1e-05", "5e-06")
SLBP_MAIN_D = "1e-05"
FIG5_TIME_ROWS = ("200000.0:t2e5:10", "300000.0:t3e5:10", "400000.0:t4e5:20")
SENS_LENS = (200, 500)                # fig4's pred/window sweep

# constant-control training datasets (the NsDiff_dataset_contant panels)
CONTANT_SPECS = {
    "D_0.001": (0.001, 1.0),
    "D_0.0001": (0.0001, 1.0),
    "D_1e-05": (1e-05, 1.0),
    "D_0.001_N_0.5": (0.001, 0.5),
    "D_0.001_N_2.5": (0.001, 2.5),
    "D_0.001_N_5": (0.001, 5.0),
}

# ---- networked systems at reference node counts (figs 2/3 conventions) -----
GRAPHS = {
    "barabasi_albert_30_0": ("barabasi_albert", 30),
    "erdos_renyi_50_0": ("erdos_renyi", 50),
    "small-world_70_0": ("small-world", 70),
}
SYSTEMS = {
    "biomass": dict(control_range=(0.0, 4.0),
                    base_params={"r": 0.7, "k": 10.0, "d": 0.05}, eta=0.005,
                    total_time=3000.0, burn_time=100.0, sampling_t=10),
    "neuronal": dict(control_range=(0.0, 1.0),
                     # mu 1.5 as the reference generator: 3.0 kills the bistability
                     base_params={"tau": 2.0, "mu": 1.5}, eta=0.01,
                     total_time=3000.0, burn_time=100.0, sampling_t=10),
    "SIS": dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4,
                total_time=40.0, burn_time=20.0, sampling_t=0.1),
}

SLBP_NET = dict(
    dataset_nf=2, rolling_length=50, diffusion_steps=20,
    diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2,
    scaler_type="StandardScaler", d_model=16, n_heads=2, e_layers=1,
    d_layers=1, d_ff=32, dropout=0.05, p_hidden_dims=[8, 8], p_hidden_layers=2,
    n_z_samples=20, parallel_sample=10, load_pretrain=False,
    freeze_pretrain=False, output_attention=False, factor=3, activation="gelu",
)


def log(msg):
    print(f"[{time.time()-T0:6.0f}s] {msg}", flush=True)


def stable_seed(*parts) -> int:
    """A seed from the spec tuple that repeats across processes (the builtin
    ``hash`` is salted per process)."""
    return zlib.crc32(repr(parts).encode()) % 100_000


# ===========================================================================
# stage: data
# ===========================================================================

def gen_data(out: Path, device=None):
    from ..data.graphs import gen_graph, save_graphml
    from ..data.sde import simulate_network_system, simulate_slbp
    from ..ops.graph import graphml_to_adjacency

    ds = out / "dataset"
    # SLBP ramped records for every (total, trend, D) the figures touch
    for total in SLBP_TOTALS:
        for trend in ("increase", "decrease"):
            for d in SLBP_D_VALUES:
                path = slbp_source_path(ds, total, trend, d)
                if path.exists():
                    continue
                rec = simulate_slbp(
                    params={"D": float(d)}, trend=trend, total_time=float(total),
                    burn_time=1000.0, dt=0.1,
                    seed=stable_seed(total, trend, d), device=device,
                )
                save_pt(rec, path)
                log(f"SLBP {total} {trend} D={d}: {rec['ys_dynamic'].shape}")
    # constant-control SLBP training records (the *_contant datasets)
    for folder, (d, n) in CONTANT_SPECS.items():
        path = ds / "SLBP_model_data_contant" / folder / "SLBP_dynamic.pt"
        if path.exists():
            continue
        rec = simulate_slbp(
            params={"D": d}, total_time=100000.0, burn_time=1000.0, dt=0.1,
            seed=stable_seed(folder), constant_n=n, device=device,
        )
        save_pt(rec, path)
        log(f"SLBP contant {folder}: {rec['ys_dynamic'].shape}")

    # networked systems on reference-size graphs, figure file names
    for gname, (gtype, n_nodes) in GRAPHS.items():
        gpath = ds / "test_graph" / f"{gname}.graphml"
        if not gpath.exists():
            g = gen_graph(gtype, n_nodes, n_nodes, rng=random.Random(int(gname[-1])))
            save_graphml(g, gpath)
    for system, cfg in SYSTEMS.items():
        for gname in GRAPHS:
            path = (ds / f"spdata_sde_{system}" / gname
                    / dynamics_filename(system, "increase"))
            if path.exists():
                continue
            adj = graphml_to_adjacency(ds / "test_graph" / f"{gname}.graphml").adj
            rec = simulate_network_system(
                system, adj, trend="increase", total_time=cfg["total_time"],
                burn_time=cfg["burn_time"], dt=0.1,
                seed=stable_seed(system, gname),
                control_range=cfg["control_range"],
                base_params=cfg["base_params"], eta=cfg["eta"], device=device,
            )
            save_pt(rec, path)
            log(f"{system} {gname}: {rec['ys_dynamic'].shape}")


# ===========================================================================
# stage: models
# ===========================================================================

def _slbp_windows(record_paths, windows, pred_len, stride=None):
    """[n, windows+pred, 2] training windows of SLBP records (decimated by
    the st100 convention, as ``pre_dataset_timeseries``)."""
    from ..utils.data_prep import unfold_windows

    L = windows + pred_len
    stride = stride or max(20, L // 8)
    wins = []
    for p in record_paths:
        ys = np.asarray(load_pt(p)["ys_dynamic"], np.float32)[::1000]  # st=100
        wins.append(unfold_windows(ys, L, stride))
    wins = np.concatenate(wins, axis=0)
    return wins.astype(np.float32)


def _train(flat, net_param, select, records_dir, epochs=3, seed=0,
           dataset_param=None, task_model="NsDiff", device=None):
    from ..train.loop import run_training

    perm = np.random.default_rng(seed).permutation(len(flat))
    batch = min(32, max(8, len(flat) // 4))
    n_train = max(batch, int(len(flat) * 0.9))
    run_training(
        flat[perm[:n_train]], flat[perm[n_train:]] if n_train < len(flat) else flat[perm[:4]],
        dict(train_model_select=select, train_batch_size=batch,
             val_batch_size=batch, train_epochs=epochs, test_set=True, ckpt=False),
        dict(net_param, task_model=task_model),
        {"loss_metric": "KL divergence"},
        dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5),
        records_dir, seed=seed, dataset_param=dataset_param, device=device,
    )
    return Path(records_dir) / "trained_model"


def _install(trained: Path, target_dir: Path, name: str = "model_trained"):
    target_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(trained / "model_trained", target_dir / name)
    shutil.copy(trained / "model_trained.yaml", target_dir / f"{name}.yaml")


def train_models(out: Path, device=None):
    from ..utils.data_prep import pre_dataset_spdata, unfold_windows

    ds, ews, scratch = out / "dataset", out / "ews_results", out / "train_scratch"
    main_rec = [slbp_source_path(ds, SLBP_MAIN_TOTAL, "increase", SLBP_MAIN_D)]
    dec_rec = [slbp_source_path(ds, SLBP_MAIN_TOTAL, "decrease", SLBP_MAIN_D)]

    def slbp_dataset_param(w, p):
        return dict(file_path=str(ds / "SLBP_model_data"), windows=w, pred_len=p,
                    sampling_t=100, interval_step=100, STG_exist=False)

    # --- SLBP sensitivity banks (full NsDiff, models/<name> layout) --------
    jobs = []  # (root, name, w, p, seed)
    jobs.append(("NsDiff_trends", "dataset__w200p200st100", 200, 200, 1))
    for p in SENS_LENS:
        jobs.append(("NsDiff_pred", f"dataset__w200p{p}st100", 200, p, 2 + p))
    for w in SENS_LENS:
        jobs.append(("NsDiff_windows", f"dataset__w{w}p200st100", w, 200, 3 + w))
    jobs.append(("NsDiff_machine/NsDiff", "dataset_w200p200st100", 200, 200, 7))
    for root, name, w, p, seed in jobs:
        target = ews / root / "models"
        if (target / name).exists():
            continue
        flat = _slbp_windows(main_rec, w, p)
        net = dict(SLBP_NET, windows=w, pred_len=p)
        trained = _train(flat, net, "NsDiff_model", scratch / root.replace("/", "_") / name,
                         seed=seed, dataset_param=slbp_dataset_param(w, p), device=device)
        _install(trained, target, name)
        log(f"trained {root}/models/{name} ({len(flat)} windows)")

    # --- preg (pretrain_g stage, g-submodule-only checkpoint) ---------------
    target = ews / "NsDiff_machine/preg/models"
    if not (target / "dataset_w200p200st100").exists():
        flat = _slbp_windows(main_rec, 200, 200)
        trained = _train(flat, dict(SLBP_NET, windows=200, pred_len=200),
                         "pretrain_g", scratch / "preg", seed=11,
                         dataset_param=slbp_dataset_param(200, 200), device=device)
        _install(trained, target, "dataset_w200p200st100")
        log("trained NsDiff_machine/preg")

    # --- ablation variants (fig7): wo_gx/wo_fx/wo_UANS ----------------------
    for folder, select in (("wo_gx", "cond_mean"), ("wo_fx", "cond_var"),
                           ("wo_UANS", "wo_UANS")):
        target = ews / "NsDiff_machine" / folder
        if (target / "model_trained").exists():
            continue
        flat = _slbp_windows(main_rec, 200, 200)
        trained = _train(flat, dict(SLBP_NET, windows=200, pred_len=200), select,
                         scratch / f"machine_{folder}", seed=13,
                         dataset_param=slbp_dataset_param(200, 200),
                         task_model="NsDiff_model_variants", device=device)
        _install(trained, target)
        log(f"trained NsDiff_machine/{folder} ({select})")

    # --- constant-dataset gx models (fig7 train-D / train-N panels) ---------
    for folder in CONTANT_SPECS:
        target = ews / "NsDiff_dataset_contant" / folder
        if (target / "model_trained").exists():
            continue
        rec = ds / "SLBP_model_data_contant" / folder / "SLBP_dynamic.pt"
        flat = _slbp_windows([rec], 200, 200, stride=30)
        trained = _train(flat, dict(SLBP_NET, windows=200, pred_len=200), "cond_var",
                         scratch / f"contant_{folder}", seed=17,
                         dataset_param=slbp_dataset_param(200, 200),
                         task_model="NsDiff_model_variants", device=device)
        _install(trained, target)
        log(f"trained NsDiff_dataset_contant/{folder}")

    # --- training-source models (fig8) --------------------------------------
    for folder, recs in (
        ("1000000.0_radio_0.5_decrease", dec_rec),
        ("1000000.0_radio_0.5_increase", main_rec),
        ("1000000.0_N__radio_0.5_all", main_rec + dec_rec),
    ):
        target = ews / "NsDiff_dataset" / folder
        if (target / "model_trained").exists():
            continue
        flat = _slbp_windows(recs, 200, 200)
        trained = _train(flat, dict(SLBP_NET, windows=200, pred_len=200), "cond_var",
                         scratch / f"dataset_{folder}", seed=19,
                         dataset_param=slbp_dataset_param(200, 200),
                         task_model="NsDiff_model_variants", device=device)
        _install(trained, target)
        log(f"trained NsDiff_dataset/{folder}")

    # --- generalization models (figs 2/3): one full NsDiff per dynamics -----
    for system, cfg in SYSTEMS.items():
        graph_target = ews / "ews_generalization/graph" / system
        dyn_target = ews / "ews_generalization/dynamic" / system
        if (graph_target / "model_trained").exists():
            continue
        dataset_param = dict(
            spdata_file_path=str(ds / f"spdata_sde_{system}"),
            graph_file_path=str(ds / "test_graph"),
            windows=100, pred_len=100, interval_step=2,
            sampling_t=cfg["sampling_t"], filter=graph_name("BA"),
        )
        x, _adjs, _gids = pre_dataset_spdata(**dataset_param)
        flat = x.reshape(-1, x.shape[2], x.shape[3])
        net = dict(
            SLBP_NET, dataset_nf=1, windows=100, pred_len=100, rolling_length=50,
        )
        trained = _train(flat, net, "NsDiff_model", scratch / f"gen_{system}",
                         seed=23, dataset_param=dataset_param, device=device)
        _install(trained, graph_target)
        _install(trained, dyn_target)
        log(f"trained ews_generalization {system} ({len(flat)} windows)")

    # --- empirical records + model for real_systems -------------------------
    from ..figures.mpv_collapse import locate_transition

    emp_src = slbp_source_path(ds, SLBP_MAIN_TOTAL, "increase", SLBP_MAIN_D)
    rec = load_pt(emp_src)
    ys = np.asarray(rec["ys_dynamic"], np.float32)
    ts = np.asarray(rec["ts_dynamic"], np.float32).ravel()
    for i, name in enumerate(_real_names()):
        path = ds / "real_data" / f"{name}.pt"
        if path.exists():
            continue
        tr = locate_transition(ts, ys[:, i % 2], "SLBP", "increase")
        t_end = float(tr["transition_time"]) + (0.05 + 0.03 * i) * (ts[-1] - ts[0])
        keep = ts <= t_end
        sub_y, sub_t = ys[keep][:: max(1, keep.sum() // (400 + 50 * i))], \
            ts[keep][:: max(1, keep.sum() // (400 + 50 * i))]
        save_pt({"name": name, "ys_dynamic": sub_y[:, i % 2 : i % 2 + 1],
                 "ts_dynamic": sub_t, "transition_time": float(tr["transition_time"]),
                 "data_type": "demo_slbp"}, path)
        log(f"empirical record {name} ({len(sub_t)} points)")
    model_dir = ews / "real_data/model/simulation"
    if not (model_dir / "model_trained").exists():
        from ..eval.ews_classic import detrend

        emp = load_pt(ds / "real_data" / f"{_real_names()[0]}.pt")
        series = detrend(np.asarray(emp["ys_dynamic"], np.float32)[:, 0],
                         method="Lowess", span=0.2).astype(np.float32)
        flat = unfold_windows(series[:, None], 200, 2)
        net = dict(SLBP_NET, dataset_nf=1, windows=100, pred_len=100)
        trained = _train(flat, net, "NsDiff_model", scratch / "real_model", seed=29,
                         dataset_param=dict(file_path=str(ds / "real_data"),
                                            windows=100, pred_len=100,
                                            sampling_t=0.1, interval_step=2),
                         device=device)
        _install(trained, model_dir)
        log("trained real_data/model/simulation")


def _real_names():
    return [f"slbp_empirical_demo_{i}" for i in range(4)]


# ===========================================================================
# stage: figures
# ===========================================================================

def run_figures(out: Path, only=None, device=None):
    """Every figure CLI on the demo tree (without matplotlib each runs its
    loaders and writes its tables, and skips the render)."""
    from ..figures import (
        fig2_graph_generalization, fig3_dynamics_transfer, fig4_model_sensitivity,
        fig5_tipping_types, fig6_slbp_model_analysis, fig7_train_analysis,
        fig8_train_source, fig9_smoothing, real_systems,
    )

    ds, ews, figs = str(out / "dataset"), str(out / "ews_results"), str(out / "figures")
    base = ["--ews-root", ews, "--source-root", ds, "--output-dir", figs]
    dev = [] if device is None else ["--device", str(device)]
    sens_lens = [str(x) for x in SENS_LENS]
    slbp = ["--total-time", SLBP_MAIN_TOTAL, "--d-value", SLBP_MAIN_D]
    runs = {
        "fig2": (fig2_graph_generalization, base + ["--trend", "increase"]),
        "fig3": (fig3_dynamics_transfer, base + ["--trend", "increase"]),
        "fig4": (fig4_model_sensitivity, base + ["--trend", "increase"] + slbp
                 + ["--pred-lens"] + sens_lens + ["--window-lens"] + sens_lens),
        "fig5": (fig5_tipping_types, base + ["--d-values"] + list(SLBP_D_VALUES)
                 + ["--time-rows"] + list(FIG5_TIME_ROWS)),
        "fig6": (fig6_slbp_model_analysis, base + slbp),
        "fig7": (fig7_train_analysis, base + ["--trend", "increase"] + slbp),
        "fig8": (fig8_train_source, base + slbp + ["--train-end", "200000.0"]),
        "fig9": (fig9_smoothing, base + ["--trend", "increase", "--total-time",
                 SLBP_MAIN_TOTAL, "--noises"] + list(SLBP_D_VALUES)),
        "real": (real_systems, [
            "--data-real-names", *_real_names(),
            "--output-dir", figs,
            "--data-root", f"{ds}/real_data",
            "--real-data-result-root", f"{ews}/real_data",
            "--bury-prob-root", f"{ews}/bury_2021_ml_probs",
            "--model-dir", f"{ews}/real_data/model/simulation",
            "--signals", "model_uncertainty", "model_trend", "ar1", "variance",
        ]),
    }
    for name, (mod, argv) in runs.items():
        if only and name not in only:
            continue
        log(f"figure {name} ...")
        mod.main(argv + dev)
        log(f"figure {name} done")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--stage", choices=["data", "models", "figures", "all"],
                    default="all")
    ap.add_argument("--only", nargs="+", default=None,
                    help="restrict --stage figures to these figure keys")
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    out = args.out_dir
    if args.stage in ("data", "all"):
        gen_data(out, args.device)
    if args.stage in ("models", "all"):
        train_models(out, args.device)
    if args.stage in ("figures", "all"):
        run_figures(out, only=args.only, device=args.device)
    log("done")


if __name__ == "__main__":
    main()
