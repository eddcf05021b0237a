"""Reference-scale experiment zoo and corpus MPV-collapse statistics, on the
port (counterpart of ``examples/reference_zoo.py``).

Trains the generalization and ablation trees at the reference model scale
(every NsDiff d512 e4/d2, the dims of the shipped ``model_trained.yaml``
configs) on regenerated corpora at reference node counts (the tracked
120-graph library, 30-100 nodes), runs the MPV-collapse statistics over the
corpus and renders the paper figures from the new zoo. Each dynamics uses 60
graphs (3 topology types x 4 node counts x 5 seeds) x 2 trends x 1 physics
combination: 360 corpus trajectories.

Stages (idempotent: each skips the work whose outputs exist):

    python -m upgdm_tpu_torch.examples.reference_zoo --stage data
    python -m upgdm_tpu_torch.examples.reference_zoo --stage models
    python -m upgdm_tpu_torch.examples.reference_zoo --stage compare
    python -m upgdm_tpu_torch.examples.reference_zoo --stage real
    python -m upgdm_tpu_torch.examples.reference_zoo --stage sweep   # = stats
    python -m upgdm_tpu_torch.examples.reference_zoo --stage figures
    python -m upgdm_tpu_torch.examples.reference_zoo --stage fig1
    python -m upgdm_tpu_torch.examples.reference_zoo --stage slbpfigs

``--stage fig1`` regenerates only the paper-Fig-1 chain (the
``TRAINED_ON_TOPOLOGY`` corpus, the three generalization NsDiffs and the nine
model_compare family models, then the fig1 render); ``--stage slbpfigs`` the
figs-5/6/9 chain. Every stage runs on ``--device`` (default the card; ``cpu``
for the CPU), the renders and the corpus statistics as subprocesses of the
port's figure CLIs with the same ``--device``. ``--out-dir`` defaults to
``demo_zoo_torch/`` beside the package (the JAX package's ``demo_zoo/`` is
never written). ``--tiny`` is the plumbing run of the JAX driver (3 graphs,
tiny nets, 1 epoch).

The SDE noise of the port is Philox (the K4 kernel), not ``jax.random``: a
regenerated corpus equals the JAX package's in distribution; the graph files,
``stable_seed``, the window layouts and the file tree are equal exactly.
``summarize`` reduces the samples CSV without pandas (``frame.py``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

from ..figures.common import dynamics_filename, slbp_source_path
from ..utils.io import load_pt, save_pt
from . import frame

REPO = Path(__file__).resolve().parents[2]
T0 = time.time()
GRAPH_LIB = REPO / "dataset" / "train_dataset_graph"
DEFAULT_OUT = REPO / "demo_zoo_torch"

# 60 graphs per dynamics: the 3 reference topology types x the 4 library node
# counts x 5 seeds (half the tracked 120-graph library)
CORPUS_GRAPHS = [
    f"{gtype}_{n}_{seed}"
    for gtype in ("barabasi_albert", "erdos_renyi", "small-world")
    for n in (30, 50, 70, 100)
    for seed in range(5)
]
TRENDS = ("increase", "decrease")

# physics per dynamics; dt/save_every keep the stored grid at 0.1 (SIS
# integrates at dt 0.01: Euler is marginal at 0.1 on 100-node BA hubs)
SYSTEMS = {
    "biomass": dict(control_range=(0.0, 4.0),
                    base_params={"r": 0.7, "k": 10.0, "d": 0.05}, eta=0.005,
                    total_time=3000.0, burn_time=100.0, sampling_t=10,
                    dt=0.1, save_every=1),
    # mu 1.5 (the reference generator's): at 3.0 no transition exists;
    # total_time 10000 as the reference: the w100+p100 window spans 2000 units
    "neuronal": dict(control_range=(0.0, 1.0),
                     base_params={"tau": 2.0, "mu": 1.5}, eta=0.01,
                     total_time=10000.0, burn_time=100.0, sampling_t=10,
                     dt=0.1, save_every=1),
    "SIS": dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4,
                total_time=40.0, burn_time=20.0, sampling_t=0.1,
                dt=0.01, save_every=10),
}
TRAINED_ON_TOPOLOGY = "barabasi_albert"  # graph-generalization trained-on type

# reference net dims (ews_generalization/*/model_trained.yaml)
REF_NET = dict(
    rolling_length=50, diffusion_steps=20, diffusion_schedule="linear",
    beta_start=1e-4, beta_end=2e-2, scaler_type="StandardScaler",
    d_model=512, n_heads=8, e_layers=4, d_layers=2, d_ff=256, dropout=0.05,
    p_hidden_dims=[64, 64], p_hidden_layers=2, n_z_samples=100,
    parallel_sample=10, load_pretrain=False, freeze_pretrain=False,
    output_attention=False, factor=3, activation="gelu",
)

SLBP_TOTAL = "400000.0"
SLBP_D = "1e-05"
# figs 5/9 SLBP grid at zoo scale (two totals anchored at 400k)
FIG5_TIME_ROWS = (("400000.0", "t4e5", 10), ("800000.0", "t8e5", 20))
FIG59_D_VALUES = ("1e-05", "5e-06")
CONTANT_SPECS = {
    "D_0.001": (0.001, 1.0),
    "D_0.0001": (0.0001, 1.0),
    "D_1e-05": (1e-05, 1.0),
    "D_0.001_N_0.5": (0.001, 0.5),
    "D_0.001_N_2.5": (0.001, 2.5),
    "D_0.001_N_5": (0.001, 5.0),
}


def log(msg):
    print(f"[{time.time()-T0:6.0f}s] {msg}", flush=True)


def stable_seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) % 100_000


# ===========================================================================
# stage: data
# ===========================================================================

def gen_data(out: Path, fig1_only: bool = False, device=None):
    """The corpus (3 dynamics x ``CORPUS_GRAPHS`` x 2 trends), the graphml
    copies under ``dataset/test_graph`` and the SLBP records of the SLBP
    trees, integrated on ``device``. ``fig1_only`` restricts the corpus to the
    ``TRAINED_ON_TOPOLOGY`` graphs and skips the SLBP records."""
    from ..data.sde import simulate_network_system, simulate_slbp
    from ..ops.graph import graphml_to_adjacency

    ds = out / "dataset"
    corpus_graphs = ([g for g in CORPUS_GRAPHS if g.startswith(TRAINED_ON_TOPOLOGY)]
                     if fig1_only else CORPUS_GRAPHS)
    for system, cfg in SYSTEMS.items():
        for gname in corpus_graphs:
            gpath = GRAPH_LIB / f"{gname}.graphml"
            adj = None
            for trend in TRENDS:
                path = ds / f"spdata_sde_{system}" / gname / dynamics_filename(system, trend)
                if path.exists():
                    continue
                if adj is None:
                    adj = graphml_to_adjacency(gpath).adj
                rec = simulate_network_system(
                    system, adj, trend=trend, total_time=cfg["total_time"],
                    burn_time=cfg["burn_time"], dt=cfg["dt"],
                    save_every=cfg["save_every"],
                    seed=stable_seed(system, gname, trend),
                    control_range=cfg["control_range"],
                    base_params=cfg["base_params"], eta=cfg["eta"], device=device,
                )
                save_pt(rec, path)
                log(f"{system} {gname} {trend}: {rec['ys_dynamic'].shape}")
    # graphml copies next to the corpus (figure scripts resolve test_graph/)
    tg = ds / "test_graph"
    tg.mkdir(parents=True, exist_ok=True)
    for gname in CORPUS_GRAPHS:
        dst = tg / f"{gname}.graphml"
        if not dst.exists():
            shutil.copy(GRAPH_LIB / f"{gname}.graphml", dst)
    if fig1_only:
        return

    # SLBP records for the machine/window/dataset trees
    for trend in TRENDS:
        path = slbp_source_path(ds, SLBP_TOTAL, trend, SLBP_D)
        if not path.exists():
            rec = simulate_slbp(
                params={"D": float(SLBP_D)}, trend=trend,
                total_time=float(SLBP_TOTAL), burn_time=1000.0, dt=0.1,
                seed=stable_seed(SLBP_TOTAL, trend, SLBP_D), device=device,
            )
            save_pt(rec, path)
            log(f"SLBP {trend}: {rec['ys_dynamic'].shape}")
    # figs 5/9 SLBP grid (the (SLBP_TOTAL, SLBP_D) cell is the record above)
    for total, _folder, _step in FIG5_TIME_ROWS:
        for d in FIG59_D_VALUES:
            for trend in TRENDS:
                path = slbp_source_path(ds, total, trend, d)
                if path.exists():
                    continue
                rec = simulate_slbp(
                    params={"D": float(d)}, trend=trend,
                    total_time=float(total), burn_time=1000.0, dt=0.1,
                    seed=stable_seed(total, trend, d), device=device,
                )
                save_pt(rec, path)
                log(f"SLBP T{total} D{d} {trend}: {rec['ys_dynamic'].shape}")
    for folder, (d, n) in CONTANT_SPECS.items():
        path = ds / "SLBP_model_data_contant" / folder / "SLBP_dynamic.pt"
        if not path.exists():
            # high constant N needs a finer Euler step (dt 0.1 diverges at
            # N 5); the stored grid stays at 0.1
            dt, save_every = (0.01, 10) if n > 2.0 else (0.1, 1)
            rec = simulate_slbp(
                params={"D": d}, total_time=100000.0, burn_time=1000.0, dt=dt,
                save_every=save_every, seed=stable_seed(folder), constant_n=n,
                device=device,
            )
            ys = np.asarray(rec["ys_dynamic"])
            if not np.isfinite(ys).all():
                raise ValueError(f"SLBP contant {folder} diverged (dt={dt})")
            save_pt(rec, path)
            log(f"SLBP contant {folder}: {rec['ys_dynamic'].shape}")


# ===========================================================================
# stage: models
# ===========================================================================

def _corpus_windows(out: Path, system: str, windows: int, pred_len: int,
                    topology: str, max_windows: int = 6000,
                    stride: int = None):
    """Per-node univariate [n, W+P, 1] training windows of the corpus records
    whose graph name starts with ``topology`` ("" matches every graph);
    near-constant windows dropped, at most ``max_windows`` kept (a seeded
    choice)."""
    from ..utils.data_prep import unfold_windows

    ds = out / "dataset"
    L = windows + pred_len
    wins = []
    for gname in CORPUS_GRAPHS:
        if not gname.startswith(topology):
            continue
        for trend in TRENDS:
            p = ds / f"spdata_sde_{system}" / gname / dynamics_filename(system, trend)
            if not p.exists():
                continue
            ys = np.asarray(load_pt(p)["ys_dynamic"], np.float32)  # [T, node]
            cfg = SYSTEMS[system]
            step = max(1, int(round(cfg["sampling_t"] / 0.1)))
            ys = ys[::step]
            if ys.shape[0] < L:
                continue
            w = unfold_windows(ys, L, stride or max(10, L // 10))
            w = np.moveaxis(w, 2, 1).reshape(-1, L, 1)
            wins.append(w)
    flat = np.concatenate(wins, axis=0).astype(np.float32)
    # a zero-variance window NaNs the NS-Transformer's per-window normalization
    keep = flat.std(axis=(1, 2)) > 1e-6
    flat = flat[keep]
    if len(flat) > max_windows:
        sel = np.random.default_rng(0).choice(len(flat), max_windows, replace=False)
        flat = flat[sel]
    return flat


def _slbp_windows(record_paths, windows, pred_len, stride=None):
    """[n, W+P, 2] windows of SLBP records decimated by 1000 (st100);
    near-constant windows dropped, non-finite ones an error."""
    from ..utils.data_prep import unfold_windows

    L = windows + pred_len
    stride = stride or max(20, L // 8)
    wins = []
    for p in record_paths:
        ys = np.asarray(load_pt(p)["ys_dynamic"], np.float32)[::1000]  # st=100
        wins.append(unfold_windows(ys, L, stride))
    flat = np.concatenate(wins, axis=0).astype(np.float32)
    std = flat.std(axis=(1, 2))
    if not np.isfinite(flat).all():
        raise ValueError(
            f"non-finite training windows from {record_paths} — regenerate the "
            "record with a finer integrator (dt)")
    keep = std > 1e-6
    if not keep.any():
        raise ValueError(f"all windows near-constant in {record_paths}")
    return flat[keep]


def _train(flat, net_param, select, records_dir, epochs, seed=0,
           dataset_param=None, task_model="NsDiff", batch=256,
           loss_metric="KL divergence", lr=1e-3, scheduler_set=True, device=None):
    from ..train.loop import run_training

    perm = np.random.default_rng(seed).permutation(len(flat))
    batch = min(batch, max(8, len(flat) // 4))
    n_train = max(batch, int(len(flat) * 0.9))
    run_training(
        flat[perm[:n_train]],
        flat[perm[n_train:]] if n_train < len(flat) else flat[perm[:4]],
        dict(train_model_select=select, train_batch_size=batch,
             val_batch_size=batch, train_epochs=epochs, test_set=True, ckpt=False),
        dict(net_param, task_model=task_model),
        {"loss_metric": loss_metric},
        # the reference optimizer block: Adam + MultiStepLR(milestones=[10], 0.1)
        dict(optimizer_name="Adam", lr=lr, weight_decay=1e-5,
             scheduler="MultiStepLR", scheduler_set=scheduler_set,
             MstepLR_milestones=[10], MstepLR_gamma=0.1),
        records_dir, seed=seed, dataset_param=dataset_param, device=device,
    )
    return Path(records_dir) / "trained_model"


def _install(trained: Path, target_dir: Path, name: str = "model_trained"):
    target_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(trained / "model_trained", target_dir / name)
    shutil.copy(trained / "model_trained.yaml", target_dir / f"{name}.yaml")


def train_models(out: Path, epochs: int, generalization_only: bool = False,
                 fig569_only: bool = False, device=None):
    """The generalization/corpus NsDiffs (one a dynamics) and the SLBP trees
    (banks, ablations, train-source, constant nulls) at the reference dims."""
    ews = out / "ews_results"
    scratch = out / "_scratch"
    ds = out / "dataset"
    main_rec = [slbp_source_path(ds, SLBP_TOTAL, t, SLBP_D) for t in TRENDS]

    # --- generalization + corpus-statistics models: one per dynamics --------
    for system, cfg in () if fig569_only else SYSTEMS.items():
        graph_t = ews / "ews_generalization/graph" / system
        dyn_t = ews / "ews_generalization/dynamic" / system
        stats_t = ews / "model_compare/NsDiff" / system
        # resume only when all three install targets exist
        if all((t / "model_trained").exists() for t in (graph_t, dyn_t, stats_t)):
            continue
        flat = _corpus_windows(out, system, 100, 100, TRAINED_ON_TOPOLOGY)
        dataset_param = dict(
            spdata_file_path=str(ds / f"spdata_sde_{system}"),
            graph_file_path=str(ds / "test_graph"),
            windows=100, pred_len=100, interval_step=100,
            sampling_t=cfg["sampling_t"], filter=f"{TRAINED_ON_TOPOLOGY}_*",
        )
        net = dict(REF_NET, dataset_nf=1, windows=100, pred_len=100)
        trained = _train(flat, net, "NsDiff_model", scratch / f"gen_{system}",
                         epochs, seed=23, dataset_param=dataset_param, device=device)
        for tgt in (graph_t, dyn_t, stats_t):
            _install(trained, tgt)
        log(f"trained generalization/{system} at d512 ({len(flat)} windows)")

    if generalization_only:
        return

    # --- SLBP trees: more epochs than the corpus models (a few hundred windows)
    slbp_epochs = max(epochs, 40)
    slbp_net = dict(REF_NET, dataset_nf=2, windows=200, pred_len=200)

    def slbp_dsp(w, p, file_path=None):
        return dict(file_path=str(file_path or (ds / "SLBP_model_data")),
                    windows=w, pred_len=p, sampling_t=100, interval_step=100,
                    STG_exist=False)

    bank_jobs = [("NsDiff_machine/NsDiff", "dataset_w200p200st100", 200, 200,
                  "NsDiff_model"),
                 ("NsDiff_machine/preg", "dataset_w200p200st100", 200, 200,
                  "pretrain_g"),
                 ("NsDiff_trends", "dataset__w200p200st100", 200, 200,
                  "NsDiff_model")]
    for w in (200, 500, 1000):
        bank_jobs.append(("NsDiff_windows", f"dataset__w{w}p200st100", w, 200,
                          "NsDiff_model"))
    for p in (500, 1000):
        bank_jobs.append(("NsDiff_pred", f"dataset__w200p{p}st100", 200, p,
                          "NsDiff_model"))
    if fig569_only:
        bank_jobs = [j for j in bank_jobs
                     if j[0] in ("NsDiff_machine/NsDiff", "NsDiff_machine/preg",
                                 "NsDiff_trends")]
    for root, name, w, p, select in bank_jobs:
        target = ews / root / "models"
        if (target / name).exists():
            continue
        flat = _slbp_windows(main_rec, w, p)
        net = dict(REF_NET, dataset_nf=2, windows=w, pred_len=p)
        trained = _train(flat, net, select,
                         scratch / root.replace("/", "_") / name, slbp_epochs,
                         seed=stable_seed(root, name),
                         dataset_param=slbp_dsp(w, p), batch=64, device=device)
        _install(trained, target, name)
        log(f"trained {root}/models/{name} at d512 ({len(flat)} windows)")

    if fig569_only:
        return

    # NsDiff_pred shares its w200p200 anchor with the window sweep
    pred_anchor = ews / "NsDiff_pred" / "models" / "dataset__w200p200st100"
    win_anchor = ews / "NsDiff_windows" / "models" / "dataset__w200p200st100"
    if win_anchor.exists() and not pred_anchor.exists():
        pred_anchor.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(win_anchor, pred_anchor)
        shutil.copy(win_anchor.with_suffix(".yaml"), pred_anchor.with_suffix(".yaml"))
        log("aliased NsDiff_windows w200p200 into NsDiff_pred")

    # ablation variants (wo_gx/wo_fx/wo_UANS: fig7's machine panels)
    for folder, select in (("wo_gx", "cond_mean"), ("wo_fx", "cond_var"),
                           ("wo_UANS", "wo_UANS")):
        target = ews / "NsDiff_machine" / folder
        if (target / "model_trained").exists():
            continue
        flat = _slbp_windows(main_rec, 200, 200)
        trained = _train(flat, slbp_net, select, scratch / f"machine_{folder}",
                         slbp_epochs, seed=stable_seed("machine", folder),
                         dataset_param=slbp_dsp(200, 200),
                         task_model="NsDiff_model_variants", batch=64, device=device)
        _install(trained, target)
        log(f"trained NsDiff_machine/{folder} ({select}) at d512")

    # train-source panels (fig8): per-trend + combined cond_var models
    src_jobs = [("1000000.0_radio_0.5_increase", main_rec[:1]),
                ("1000000.0_radio_0.5_decrease", main_rec[1:]),
                ("1000000.0_N__radio_0.5_all", main_rec)]
    for folder, recs in src_jobs:
        target = ews / "NsDiff_dataset" / folder
        if (target / "model_trained").exists():
            continue
        flat = _slbp_windows(recs, 200, 200, stride=25)
        trained = _train(flat, slbp_net, "cond_var", scratch / f"dataset_{folder}",
                         slbp_epochs, seed=stable_seed("dataset", folder),
                         dataset_param=slbp_dsp(200, 200),
                         task_model="NsDiff_model_variants", batch=64, device=device)
        _install(trained, target)
        log(f"trained NsDiff_dataset/{folder} at d512 ({len(flat)} windows)")

    # constant-parameter nulls (gx models, NsDiff_dataset_contant)
    for folder in CONTANT_SPECS:
        target = ews / "NsDiff_dataset_contant" / folder
        if (target / "model_trained").exists():
            continue
        rec = ds / "SLBP_model_data_contant" / folder / "SLBP_dynamic.pt"
        flat = _slbp_windows([rec], 200, 200, stride=30)
        trained = _train(flat, slbp_net, "cond_var", scratch / f"contant_{folder}",
                         slbp_epochs, seed=stable_seed("contant", folder),
                         dataset_param=slbp_dsp(
                             200, 200, ds / "SLBP_model_data_contant" / folder),
                         task_model="NsDiff_model_variants", batch=64, device=device)
        _install(trained, target)
        log(f"trained NsDiff_dataset_contant/{folder} at d512 ({len(flat)} windows)")


# ===========================================================================
# stage: compare — the 4-family model_compare tree behind paper Fig. 1
# ===========================================================================

# the reference net dims of the shipped model_compare yamls; NsDiff's entry is
# trained by the models stage
COMPARE_NETS = {
    "TMDM": dict(
        task_model="TMDM", dataset_nf=1, windows=100, pred_len=100,
        scaler_type="StandardScaler", d_model=64, n_heads=4, e_layers=2,
        d_layers=1, d_ff=128, dropout=0.05, activation="gelu", factor=3,
        output_attention=False, p_hidden_dims=[64, 64], p_hidden_layers=2,
        diffusion_steps=20, beta_schedule="linear", beta_start=1e-4,
        beta_end=2e-2, k_z=0.01, k_cond=1.0, d_z=64,
        CART_input_x_embed_dim=64, n_z_samples=100, parallel_sample=10,
        load_pretrain=False, freeze_pretrain=False),
    "DiffusionTS": dict(
        task_model="DiffusionTS", dataset_nf=1, windows=100, pred_len=100,
        scaler_type="StandardScaler", d_model=64, n_heads=4, n_layer_enc=3,
        n_layer_dec=6, mlp_hidden_times=4, timesteps=100, diffusion_steps=100,
        beta_schedule="cosine", loss_type="l2", eta=0.0, attn_pd=0.0,
        resid_pd=0.0, use_ff=True, infill_coef=0.1, infill_learning_rate=0.05,
        n_z_samples=100, parallel_sample=10),
    "DiffSTG": dict(
        task_model="DiffSTG", dataset_nf=1, windows=100, pred_len=100,
        F=1, T_h=100, T_p=100, scaler_type="StandardScaler", d_h=4, Td_h=10,
        channel_multipliers=[2, 2], n_blocks=2, diffusion_schedule="linear",
        diffusion_steps=200, inference_diffusion_steps=20,
        inference_schedule="cosine", inference_trick="ddim",
        loss_weight_schedule="constant", mask_ratio=0.0,
        parallel_sampling=10, sequential_sampling=10,
        gnn_name="ResGatedGraphConv", gnn_param=dict(bias=True, root_weight=True)),
}
# the reference train blocks: epochs / loss / lr per family
COMPARE_TRAIN = {
    "TMDM": dict(epochs=50, loss="TMDM loss", lr=1e-4, max_windows=4000,
                 batch=512),
    "DiffusionTS": dict(epochs=100, loss="DiffusionTS loss", lr=1e-3,
                        max_windows=1024, batch=256),
    "DiffSTG": dict(epochs=20, loss="KL divergence", lr=1e-4, batch=16),
}


def _train_spatial(x, adjs, gids, net_param, records_dir, epochs, seed=0,
                   dataset_param=None, batch=16, lr=1e-4, device=None):
    """DiffSTG on dense mixed-topology batches (hold-out split)."""
    from ..train.loop import run_training

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    batch = min(batch, max(4, len(x) // 4))
    n_train = max(batch, int(len(x) * 0.8))
    tr = perm[:n_train]
    va = perm[n_train:] if n_train < len(x) else perm[:4]
    run_training(
        x[tr], x[va],
        dict(train_model_select=None, train_batch_size=batch,
             val_batch_size=batch, train_epochs=epochs, test_set=True,
             ckpt=False),
        net_param,
        {"loss_metric": "KL divergence"},
        dict(optimizer_name="Adam", lr=lr, weight_decay=1e-5,
             scheduler="MultiStepLR", scheduler_set=False,
             MstepLR_milestones=[50], MstepLR_gamma=0.1),
        records_dir, adj=(adjs, gids[tr], gids[va]), seed=seed,
        dataset_param=dataset_param, device=device,
    )
    return Path(records_dir) / "trained_model"


def train_compare_models(out: Path, device=None):
    """DiffSTG / DiffusionTS / TMDM per dynamics at the reference
    model_compare dims, installed beside the models stage's NsDiff."""
    from ..utils.data_prep import pre_dataset_spdata

    ews = out / "ews_results"
    scratch = out / "_scratch"
    ds = out / "dataset"
    for system, cfg in SYSTEMS.items():
        # flat families: per-node univariate windows over every topology
        for fam in ("TMDM", "DiffusionTS"):
            target = ews / "model_compare" / fam / system
            if (target / "model_trained").exists():
                continue
            tp = COMPARE_TRAIN[fam]
            flat = _corpus_windows(out, system, 100, 100, topology="",
                                   max_windows=tp["max_windows"], stride=100)
            dataset_param = dict(
                file_path=str(ds / f"spdata_sde_{system}"), filter="*",
                windows=100, pred_len=100, interval_step=100,
                sampling_t=cfg["sampling_t"], STG_exist=True)
            trained = _train(
                flat, COMPARE_NETS[fam], None,
                scratch / f"compare_{fam}_{system}", tp["epochs"],
                seed=stable_seed("compare", fam, system),
                dataset_param=dataset_param, task_model=fam,
                batch=tp["batch"], loss_metric=tp["loss"], lr=tp["lr"],
                scheduler_set=False, device=device)
            _install(trained, target)
            log(f"trained model_compare/{fam}/{system} ({len(flat)} windows)")

        # DiffSTG: dense spatial windows + per-graph adjacency
        target = ews / "model_compare" / "DiffSTG" / system
        if not (target / "model_trained").exists():
            tp = COMPARE_TRAIN["DiffSTG"]
            x, adjs, gids = pre_dataset_spdata(
                spdata_file_path=str(ds / f"spdata_sde_{system}"),
                graph_file_path=str(GRAPH_LIB),
                windows=100, pred_len=100, interval_step=50,
                sampling_t=cfg["sampling_t"])
            dataset_param = dict(
                spdata_file_path=str(ds / f"spdata_sde_{system}"),
                graph_file_path=str(GRAPH_LIB), filter="*",
                windows=100, pred_len=100, interval_step=50,
                sampling_t=cfg["sampling_t"])
            trained = _train_spatial(
                x, np.asarray(adjs, np.float32), np.asarray(gids),
                COMPARE_NETS["DiffSTG"],
                scratch / f"compare_DiffSTG_{system}", tp["epochs"],
                seed=stable_seed("compare", "DiffSTG", system),
                dataset_param=dataset_param, batch=tp["batch"], lr=tp["lr"],
                device=device)
            _install(trained, target)
            log(f"trained model_compare/DiffSTG/{system} ({len(x)} windows)")


# ===========================================================================
# stage: sweep + stats (corpus MPV-collapse statistics)
# ===========================================================================

def _device_args(device) -> list:
    return [] if device is None else ["--device", str(device)]


def run_stats(out: Path, plot_checks: bool = False, attempts: int = 8,
              stall_timeout: int = 20 * 60, device=None):
    """``mpv_collapse`` over the corpus (the gx-MPV of the per-dynamics d512
    models over every corpus trajectory), as an unbuffered subprocess under
    the log-growth stall watchdog; the per-trajectory caches make a relaunch
    resume. Fails after ``attempts`` failed runs."""
    argv = [
        "--ews-root", str(out / "ews_results"),
        "--source-root", str(out / "dataset"),
        "--output-dir", str(out / "mpv_collapse"),
        "--model-name", "NsDiff",
        "--dynamics", *SYSTEMS.keys(),
        "--trends", *TRENDS,
        "--plot-summary-relations",
        *_device_args(device),
    ]
    if plot_checks:
        argv.append("--plot-checks")
    cmd = [sys.executable, "-u", "-m", "upgdm_tpu_torch.figures.mpv_collapse", *argv]
    (out / "mpv_collapse").mkdir(parents=True, exist_ok=True)
    logf = out / "mpv_collapse" / "corpus_sweep.log"
    for attempt in range(attempts):
        log("corpus sweep" + (f" (retry {attempt})" if attempt else "")
            + f" -> {logf}")
        code = _run_until_stalled(cmd, logf, stall_timeout)
        if code == 0:
            log("corpus sweep done")
            return
        log(f"CORPUS SWEEP FAILED (exit {code}; tail of {logf}):")
        log(logf.read_text()[-2000:])
    raise RuntimeError(f"corpus sweep failed after {attempts} attempts")


def _stats(cols: dict, rows) -> dict:
    pick = lambda name: [cols[name][i] for i in rows]
    lead = frame.to_numeric(pick("lead_time"))
    drop = frame.to_numeric(pick("pre_transition_drop_percent"))
    gdrop = frame.to_numeric(pick("global_drop_percent"))
    return {
        "n": int(len(rows)),
        "lead_time_positive_frac": frame.positive_frac(lead) if len(lead) else None,
        "lead_time_median": frame.median(lead) if len(lead) else None,
        "pre_transition_drop_percent_median": frame.median(drop) if len(drop) else None,
        "global_drop_percent_median": frame.median(gdrop) if len(gdrop) else None,
    }


def summarize(out: Path):
    """Lead-time sign distribution and collapse-depth statistics of the
    corpus samples CSV, overall, per dynamics and per dynamics/trend with the
    skipped files counted by reason: ``corpus_summary.json``, as the JAX
    package's pandas reduction writes it."""
    cols = frame.read_csv(out / "mpv_collapse" / "mpv_collapse_samples.csv")
    n_rows = len(next(iter(cols.values())))
    flag = cols["is_transition"]
    done = [i for i in range(n_rows) if frame.is_true(flag[i])]
    res = {
        "n_files": int(n_rows),
        "n_transition": int(len(done)),
        "by_dynamic": {},
    }
    for dyn, g in frame.group_rows(cols, "dynamic_type", done).items():
        res["by_dynamic"][dyn] = _stats(cols, g)
    # per trend, with the skipped files of each cell counted by reason
    res["by_dynamic_trend"] = {}
    for (dyn, trend), g_all in frame.group_rows(cols, ["dynamic_type", "trend"]).items():
        cell = _stats(cols, [i for i in g_all if frame.is_true(flag[i])])
        cell["n_files"] = int(len(g_all))
        skips = frame.value_counts(frame.as_str(cols["skip_reason"][i])
                                   for i in g_all if not frame.is_true(flag[i]))
        cell["n_skipped_by_reason"] = {k or "(unspecified)": int(v)
                                       for k, v in skips.items()}
        res["by_dynamic_trend"][f"{dyn}/{trend}"] = cell
    lead_all = frame.to_numeric([cols["lead_time"][i] for i in done])
    res["lead_time_positive_frac_overall"] = (
        frame.positive_frac(lead_all) if len(lead_all) else None
    )
    path = out / "mpv_collapse" / "corpus_summary.json"
    path.write_text(json.dumps(res, indent=2))
    log(json.dumps(res, indent=2))
    return res


# ===========================================================================
# stage: real (Bury-sim training corpus -> simulation model -> Bury
# probabilities -> the real-systems composite)
# ===========================================================================

REAL_DATA_NAMES = tuple(f"bury_2021_anoxia_tsid_{i}" for i in (3, 6, 9))
N_BURY_SERIES = 96        # training-sim corpus size (Bury protocol, ts_500)
BURY_MAX_MODELS = None    # cap of the 20-classifier ensemble (tests, tiny runs)


def gen_real_data(out: Path):
    """The Bury-protocol training corpus and the empirical stand-ins: sparse
    univariate series cut from the zoo's SLBP trajectory, ending shortly after
    a located transition, the transition time stamped (host work)."""
    from ..data.bury_sim import generate_bury_training_corpus
    from ..figures.mpv_collapse import locate_transition

    ds = out / "dataset"
    n = len(generate_bury_training_corpus(
        ds / "bury_2021_training_data2", n_series=N_BURY_SERIES,
        seed=stable_seed("bury")))
    log(f"bury training corpus: {n} series")

    src = slbp_source_path(ds, SLBP_TOTAL, "increase", SLBP_D)
    rec = load_pt(src)
    ys = np.asarray(rec["ys_dynamic"], np.float32)
    ts = np.asarray(rec["ts_dynamic"], np.float32).ravel()
    for i, name in enumerate(REAL_DATA_NAMES):
        path = ds / "real_data" / f"{name}.pt"
        if path.exists():
            continue
        dim = i % ys.shape[1]
        tr = locate_transition(ts, ys[:, dim], "SLBP", "increase")
        t_end = float(tr["transition_time"]) + (0.05 + 0.03 * i) * (ts[-1] - ts[0])
        keep = ts <= t_end
        stride = max(1, int(keep.sum()) // (500 + 100 * i))
        sub_y, sub_t = ys[keep][::stride], ts[keep][::stride]
        save_pt({"name": name, "ys_dynamic": sub_y[:, dim:dim + 1],
                 "ts_dynamic": sub_t,
                 "transition_time": float(tr["transition_time"]),
                 "data_type": "slbp_standin"}, path)
        log(f"empirical stand-in {name} ({len(sub_t)} points)")


def train_real_model(out: Path, epochs: int, device=None):
    """NsDiff at the reference real-data dims (d512 w200 p200, interval 10,
    no scaler: the Bury residual series arrive standardized)."""
    target = out / "ews_results/real_data/model/simulation"
    if (target / "model_trained").exists():
        return
    from ..utils.data_prep import pre_dataset_timeseries_real

    ds = out / "dataset"
    dataset_param = dict(
        file_path=str(ds / "bury_2021_training_data2"), filter="ts_500",
        windows=200, pred_len=200, interval_step=10, sampling_t=0.1,
        STG_exist=False)
    flat = pre_dataset_timeseries_real(**dataset_param)
    net = dict(REF_NET, dataset_nf=1, windows=200, pred_len=200,
               scaler_type=None)
    trained = _train(flat, net, "NsDiff_model", out / "_scratch/real_sim",
                     epochs, seed=stable_seed("real_sim"),
                     dataset_param=dataset_param, device=device)
    _install(trained, target)
    log(f"trained real_data/model/simulation ({len(flat)} windows)")


def run_real_chain(out: Path, device=None):
    """The Bury-2021 classifier probabilities and the real-systems
    composite."""
    from ..eval import bury
    from ..figures import real_systems

    ds, ews, figs = out / "dataset", out / "ews_results", out / "figures"
    probs_root = ews / "bury_2021_ml_probs"
    missing = [n for n in REAL_DATA_NAMES
               if not list(probs_root.rglob(f"{n}_bury_ml_probs.csv"))]
    if missing:
        argv = [
            "--data-root", str(ds / "real_data"),
            "--output-root", str(probs_root),
            "--data-real-names", *missing,
            "--classifier-len", "500",
            *_device_args(device),
        ]
        if BURY_MAX_MODELS:
            argv += ["--max-models", str(BURY_MAX_MODELS)]
        bury.main(argv)
        log(f"bury probabilities: {missing}")
    real_systems.main([
        "--data-real-names", *REAL_DATA_NAMES,
        "--output-dir", str(figs),
        "--data-root", str(ds / "real_data"),
        "--real-data-result-root", str(ews / "real_data"),
        "--bury-prob-root", str(probs_root),
        "--model-dir", str(ews / "real_data/model/simulation"),
        "--signals", "model_uncertainty", "model_trend", "ar1", "variance",
        "sample-entropy-1", "bury_ml",
        *_device_args(device),
    ])
    log("real-systems composite rendered")


# ===========================================================================
# stage: figures
# ===========================================================================

def figure_jobs(out: Path) -> list:
    """(module, extra-args) figure renders for the trees present under
    ``out``: fig1/fig4 only once their model trees exist, figs 5/6/9 once
    their SLBP trees and grid corpora do, fig1 last (its DiffusionTS/TMDM
    arms sweep n_z 100 ensembles and dwarf every other figure)."""
    slbp = ["--total-time", SLBP_TOTAL, "--d-value", SLBP_D]
    train_end = str(float(SLBP_TOTAL) / 2)
    jobs = []
    # two-trend renders (the reference figure CLIs' --trend contract)
    for trend in TRENDS:
        if (out / "ews_results/NsDiff_pred/models/dataset__w200p1000st100").exists():
            jobs.append(("upgdm_tpu_torch.figures.fig4_model_sensitivity",
                         ["--trend", trend] + slbp))
        jobs += [
            ("upgdm_tpu_torch.figures.fig2_graph_generalization", ["--trend", trend]),
            ("upgdm_tpu_torch.figures.fig3_dynamics_transfer", ["--trend", trend]),
            ("upgdm_tpu_torch.figures.fig7_train_analysis", ["--trend", trend] + slbp),
        ]
    jobs.append(
        ("upgdm_tpu_torch.figures.fig8_train_source", slbp + ["--train-end", train_end]))
    ds = out / "dataset"
    machine = out / "ews_results/NsDiff_machine"
    fig5_ready = (
        (out / "ews_results/NsDiff_trends/models/dataset__w200p200st100").exists()
        and all(slbp_source_path(ds, t, trend, d).exists()
                for t, _f, _s in FIG5_TIME_ROWS
                for d in FIG59_D_VALUES for trend in TRENDS))
    if fig5_ready:
        jobs.append(("upgdm_tpu_torch.figures.fig5_tipping_types",
                     ["--d-values", *FIG59_D_VALUES, "--time-rows",
                      *[f"{t}:{f}:{s}" for t, f, s in FIG5_TIME_ROWS]]))
    if all((machine / m / "models/dataset_w200p200st100").exists()
           for m in ("NsDiff", "preg")):
        jobs.append(("upgdm_tpu_torch.figures.fig6_slbp_model_analysis", list(slbp)))
    fig9_ready = (
        (machine / "NsDiff/models/dataset_w200p200st100").exists()
        and all(slbp_source_path(ds, SLBP_TOTAL, "increase", d).exists()
                for d in FIG59_D_VALUES))
    if fig9_ready:
        jobs.append(("upgdm_tpu_torch.figures.fig9_smoothing",
                     ["--trend", "increase", "--total-time", SLBP_TOTAL,
                      "--noises", *FIG59_D_VALUES]))
    if all((out / "ews_results/model_compare" / fam / "SIS/model_trained").exists()
           for fam in ("NsDiff", "DiffSTG", "DiffusionTS", "TMDM")):
        jobs.append(("upgdm_tpu_torch.figures.fig1_model_compare",
                     ["--trend", "increase", "--graph", "barabasi_albert_30_0"]))
    return jobs


def select_figure_jobs(out: Path, stage: str) -> list:
    """Figure jobs of a stage: every schedulable figure for figures/all,
    only fig1 for ``--stage fig1``, only figs 5/6/9 for ``--stage slbpfigs``
    (empty: the tree is incomplete)."""
    jobs = figure_jobs(out)
    if stage == "fig1":
        jobs = [j for j in jobs if "fig1" in j[0]]
    elif stage == "slbpfigs":
        jobs = [j for j in jobs if any(f"fig{n}" in j[0] for n in (5, 6, 9))]
    return jobs


def _run_until_stalled(cmd, logf: Path, stall_timeout: int, poll_s: int = 60):
    """Run a subprocess with its output streamed to ``logf``; kill it when
    the log has not grown for ``stall_timeout`` seconds. Returns the exit
    code, or "stalled"."""
    with open(logf, "a") as fh:
        fh.write(f"\n=== attempt: {' '.join(cmd)}\n")
        fh.flush()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=fh,
                                stderr=subprocess.STDOUT)
        last_size = logf.stat().st_size
        last_progress = time.time()
        while True:
            try:
                return proc.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                pass
            size = logf.stat().st_size
            if size != last_size:
                last_size, last_progress = size, time.time()
            elif time.time() - last_progress > stall_timeout:
                proc.kill()
                proc.wait()
                return "stalled"


def render_figures(out: Path, jobs: list = None, attempts: int = 8,
                   stall_timeout: int = 45 * 60, device=None) -> int:
    """Each job as a subprocess of the port's figure CLI under the stall
    watchdog, retried up to ``attempts`` times (the sweeps checkpoint, so a
    retry resumes); returns the number of figures that failed every
    attempt."""
    figs = out / "figures"
    if jobs is None:
        jobs = figure_jobs(out)
    failed = 0
    for mod, extra in jobs:
        cmd = [sys.executable, "-m", mod,
               "--ews-root", str(out / "ews_results"),
               "--source-root", str(out / "dataset"),
               "--output-dir", str(figs), *extra, *_device_args(device)]
        figs.mkdir(parents=True, exist_ok=True)
        logf = figs / (mod.rsplit(".", 1)[-1] + ".log")
        for attempt in range(attempts):
            log("render " + mod + (f" (retry {attempt})" if attempt else "")
                + f" -> {logf}")
            code = _run_until_stalled(cmd, logf, stall_timeout)
            if code == 0:
                log(f"rendered {mod}")
                break
            log(f"FIGURE FAILED {mod} (exit {code}; tail of {logf}):")
            log(logf.read_text()[-2000:])
        else:
            failed += 1
    return failed


def write_manifest(out: Path):
    """MANIFEST.json: every artifact with its size and sha256 (the scratch
    tree and an earlier manifest left out)."""
    rows = []
    for p in sorted(out.rglob("*")):
        if not p.is_file() or "_scratch" in p.parts or p.name == "MANIFEST.json":
            continue
        h = hashlib.sha256()
        with open(p, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        rows.append({
            "path": str(p.relative_to(out)),
            "bytes": p.stat().st_size,
            "sha256": h.hexdigest(),
        })
    (out / "MANIFEST.json").write_text(json.dumps(rows, indent=1))
    log(f"manifest: {len(rows)} artifacts")


def apply_tiny():
    """The ``--tiny`` plumbing overrides: 3 graphs, tiny nets, 1 epoch, a
    short SLBP trajectory, 6 Bury series and 2 classifiers."""
    global CORPUS_GRAPHS, REF_NET, SLBP_TOTAL, N_BURY_SERIES, BURY_MAX_MODELS
    CORPUS_GRAPHS = ["barabasi_albert_30_0", "erdos_renyi_50_0", "small-world_70_0"]
    REF_NET = dict(REF_NET, d_model=16, n_heads=2, e_layers=1, d_layers=1,
                   d_ff=16, p_hidden_dims=[8, 8], n_z_samples=8)
    SLBP_TOTAL = "200000.0"
    N_BURY_SERIES = 6
    BURY_MAX_MODELS = 2
    COMPARE_NETS["TMDM"].update(d_model=16, n_heads=2, e_layers=1,
                                d_layers=1, d_ff=16, p_hidden_dims=[8, 8],
                                diffusion_steps=5, n_z_samples=8)
    COMPARE_NETS["DiffusionTS"].update(d_model=16, n_heads=2, n_layer_enc=1,
                                       n_layer_dec=2, timesteps=8,
                                       diffusion_steps=8, n_z_samples=8)
    COMPARE_NETS["DiffSTG"].update(d_h=4, Td_h=4, channel_multipliers=[1, 2],
                                   n_blocks=1, diffusion_steps=20,
                                   inference_diffusion_steps=4,
                                   parallel_sampling=2, sequential_sampling=2)
    for tp in COMPARE_TRAIN.values():
        tp["epochs"] = 1
        if "max_windows" in tp:
            tp["max_windows"] = 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--stage", choices=["data", "models", "compare", "sweep",
                                        "stats", "figures", "fig1", "slbpfigs",
                                        "real", "all"],
                    default="all")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--plot-checks", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="plumbing test: 3 graphs, tiny nets, 1 epoch")
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    args = ap.parse_args(argv)
    if args.tiny:
        apply_tiny()
        args.epochs = 1
    out, dev = args.out_dir.resolve(), args.device
    out.mkdir(parents=True, exist_ok=True)
    if args.stage in ("data", "fig1", "slbpfigs", "all"):
        gen_data(out, fig1_only=(args.stage == "fig1"), device=dev)
    if args.stage in ("models", "fig1", "slbpfigs", "all"):
        train_models(out, args.epochs,
                     generalization_only=(args.stage == "fig1"),
                     fig569_only=(args.stage == "slbpfigs"), device=dev)
    if args.stage in ("compare", "fig1", "all"):
        train_compare_models(out, device=dev)
    if args.stage in ("real", "all"):
        gen_real_data(out)
        train_real_model(out, args.epochs, device=dev)
        run_real_chain(out, device=dev)
    if args.stage in ("sweep", "stats", "all"):
        run_stats(out, plot_checks=args.plot_checks, device=dev)
        summarize(out)
    failed = 0
    if args.stage in ("figures", "fig1", "slbpfigs", "all"):
        jobs = select_figure_jobs(out, args.stage)
        if args.stage in ("fig1", "slbpfigs") and not jobs:
            log(f"{args.stage} jobs not schedulable: model tree incomplete")
            failed = 1
        failed += render_figures(out, jobs, device=dev)
        write_manifest(out)
    if failed:
        log(f"zoo INCOMPLETE: {failed} figure(s) failed to render")
        sys.exit(1)
    log("zoo done")


if __name__ == "__main__":
    main()
