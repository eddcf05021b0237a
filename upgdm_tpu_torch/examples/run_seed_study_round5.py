"""Neuronal seed study on the port (counterpart of
``examples/run_seed_study_round5.py``).

Retrains the zoo's neuronal corpus model at several seeds with the zoo's
recipe (same data, windows, net and epochs as the seed-23 model behind
``corpus_summary.json``), runs the corpus g(x)-MPV statistics and the lead
metrics for each seed, and writes a table: the argmin lead's median and sign
and the 10%-drop threshold lead. The table is reduced without pandas
(``frame.py``), as pandas reduces it in the JAX runner.

    python -m upgdm_tpu_torch.examples.run_seed_study_round5 [--seeds 101 202 303]
        [--max-files 20] [--epochs 15] [--out-dir demo_zoo_torch] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from . import frame
from . import reference_zoo as zoo


def train_seed_model(out: Path, study: Path, seed: int, epochs: int, device=None) -> Path:
    """The neuronal corpus model at ``seed``: the zoo's generalization recipe
    but for the permutation and initialisation seed."""
    tree = study / f"seed{seed}" / "ews_results/model_compare/NsDiff/neuronal"
    if (tree / "model_trained").exists():
        zoo.log(f"seed {seed}: model present, skipping train")
        return tree
    ds = out / "dataset"
    cfg = zoo.SYSTEMS["neuronal"]
    flat = zoo._corpus_windows(out, "neuronal", 100, 100, zoo.TRAINED_ON_TOPOLOGY)
    dataset_param = dict(
        spdata_file_path=str(ds / "spdata_sde_neuronal"),
        graph_file_path=str(ds / "test_graph"),
        windows=100, pred_len=100, interval_step=100,
        sampling_t=cfg["sampling_t"], filter=f"{zoo.TRAINED_ON_TOPOLOGY}_*",
    )
    net = dict(zoo.REF_NET, dataset_nf=1, windows=100, pred_len=100)
    trained = zoo._train(flat, net, "NsDiff_model", study / "_scratch" / f"seed{seed}",
                         epochs, seed=seed, dataset_param=dataset_param, device=device)
    zoo._install(trained, tree)
    zoo.log(f"seed {seed}: trained ({len(flat)} windows)")
    return tree


def sweep_seed(out: Path, study: Path, seed: int, max_files=None, device=None) -> Path:
    ews = study / f"seed{seed}" / "ews_results"
    outdir = study / f"seed{seed}" / "mpv_collapse"
    argv = [sys.executable, "-u", "-m", "upgdm_tpu_torch.figures.mpv_collapse",
            "--ews-root", str(ews), "--source-root", str(out / "dataset"),
            "--output-dir", str(outdir), "--model-name", "NsDiff",
            "--dynamics", "neuronal", "--trends", "increase"]
    if max_files:
        argv += ["--max-files", str(max_files)]
    if device is not None:
        argv += ["--device", str(device)]
    zoo.log(f"seed {seed}: corpus sweep")
    subprocess.run(argv, cwd=zoo.REPO, check=True)
    return outdir


def seed_row(seed: int, outdir: Path) -> dict:
    """One seed's row: the valid files, the argmin lead's median and positive
    share, the pre-transition drop's median and, where the threshold table
    has the 0.1 drop level, its lead's median and positive share."""
    cols = frame.read_csv(outdir / "mpv_collapse_samples.csv")
    ok = [i for i, v in enumerate(cols["skip_reason"]) if frame.as_str(v) == ""]
    lead = frame.to_numeric([cols["lead_time"][i] for i in ok])
    row = {
        "seed": seed,
        "n": int(len(ok)),
        "argmin_lead_median": frame.median(lead),
        "argmin_lead_positive_frac": frame.positive_frac(lead),
        "pre_drop_median": frame.median(frame.to_numeric(
            [cols["pre_transition_drop_percent"][i] for i in ok])),
    }
    thr = outdir / "mpv_drop_threshold_lead_time.csv"
    if thr.exists():
        tcols = frame.read_csv(thr)
        # thresholds are drop fractions; 0.1 is the 10%-drop level
        rows = range(len(next(iter(tcols.values()))))
        if "threshold" in tcols:
            level = np.asarray([np.nan if frame.is_na(v) else v for v in tcols["threshold"]],
                               np.float64)
            rows = np.flatnonzero(np.isclose(level, 0.1))
        tl = frame.to_numeric([tcols["lead_time"][i] for i in rows])
        if len(tl):
            row["threshold10_lead_median"] = frame.median(tl)
            row["threshold10_lead_positive_frac"] = frame.positive_frac(tl)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", nargs="+", type=int, default=[101, 202, 303])
    ap.add_argument("--max-files", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--out-dir", type=Path, default=zoo.DEFAULT_OUT,
                    help="the zoo tree whose corpus the study reads")
    ap.add_argument("--device", default=None,
                    help="torch device of the training and sweeps (default: the card)")
    args = ap.parse_args(argv)
    out = args.out_dir.resolve()
    study = out / "seed_study"
    study.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in args.seeds:
        train_seed_model(out, study, seed, args.epochs, args.device)
        outdir = sweep_seed(out, study, seed, args.max_files, args.device)
        row = seed_row(seed, outdir)
        rows.append(row)
        zoo.log(f"seed {seed}: {json.dumps(row)}")
        (study / "seed_study_summary.json").write_text(
            json.dumps({"max_files": args.max_files, "epochs": args.epochs,
                        "rows": rows}, indent=1))
    zoo.log(f"seed study done -> {study / 'seed_study_summary.json'}")


if __name__ == "__main__":
    main()
