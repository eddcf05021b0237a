"""Fig. 9 for both trends on the port (counterpart of
``examples/run_fig9_round5.py``).

Trains the zoo's NsDiff_machine/NsDiff ``dataset_w200p200st100`` model when
its checkpoint is missing (the zoo's recipe: same seed, data and geometry),
then renders fig9_smoothing for the decreasing and the increasing trend from
that one checkpoint (the renders need matplotlib).

    python -m upgdm_tpu_torch.examples.run_fig9_round5 [--out-dir demo_zoo_torch]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from . import reference_zoo as zoo


def ensure_machine_model(out: Path, device=None):
    ews, ds = out / "ews_results", out / "dataset"
    target = ews / "NsDiff_machine/NsDiff/models"
    name = "dataset_w200p200st100"
    if (target / name).exists():
        zoo.log(f"machine model {name} present, skipping retrain")
        return
    main_rec = [zoo.slbp_source_path(ds, zoo.SLBP_TOTAL, t, zoo.SLBP_D)
                for t in zoo.TRENDS]
    flat = zoo._slbp_windows(main_rec, 200, 200)
    net = dict(zoo.REF_NET, dataset_nf=2, windows=200, pred_len=200)
    dsp = dict(file_path=str(ds / "SLBP_model_data"), windows=200, pred_len=200,
               sampling_t=100, interval_step=100, STG_exist=False)
    trained = zoo._train(
        flat, net, "NsDiff_model", out / "_scratch/NsDiff_machine_NsDiff" / name,
        max(15, 40), seed=zoo.stable_seed("NsDiff_machine/NsDiff", name),
        dataset_param=dsp, batch=64, device=device)
    zoo._install(trained, target, name)
    zoo.log(f"retrained NsDiff_machine/NsDiff/models/{name} ({len(flat)} windows)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=zoo.DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device of the training and renders (default: the card)")
    args = ap.parse_args(argv)
    out = args.out_dir.resolve()
    ensure_machine_model(out, args.device)
    for trend in ("decrease", "increase"):
        cmd = [sys.executable, "-m", "upgdm_tpu_torch.figures.fig9_smoothing",
               "--ews-root", str(out / "ews_results"),
               "--source-root", str(out / "dataset"),
               "--output-dir", str(out / "figures"),
               "--trend", trend, "--total-time", "400000.0",
               "--noises", "1e-05", "5e-06"]
        if args.device is not None:
            cmd += ["--device", str(args.device)]
        zoo.log(f"render fig9 {trend}")
        subprocess.run(cmd, cwd=zoo.REPO, check=True)
    zoo.log("fig9 both trends done")


if __name__ == "__main__":
    main()
