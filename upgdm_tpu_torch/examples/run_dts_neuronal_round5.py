"""The zoo's DiffusionTS/neuronal Fig-1 arm model alone, on the port
(counterpart of ``examples/run_dts_neuronal_round5.py``).

Trains only ``model_compare/DiffusionTS/neuronal`` with the zoo's
``train_compare_models`` recipe (same windows, seed and dims) when its
checkpoint is missing, leaving the other families' trees as they are.

    python -m upgdm_tpu_torch.examples.run_dts_neuronal_round5 [--out-dir demo_zoo_torch]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from . import reference_zoo as Z


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", type=Path, default=Z.DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device of the training (default: the card)")
    args = ap.parse_args(argv)
    out = args.out_dir.resolve()
    fam, system = "DiffusionTS", "neuronal"
    target = out / "ews_results" / "model_compare" / fam / system
    if (target / "model_trained").exists():
        print(f"[dts-neuronal] {target} already present, nothing to do",
              flush=True)
        return
    cfg = Z.SYSTEMS[system]
    tp = Z.COMPARE_TRAIN[fam]
    t0 = time.time()
    flat = Z._corpus_windows(out, system, 100, 100, topology="",
                             max_windows=tp["max_windows"], stride=100)
    print(f"[dts-neuronal] {len(flat)} training windows "
          f"({time.time()-t0:.0f}s)", flush=True)
    dataset_param = dict(
        file_path=str(out / "dataset" / f"spdata_sde_{system}"), filter="*",
        windows=100, pred_len=100, interval_step=100,
        sampling_t=cfg["sampling_t"], STG_exist=True)
    trained = Z._train(
        flat, Z.COMPARE_NETS[fam], None,
        out / "_scratch" / f"compare_{fam}_{system}", tp["epochs"],
        seed=Z.stable_seed("compare", fam, system),
        dataset_param=dataset_param, task_model=fam,
        batch=tp["batch"], loss_metric=tp["loss"], lr=tp["lr"],
        scheduler_set=False, device=args.device)
    Z._install(trained, target)
    print(f"[dts-neuronal] trained + installed in {time.time()-t0:.0f}s",
          flush=True)


if __name__ == "__main__":
    main()
