"""Per-arm driver of the paper-Fig-1 model_compare MPV sweeps, on the port
(counterpart of ``examples/fig1_arm_driver.py``).

The Fig-1 render iterates datasets x models in a fixed order, so a run cut
short loses the arms queued behind the expensive DiffusionTS ones. This
driver sweeps arms one at a time in the order given, through the figure
module's own ``load_model_signal`` (the same ``uncertainty_ews`` call and
cache layout, partial resume intact), so each finished arm is durable before
the next starts; an arm whose ``.mpv.json`` sidecar says complete is skipped.
NsDiff arms run K1, TMDM arms K3.

    python -m upgdm_tpu_torch.examples.fig1_arm_driver --arms NsDiff:SIS TMDM:SIS \\
        [--ews-root demo_zoo_torch/ews_results] [--source-root demo_zoo_torch/dataset] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

DEFAULT_EWS_ROOT = "demo_zoo_torch/ews_results"
DEFAULT_SOURCE_ROOT = "demo_zoo_torch/dataset"


def arm_sidecar(ews_root: Path, model: str, dataset: str, trend: str) -> Path:
    from ..figures.common import dynamics_filename

    name = dynamics_filename(dataset, trend)
    return ews_root / "model_compare" / model / dataset / f"{name}.mpv.json"


def arm_complete(ews_root: Path, model: str, dataset: str, trend: str) -> bool:
    sc = arm_sidecar(ews_root, model, dataset, trend)
    if not sc.exists():
        return False
    try:
        return bool(json.loads(sc.read_text()).get("complete"))
    except (ValueError, OSError):
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ews-root", default=DEFAULT_EWS_ROOT)
    ap.add_argument("--source-root", default=DEFAULT_SOURCE_ROOT)
    ap.add_argument("--trend", default="increase")
    ap.add_argument("--graph", default="barabasi_albert_30_0")
    ap.add_argument("--arms", nargs="+", required=True,
                    help="ordered Model:dataset pairs, e.g. NsDiff:SIS")
    ap.add_argument("--device", default=None,
                    help="torch device of the sweeps (default: the card)")
    args = ap.parse_args(argv)
    from ..figures.common import dynamics_filename, spdata_source_path
    from ..figures.fig1_model_compare import load_model_signal

    ews_root = Path(args.ews_root)
    for arm in args.arms:
        model, dataset = arm.split(":")
        if arm_complete(ews_root, model, dataset, args.trend):
            print(f"[arm] {arm}: already complete, skipping", flush=True)
            continue
        data_file = spdata_source_path(
            args.source_root, dataset, args.graph,
            dynamics_filename(dataset, args.trend))
        t0 = time.time()
        print(f"[arm] {arm}: sweeping {data_file.name}", flush=True)
        sig = load_model_signal(ews_root, args.source_root, model, dataset,
                                data_file, args.graph, device=args.device)
        print(f"[arm] {arm}: done, {len(sig['ews'])} windows in "
              f"{time.time() - t0:.0f}s", flush=True)
        del sig
        gc.collect()
    print("[arm] all requested arms complete", flush=True)


if __name__ == "__main__":
    main()
