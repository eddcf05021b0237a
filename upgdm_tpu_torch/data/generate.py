"""Dataset generation drivers — the CLI layer over data.sde / data.graphs.

Counterpart of ``upgdm_tpu/data/generate.py``, with its directory layouts,
so the data-prep loaders and the evaluation facade of either package read
the port's corpora, and the port reads the JAX package's:

  - networked systems: <out>/<graph_name>/<system>_dynamic_<trend>.pt
    (``contant`` for a fixed control), paired with
    <graph_dir>/<graph_name>.graphml
  - SLBP: <out>/SLBP_dynamic_total_time_<T>_N_<trend>/SLBP_dynamic_D_<D>.pt

    python -m upgdm_tpu_torch.data.generate SLBP --out-dir <dir> [--device cpu]
    python -m upgdm_tpu_torch.data.generate SIS --out-dir <dir> --graph-dir <dir>

The trajectories are integrated on the card (one K4 launch a segment) unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..ops.graph import graphml_to_adjacency
from ..utils.device import resolve_device
from ..utils.io import save_pt
from .sde import simulate_network_system, simulate_slbp

__all__ = ["generate_network_dataset", "generate_slbp_dataset", "main"]

# the JAX package's physics defaults: the combination each paper figure
# consumes, control ranges bracketing each system's tipping point
_SYSTEM_DEFAULTS = {
    "SIS": dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4),
    "biomass": dict(control_range=(0.0, 4.0), base_params={"r": 0.7, "k": 10.0, "d": 0.05}, eta=0.005),
    "neuronal": dict(control_range=(0.0, 1.0), base_params={"tau": 2.0, "mu": 1.5}, eta=0.01),
}


def generate_network_dataset(
    system: str,
    graph_dir,
    out_dir,
    trends=("increase", "decrease"),
    total_time: float = 1e4,
    burn_time: float = 100.0,
    dt: float = 0.1,
    seed: int = 0,
    graph_filter: str = "*",
    constant_control=None,
    device=None,
    **overrides,
):
    """One record per (graph, trend): <out>/<graph_name>/<system>_dynamic_<trend>.pt.
    A record's seed is ``seed + hash((graph_name, trend)) % 10_000``, as in the
    JAX package: the hash of a string changes with ``PYTHONHASHSEED``."""
    cfg = dict(_SYSTEM_DEFAULTS[system])
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    written = []
    for gpath in sorted(Path(graph_dir).glob(f"{graph_filter}.graphml")):
        graph = graphml_to_adjacency(gpath)
        for trend in trends:
            rec = simulate_network_system(
                system,
                graph.adj,
                trend=trend,
                total_time=total_time,
                burn_time=burn_time,
                dt=dt,
                seed=seed + hash((gpath.stem, trend)) % 10_000,
                constant_control=constant_control,
                device=dev,
                **{k: cfg[k] for k in ("control_range", "base_params", "eta")},
            )
            tag = "contant" if constant_control is not None else trend
            path = out_dir / gpath.stem / f"{system}_dynamic_{tag}.pt"
            save_pt(rec, path)
            written.append(path)
    return written


def generate_slbp_dataset(
    out_dir,
    trends=("increase", "decrease"),
    total_times=(1e6,),
    d_values=(1e-5, 5e-6),
    burn_time: float = 1000.0,
    dt: float = 0.1,
    seed: int = 0,
    save_every: int = 1,
    constant_n=None,
    device=None,
):
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    written = []
    for total_time in total_times:
        for trend in trends:
            for d in d_values:
                rec = simulate_slbp(
                    params={"D": d},
                    trend=trend,
                    total_time=total_time,
                    burn_time=burn_time,
                    dt=dt,
                    seed=seed,
                    save_every=save_every,
                    constant_n=constant_n,
                    device=dev,
                )
                path = (
                    out_dir
                    / f"SLBP_dynamic_total_time_{total_time}_N_{trend}"
                    / f"SLBP_dynamic_D_{d}.pt"
                )
                save_pt(rec, path)
                written.append(path)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate SDE trajectory datasets")
    ap.add_argument("system", choices=["SIS", "biomass", "neuronal", "SLBP"])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--graph-dir", default=None, help="dir of .graphml (networked systems)")
    ap.add_argument("--graph-filter", default="*")
    ap.add_argument("--total-time", type=float, default=1e4)
    ap.add_argument("--burn-time", type=float, default=100.0)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trend", choices=["increase", "decrease", "both"], default="both")
    ap.add_argument("--constant", type=float, default=None, help="fixed control (null dataset)")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device that integrates the trajectories (default: cuda)")
    args = ap.parse_args(argv)

    trends = ("increase", "decrease") if args.trend == "both" else (args.trend,)
    if args.system == "SLBP":
        written = generate_slbp_dataset(
            args.out_dir, trends=trends, total_times=(args.total_time,),
            burn_time=args.burn_time, dt=args.dt, seed=args.seed,
            save_every=args.save_every, constant_n=args.constant, device=args.device,
        )
    else:
        if args.graph_dir is None:
            ap.error("--graph-dir is required for networked systems")
        written = generate_network_dataset(
            args.system, args.graph_dir, args.out_dir, trends=trends,
            total_time=args.total_time, burn_time=args.burn_time, dt=args.dt,
            seed=args.seed, graph_filter=args.graph_filter,
            constant_control=args.constant, device=args.device,
        )
    for p in written:
        print(p)


if __name__ == "__main__":
    main()
