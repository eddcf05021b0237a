"""Paper Fig. 1: diffusion-model uncertainty signals across network dynamics.

Counterpart of ``upgdm_tpu/figures/fig1_model_compare.py``: for each
dynamics (biomass / neuronal / SIS) on one test graph, the raw mean state
and each model's relative MPV signal (normalised by the first-10% baseline)
with the raw-state transition marked. Models run on ``--device`` (default:
the card).
"""
from __future__ import annotations

import argparse
import gc
import json
from pathlib import Path

import numpy as np

from ..eval.uncertainty import (
    DEFAULT_SAMPLING_T,
    default_sample_window_step,
    load_dynamic_data,
    read_model_config,
    resolve_cache_path,
    uncertainty_ews,
)
from ..ops.windows import sample_time_series, sliding_windows
from .common import (
    DATASETS,
    FIG1_MODELS,
    MODEL_COLORS,
    RAW_COLOR,
    TRANSITION_COLOR,
    add_common_args,
    dynamics_title,
    ensure_output,
    graph_file,
    load_raw_trace,
    relative_uncertainty,
    set_nature_style,
    skip_render,
    thin_for_plot,
)

__all__ = ["load_model_signal", "load_partial_signal", "arm_state",
           "collect_fig1_data", "main"]


def arm_state(ews_root, model_name, dataset_type, data_file) -> tuple:
    """(cache_path, sidecar_dict_or_None, complete: bool) for one fig1 arm.

    ``complete`` means the arm needs no device work: either the ensemble
    ``.pt`` cache exists or its ``.mpv.json`` sidecar is marked complete.
    """
    model_dir = Path(ews_root) / "model_compare" / model_name / dataset_type
    cache_path = resolve_cache_path(model_dir, model_dir, data_file, dataset_type)
    sidecar_path = cache_path.with_name(cache_path.name + ".mpv.json")
    sidecar = None
    if sidecar_path.exists():
        try:
            sidecar = json.loads(sidecar_path.read_text())
        except (ValueError, OSError):
            sidecar = None
    complete = cache_path.exists() or bool(sidecar and sidecar.get("complete"))
    return cache_path, sidecar, complete


def load_partial_signal(ews_root, source_root, model_name, dataset_type,
                        data_file) -> dict:
    """Sidecar-only signal for an arm — no model, no device.

    Used by ``--allow-partial`` renders: the committed ``.mpv.json`` sidecar
    holds the swept MPVs; the time axis is rebuilt with the same sampling/
    windowing as the sweep and the signal is marked partial only when the
    sidecar is a truncated prefix.  Unlike the sweep's resume path this does
    NOT gate on the window fingerprint: SDE corpus regeneration is not
    bit-reproducible across host CPUs (XLA:CPU reduction order differs with
    core count and ISA, and the chaotic dynamics amplify last-ulp
    differences into a different noise realization), so on a fresh machine
    the committed sidecar is the measurement of record even though its
    fingerprint no longer matches the locally regenerated corpus.
    """
    cache_path, sidecar, _complete = arm_state(
        ews_root, model_name, dataset_type, data_file)
    n_done = int(sidecar.get("n_windows_done", 0)) if sidecar else 0
    if n_done <= 0:
        raise FileNotFoundError(
            f"no sweep progress for {model_name}/{dataset_type}: {cache_path}")
    method_config = read_model_config(
        Path(ews_root) / "model_compare" / model_name / dataset_type)
    cfg = method_config.get("dataset", {})
    loaded = load_dynamic_data(data_file, dynamic_type=dataset_type)
    sampling_t = cfg.get("sampling_t", DEFAULT_SAMPLING_T.get(dataset_type, 0.1))
    sampled_series, sampled_time = sample_time_series(
        np.asarray(loaded["torch_time_series"]), loaded["time_data"], sampling_t)
    step = sidecar.get("sample_window_step") or default_sample_window_step(
        dataset_type, model_name if model_name == "DiffSTG" else None, cfg)
    _arr, time_points = sliding_windows(
        sampled_series, sampled_time, cfg["windows"], int(step))
    ews = np.asarray(sidecar["ews"], float)[:n_done]
    n_total = int(sidecar.get("n_windows_total", len(time_points)))
    sig = {
        "time": np.asarray(time_points)[:n_done],
        "ews": ews,
        "cache_path": cache_path,
        "sample_window_step": int(step),
    }
    if n_done < n_total:
        sig["partial"] = (n_done, n_total)
    return sig


def load_model_signal(ews_root, source_root, model_name, dataset_type, data_file, graph,
                      force_recompute=False, device=None) -> dict:
    model_dir = Path(ews_root) / "model_compare" / model_name / dataset_type
    if not model_dir.exists():
        raise FileNotFoundError(f"model folder not found: {model_dir}")
    result = uncertainty_ews(
        model_save_file=model_dir,
        data_file=data_file,
        dynamic_type=dataset_type,
        task_model=model_name if model_name == "DiffSTG" else None,
        graph_file=graph_file(source_root, graph) if model_name == "DiffSTG" else None,
        cache_path=model_dir,
        force_recompute=force_recompute,
        device=device,
    )
    signal = {
        "time": np.asarray(result["time_points"]),
        "ews": np.asarray(result["ews"], float),
        "cache_path": result["cache_path"],
        "sample_window_step": result["sample_window_step"],
    }
    del result
    gc.collect()
    return signal


def collect_fig1_data(ews_root, source_root, data_trend, graph, models,
                      force_recompute=False, allow_partial=False, device=None):
    fig_data = {}
    for dataset_type in DATASETS:
        raw = load_raw_trace(source_root, dataset_type, data_trend, graph)
        model_signals = {}
        for m in models:
            if allow_partial and not force_recompute:
                cp, sc, _complete = arm_state(ews_root, m, dataset_type,
                                              raw["data_file"])
                # the `.pt` ensemble cache wins when present; without
                # it, ANY sidecar progress renders device-free — including
                # complete arms (their fingerprint may lag a regenerated
                # corpus, see load_partial_signal)
                if not cp.exists() and sc and int(sc.get("n_windows_done", 0)) > 0:
                    sig = load_partial_signal(ews_root, source_root, m,
                                              dataset_type, raw["data_file"])
                    if sig.get("partial"):
                        n, tot = sig["partial"]
                        print(f"[fig1] {m}/{dataset_type}: PARTIAL {n}/{tot} "
                              "windows (sidecar-only render)", flush=True)
                    else:
                        print(f"[fig1] {m}/{dataset_type}: complete sidecar "
                              "render (no device)", flush=True)
                    model_signals[m] = sig
                    continue
            model_signals[m] = load_model_signal(
                ews_root, source_root, m, dataset_type, raw["data_file"],
                graph, force_recompute, device)
        fig_data[dataset_type] = {"raw": raw, "models": model_signals}
    return fig_data


def plot_fig1(fig_data, models, output_dir, data_trend):
    import matplotlib.pyplot as plt

    set_nature_style()
    n_cols = len(fig_data)
    fig, axes = plt.subplots(
        2, n_cols, figsize=(3.2 * n_cols, 4.6), sharex="col",
        gridspec_kw={"hspace": 0.08, "wspace": 0.28},
    )
    if n_cols == 1:
        axes = axes.reshape(2, 1)
    for col, (dataset_type, data) in enumerate(fig_data.items()):
        raw = data["raw"]
        t, m = thin_for_plot(raw["time"][: len(raw["mean"])], raw["mean"])
        axes[0, col].plot(t, m, color=RAW_COLOR, linewidth=1.4)
        axes[0, col].set_title(dynamics_title(dataset_type))
        axes[0, col].axvline(raw["transition_time"], color=TRANSITION_COLOR,
                             linestyle="--", linewidth=0.9)
        if col == 0:
            axes[0, col].set_ylabel("State")
        for model_name, sig in data["models"].items():
            rel = relative_uncertainty(sig["ews"])
            label = model_name
            if sig.get("partial"):
                label = f"{model_name} ({sig['partial'][0]}/{sig['partial'][1]})"
            axes[1, col].plot(sig["time"][: len(rel)], rel,
                              color=MODEL_COLORS.get(model_name, "#333333"),
                              linewidth=1.1, label=label)
        axes[1, col].axvline(raw["transition_time"], color=TRANSITION_COLOR,
                             linestyle="--", linewidth=0.9)
        axes[1, col].set_xlabel("Time")
        if col == 0:
            axes[1, col].set_ylabel("Relative uncertainty")
            axes[1, col].legend(fontsize=7, ncol=2)
    fig.tight_layout()
    out = ensure_output(output_dir)
    png = out / f"fig1_model_compare_{data_trend}.png"
    fig.savefig(png, dpi=300, bbox_inches="tight")
    fig.savefig(out / f"fig1_model_compare_{data_trend}.pdf", bbox_inches="tight")
    plt.close(fig)
    return png


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fig 1: model comparison")
    add_common_args(parser)
    parser.add_argument("--graph", default="barabasi_albert_30_0")
    parser.add_argument("--models", nargs="+", default=list(FIG1_MODELS))
    parser.add_argument("--force-recompute", action="store_true")
    parser.add_argument("--allow-partial", action="store_true",
                        help="render unfinished arms from their .mpv.json "
                             "sidecars (truncated curve, labelled n/total) "
                             "instead of sweeping them")
    args = parser.parse_args(argv)
    fig_data = collect_fig1_data(
        args.ews_root, args.source_root, args.trend, args.graph, tuple(args.models),
        args.force_recompute, allow_partial=args.allow_partial, device=args.device,
    )
    if skip_render():
        return
    png = plot_fig1(fig_data, args.models, args.output_dir, args.trend)
    print(f"saved: {png}")


if __name__ == "__main__":
    main()
