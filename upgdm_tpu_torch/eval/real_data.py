"""Real-data EWS pipeline, without pandas.

Counterpart of ``upgdm_tpu/eval/real_data.py``, function for function:
loads empirical ``.pt`` records, linearly resamples a record too short for
one model window, detrends, computes the classic EWS (variance, AR(1),
sample entropy), the g(x) uncertainty signal of a trained NsDiff model with
its rolling trend slope, overlays the Bury-2021 classifier probabilities
(``eval/bury.py``), and writes per-record CSV, PNG and SVG.

Where the JAX package uses pandas, the port uses numpy and the ``csv``
module: the Bury CSV is read into a dict of column arrays, and the signal
table is a list of row dicts (``data_name, signal, component, time, value``)
written with the same header and rows in the same order, NaN as an empty
field as pandas writes it. The g(x) sweep goes through the port's
``load_model_from_dir`` and ``batched_gx`` on ``args.device`` (default the
card), and its cache is the JAX package's ``model_uncertainty.pt``, so each
side reads the other's. matplotlib is imported only by the renders.
"""
from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from ..ops.windows import sampling_interval_from_t
from ..utils import io as uio
from .ews_classic import (
    compute_classic_ews,
    compute_variance_trend,
    detrend,
    normalize_by_head_mean,
)
from .uncertainty import batched_gx, load_model_from_dir

BURY_ML_PROB_COLUMNS = ["fold_prob", "hopf_prob", "branch_prob", "null_prob"]
SIGNAL_COLUMNS = ["data_name", "signal", "component", "time", "value"]
VALID_SIGNALS = {
    "model_uncertainty", "model_trend", "ar1", "variance", "sample-entropy-1", "bury_ml",
}

__all__ = [
    "resolve_real_data_path",
    "get_transition_time_from_record",
    "ensure_min_time_points_linear_interp",
    "prepare_model_input_series",
    "run_model_uncertainty",
    "load_or_run_model_uncertainty",
    "parse_model_uncertainty_cache",
    "infer_model_times",
    "load_bury_ml_probabilities",
    "build_signal_data",
    "write_signal_table",
    "plot_real_data_subfigure",
    "run_one",
    "main",
]


def resolve_real_data_path(name, data_root):
    """Accept either a direct ``.pt`` path or a bare record name searched
    recursively under ``data_root`` (first match in sorted order wins)."""
    direct = Path(name)
    if direct.suffix == ".pt" and direct.exists():
        return direct
    found = sorted(Path(data_root).rglob(f"{name}.pt"))
    if found:
        return found[0]
    raise FileNotFoundError(f"no real-data record '{name}' anywhere under {data_root}")


def data_name_from_record(record, data_path):
    return str(record.get("name", Path(data_path).stem))


def get_transition_time_from_record(record):
    """transition_index / transition_time / transition_age resolution."""
    ts = np.asarray(record.get("ts_dynamic", []), float).ravel()
    if len(ts) == 0:
        return None
    if "transition_index" in record:
        idx = max(0, min(int(record["transition_index"]), len(ts) - 1))
        return float(ts[idx])
    if "transition_time" in record:
        return float(record["transition_time"])
    if "transition_age" in record:
        age = float(record["transition_age"])
        return float(ts[int(np.argmin(np.abs(ts - age)))])
    return None


def ensure_min_time_points_linear_interp(record, min_sampled_points=200, sampling_interval=1):
    """Linearly upsample a record too short for one model window.

    Records that keep fewer than ``min_sampled_points`` after decimation by
    ``sampling_interval`` are resampled onto a uniform float32 grid dense
    enough that decimation leaves that many; duplicate time stamps collapse to
    their first occurrence, the transition marker moves to the nearest new
    grid point, and ``tp_values`` (if present) is re-zeroed at the new length.
    Returns ``(record, was_resampled)``.
    """
    ys = np.asarray(record["ys_dynamic"], np.float32)
    ys = ys.reshape(len(ys), -1)
    ts = np.asarray(record["ts_dynamic"], np.float32).ravel()
    decim = max(1, int(sampling_interval))
    need = int(min_sampled_points)
    if len(ts[::decim]) >= need:
        record.update(ys_dynamic=ys, ts_dynamic=ts)
        return record, False
    if ts.size < 2:
        raise ValueError("cannot upsample a record with fewer than two time points")

    keep = np.argsort(ts)
    grid_t, first = np.unique(ts[keep], return_index=True)
    grid_y = ys[keep][first]
    n_new = max(len(grid_t), (need - 1) * decim + 1)
    new_ts = np.linspace(grid_t[0], grid_t[-1], n_new, dtype=np.float32)
    new_ys = np.column_stack(
        [np.interp(new_ts, grid_t, col) for col in grid_y.T]
    ).astype(np.float32)

    marker = get_transition_time_from_record(record)
    record.update(ys_dynamic=new_ys, ts_dynamic=new_ts, num_time_points=int(n_new))
    if marker is not None:
        at = int(np.abs(new_ts - marker).argmin())
        record.update(transition_index=at, transition_time=float(new_ts[at]))
    if "tp_values" in record:
        record["tp_values"] = np.zeros(n_new, np.float32)
    return record, True


def prepare_model_input_series(ys, model_input, detrend_method, detrend_span, detrend_bandwidth):
    ys = np.asarray(ys, np.float32)
    if ys.ndim == 1:
        ys = ys[:, None]
    if model_input == "raw":
        return ys
    if model_input != "detrended":
        raise ValueError(f"Unsupported model input: {model_input}")
    cols = [
        detrend(ys[:, d], method=detrend_method, span=detrend_span, bandwidth=detrend_bandwidth)
        for d in range(ys.shape[1])
    ]
    return np.stack(cols, axis=1).astype(np.float32)


def model_cache_path(data_name, real_data_result_root):
    return Path(real_data_result_root) / "data" / data_name / "model_uncertainty.pt"


def parse_model_uncertainty_cache(cache_path, pred_dim):
    """Read a model-uncertainty cache in any of its three layouts.

    A summary dict carrying explicit ``time`` + per-window values under
    either the ``model_uncertainty`` or ``values`` key, or a raw list of
    per-window gx tensors ``[Node, pred_len]`` (possibly nested under
    ``data_save_list``) that still needs the horizon-mean reduction. Returns
    ``(time, values)`` with ``time=None`` for the raw-list layouts (the caller
    reconstructs it).
    """
    obj = uio.load_pt(cache_path)
    if isinstance(obj, dict):
        value_key = next(
            (k for k in ("model_uncertainty", "values") if k in obj and "time" in obj), None
        )
        if value_key is not None:
            return np.asarray(obj["time"], float), np.asarray(obj[value_key], float)
        obj = obj.get("data_save_list")
        if obj is None:
            raise ValueError(f"unrecognized model-uncertainty cache layout: {cache_path}")
    if not isinstance(obj, list):
        raise ValueError(f"model-uncertainty cache {cache_path} is not a tensor list")
    per_window = [np.asarray(gx).mean(axis=-1) for gx in obj]
    if per_window and pred_dim >= len(per_window[0]):
        raise ValueError(
            f"pred_dim={pred_dim} out of range for cached gx with "
            f"{len(per_window[0])} dims in {cache_path}"
        )
    return None, np.asarray([float(e[pred_dim]) for e in per_window], float)


def infer_model_times(time_data, num_values, sample_window_step=1, sampling_t=0.1, model_window=None):
    """Time stamp of each cached gx value (window-END convention).

    Value ``i`` belongs to the rolling window ending at sampled index
    ``w - 1 + i*step``; when ``model_window`` is unknown it is recovered from
    the cache length (``n`` values stepping over the sampled series leave
    exactly ``w - 1`` leading points).
    """
    step = int(sample_window_step)
    n = int(num_values)
    t = np.asarray(time_data, float).ravel()[:: sampling_interval_from_t(sampling_t)]
    w = int(model_window) if model_window is not None else len(t) - (n - 1) * step
    if w < 1:
        raise ValueError(
            f"window inference failed: {n} values with step {step} do not fit "
            f"in {len(t)} sampled points"
        )
    end_idx = w - 1 + step * np.arange(n)
    end_idx = end_idx[end_idx < len(t)]
    return t[end_idx]


def run_model_uncertainty(record, data_name, cache_path, model_dir, args):
    """Fresh gx sweep over the record's rolling windows, then cache.

    All windows go through ``batched_gx`` on ``args.device``; the window and
    sampling geometry come from the checkpoint's own yaml, and records
    shorter than one model window are first linearly resampled up to it.
    """
    cfg = uio.read_model_config(model_dir)["dataset"]
    w = int(cfg["windows"])
    stride = int(args.sample_window_step)
    interval = sampling_interval_from_t(float(cfg.get("sampling_t", args.sampling_t)))

    record, resampled = ensure_min_time_points_linear_interp(
        record, min_sampled_points=w, sampling_interval=interval
    )
    if resampled:
        print(f"{data_name}: record resampled up to {record['num_time_points']} "
              f"points (model needs a {w}-point window)")

    # [dims, T_sampled, 1] series in the model's input layout, detrended per
    # the CLI policy, decimated to the checkpoint's sampling interval
    series = prepare_model_input_series(
        record["ys_dynamic"], args.model_input, args.model_detrend_method,
        args.model_detrend_span, args.model_detrend_bandwidth,
    ).T[:, ::interval, None]
    t_sampled = np.asarray(record["ts_dynamic"], float).ravel()[::interval]

    ends = np.arange(w - 1, series.shape[1], stride)  # window-END indices
    gather = ends[:, None] + np.arange(-(w - 1), 1)[None, :]
    windows_array = np.ascontiguousarray(
        series[:, gather, :].transpose(1, 0, 2, 3))  # [n_win, dims, w, 1]

    device = getattr(args, "device", None)
    model, _np_ = load_model_from_dir(
        model_dir, device=device,
        infer_params={"parallel_sample": args.parallel_sample,
                      "n_z_samples": args.n_z_samples},
    )
    g_list = batched_gx(model, windows_array, device=device)  # list of [dims, pred_len, F]
    flat = [g[..., 0] if g.shape[-1] == 1 else g.squeeze(-1) for g in g_list]
    Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
    uio.save_tensor_list(flat, cache_path)
    values = np.asarray([float(g.mean(axis=1)[args.pred_dim]) for g in flat], float)
    return t_sampled[ends][: len(values)], values


def load_or_run_model_uncertainty(record, data_name, args):
    """Model-uncertainty signal for one record: cache hit wins, else sweep.

    A raw-list cache stores no time axis, so one is reconstructed from the
    record's own time stamps, anchored at the checkpoint's window length when
    a model dir is at hand, otherwise inferred from the value count.
    """
    cache_path = model_cache_path(data_name, args.real_data_result_root)
    model_dir = Path(args.model_dir) if args.model_dir is not None else None

    if not cache_path.exists():
        if model_dir is None:
            raise FileNotFoundError(
                f"no cached model uncertainty at {cache_path} and no "
                "--model-dir to sweep it fresh"
            )
        times, values = run_model_uncertainty(record, data_name, cache_path, model_dir, args)
        return times, values, cache_path

    times, values = parse_model_uncertainty_cache(cache_path, args.pred_dim)
    if times is None:
        w = (int(uio.read_model_config(model_dir)["dataset"]["windows"])
             if model_dir is not None else None)
        times = infer_model_times(
            record["ts_dynamic"], len(values),
            sample_window_step=args.sample_window_step,
            sampling_t=args.sampling_t, model_window=w,
        )
    return times, values, cache_path


def _column(values):
    """A CSV column as float64 (an empty field is NaN), else as strings."""
    try:
        return np.asarray([float(v) if v != "" else math.nan for v in values], float)
    except ValueError:
        return np.asarray(values, dtype=object)


def load_bury_ml_probabilities(data_name, bury_prob_root):
    """Find and validate the record's Bury-2021 classifier probability CSV:
    ``({column: array}, path)``."""
    found = sorted(Path(bury_prob_root).rglob(f"{data_name}_bury_ml_probs.csv"))
    if not found:
        raise FileNotFoundError(
            f"no Bury ML probability CSV for {data_name} under {bury_prob_root}"
        )
    with open(found[0], newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = list(reader)
    wanted = ("time",) + tuple(BURY_ML_PROB_COLUMNS)
    absent = [c for c in wanted if c not in header]
    if absent:
        raise ValueError(f"{found[0]} lacks required columns {absent}")
    table = {name: _column([r[i] for r in rows]) for i, name in enumerate(header)}
    return table, found[0]


def append_signal_rows(rows, data_name, signal, times, values, component="value"):
    for t, v in zip(np.asarray(times, float), np.asarray(values, float)):
        rows.append(
            {"data_name": data_name, "signal": signal, "component": component,
             "time": t, "value": v}
        )


CLASSIC_SIGNALS = ("ar1", "variance", "sample-entropy-1")


def _classic_signals(record, data_name, ts, y, args):
    """Classic rolling EWS (AR1 / variance / sample entropy) as (t, v) pairs."""
    table = compute_classic_ews(
        ts, y, method=args.ews_detrend_method, span=args.ews_detrend_span,
        bandwidth=args.ews_detrend_bandwidth, rolling_window=args.rolling_window,
    )
    return {
        key: (np.asarray(table["times"], float), np.asarray(table[key], float))
        for key in CLASSIC_SIGNALS if key in args.signals
    }


def _model_signals(record, data_name, ts, y, args):
    """gx uncertainty (head-normalized) and its rolling trend slope."""
    t, v, cache_path = load_or_run_model_uncertainty(record, data_name, args)
    v = normalize_by_head_mean(v, head_points=args.model_normalize_head)
    print(f"{data_name}: model uncertainty from {cache_path}")
    return {
        "model_uncertainty": (t, v),
        "model_trend": compute_variance_trend(
            t, v, trend_window=args.trend_window,
            min_points=args.trend_min_points, normalize_time=True),
    }


def _bury_signals(record, data_name, ts, y, args):
    table, path = load_bury_ml_probabilities(data_name, args.bury_prob_root)
    print(f"{data_name}: Bury ML probabilities from {path}")
    return {"bury_ml": table}


#: builder groups keyed by the signal names that activate them; each runs at
#: most once even when it serves several requested signals
_SIGNAL_BUILDERS = (
    (CLASSIC_SIGNALS, _classic_signals),
    (("model_uncertainty", "model_trend"), _model_signals),
    (("bury_ml",), _bury_signals),
)


def build_signal_data(record, data_name, args):
    """Every requested signal and the long-format table: ``(ts, y,
    signal_data, rows)``, ``rows`` a list of dicts keyed by
    ``SIGNAL_COLUMNS``, the trajectory first, then each signal in
    ``args.signals`` order (Bury columns in ``BURY_ML_PROB_COLUMNS`` order)."""
    ts = np.asarray(record["ts_dynamic"], float).ravel()
    ys = np.asarray(record["ys_dynamic"], np.float32)
    if ys.ndim == 1:
        ys = ys[:, None]
    if args.pred_dim >= ys.shape[1]:
        raise ValueError(f"pred_dim={args.pred_dim} invalid for ys_dynamic shape {ys.shape}")
    y = ys[:, args.pred_dim]

    signal_data = {}
    for triggers, build in _SIGNAL_BUILDERS:
        if any(sig in args.signals for sig in triggers):
            signal_data.update(build(record, data_name, ts, y, args))

    csv_rows = []
    append_signal_rows(csv_rows, data_name, "trajectory", ts, y, component=f"dim_{args.pred_dim}")
    for signal in args.signals:
        if signal not in signal_data:
            continue
        if signal == "bury_ml":
            bdf = signal_data[signal]
            for col in BURY_ML_PROB_COLUMNS:
                append_signal_rows(csv_rows, data_name, signal, bdf["time"], bdf[col], col)
        else:
            append_signal_rows(csv_rows, data_name, signal, *signal_data[signal])
    return ts, y, signal_data, csv_rows


def write_signal_table(rows, path) -> Path:
    """The signal rows as CSV (``SIGNAL_COLUMNS``, NaN as an empty field)."""
    return uio.write_csv(path, SIGNAL_COLUMNS, ([row[c] for c in SIGNAL_COLUMNS] for row in rows))


def output_stem(data_name, args) -> Path:
    """``<output_root>/<name>/<name>_real_data_ews`` (directory created)."""
    out_dir = Path(args.output_root) / data_name
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir / f"{data_name}_real_data_ews"


#: per-signal panel styling: color, linestyle ("." = dot markers), y label
PANEL_STYLES = {
    "model_uncertainty": ("#d62728", ".", "Model uncertainty"),
    "model_trend": ("#1f77b4", "-.", "Uncertainty trend"),
    "ar1": ("#d62728", "-", "AR(1)"),
    "variance": ("#2ca02c", "-", "Variance"),
    "sample-entropy-1": ("#9467bd", "-", "Sample Entropy"),
}
BURY_PANEL = {  # column -> (color, legend label)
    "fold_prob": ("#1f77b4", "fold"), "hopf_prob": ("#ff7f0e", "Hopf"),
    "branch_prob": ("#2ca02c", "branch"), "null_prob": ("#6c757d", "null"),
}


def _draw_signal_panel(ax, signal, signal_data):
    """One stacked panel: Bury probability bundle, styled line, or a
    'missing' placeholder when the signal was requested but never built."""
    if signal not in signal_data:
        ax.text(0.5, 0.5, f"missing: {signal}", transform=ax.transAxes,
                ha="center", va="center")
        ax.set_ylabel(signal)
    elif signal == "bury_ml":
        bdf = signal_data[signal]
        for col, (color, label) in BURY_PANEL.items():
            ax.plot(bdf["time"], bdf[col], color=color, linewidth=1.1, label=label)
        ax.set_ylim(-0.03, 1.03)
        ax.legend(loc="best", frameon=False, ncol=4, fontsize=8)
        ax.set_ylabel("Bury ML")
    else:
        times, values = signal_data[signal]
        color, style, label = PANEL_STYLES[signal]
        dotted = style == "."
        ax.plot(times, values, color=color, linewidth=1.0, markersize=3,
                linestyle="None" if dotted else style,
                marker="." if dotted else None)
        ax.set_ylabel(label)


def plot_real_data_subfigure(data_name, ts, y, signal_data, transition_time, args):
    """Stacked per-record panel: raw trajectory on top, one panel per
    requested signal below, shared time axis, transition marked everywhere."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_axes = 1 + len(args.signals)
    fig, axes = plt.subplots(
        n_axes, 1, figsize=(args.fig_width, max(2.2 * n_axes, 5.5)), sharex=True
    )
    axes = np.atleast_1d(axes)
    axes[0].plot(ts, y, color="#1f4e79", linewidth=1.5)
    axes[0].set_ylabel(args.trajectory_ylabel)
    axes[0].set_title(data_name)
    for ax, signal in zip(axes[1:], args.signals):
        _draw_signal_panel(ax, signal, signal_data)

    for ax in axes:
        if transition_time is not None:
            ax.axvline(transition_time, color="black", linestyle="--",
                       linewidth=1.0, alpha=0.75)
        ax.grid(alpha=0.18, linewidth=0.6)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
    axes[-1].set_xlabel("Time")
    axes[-1].set_xlim(float(np.nanmin(ts)), float(np.nanmax(ts)))
    fig.tight_layout()
    return fig


def run_one(data_name_or_path, args):
    """Full per-record pipeline: load -> signals -> stacked figure + CSV.

    Writes ``<output_root>/<name>/<name>_real_data_ews.png`` + ``.svg`` (when
    matplotlib is installed) and, unless suppressed, the long-format signals
    CSV. Returns the PNG's path (None without matplotlib).
    """
    from ..figures.common import can_render

    record = uio.load_pt(resolve_real_data_path(data_name_or_path, args.data_root))
    data_name = data_name_from_record(record, data_name_or_path)
    ts, y, signal_data, signal_rows = build_signal_data(record, data_name, args)

    stem = output_stem(data_name, args)
    if not args.no_save_csv:
        write_signal_table(signal_rows, f"{stem}_signals.csv")
    if not can_render():
        print(f"saved: {stem}_signals.csv (matplotlib is not installed: no render)")
        return None
    import matplotlib.pyplot as plt

    fig = plot_real_data_subfigure(
        data_name, ts, y, signal_data, get_transition_time_from_record(record), args)
    fig.savefig(stem.with_suffix(".png"), dpi=args.dpi)
    fig.savefig(stem.with_suffix(".svg"))
    plt.close(fig)
    print(f"saved: {stem.with_suffix('.png')}")
    return stem.with_suffix(".png")


def default_args(**overrides) -> SimpleNamespace:
    args = SimpleNamespace(
        data_root="dataset/real_data",
        real_data_result_root="ews_results/real_data",
        bury_prob_root="ews_results/bury_2021_ml_probs",
        output_root="ews_results/real_data/figures",
        signals=["model_uncertainty", "model_trend", "ar1", "variance", "bury_ml"],
        pred_dim=0,
        model_dir=None,
        model_input="detrended",
        model_detrend_method="Lowess",
        model_detrend_span=0.2,
        model_detrend_bandwidth=0.2,
        sampling_t=0.1,
        sample_window_step=1,
        parallel_sample=50,
        n_z_samples=100,
        ews_detrend_method="Gaussian",
        ews_detrend_span=0.2,
        ews_detrend_bandwidth=0.2,
        rolling_window=0.5,
        trend_window=40,
        trend_min_points=5,
        model_normalize_head=40,
        trajectory_ylabel="Time Series",
        fig_width=8.0,
        dpi=300,
        no_save_csv=False,
        device=None,
    )
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def main(argv=None):
    d = default_args()
    parser = argparse.ArgumentParser(description="Create real-data EWS subfigures.")
    parser.add_argument("--data-root", default=d.data_root)
    parser.add_argument("--real-data-result-root", default=d.real_data_result_root)
    parser.add_argument("--bury-prob-root", default=d.bury_prob_root)
    parser.add_argument("--output-root", default=d.output_root)
    parser.add_argument("--data-real-names", nargs="+", default=["bury_2021_anoxia_tsid_1"])
    parser.add_argument("--signals", nargs="+", default=d.signals)
    parser.add_argument("--pred-dim", type=int, default=0, dest="pred_dim")
    parser.add_argument("--model-dir", default=None, dest="model_dir")
    parser.add_argument("--model-input", choices=["raw", "detrended"], default="detrended",
                        dest="model_input")
    parser.add_argument("--model-detrend-method", default="Lowess", dest="model_detrend_method")
    parser.add_argument("--sample-window-step", type=int, default=1, dest="sample_window_step")
    parser.add_argument("--sampling-t", type=float, default=0.1, dest="sampling_t")
    parser.add_argument("--no-save-csv", action="store_true", dest="no_save_csv")
    parser.add_argument("--device", default=None,
                        help="torch device of the g(x) sweep (default: the card)")
    ns = parser.parse_args(argv)
    args = default_args(**vars(ns))
    unknown = [s for s in args.signals if s not in VALID_SIGNALS]
    if unknown:
        raise ValueError(f"Unknown signals {unknown}. Valid signals: {sorted(VALID_SIGNALS)}")
    for name in ns.data_real_names:
        run_one(name, args)


if __name__ == "__main__":
    main()
