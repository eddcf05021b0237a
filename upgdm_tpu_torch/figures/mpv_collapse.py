"""MPV-collapse statistics tables (the paper's statistical summary).

Counterpart of ``upgdm_tpu/figures/mpv_collapse.py``: sweeps every simulated
trajectory x topology x trend, locates the raw-state transition, pulls
gx-MPV via ``uncertainty_ews(uncertainty_method='gx')`` on ``--device``
(default: the card), computes baseline/min MPV drops, lead times and
trailing-slope metrics, and writes per-sample CSV + mean±std summary tables
(+ optional check plots and relation figures, rendered when matplotlib is
installed; the tables are written without it).
"""
from __future__ import annotations

import argparse
import csv
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..eval.uncertainty import uncertainty_ews
from .common import DATASETS, EWS_ROOT, OUTPUT_ROOT, SOURCE_ROOT, TRENDS, can_render

TRANSITION_EDGE_FRACTION = 0.10
MIN_TRANSITION_WINDOW = 10
SIS_THRESHOLD = 1e-2
DEFAULT_EXCLUDE_ETA = ("0.5",)
BASELINE_FRACTION_RANGE = (0.01, 0.20)
TOPOLOGY_TYPES = ("BA", "ER", "SW")
TOPOLOGY_TYPE_NAMES = {"BA": "barabasi_albert", "ER": "erdos_renyi", "SW": "small-world"}
METRICS = (
    "pre_transition_drop_percent",
    "global_drop_percent",
    "lead_time",
    "min_slope_before_transition",
    "min_slope_global",
    "slope_lead_time",
)
# One display CSV per metric + what it measures (used in the markdown summary).
METRIC_DESCRIPTIONS = {
    "pre_transition_drop_percent":
        "MPV drop before the raw-state transition, relative to the early "
        "pre-transition baseline (%).",
    "global_drop_percent":
        "Largest MPV drop over the whole trajectory, relative to the early "
        "pre-transition baseline (%).",
    "lead_time":
        "Time difference between the raw-state transition and the global MPV "
        "minimum; positive values mean early warning.",
    "min_slope_before_transition":
        "Minimum trailing MPV local slope before the raw-state transition.",
    "min_slope_global":
        "Minimum trailing MPV local slope over the whole trajectory.",
    "slope_lead_time":
        "Time difference between the raw-state transition and the global "
        "minimum trailing MPV local slope.",
}
COUNT_TABLE = "mpv_collapse_n_valid.csv"
SAMPLE_FIELDS = (
    "dynamic_type", "topology_type", "topology", "trend", "data_file",
    "transition_time", "is_transition", "skip_reason", "baseline_mpv",
    "min_mpv_before_transition", "min_mpv_global", "pre_transition_drop_percent",
    "global_drop_percent", "global_min_mpv_time", "lead_time",
    "min_slope_before_transition", "min_slope_global", "slope_lead_time",
    "mpv_cache_path", "check_plot_path",
)

__all__ = [
    "locate_transition",
    "compute_local_slopes",
    "slope_metrics_from_mpv",
    "metric_row_from_mpv",
    "summarize_metric",
    "build_summary_rows",
    "iter_data_files",
    "main",
]


def as_float_or_nan(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return np.nan


def parse_eta(path: Path) -> str:
    m = re.search(r"eta([0-9.]+)", Path(path).name)
    return m.group(1).rstrip(".") if m else ""


def parse_trend(path: Path) -> str:
    name = Path(path).name
    if "increase" in name:
        return "increase"
    if "decrease" in name:
        return "decrease"
    return ""


def topology_type_from_name(topology: str) -> str:
    for key, prefix in TOPOLOGY_TYPE_NAMES.items():
        if topology.startswith(prefix):
            return key
    return ""


def iter_data_files(source_root, dynamics, trends, topologies=None, topology_types=None,
                    include_eta=None, exclude_eta=None):
    """Every (dynamic, topology, trend, eta, file) tuple under the dataset tree."""
    include_eta = set(include_eta or [])
    exclude_eta = set(exclude_eta or [])
    topology_set = set(topologies or [])
    topology_type_set = set(topology_types or [])
    for dynamic_type in dynamics:
        dynamic_root = Path(source_root) / f"spdata_sde_{dynamic_type}"
        if not dynamic_root.exists():
            continue
        for topology_dir in sorted(p for p in dynamic_root.iterdir() if p.is_dir()):
            topology_type = topology_type_from_name(topology_dir.name)
            if not topology_type:
                continue
            if topology_set and topology_dir.name not in topology_set:
                continue
            if topology_type_set and topology_type not in topology_type_set:
                continue
            for data_file in sorted(topology_dir.glob("*.pt")):
                trend = parse_trend(data_file)
                eta = parse_eta(data_file)
                if trend not in trends:
                    continue
                if include_eta and eta not in include_eta:
                    continue
                if eta in exclude_eta:
                    continue
                yield dynamic_type, topology_type, topology_dir.name, trend, eta, data_file


def load_raw_state(data_file):
    from ..utils.io import load_pt

    record = load_pt(data_file)
    if not isinstance(record, dict) or "ys_dynamic" not in record or "ts_dynamic" not in record:
        raise ValueError(f"{data_file} must contain ys_dynamic and ts_dynamic.")
    ys = np.asarray(record["ys_dynamic"], np.float32)
    ts = np.asarray(record["ts_dynamic"], np.float32)
    if ys.ndim != 2:
        raise ValueError(f"{data_file} ys_dynamic must have shape [T, Node], got {ys.shape}.")
    return ts, ys.mean(axis=1)


def _rolling_means(values, width):
    """Full-window trailing means, one per start index.  Rows of
    ``sliding_window_view`` are contiguous slices of the base buffer, so the
    per-row pairwise reduction is bit-identical to ``np.mean`` of each slice."""
    return np.lib.stride_tricks.sliding_window_view(values, width).mean(axis=-1)


def _first_sis_crossing(state_mean, trend):
    """SIS: index where the smoothed infection level first crosses the
    endemic threshold (direction set by the control-parameter trend)."""
    n = len(state_mean)
    width = min(10, n)
    smoothed = _rolling_means(state_mean, width)[: n - width]
    crossed = smoothed > SIS_THRESHOLD if trend == "increase" else smoothed < SIS_THRESHOLD
    if crossed.any():
        return int(np.argmax(crossed)), "sis_threshold"
    # no crossing anywhere: fall back to the largest single-step jump
    return int(np.argmax(np.abs(np.diff(state_mean)))), "sis_max_diff_fallback"


def _steepest_lagged_change(state_mean):
    """Non-SIS: index maximising |s[i+w] - s[i]| / w, i.e. the steepest mean
    state change over a fixed lag."""
    n = len(state_mean)
    lag = min(10, n - 1)
    rate = np.abs(state_mean[lag:] - state_mean[:-lag]) / lag
    if rate.size == 0:
        return None, None
    return int(np.argmax(rate)), "max_window_change"


def locate_transition(time, state_mean, dynamic_type, trend) -> dict:
    """Raw-state transition locator: for SIS the rolling-mean threshold
    crossing, otherwise the maximum lagged state change."""
    time = np.asarray(time, float)
    state_mean = np.asarray(state_mean, float)
    n = len(state_mean)
    if n < 2 * MIN_TRANSITION_WINDOW + 1:
        return {"is_transition": False, "skip_reason": "too_short"}

    if dynamic_type == "SIS":
        idx, method = _first_sis_crossing(state_mean, trend)
    else:
        idx, method = _steepest_lagged_change(state_mean)
        if idx is None:
            return {"is_transition": False, "skip_reason": "too_short_for_change_score"}

    # magnitude of the jump: mean level in a context window either side of idx
    half = max(MIN_TRANSITION_WINDOW, min(n // 20, 100))
    pre = state_mean[max(0, idx - half) : idx]
    post = state_mean[idx : idx + half]
    pre_mean = float(np.nanmean(pre)) if pre.size else np.nan
    post_mean = float(np.nanmean(post)) if post.size else np.nan
    jump = abs(post_mean - pre_mean) if np.isfinite(pre_mean) and np.isfinite(post_mean) else np.nan
    span = float(np.nanmax(state_mean) - np.nanmin(state_mean))
    return {
        "is_transition": True,
        "skip_reason": "",
        "transition_time": float(time[idx]),
        "transition_index": idx,
        "transition_method": method,
        "state_change": jump,
        "state_change_ratio": jump / span if span > 0 and np.isfinite(jump) else np.nan,
    }


def _ols_slope(x, y):
    """Least-squares slope of y on x; None when degenerate (<3 finite points
    or zero spread in x)."""
    ok = np.isfinite(x) & np.isfinite(y)
    if ok.sum() < 3:
        return None
    x, y = x[ok], y[ok]
    xc = x - np.mean(x)
    sxx = np.sum(xc * xc)
    if sxx <= 0:
        return None
    return float(np.sum(xc * (y - np.mean(y))) / sxx)


def compute_local_slopes(time_points, values, window_points):
    """Trailing-window OLS slopes, stamped at each window's right edge, as
    one batched rolling regression: ``sliding_window_view`` rows alias
    contiguous slices, so the row-wise reductions reproduce the per-window
    math bit for bit."""
    time_points = np.asarray(time_points, float)
    values = np.asarray(values, float)
    W = max(3, min(int(window_points), len(values)))
    if len(values) < W:
        return np.asarray([], float), np.asarray([], float)

    X = np.lib.stride_tricks.sliding_window_view(time_points, W)  # [m, W]
    Y = np.lib.stride_tricks.sliding_window_view(values, W)
    clean = np.isfinite(X).all(axis=1) & np.isfinite(Y).all(axis=1)

    # batched OLS over the all-finite windows (the common case)
    Xc = X - X.mean(axis=1, keepdims=True)
    sxx = (Xc * Xc).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        sxy = (Xc * (Y - Y.mean(axis=1, keepdims=True))).sum(axis=1)
        batched = sxy / sxx
    keep = clean & (sxx > 0)
    out = np.where(keep, batched, np.nan)

    # windows with gaps: rank-deficient per-row math above is wrong for them,
    # so redo those few with the masked scalar regression
    for i in np.flatnonzero(~clean):
        s = _ols_slope(X[i], Y[i])
        if s is not None:
            out[i] = s
    kept = np.isfinite(out)
    return time_points[W - 1 :][kept].astype(float), out[kept]


def slope_metrics_from_mpv(slope_times, slopes, transition_time) -> dict:
    """Minimum trailing slope before the transition and overall, with its
    time and the lead of the overall minimum."""
    slope_times = np.asarray(slope_times, float)
    slopes = np.asarray(slopes, float)
    finite = np.isfinite(slope_times) & np.isfinite(slopes)
    slope_times, slopes = slope_times[finite], slopes[finite]
    if len(slopes) < 1:
        return {}
    pre = np.flatnonzero(slope_times < transition_time)
    if len(pre):
        i = int(pre[int(np.nanargmin(slopes[pre]))])
        min_pre, min_pre_time = float(slopes[i]), float(slope_times[i])
    else:
        min_pre = min_pre_time = np.nan
    gi = int(np.nanargmin(slopes))
    return {
        "min_slope_before_transition": min_pre,
        "min_slope_before_transition_time": min_pre_time,
        "min_slope_global": float(slopes[gi]),
        "min_slope_global_time": float(slope_times[gi]),
        "slope_lead_time": float(transition_time - float(slope_times[gi])),
    }


def _fractional_span(n, fractions):
    """Half-open index range covering the given fraction band of n points
    (floor/ceil bounds, at least one point)."""
    lo = int(np.floor(n * fractions[0]))
    hi = max(lo + 1, min(int(np.ceil(n * fractions[1])), n))
    return lo, hi


def _drop_percent(baseline, value):
    return 100.0 * (baseline - value) / baseline


def metric_row_from_mpv(time_points, mpv_values, transition_time, slope_window_points=None) -> dict:
    """Baseline / MPV-drop / lead-time metrics for one trajectory: baseline
    = mean MPV over an early fraction band of the pre-transition scan; drops
    in % of baseline; lead time = transition minus global-minimum time."""
    t = np.asarray(time_points, float)
    mpv = np.asarray(mpv_values, float)
    ok = np.isfinite(t) & np.isfinite(mpv)
    t, mpv = t[ok], mpv[ok]
    if mpv.size < 3:
        return {"skip_reason": "too_few_mpv_points"}

    pre = np.flatnonzero(t < transition_time)
    if pre.size < 3:
        return {"skip_reason": "too_few_pre_transition_mpv_points"}

    lo, hi = _fractional_span(pre.size, BASELINE_FRACTION_RANGE)
    baseline = float(np.nanmean(mpv[pre[lo:hi]]))
    if not (np.isfinite(baseline) and baseline > 0):
        return {"skip_reason": "invalid_baseline_mpv"}

    i_pre = int(pre[int(np.nanargmin(mpv[pre]))])   # deepest pre-transition dip
    i_glob = int(np.nanargmin(mpv))                 # deepest dip anywhere
    row = {
        "baseline_mpv": baseline,
        "baseline_start_time": float(t[pre[lo]]),
        "baseline_end_time": float(t[pre[hi - 1]]),
        "min_mpv_before_transition": float(mpv[i_pre]),
        "min_mpv_before_transition_time": float(t[i_pre]),
        "min_mpv_global": float(mpv[i_glob]),
        "pre_transition_drop_percent": _drop_percent(baseline, float(mpv[i_pre])),
        "global_drop_percent": _drop_percent(baseline, float(mpv[i_glob])),
        "global_min_mpv_time": float(t[i_glob]),
        "lead_time": float(transition_time - float(t[i_glob])),
        "skip_reason": "",
    }
    if slope_window_points is not None:
        slope_times, slopes = compute_local_slopes(t, mpv, slope_window_points)
        row.update(slope_metrics_from_mpv(slope_times, slopes, transition_time))
        row["slope_times"] = slope_times
        row["slopes"] = slopes
    return row


def summarize_metric(values) -> dict:
    arr = np.asarray([v for v in values if np.isfinite(v)], float)
    if len(arr) == 0:
        return {"n_valid": 0, "mean": np.nan, "std": np.nan, "median": np.nan,
                "q25": np.nan, "q75": np.nan}
    return {
        "n_valid": int(len(arr)),
        "mean": float(np.nanmean(arr)),
        "std": float(np.nanstd(arr, ddof=1)) if len(arr) > 1 else 0.0,
        "median": float(np.nanmedian(arr)),
        "q25": float(np.nanpercentile(arr, 25)),
        "q75": float(np.nanpercentile(arr, 75)),
    }


def build_summary_rows(sample_rows) -> list:
    valid = [r for r in sample_rows if str(r.get("skip_reason", "")) == ""]
    grouped = defaultdict(list)
    for row in valid:
        grouped[(row.get("dynamic_type", ""), row.get("topology_type", ""), row.get("trend", ""))].append(row)
    out = []
    for (dynamic_type, topology_type, trend), rows in sorted(grouped.items()):
        for metric in METRICS:
            stats = summarize_metric([as_float_or_nan(r.get(metric)) for r in rows])
            out.append({"dynamic_type": dynamic_type, "topology_type": topology_type,
                        "trend": trend, "metric": metric, **stats})
    return out


def _format(value, digits=2):
    value = as_float_or_nan(value)
    return "NA" if not np.isfinite(value) else f"{value:.{digits}f}"


def build_metric_matrix(summary_rows, metric):
    """mean +/- std matrix per (dynamics x topology-type x trend)."""
    by_key = {(r["dynamic_type"], r["topology_type"], r["trend"], r["metric"]): r
              for r in summary_rows}
    pairs = [(t, tr) for t in TOPOLOGY_TYPES for tr in TRENDS]
    fields = ["dynamic_type"] + [f"{t} | {tr}" for t, tr in pairs]
    dynamics = [d for d in DATASETS if any(r["dynamic_type"] == d for r in summary_rows)]
    suffix = "%" if metric.endswith("percent") else ""
    rows = []
    for d in dynamics:
        out = {"dynamic_type": d}
        for t, tr in pairs:
            key = (d, t, tr, metric)
            if key in by_key and int(by_key[key]["n_valid"]) > 0:
                s = by_key[key]
                out[f"{t} | {tr}"] = f"{_format(s['mean'])}{suffix} +/- {_format(s['std'])}{suffix}"
            else:
                out[f"{t} | {tr}"] = ""
        rows.append(out)
    return fields, rows


def build_count_matrix(summary_rows):
    """n_valid counts per (dynamics x topology-type x trend)."""
    metric = METRICS[0]
    by_key = {(r["dynamic_type"], r["topology_type"], r["trend"], r["metric"]): r
              for r in summary_rows}
    pairs = [(t, tr) for t in TOPOLOGY_TYPES for tr in TRENDS]
    fields = ["dynamic_type"] + [f"{t} | {tr}" for t, tr in pairs]
    dynamics = [d for d in DATASETS if any(r["dynamic_type"] == d for r in summary_rows)]
    rows = []
    for d in dynamics:
        out = {"dynamic_type": d}
        for t, tr in pairs:
            key = (d, t, tr, metric)
            out[f"{t} | {tr}"] = int(by_key[key]["n_valid"]) if key in by_key else ""
        rows.append(out)
    return fields, rows


def write_markdown_summary(path, summary_rows, sample_rows):
    """The markdown README of the table set."""
    valid = sum(1 for r in sample_rows if str(r.get("skip_reason", "")) == "")
    lines = [
        "# MPV Collapse Summary",
        "",
        "Purpose: these tables support the reviewer-requested statistical "
        "summary of MPV collapse across network dynamics and topologies.",
        "Rows are dynamical systems; columns are topology classes (BA, ER, SW) "
        "and control-parameter trend. Noise levels are used only for data "
        "filtering and are not reported as table columns.",
        "Topology classes aggregate all matching graph instances: "
        "BA = barabasi_albert, ER = erdos_renyi, SW = small-world.",
        "",
        f"Total scanned samples: {len(sample_rows)}",
        f"Valid transition samples with MPV metrics: {valid}",
        "",
        "## Manuscript-facing CSV tables",
        "",
        f"- `{COUNT_TABLE}`: number of valid transition-bearing samples used "
        "in each dynamical-system/topology-class/trend cell.",
    ]
    for metric, description in METRIC_DESCRIPTIONS.items():
        lines.append(f"- `mpv_collapse_{metric}.csv`: {description}")
    lines += [
        "",
        "Each metric display cell is formatted as `mean +/- SD`; percentage "
        "signs denote MPV reduction percentages.",
        "",
        "## Source-data table",
        "",
        "`mpv_collapse_samples.csv` contains one row per scanned data file for "
        "audit and reproducibility. Rows with non-empty `skip_reason` are "
        "excluded from summary statistics.",
        "`mpv_collapse_summary.csv` contains the numeric long-format source "
        "table behind the display CSV files.",
        "",
        "Positive lead_time means the global MPV minimum precedes the "
        "raw-state transition time.",
    ]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def write_csv(path, rows, fields):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(fields))
        writer.writeheader()
        for row in rows:
            writer.writerow({field: row.get(field, "") for field in fields})


def _empty_row(dynamic_type, topology_type, topology, trend, data_file, reason):
    row = {f: "" for f in SAMPLE_FIELDS}
    row.update(dynamic_type=dynamic_type, topology_type=topology_type, topology=topology,
               trend=trend, data_file=str(data_file), is_transition=False, skip_reason=reason)
    return row


def save_check_plot(path, time, state_mean, mpv_time, mpv_values, transition,
                    metrics, title: str) -> None:
    """3-panel diagnostic: state + MPV (baseline window, minima) + slopes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    time = np.asarray(time, float)
    state_mean = np.asarray(state_mean, float)
    mpv_time = np.asarray(mpv_time, float)
    mpv_values = np.asarray(mpv_values, float)
    transition_time = float(transition["transition_time"])
    slope_times = np.asarray(metrics.get("slope_times", []), float)
    slopes = np.asarray(metrics.get("slopes", []), float)

    fig, axs = plt.subplots(3, 1, figsize=(7.0, 5.4), sharex=True,
                            gridspec_kw={"hspace": 0.12})
    axs[0].plot(time, state_mean, color="#0F4D92", linewidth=1.0)
    axs[0].axvline(transition_time, color="#B64342", linestyle="--", linewidth=0.9,
                   label="Transition")
    axs[0].set_ylabel("State")
    axs[0].set_title(title, fontsize=8.5)
    axs[0].legend(loc="best", frameon=False, fontsize=6.8)

    axs[1].plot(mpv_time, mpv_values, color="#B64342", linewidth=1.0)
    axs[1].axvline(transition_time, color="#B64342", linestyle="--", linewidth=0.9)
    axs[1].axhline(float(metrics["baseline_mpv"]), color="#4D4D4D", linestyle=":",
                   linewidth=0.9, label="Baseline MPV")
    axs[1].axvspan(float(metrics["baseline_start_time"]), float(metrics["baseline_end_time"]),
                   color="#D8D8D8", alpha=0.25, linewidth=0, label="Baseline Window")
    axs[1].scatter([float(metrics["min_mpv_before_transition_time"])],
                   [float(metrics["min_mpv_before_transition"])],
                   color="#E28E2C", s=18, zorder=3, label="Pre-transition Min")
    axs[1].scatter([float(metrics["global_min_mpv_time"])],
                   [float(metrics["min_mpv_global"])],
                   color="#42949E", s=18, zorder=3, label="Global Min")
    axs[1].set_ylabel("MPV")
    axs[1].legend(loc="best", frameon=False, fontsize=6.8, ncol=2)

    axs[2].plot(slope_times, slopes, color="#9A4D8E", linewidth=1.0)
    axs[2].axhline(0, color="#767676", linestyle=":", linewidth=0.8)
    axs[2].axvline(transition_time, color="#B64342", linestyle="--", linewidth=0.9)
    if np.isfinite(as_float_or_nan(metrics.get("min_slope_global_time"))):
        axs[2].scatter([float(metrics["min_slope_global_time"])],
                       [float(metrics["min_slope_global"])],
                       color="#42949E", s=18, zorder=3)
    axs[2].set_ylabel("MPV Slope")
    axs[2].set_xlabel("Time")
    for ax in axs:
        ax.set_xlim(float(np.nanmin(time)), float(np.nanmax(time)))
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        ax.tick_params(labelsize=6.8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=220, bbox_inches="tight")
    plt.close(fig)


def analyze_file(args, dynamic_type, topology_type, topology, trend, eta, data_file) -> dict:
    """One trajectory's row. Any failure of the MPV call becomes a row with
    ``skip_reason="mpv_error:..."``, as in the JAX package."""
    try:
        time, state_mean = load_raw_state(data_file)
        transition = locate_transition(time, state_mean, dynamic_type, trend)
    except Exception as exc:
        return _empty_row(dynamic_type, topology_type, topology, trend, data_file,
                          f"raw_error:{exc}")
    row = _empty_row(dynamic_type, topology_type, topology, trend, data_file,
                     transition.get("skip_reason", ""))
    row.update(transition_time=transition.get("transition_time", ""),
               is_transition=bool(transition.get("is_transition", False)))
    if not transition.get("is_transition", False):
        return row
    model_dir = Path(args.ews_root) / "model_compare" / args.model_name / dynamic_type
    if not model_dir.exists():
        row.update(is_transition=False, skip_reason=f"missing_model_dir:{model_dir}")
        return row
    if args.dry_run:
        row.update(skip_reason="dry_run_no_model_call")
        return row
    try:
        gx_cache_dir = Path(args.ews_root) / "statistics_dataset" / dynamic_type / topology
        result = uncertainty_ews(
            model_save_file=model_dir, data_file=data_file, dynamic_type=dynamic_type,
            cache_path=model_dir, nsdiff_g_path=gx_cache_dir, uncertainty_method="gx",
            pred_dim=args.pred_dim, force_recompute=args.force_recompute,
            device=getattr(args, "device", None),
        )
        slope_window_points = max(3, int(round(float(result["windows"]) * args.slope_window_ratio)))
        metrics = metric_row_from_mpv(
            result["time_points"], result["ews"],
            transition_time=float(transition["transition_time"]),
            slope_window_points=slope_window_points,
        )
    except Exception as exc:
        row.update(is_transition=False, skip_reason=f"mpv_error:{exc}")
        return row
    if metrics.get("skip_reason"):
        row.update(is_transition=False, skip_reason=metrics["skip_reason"])
        return row
    if getattr(args, "plot_checks", False) and can_render():
        plot_path = (
            Path(getattr(args, "check_plot_dir", None) or Path(args.output_dir) / "mpv_collapse_checks")
            / dynamic_type / topology_type / topology / f"{data_file.stem}_mpv_check.png"
        )
        save_check_plot(
            plot_path, time, state_mean, result["time_points"], result["ews"],
            transition, metrics,
            title=f"{dynamic_type} | {topology_type} | {topology} | {trend} | {data_file.name}",
        )
        row["check_plot_path"] = str(plot_path)
    metrics.pop("slope_times", None)
    metrics.pop("slopes", None)
    row["mpv_time"] = np.asarray(result["time_points"], float)
    row["mpv_values"] = np.asarray(result["ews"], float)
    row.update(metrics)
    row.update(skip_reason="", mpv_cache_path=result.get("cache_path", ""))
    return row


def summarize_xy_records(records, x_key, y_key):
    """Group y by x and compute mean±std lead time."""
    grouped = defaultdict(list)
    for r in records:
        x = as_float_or_nan(r.get(x_key))
        y = as_float_or_nan(r.get(y_key))
        if np.isfinite(x) and np.isfinite(y):
            grouped[x].append(y)
    rows = []
    for x in sorted(grouped):
        vals = np.asarray(grouped[x], float)
        rows.append({
            x_key: x,
            "mean_lead_time": float(np.nanmean(vals)),
            "std_lead_time": float(np.nanstd(vals, ddof=1)) if len(vals) > 1 else 0.0,
            "n_valid": int(len(vals)),
        })
    return rows


def threshold_records_from_runtime(runtime_records):
    """MPV-drop-threshold -> detection lead-time records."""
    max_drop_by_group = defaultdict(float)
    for r in runtime_records:
        if str(r.get("skip_reason", "")) != "" or "mpv_values" not in r:
            continue
        baseline = as_float_or_nan(r.get("baseline_mpv"))
        if not np.isfinite(baseline) or baseline <= 0:
            continue
        drops = (baseline - r["mpv_values"]) / baseline
        if len(drops) == 0 or not np.isfinite(drops).any():
            continue
        group = (r["dynamic_type"], r["trend"])
        max_drop_by_group[group] = max(max_drop_by_group[group], float(np.nanmax(drops)))
    thresholds_by_group = {
        g: np.linspace(0.1, md, 8) for g, md in max_drop_by_group.items() if md >= 0.1
    }
    records = []
    for r in runtime_records:
        if str(r.get("skip_reason", "")) != "" or "mpv_values" not in r or "mpv_time" not in r:
            continue
        group = (r["dynamic_type"], r["trend"])
        baseline = as_float_or_nan(r.get("baseline_mpv"))
        if not np.isfinite(baseline) or baseline <= 0:
            continue
        drops = (baseline - r["mpv_values"]) / baseline
        for threshold in thresholds_by_group.get(group, []):
            hits = np.flatnonzero(drops >= threshold)
            if len(hits) == 0:
                continue
            hit_time = float(r["mpv_time"][int(hits[0])])
            records.append({
                "dynamic_type": r["dynamic_type"], "trend": r["trend"],
                "threshold": float(threshold),
                "lead_time": float(r["transition_time"] - hit_time),
            })
    return records


def slope_relation_records(sample_rows):
    """(min global slope, slope lead time) per valid sample."""
    records = []
    for row in sample_rows:
        if str(row.get("skip_reason", "")) != "":
            continue
        slope = as_float_or_nan(row.get("min_slope_global"))
        lead = as_float_or_nan(row.get("slope_lead_time"))
        if np.isfinite(slope) and np.isfinite(lead):
            records.append({
                "dynamic_type": row.get("dynamic_type", ""),
                "trend": row.get("trend", ""),
                "min_slope_global": slope,
                "lead_time": lead,
            })
    return records


def write_relation_csv(path, records, x_key):
    grouped = defaultdict(list)
    for r in records:
        grouped[(r["dynamic_type"], r["trend"])].append(r)
    rows = []
    for (dynamic_type, trend), recs in sorted(grouped.items()):
        for row in summarize_xy_records(recs, x_key, "lead_time"):
            rows.append({"dynamic_type": dynamic_type, "trend": trend, **row})
    write_csv(path, rows, ["dynamic_type", "trend", x_key, "mean_lead_time",
                           "std_lead_time", "n_valid"])


def plot_six_panel_relation(records, x_key, y_key, output_path, xlabel, ylabel):
    """2x3 mean±std relation panels per (trend x dynamics)."""
    import string

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 3, figsize=(7.1, 4.6),
                            gridspec_kw={"hspace": 0.36, "wspace": 0.32})
    panel_order = [(d, t) for t in TRENDS for d in DATASETS]
    labels = string.ascii_lowercase[:6]
    for i, (ax, (dynamic_type, trend)) in enumerate(zip(axs.ravel(), panel_order)):
        panel = [r for r in records
                 if r.get("dynamic_type") == dynamic_type and r.get("trend") == trend]
        if panel:
            rows = summarize_xy_records(panel, x_key, y_key)
            x = np.asarray([r[x_key] for r in rows], float)
            y = np.asarray([r["mean_lead_time"] for r in rows], float)
            sd = np.asarray([r["std_lead_time"] for r in rows], float)
            valid = np.isfinite(x) & np.isfinite(y) & np.isfinite(sd)
            x, y, sd = x[valid], y[valid], sd[valid]
            order = np.argsort(x)
            x, y, sd = x[order], y[order], sd[order]
            if len(x):
                ax.fill_between(x, y - sd, y + sd, color="#0F4D92", alpha=0.16,
                                linewidth=0)
                ax.plot(x, y, color="#0F4D92", linewidth=1.1, marker="o", markersize=3)
                ax.axhline(0, color="#767676", linestyle=":", linewidth=0.7)
                if x_key == "min_slope_global":
                    ax.ticklabel_format(axis="x", style="sci", scilimits=(-2, 2))
        else:
            ax.text(0.5, 0.5, "No data", ha="center", va="center",
                    transform=ax.transAxes, color="#767676", fontsize=7)
        ax.set_title(str(dynamic_type), pad=4, fontsize=8)
        ax.text(-0.15, 1.10, labels[i], transform=ax.transAxes, ha="left", va="top",
                fontsize=9.2, fontweight="bold", clip_on=False)
        ax.set_xlabel(xlabel, fontsize=8)
        ax.set_ylabel(ylabel, fontsize=8)
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
        ax.tick_params(labelsize=6.6)
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def summary_fields():
    return ["dynamic_type", "topology_type", "trend", "metric", "n_valid", "mean",
            "std", "median", "q25", "q75"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="MPV collapse summary tables")
    parser.add_argument("--ews-root", type=Path, default=EWS_ROOT)
    parser.add_argument("--source-root", type=Path, default=SOURCE_ROOT)
    parser.add_argument("--output-dir", type=Path, default=OUTPUT_ROOT / "mpv_collapse")
    parser.add_argument("--model-name", default="NsDiff")
    parser.add_argument("--dynamics", nargs="+", default=list(DATASETS))
    parser.add_argument("--trends", nargs="+", default=list(TRENDS))
    parser.add_argument("--topology", nargs="+", default=None)
    parser.add_argument("--topology-type", nargs="+", default=None)
    parser.add_argument("--eta", nargs="+", default=None)
    parser.add_argument("--exclude-eta", nargs="+", default=list(DEFAULT_EXCLUDE_ETA))
    parser.add_argument("--pred-dim", type=int, default=0)
    parser.add_argument("--slope-window-ratio", type=float, default=0.25)
    parser.add_argument("--force-recompute", action="store_true")
    parser.add_argument("--plot-checks", action="store_true")
    parser.add_argument("--check-plot-dir", default=None)
    parser.add_argument("--plot-summary-relations", action="store_true")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--max-files", type=int, default=None)
    parser.add_argument("--samples-csv", default="mpv_collapse_samples.csv")
    parser.add_argument("--summary-csv", default="mpv_collapse_summary.csv")
    parser.add_argument("--summary-md", default="mpv_collapse_summary.md")
    parser.add_argument("--device", default=None,
                        help="device of the gx model (default: the card)")
    args = parser.parse_args(argv)

    files = list(iter_data_files(
        args.source_root, args.dynamics, args.trends, args.topology,
        args.topology_type, args.eta, args.exclude_eta,
    ))
    if args.max_files is not None:
        files = files[: args.max_files]
    sample_rows = [analyze_file(args, *info) for info in files]
    summary_rows = build_summary_rows(sample_rows)
    output_dir = Path(args.output_dir)
    write_csv(output_dir / args.samples_csv, sample_rows, SAMPLE_FIELDS)
    write_csv(output_dir / args.summary_csv, summary_rows, summary_fields())
    for metric in METRICS:
        fields, rows = build_metric_matrix(summary_rows, metric)
        write_csv(output_dir / f"mpv_collapse_{metric}.csv", rows, fields)
    fields, rows = build_count_matrix(summary_rows)
    write_csv(output_dir / COUNT_TABLE, rows, fields)
    write_markdown_summary(output_dir / args.summary_md, summary_rows, sample_rows)
    if args.plot_summary_relations:
        drop_records = threshold_records_from_runtime(sample_rows)
        write_relation_csv(output_dir / "mpv_drop_threshold_lead_time.csv",
                           drop_records, "threshold")
        slope_records = slope_relation_records(sample_rows)
        write_relation_csv(output_dir / "mpv_slope_lead_time.csv",
                           slope_records, "min_slope_global")
        if can_render():
            plot_six_panel_relation(
                drop_records, "threshold", "lead_time",
                output_dir / "mpv_drop_threshold_lead_time.png",
                xlabel="MPV drop threshold", ylabel="Lead time",
            )
            plot_six_panel_relation(
                slope_records, "min_slope_global", "lead_time",
                output_dir / "mpv_slope_lead_time.png",
                xlabel="Minimum MPV local slope", ylabel="Lead time",
            )
    print(f"scanned_files: {len(files)}")
    print(f"valid_rows: {sum(1 for r in sample_rows if str(r.get('skip_reason', '')) == '')}")
    print(f"samples_csv: {output_dir / args.samples_csv}")
    print(f"summary_csv: {output_dir / args.summary_csv}")
    print(f"summary_md: {output_dir / args.summary_md}")


if __name__ == "__main__":
    main()
