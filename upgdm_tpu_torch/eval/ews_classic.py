"""Classic early-warning-signal indicators and detrending, without pandas.

Counterpart of ``upgdm_tpu/eval/ews_classic.py`` (ewstools' conventions):

  - Gaussian detrend: gaussian_filter1d smoother, ``bandwidth`` < 1 taken as a
    proportion of the series length;
  - Lowess detrend: tricube-weighted local linear regression with ``span``
    as the fraction of points per local fit, three robustifying passes;
  - rolling indicators over a trailing window of ``rolling_window`` x len
    points, right-aligned (values defined from the first full window):
    variance, lag-1 autocorrelation, sample entropy (m=1, r=0.2*std).

The card's machine has no pandas: the rolling variance is pandas'
``rolling(w).var()`` restated in Python (its online update, bit for bit), and
``compute_classic_ews`` returns numpy arrays where the JAX package returns
``pd.Series``. Everything here runs
on the host in numpy, as in the JAX package; every other function is the JAX
package's numpy code.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.ndimage import gaussian_filter1d

__all__ = [
    "gaussian_smooth",
    "lowess_smooth",
    "detrend",
    "rolling_variance",
    "rolling_ar1",
    "rolling_sample_entropy",
    "compute_classic_ews",
    "compute_variance_trend",
    "normalize_by_head_mean",
]

_RECOMPUTE = 1000 * np.finfo(float).eps  # rolling_variance's cancellation test


def gaussian_smooth(values: np.ndarray, bandwidth: float = 0.2) -> np.ndarray:
    values = np.asarray(values, float)
    sigma = bandwidth * len(values) if bandwidth < 1 else bandwidth
    return gaussian_filter1d(values, sigma=max(sigma, 1e-9), mode="reflect")


def lowess_smooth(
    values: np.ndarray, span: float = 0.2, times=None, iters: int = 3
) -> np.ndarray:
    """Robustified LOWESS (Cleveland 1979): tricube-weighted local linear
    regression plus ``iters`` bisquare-reweighting passes (the defaults of
    statsmodels' ``lowess``: ``frac=span``, ``it=3``, ``delta=0``); robust
    weights are ``(1 - (r/(6*median|r|))^2)^2`` clipped at 0."""
    y = np.asarray(values, float)
    n = len(y)
    x = np.asarray(times, float) if times is not None else np.arange(n, dtype=float)
    k = max(2, int(np.ceil(span * n)))
    order = np.argsort(x)
    xs, ys = x[order], y[order]

    def fit(delta_w):
        out = np.empty(n)
        for j, xi in enumerate(xs):
            d = np.abs(xs - xi)
            idx = np.argpartition(d, k - 1)[:k]
            dmax = d[idx].max()
            w = (1 - (d[idx] / max(dmax, 1e-12)) ** 3) ** 3
            w = np.clip(w, 0, None) * delta_w[idx]
            xw, yw = xs[idx], ys[idx]
            sw = w.sum()
            if sw <= 1e-12:
                out[j] = ys[j]
                continue
            xm = (w * xw).sum() / sw
            ym = (w * yw).sum() / sw
            cov = (w * (xw - xm) * (yw - ym)).sum()
            var = (w * (xw - xm) ** 2).sum()
            beta = cov / var if var > 1e-12 else 0.0
            out[j] = ym + beta * (xi - xm)
        return out

    delta_w = np.ones(n)
    out = fit(delta_w)
    for _ in range(max(0, int(iters))):
        resid = ys - out
        s = np.median(np.abs(resid))
        if s <= 1e-12:
            break
        delta_w = np.clip(1.0 - (resid / (6.0 * s)) ** 2, 0.0, None) ** 2
        out = fit(delta_w)
    res = np.empty(n)
    res[order] = out
    return res


def detrend(values, method="Gaussian", span=0.2, bandwidth=0.2, times=None):
    """Residuals = values - smooth (NaNs interpolated first)."""
    values = np.asarray(values, float)
    m = str(method).lower()
    if m in {"none", "raw"}:
        return values.copy()
    if np.isnan(values).any():
        good = np.flatnonzero(~np.isnan(values))
        values = np.interp(np.arange(len(values)), good, values[good])
    if m == "gaussian":
        return values - gaussian_smooth(values, bandwidth)
    if m == "lowess":
        return values - lowess_smooth(values, span, times=times)
    raise ValueError(f"Unsupported detrend method: {method}")


def _window_size(n: int, rolling_window: float) -> int:
    w = int(np.floor(rolling_window * n)) if rolling_window < 1 else int(rolling_window)
    return max(2, min(w, n))


def rolling_variance(residuals: np.ndarray, rolling_window: float = 0.5) -> np.ndarray:
    """Sample variance (ddof 1) over trailing windows of w points, NaN before
    the first full window and wherever a window holds a NaN: pandas'
    ``rolling(w).var()`` bit for bit, its online update restated in Python.

    Welford's update with a Kahan-compensated mean, one compensation for the
    values added and one for those removed; each step removes the value
    leaving the window, then adds the new one. Where a removal leaves less
    than 1000 machine epsilons of the sum of squared deviations it had
    (cancellation), the window's remaining values are summed afresh."""
    r = np.asarray(residuals, float)
    n = len(r)
    w = _window_size(n, rolling_window)
    out = np.full(n, np.nan)
    vals = r.tolist()
    nobs, mean, ssq, comp_add, comp_rem = 0, 0.0, 0.0, 0.0, 0.0

    def add(val):
        nonlocal nobs, mean, ssq, comp_add
        if val != val:
            return
        nobs += 1
        prev_mean = mean - comp_add
        y = val - comp_add
        t = y - mean
        comp_add = t + mean - y
        mean = mean + t / nobs
        ssq = ssq + (val - prev_mean) * (val - mean)

    for i in range(n):
        if i >= w:
            val, before = vals[i - w], ssq
            if val == val:
                nobs -= 1
                if nobs:
                    prev_mean = mean - comp_rem
                    y = val - comp_rem
                    t = y - mean
                    comp_rem = t + mean - y
                    mean = mean - t / nobs
                    ssq = ssq - (val - prev_mean) * (val - mean)
                else:
                    mean = ssq = 0.0
            if ssq < _RECOMPUTE * before:
                nobs, mean, ssq, comp_add, comp_rem = 0, 0.0, 0.0, 0.0, 0.0
                for j in range(i - w + 1, i):
                    add(vals[j])
        add(vals[i])
        if i >= w - 1 and nobs >= w:
            out[i] = ssq / (nobs - 1)
    return out


def rolling_ar1(residuals: np.ndarray, rolling_window: float = 0.5) -> np.ndarray:
    """Lag-1 autocorrelation over trailing windows (pandas autocorr semantics)."""
    vals = np.asarray(residuals, float)
    w = _window_size(len(vals), rolling_window)
    out = np.full(len(vals), np.nan)
    for end in range(w, len(vals) + 1):
        seg = vals[end - w : end]
        a, b = seg[:-1], seg[1:]
        sa, sb = a.std(), b.std()
        if sa > 1e-12 and sb > 1e-12:
            out[end - 1] = np.corrcoef(a, b)[0, 1]
    return out


def _sample_entropy(seg: np.ndarray, m: int = 1, r_frac: float = 0.2) -> float:
    """SampEn(m, r=r_frac*std) with Chebyshev distance."""
    n = len(seg)
    r = r_frac * seg.std()
    if r <= 0 or n <= m + 1:
        return np.nan

    def count(mm):
        # templates of length mm: [n-mm+1, mm]
        t = np.lib.stride_tricks.sliding_window_view(seg, mm)
        d = np.max(np.abs(t[:, None, :] - t[None, :, :]), axis=-1)
        iu = np.triu_indices(len(t), k=1)
        return np.count_nonzero(d[iu] <= r)

    B = count(m)
    A = count(m + 1)
    if B == 0 or A == 0:
        return np.nan
    return -np.log(A / B)


def rolling_sample_entropy(
    residuals: np.ndarray, rolling_window: float = 0.5, m: int = 1, r_frac: float = 0.2
) -> np.ndarray:
    r = np.asarray(residuals, float)
    w = _window_size(len(r), rolling_window)
    out = np.full(len(r), np.nan)
    for end in range(w, len(r) + 1):
        out[end - 1] = _sample_entropy(r[end - w : end], m=m, r_frac=r_frac)
    return out


def compute_classic_ews(
    times, values, method="Gaussian", span=0.2, bandwidth=0.2, rolling_window=0.5
) -> Dict[str, np.ndarray]:
    """Variance / AR(1) / sample-entropy over detrended residuals: a dict of
    float64 arrays ``variance``, ``ar1`` and ``sample-entropy-1`` aligned with
    ``times`` (also in the dict), where the JAX package returns ``pd.Series``
    indexed by time."""
    times = np.asarray(times, float)
    residuals = detrend(values, method=method, span=span, bandwidth=bandwidth, times=times)
    return {
        "times": times,
        "variance": rolling_variance(residuals, rolling_window),
        "ar1": rolling_ar1(residuals, rolling_window),
        "sample-entropy-1": rolling_sample_entropy(residuals, rolling_window),
    }


def compute_variance_trend(
    time_points, variance_values, trend_window=40, min_points=5, normalize_time=True
):
    """Rolling OLS slope of a signal over trailing windows."""
    time_points = np.asarray(time_points, float)
    variance_values = np.asarray(variance_values, float)
    if len(time_points) != len(variance_values):
        raise ValueError("time_points and variance_values must have the same length.")
    trend_window = min(int(trend_window), len(variance_values))
    if trend_window < min_points:
        return np.array([]), np.array([])
    trend_times, trend_values = [], []
    for end in range(trend_window, len(variance_values) + 1):
        t = time_points[end - trend_window : end]
        v = variance_values[end - trend_window : end]
        valid = np.isfinite(t) & np.isfinite(v)
        if valid.sum() < min_points:
            continue
        tv, vv = t[valid], v[valid]
        if normalize_time:
            span_t = tv.max() - tv.min()
            if span_t == 0:
                continue
            tv = (tv - tv.min()) / span_t
        slope, _ = np.polyfit(tv, vv, deg=1)
        trend_times.append(time_points[end - 1])
        trend_values.append(slope)
    return np.asarray(trend_times), np.asarray(trend_values)


def normalize_by_head_mean(values, head_points=40):
    """Scale by the mean of the first head_points finite values."""
    values = np.asarray(values, float)
    head = values[: min(head_points, len(values))]
    head = head[np.isfinite(head)]
    if len(head) == 0:
        return values
    scale = np.mean(head)
    if abs(scale) < 1e-12:
        return values
    return values / scale
