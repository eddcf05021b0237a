"""The statistics CSVs read as ``pandas.read_csv`` reads them, without pandas.

The zoo's ``summarize`` and the seed study reduce ``mpv_collapse``'s sample
CSV with pandas in the JAX package. The card's machine has no pandas, so this
module restates the part they use:

- ``read_csv``: each column typed as pandas infers it (integers, floats,
  booleans, else strings), its default missing-value markers read as missing;
- numbers parsed as pandas' C parser parses them (``precise_xstrtod``: up to
  17 digits summed in a double, then scaled by a power of ten), which is not
  always the correctly rounded ``float()``;
- ``to_numeric`` (``errors="coerce"``), ``median``, ``positive_frac``,
  ``value_counts`` (first appearance, then a stable sort by count) and
  ``group_rows`` (sorted keys, rows with a missing key dropped).
"""
from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

__all__ = ["NA_VALUES", "parse_float", "read_csv", "is_na", "is_true", "as_str",
           "to_numeric", "median", "positive_frac", "value_counts", "group_rows"]

# pandas' default markers of a missing cell (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
TRUE_VALUES = frozenset({"True", "TRUE", "true"})
FALSE_VALUES = frozenset({"False", "FALSE", "false"})
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(text: str):
    """(value, is_int) as pandas' ``precise_xstrtod`` reads ``text``, or None
    when it is not a number."""
    s = text.strip()
    inf = _INF.get(s.lower())
    if inf is not None:
        return inf, False
    p, n = 0, len(s)
    negative = False
    if p < n and s[p] in "+-":
        negative = s[p] == "-"
        p += 1
    number, exponent, digits, is_int = 0.0, 0, 0, True
    while p < n and s[p].isdigit() and s[p].isascii():
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        is_int = False
        p += 1
        decimals = 0
        while digits < _MAX_DIGITS and p < n and s[p].isdigit() and s[p].isascii():
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and s[p].isdigit() and s[p].isascii():
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        is_int = False
        q = p + 1
        neg_exp = False
        if q < n and s[q] in "+-":
            neg_exp = s[q] == "-"
            q += 1
        e_digits, e = 0, 0
        while e_digits < _MAX_DIGITS and q < n and s[q].isdigit() and s[q].isascii():
            e = e * 10 + (ord(s[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if neg_exp else e
            p = q
    if p != n:
        return None
    if exponent > 308:
        return None
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        number = 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return number, is_int


def _typed_column(cells):
    """One column's cells typed as pandas infers them: all numbers (ints when
    every one is an integer and none is missing), else all booleans, else
    strings; a missing cell is NaN in a numeric column, None otherwise."""
    present = [c for c in cells if c not in NA_VALUES]
    parsed = [parse_float(c) for c in present]
    if all(v is not None for v in parsed):
        if present and len(present) == len(cells) and all(i for _, i in parsed):
            return [int(c) for c in cells]
        return [math.nan if c in NA_VALUES else parse_float(c)[0] for c in cells]
    if all(c in TRUE_VALUES or c in FALSE_VALUES for c in present):
        return [None if c in NA_VALUES else c in TRUE_VALUES for c in cells]
    return [None if c in NA_VALUES else c for c in cells]


def read_csv(path) -> dict:
    """{column: list of typed cells} of a CSV with a header row."""
    with open(Path(path), newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], rows[1:]
    return {name: _typed_column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def is_na(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def is_true(value) -> bool:
    """pandas' ``cell == True``: a boolean True or a number equal to 1."""
    return not isinstance(value, str) and not is_na(value) and value == True  # noqa: E712


def as_str(value) -> str:
    """pandas' ``fillna("").astype(str)`` of one cell."""
    if is_na(value):
        return ""
    if isinstance(value, float):
        return repr(value)
    return str(value)


def to_numeric(values) -> np.ndarray:
    """``pd.to_numeric(values, errors="coerce").dropna()`` as float64."""
    out = []
    for v in values:
        if isinstance(v, str):
            parsed = parse_float(v)
            v = math.nan if parsed is None else parsed[0]
        elif v is None:
            v = math.nan
        out.append(float(v))
    arr = np.asarray(out, np.float64)
    return arr[~np.isnan(arr)]


def median(values: np.ndarray) -> float:
    """pandas' median of a Series with the missing values dropped (NaN when
    empty)."""
    return float(np.median(values)) if len(values) else math.nan


def positive_frac(values: np.ndarray) -> float:
    """pandas' ``(series > 0).mean()`` (NaN when empty)."""
    return float(np.mean(values > 0)) if len(values) else math.nan


def value_counts(values) -> dict:
    """pandas' ``value_counts().to_dict()``: counts in order of first
    appearance, then sorted by count, largest first, ties kept in order."""
    counts = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def group_rows(columns: dict, keys, rows=None) -> dict:
    """{key or key tuple: row indices} as ``groupby(keys)`` makes them: keys
    sorted, rows with a missing key left out. ``rows`` restricts the rows."""
    rows = range(len(next(iter(columns.values())))) if rows is None else rows
    single = isinstance(keys, str)
    cols = [columns[keys]] if single else [columns[k] for k in keys]
    groups = {}
    for i in rows:
        key = tuple(c[i] for c in cols)
        if any(is_na(k) for k in key):
            continue
        groups.setdefault(key[0] if single else key, []).append(i)
    return dict(sorted(groups.items()))
