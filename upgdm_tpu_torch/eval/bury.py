"""Bury et al. (PNAS 2021) deep-learning EWS baseline, in torch.

Counterpart of ``upgdm_tpu/eval/bury.py``, without TensorFlow, h5py or
pandas. The released classifiers are Keras ``.keras`` zip archives holding
``config.json`` (a Sequential) and ``model.weights.h5``. Here:

  - ``BuryClassifier`` is an ``nn.Module`` built from ``config.json``. It
    takes the layer classes and options the tracked archives use and no
    others: ``InputLayer``; ``Conv1D`` (channels last, stride 1, dilation 1,
    one group, padding ``same`` or ``valid``); ``Dropout`` (off at
    inference); ``MaxPooling1D`` (``valid``); ``LSTM`` (tanh, sigmoid
    recurrent activation, forward, not stateful, no returned state); and
    ``Dense``. Activations are ``linear``, ``relu``, ``tanh``, ``sigmoid``
    and ``softmax``. Any other class or option raises ``NotImplementedError``
    (``hard_sigmoid``, ``go_backwards``, ``causal`` padding, ...).
    Keras's ``same`` pads an even kernel with one zero more on the right, and
    so does the explicit pad here. The LSTM's gates are in Keras's order
    (i, f, c, o), which is torch's (i, f, g, o): the kernels are transposed,
    Keras's one bias goes to ``bias_ih`` and ``bias_hh`` is zero.
  - The weights come from ``model.weights.h5`` through ``utils/h5lite.py``,
    a numpy reader of exactly the HDF5 subset these files use (superblock
    version 0, version-1 object headers, old-style symbol-table groups,
    contiguous little-endian IEEE float32/float64 datasets) that raises
    ``NotImplementedError`` on anything else (chunked or compact layouts,
    filters, later superblocks, new-style groups, non-float types). The
    ``layers/<name>/vars/<i>`` and ``layers/<name>/cell/vars/<i>`` banks are
    bound to the layers as the JAX package binds them: first by matching
    name and shapes, then by unique shape signature in natural name order,
    refusing a count mismatch or a pair of different layer types with
    ``ValueError``.
  - ``apply_bury_classifiers`` keeps the prefix protocol (each prefix's last
    ``classifier_len`` residuals divided by their mean absolute value in
    float64, right-aligned into a float32 zero window), but stacks every
    prefix into one batch: one forward per classifier, where the JAX package
    makes one Keras call per prefix per classifier.
  - Series are numpy arrays (``residuals``, ``times``) and tables dicts of
    column arrays, where the JAX package uses ``pd.Series``/``pd.DataFrame``;
    the CSV is written with the ``csv`` module.

The classifiers run on the card unless the caller passes ``device="cpu"``;
on the card in float32, with TF32 off for cuDNN's convolution and LSTM.
"""
from __future__ import annotations

import argparse
import json
import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ..utils import io as uio
from ..utils.device import resolve_device
from ..utils.h5lite import read_h5
from .ews_classic import detrend

PROBABILITY_COLUMNS = ["fold_prob", "hopf_prob", "branch_prob", "null_prob"]
TABLE_COLUMNS = ["time", *PROBABILITY_COLUMNS, "transition_prob"]

DEFAULT_MODEL_ROOT = (
    Path(__file__).resolve().parents[2]
    / "evaluation_and_analysis" / "bury_2021_ml_models" / "best_models_tf215"
)

__all__ = [
    "PROBABILITY_COLUMNS",
    "TABLE_COLUMNS",
    "BuryClassifier",
    "bind_weight_groups",
    "load_keras_model",
    "load_classifiers",
    "infer_classifier_length",
    "transition_time",
    "prepare_series",
    "prefix_windows",
    "apply_bury_classifiers",
    "save_probability_outputs",
    "run_one",
    "main",
]

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r}")
    return _ACTIVATIONS[name]


def _require(cfg: dict, key: str, allowed, cls: str):
    value = cfg.get(key, allowed[0])
    if value not in allowed:
        raise NotImplementedError(f"{cls} with {key}={value!r} (supported: {allowed})")
    return value


class _Conv1D(nn.Module):
    def __init__(self, cfg: dict, channels: int):
        super().__init__()
        _require(cfg, "data_format", ["channels_last"], "Conv1D")
        _require(cfg, "strides", [[1]], "Conv1D")
        _require(cfg, "dilation_rate", [[1]], "Conv1D")
        _require(cfg, "groups", [1], "Conv1D")
        padding = _require(cfg, "padding", ["valid", "same"], "Conv1D")
        (k,) = cfg["kernel_size"]
        # Keras's "same" (stride 1): k - 1 zeros, the extra one on the right
        self.pad = ((k - 1) // 2, k - 1 - (k - 1) // 2) if padding == "same" else (0, 0)
        self.act = _activation(cfg.get("activation", "linear"))
        self.weight = nn.Parameter(torch.zeros(cfg["filters"], channels, k))
        self.bias = nn.Parameter(torch.zeros(cfg["filters"])) if cfg.get("use_bias", True) else None
        self.out_channels = cfg["filters"]

    def keras_shapes(self):
        f, c, k = self.weight.shape
        return [(k, c, f)] + ([(f,)] if self.bias is not None else [])

    def set_keras_weights(self, arrays):
        self.weight.data.copy_(torch.from_numpy(np.transpose(arrays[0], (2, 1, 0))))
        if self.bias is not None:
            self.bias.data.copy_(torch.from_numpy(arrays[1]))

    def forward(self, x):  # [B, L, C] -> [B, L', F]
        h = Fn.conv1d(Fn.pad(x.transpose(1, 2), self.pad), self.weight, self.bias)
        return self.act(h).transpose(1, 2)


class _MaxPooling1D(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        _require(cfg, "data_format", ["channels_last"], "MaxPooling1D")
        _require(cfg, "padding", ["valid"], "MaxPooling1D")
        (self.pool,) = cfg.get("pool_size", [2])
        strides = cfg.get("strides") or [self.pool]
        (self.stride,) = strides

    def forward(self, x):
        return Fn.max_pool1d(x.transpose(1, 2), self.pool, self.stride).transpose(1, 2)


class _LSTM(nn.Module):
    def __init__(self, cfg: dict, channels: int):
        super().__init__()
        _require(cfg, "activation", ["tanh"], "LSTM")
        _require(cfg, "recurrent_activation", ["sigmoid"], "LSTM")
        for key in ("go_backwards", "stateful", "return_state", "time_major"):
            _require(cfg, key, [False], "LSTM")
        _require(cfg, "use_bias", [True], "LSTM")
        self.units = cfg["units"]
        self.return_sequences = bool(cfg.get("return_sequences", False))
        self.lstm = nn.LSTM(channels, self.units, batch_first=True)

    def keras_shapes(self):
        u, c = self.units, self.lstm.input_size
        return [(c, 4 * u), (u, 4 * u), (4 * u,)]

    def set_keras_weights(self, arrays):
        kernel, recurrent, bias = arrays
        self.lstm.weight_ih_l0.data.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
        self.lstm.weight_hh_l0.data.copy_(torch.from_numpy(np.ascontiguousarray(recurrent.T)))
        self.lstm.bias_ih_l0.data.copy_(torch.from_numpy(bias))
        self.lstm.bias_hh_l0.data.zero_()

    def forward(self, x):
        out, _ = self.lstm(x)
        return out if self.return_sequences else out[:, -1]


class _Dense(nn.Module):
    def __init__(self, cfg: dict, channels: int):
        super().__init__()
        self.act = _activation(cfg.get("activation", "linear"))
        self.linear = nn.Linear(channels, cfg["units"], bias=bool(cfg.get("use_bias", True)))

    def keras_shapes(self):
        o, c = self.linear.weight.shape
        return [(c, o)] + ([(o,)] if self.linear.bias is not None else [])

    def set_keras_weights(self, arrays):
        self.linear.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(arrays[0].T)))
        if self.linear.bias is not None:
            self.linear.bias.data.copy_(torch.from_numpy(arrays[1]))

    def forward(self, x):
        return self.act(self.linear(x))


class BuryClassifier(nn.Module):
    """A Keras Sequential classifier of the supported layers; ``forward``
    takes ``[B, input_len, channels]`` (channels last, as Keras) and returns
    the last layer's output (class probabilities for the Bury models)."""

    def __init__(self, config: dict):
        super().__init__()
        if config.get("class_name") != "Sequential":
            raise NotImplementedError(f"model class {config.get('class_name')!r}")
        layers_cfg = config.get("config", {}).get("layers", [])
        self.input_shape = None
        self.layer_names: List[str] = []
        self.body = nn.ModuleList()
        channels = None
        for lc in layers_cfg:
            cls, c = lc["class_name"], lc.get("config", {})
            shape = c.get("batch_input_shape") or c.get("batch_shape")
            if self.input_shape is None:
                if shape is None or len(shape) != 3:
                    raise ValueError(f"legacy config lacks a [batch, length, channels] input "
                                     f"shape: {shape}")
                self.input_shape = (int(shape[1]), int(shape[2]))
                channels = self.input_shape[1]
            if cls == "InputLayer":
                continue
            if cls == "Conv1D":
                layer = _Conv1D(c, channels)
                channels = layer.out_channels
            elif cls == "Dropout":
                layer = nn.Identity()
            elif cls == "MaxPooling1D":
                layer = _MaxPooling1D(c)
            elif cls == "LSTM":
                layer = _LSTM(c, channels)
                channels = layer.units
            elif cls == "Dense":
                layer = _Dense(c, channels)
                channels = c["units"]
            else:
                raise NotImplementedError(f"Keras layer class {cls!r}")
            self.body.append(layer)
            self.layer_names.append(c["name"])
        if self.input_shape is None:
            raise ValueError("could not rebuild model from legacy config")

    def weighted_layers(self) -> List[Tuple[str, nn.Module]]:
        """(Keras name, layer) of every layer that holds weights, in order."""
        return [(n, l) for n, l in zip(self.layer_names, self.body) if hasattr(l, "keras_shapes")]

    def forward(self, x):
        for layer in self.body:
            x = layer(x)
        return x


def _archive_member(model_path: Path, member: str) -> bytes:
    with zipfile.ZipFile(model_path) as archive:
        return archive.read(member)


def _natural(name: str):
    m = re.match(r"(.*?)(\d+)?$", name)
    return (m.group(1), int(m.group(2) or 0))


def _signature(shapes) -> tuple:
    return tuple(tuple(s) for s in shapes)


def bind_weight_groups(layers: Sequence[Tuple[str, tuple]], groups: Dict[str, list],
                       model_path) -> Dict[str, list]:
    """{layer name: arrays} for the weighted ``layers`` ((name, shape
    signature) in model order) from the archive's ``groups`` (name: arrays in
    var order): the JAX package's two-phase binding. First every group whose
    name equals a layer's and whose shapes agree; then each remaining layer
    takes the unique leftover group of its signature, demanders in model
    order paired with groups in natural name order ("lstm_2" before
    "lstm_10"). A count mismatch, or a pair whose base names differ, raises
    ``ValueError``: never a guess."""
    sig_of = {name: sig for name, sig in layers}
    assignment = {}
    for name, sig in layers:
        arrays = groups.get(name)
        if arrays is not None and _signature(a.shape for a in arrays) == sig:
            assignment[name] = arrays
    leftovers = {n: a for n, a in groups.items() if n not in assignment}
    by_sig: Dict[tuple, List[str]] = {}
    for name, _sig in layers:
        if name not in assignment:
            by_sig.setdefault(sig_of[name], []).append(name)
    for want, demanders in by_sig.items():
        hits = sorted((n for n, a in leftovers.items()
                       if _signature(x.shape for x in a) == want), key=_natural)
        if len(hits) != len(demanders):
            raise ValueError(
                f"Cannot bind weight groups {hits} to layers {demanders} "
                f"(signature {want}) in {model_path}"
            )
        for layer, name in zip(demanders, hits):
            if _natural(layer)[0].rstrip("_") != _natural(name)[0].rstrip("_"):
                raise ValueError(
                    f"Refusing shape-only bind of group {name!r} to layer "
                    f"{layer!r} (base names differ) in {model_path}"
                )
            assignment[layer] = leftovers.pop(name)
    return assignment


def load_keras_model(model_path: Path, device=None) -> BuryClassifier:
    """A released classifier as a ``BuryClassifier`` in eval mode on
    ``device`` (default the card)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = BuryClassifier(json.loads(_archive_member(model_path, "config.json")))
    tree = read_h5(_archive_member(model_path, "model.weights.h5"))
    groups = {}
    for name, group in tree["layers"].items():
        bank = group["cell"]["vars"] if "cell" in group else group["vars"]
        groups[name] = [np.asarray(bank[str(i)]) for i in range(len(bank))]
    weighted = model.weighted_layers()
    assignment = bind_weight_groups(
        [(n, _signature(l.keras_shapes())) for n, l in weighted], groups, model_path)
    for name, layer in weighted:
        layer.set_keras_weights([np.asarray(a, np.float32) for a in assignment[name]])
    return model.to(device).eval()


def load_classifiers(model_root: Path, classifier_len: int, max_models: Optional[int] = None,
                     device=None) -> List[Tuple[str, BuryClassifier]]:
    model_dir = Path(model_root) / f"len{classifier_len}"
    model_paths = sorted(model_dir.glob(f"best_model_*_len{classifier_len}.keras"))
    model_paths = [p for p in model_paths if p.stat().st_size > 100000]
    if max_models is not None:
        model_paths = model_paths[:max_models]
    if not model_paths:
        raise FileNotFoundError(f"No complete Keras models found in {model_dir}")
    device = resolve_device(device)
    return [(p.stem, load_keras_model(p, device)) for p in model_paths]


def infer_classifier_length(record: dict, data_name: str) -> int:
    """Dataset-name heuristic (run_bury_ml_baseline.py:124-137)."""
    text = " ".join(
        str(record.get(k, "")) for k in ["name", "data_type", "record", "source_file"]
    ).lower()
    text = f"{text} {data_name.lower()}"
    if "thermoacoustic" in text:
        return 1500
    if "anoxia" in text:
        return 500
    if "paleoclimate" in text and ("tsid_3" in text or "younger_dryas" in text):
        return 1500
    if "paleoclimate" in text:
        return 500
    return 1500 if int(record.get("num_time_points", 0)) >= 1500 else 500


def transition_time(record: dict):
    ts = np.asarray(record.get("ts_dynamic", []), float).ravel()
    if len(ts) == 0:
        return None
    if "transition_index" in record:
        idx = max(0, min(int(record["transition_index"]), len(ts) - 1))
        return float(ts[idx])
    if "transition_time" in record:
        return float(record["transition_time"])
    return None


def prepare_series(record, pred_dim, detrend_method, span, bandwidth):
    """Clean, sort, dedupe, detrend: ``(residuals, y, times, transition
    time)``; the residuals are indexed by ``times`` (the JAX package's
    ``pd.Series``)."""
    values = np.asarray(record["ys_dynamic"], float)
    times = np.asarray(record["ts_dynamic"], float).ravel()
    if values.ndim == 1:
        values = values[:, None]
    if pred_dim >= values.shape[1]:
        raise ValueError(f"pred_dim={pred_dim} is invalid for data shape {values.shape}")
    y = values[:, pred_dim]
    finite = np.isfinite(y) & np.isfinite(times)
    y, times = y[finite], times[finite]
    order = np.argsort(times)
    y, times = y[order], times[order]
    _, uidx = np.unique(times, return_index=True)
    y, times = y[uidx], times[uidx]
    residuals = detrend(y, method=detrend_method, span=span, bandwidth=bandwidth, times=times)
    return residuals, y, times, transition_time(record)


def prefix_windows(residuals: np.ndarray, inc_points: int, input_len: int) -> np.ndarray:
    """``[n_prefix, input_len, 1]`` float32: for each prefix end in
    ``range(inc_points, n + 1, inc_points)`` the prefix's last ``input_len``
    residuals divided by their mean absolute value in float64 (when it is
    > 0), right-aligned into a float32 zero window."""
    residuals = np.asarray(residuals, float)
    ends = range(inc_points, len(residuals) + 1, inc_points)
    out = np.zeros((len(ends), input_len, 1), np.float32)
    for row, end in enumerate(ends):
        prefix = residuals[:end]
        data = prefix[-input_len:] if len(prefix) > input_len else prefix
        denom = np.mean(np.abs(data))
        data = data / denom if denom > 0 else data
        out[row, -len(data):, 0] = data
    return out


def apply_bury_classifiers(residuals, times, classifiers, inc_points: int,
                           classifier_len: int) -> Dict[str, np.ndarray]:
    """Incremental ensemble classification (run_bury_ml_baseline.py:189-203):
    a table as {column: array} in ``TABLE_COLUMNS`` order."""
    residuals = np.asarray(residuals, float)
    times = np.asarray(times, float)
    if len(residuals) < 2:
        raise ValueError("At least two time points are required.")
    windows = prefix_windows(residuals, inc_points, classifier_len)
    if len(windows) == 0:
        raise RuntimeError("Bury classifiers did not produce predictions.")
    # one forward a classifier over every prefix; the mean in archive order
    probs = []
    with torch.no_grad():
        for _name, clf in classifiers:
            x = torch.from_numpy(windows).to(next(clf.parameters()).device)
            probs.append(clf(x).float().cpu().numpy()[:, :4])
    probs = np.mean(np.stack(probs), axis=0)
    table = {"time": times[np.arange(inc_points, len(residuals) + 1, inc_points) - 1]}
    table.update({c: probs[:, i] for i, c in enumerate(PROBABILITY_COLUMNS)})
    table["transition_prob"] = table["fold_prob"] + table["hopf_prob"] + table["branch_prob"]
    return table


def save_probability_outputs(output_dir: Path, basename: str, table: Dict[str, np.ndarray],
                             metadata: dict):
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    csv_path = output_dir / f"{basename}_bury_ml_probs.csv"
    pt_path = output_dir / f"{basename}_bury_ml_probs.pt"
    json_path = output_dir / f"{basename}_bury_ml_probs_metadata.json"
    uio.write_csv(csv_path, list(table), zip(*table.values()))
    uio.save_pt(
        {
            "time": np.asarray(table["time"], np.float32),
            "probabilities": np.stack([table[c] for c in PROBABILITY_COLUMNS], 1).astype(
                np.float32),
            "transition_probability": np.asarray(table["transition_prob"], np.float32),
            "probability_columns": PROBABILITY_COLUMNS,
            **metadata,
        },
        pt_path,
    )
    json_path.write_text(json.dumps(metadata, indent=2, ensure_ascii=False), encoding="utf-8")
    return csv_path, pt_path, json_path


def run_one(args, data_name: str):
    from .real_data import resolve_real_data_path

    data_path = resolve_real_data_path(data_name, args.data_root)
    record = uio.load_pt(data_path)
    basename = Path(str(record.get("name", data_path.stem))).stem
    classifier_len = args.classifier_len or infer_classifier_length(record, basename)
    residuals, _raw, times, trans_time = prepare_series(
        record, args.pred_dim, args.detrend_method, args.detrend_span, args.detrend_bandwidth
    )
    if not args.full_prefix:
        if trans_time is not None:
            pre = times <= trans_time
            if pre.sum() >= 2:
                residuals, times = residuals[pre][-classifier_len:], times[pre][-classifier_len:]
        else:
            residuals, times = residuals[-classifier_len:], times[-classifier_len:]
    classifiers = load_classifiers(args.model_root, classifier_len, args.max_models,
                                   device=getattr(args, "device", None))
    table = apply_bury_classifiers(residuals, times, classifiers, args.inc_points,
                                   classifier_len)
    metadata = {
        "name": basename,
        "source_pt": str(data_path),
        "data_type": record.get("data_type", ""),
        "record": record.get("record", ""),
        "pred_dim": args.pred_dim,
        "classifier_len": classifier_len,
        "num_classifiers": len(classifiers),
        "classifier_names": [n for n, _ in classifiers],
        "detrend_method": args.detrend_method,
        "detrend_span": args.detrend_span,
        "detrend_bandwidth": args.detrend_bandwidth,
        "inc_points": args.inc_points,
        "transition_time": trans_time,
        "probability_columns": PROBABILITY_COLUMNS,
    }
    return save_probability_outputs(Path(args.output_root) / basename, basename, table, metadata)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run Bury et al. ML EWS classifiers.")
    parser.add_argument("--data-root", type=Path, default=Path("dataset/real_data"))
    parser.add_argument("--model-root", type=Path, default=DEFAULT_MODEL_ROOT,
                        help="dir with len500/len1500 subdirs of best_model_*.keras")
    parser.add_argument("--output-root", type=Path, default=Path("ews_results/bury_2021_ml_probs"))
    parser.add_argument("--data-real-names", nargs="+", required=True)
    parser.add_argument("--pred-dim", type=int, default=0)
    parser.add_argument("--classifier-len", type=int, choices=[500, 1500], default=None)
    parser.add_argument("--max-models", type=int, default=None)
    parser.add_argument("--inc-points", type=int, default=10)
    parser.add_argument("--detrend-method", choices=["lowess", "gaussian", "none"],
                        default="lowess")
    parser.add_argument("--detrend-span", type=float, default=0.2)
    parser.add_argument("--detrend-bandwidth", type=float, default=0.2)
    parser.add_argument("--full-prefix", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device of the classifiers (default: the card)")
    args = parser.parse_args(argv)
    for data_name in args.data_real_names:
        csv_path, pt_path, json_path = run_one(args, data_name)
        print(f"saved: {csv_path}")
        print(f"saved: {pt_path}")
        print(f"saved: {json_path}")


if __name__ == "__main__":
    main()
