"""Artifact IO — the `.pt` formats shared with the JAX package.

Counterpart of ``upgdm_tpu/utils/io.py``. Contracts kept:

  - checkpoints: ``torch.save({'net_param': dict, 'state_dict': {name: array}})``
    named ``model_trained`` with a sibling ``model_trained.yaml``; the state
    dict is the flax-named flat dict (``utils/weights.py`` maps it onto the
    port's modules);
  - simulation records: dict ``{ys_dynamic, ts_dynamic, tp_values/N_values}``;
  - prediction caches: a python list of per-window tensors.

Array leaves are numpy on both sides, so either package loads the other's
files.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import yaml

__all__ = [
    "save_pt",
    "load_pt",
    "save_tensor_list",
    "load_tensor_list",
    "flatten_params",
    "unflatten_params",
    "save_checkpoint",
    "load_checkpoint",
    "read_model_config",
]


def save_pt(obj, path):
    """torch.save with numpy->tensor conversion of array leaves."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return x

    with open(path, "wb") as f:
        torch.save(conv(obj), f)


def load_pt(path, to_numpy: bool = True):
    """torch.load (CPU) with tensor->numpy conversion of array leaves."""
    with open(path, "rb") as f:
        obj = torch.load(f, map_location="cpu", weights_only=False)
    if not to_numpy:
        return obj

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return conv(obj)


def save_tensor_list(data_list: List[np.ndarray], cache_path):
    """Prediction-cache contract: a python list of tensors."""
    save_pt([np.asarray(x) for x in data_list], cache_path)


def load_tensor_list(cache_path) -> List[np.ndarray]:
    data = load_pt(cache_path)
    if not isinstance(data, list):
        raise TypeError(f"cache file must contain a list of tensors: {cache_path}")
    return data


# ---------------------------------------------------------------------------
# Nested param tree <-> flat dotted state dict
# ---------------------------------------------------------------------------

def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten_params(v, key))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path, model_name: str, state_dict: Dict[str, np.ndarray], net_param: dict):
    """{'net_param', 'state_dict'} contract (utils/utils.py:611-622)."""
    net_param = {k: v for k, v in net_param.items() if k != "device"}
    save_pt({"net_param": net_param, "state_dict": state_dict}, Path(path) / model_name)


def load_checkpoint(path, infer_para: Optional[dict] = None):
    """Returns (net_param, state_dict); infer_para overrides net_param.
    DataParallel 'module.' prefixes are stripped."""
    state = load_pt(path)
    net_param = dict(state["net_param"])
    if infer_para:
        net_param.update(infer_para)
    sd = {k.replace("module.", ""): v for k, v in state["state_dict"].items()}
    return net_param, sd


def read_model_config(model_save_file) -> dict:
    config_path = Path(model_save_file) / "model_trained.yaml"
    if not config_path.exists():
        raise FileNotFoundError(f"model config not found: {config_path}")
    with open(config_path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)
