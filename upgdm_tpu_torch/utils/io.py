"""Artifact IO — the `.pt` formats shared with the JAX package.

Counterpart of ``upgdm_tpu/utils/io.py``. Contracts kept:

  - checkpoints: ``torch.save({'net_param': dict, 'state_dict': {name: array}})``
    named ``model_trained`` with a sibling ``model_trained.yaml``; the state
    dict is the flax-named flat dict (``utils/weights.py`` maps it onto the
    port's modules);
  - simulation records: dict ``{ys_dynamic, ts_dynamic, tp_values/N_values}``;
  - prediction caches: a python list of per-window tensors;
  - training records: ``record_scores.json``, the config yamls with their
    already-trained dedup, and ``emergency_checkpoint.pth`` (atomic
    tmp-then-rename; the reference's keys, ``"mdoel_params"`` included).
    The JAX package stores its optimizer state as flax bytes under
    ``optimizer_state_bytes``; the port stores a torch optimizer
    ``state_dict`` under ``torch_optimizer_state``, so each side resumes
    the other's weights, epoch and records, and its own moments only.

Array leaves are numpy on both sides, so either package loads the other's
files.
"""
from __future__ import annotations

import json
import os
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
    "emergency_checkpoint",
    "load_emergency_checkpoint",
    "save_config_yaml",
    "save_record",
    "load_record",
    "save_config_dedup",
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


EMERGENCY_FILE = "emergency_checkpoint.pth"
TORCH_OPT_KEY = "torch_optimizer_state"


def emergency_checkpoint(checkpoint_dir, state_dict: Dict[str, np.ndarray], net_param: dict,
                         optimizer_state: dict, step: int, record_scores: dict):
    """Atomic tmp-then-rename emergency checkpoint (utils/utils.py:624-640);
    ``optimizer_state`` is a torch optimizer ``state_dict``."""
    checkpoint_path = Path(checkpoint_dir) / EMERGENCY_FILE
    tmp = str(checkpoint_path) + ".tmp"
    save_pt(
        {
            "step": step,
            "record_scores": record_scores,
            "mdoel_params": {k: v for k, v in net_param.items() if k != "device"},
            "model_state_dict": state_dict,
            TORCH_OPT_KEY: optimizer_state,
        },
        tmp,
    )
    os.replace(tmp, checkpoint_path)


def _tensors(x):
    """numpy leaves back to tensors (an optimizer ``state_dict`` from disk)."""
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors(v) for v in x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def load_emergency_checkpoint(checkpoint_dir):
    """(step, record_scores, state_dict, torch optimizer state_dict or None),
    or a fresh start when there is no file. A file written by the JAX
    package gives None for the optimizer state."""
    path = Path(checkpoint_dir) / EMERGENCY_FILE
    if not path.exists():
        return 0, {"epoch": [], "train_scores": [], "val_scores": []}, None, None
    ckpt = load_pt(path)
    opt = ckpt.get(TORCH_OPT_KEY)
    return (ckpt["step"], ckpt["record_scores"], ckpt["model_state_dict"],
            None if opt is None else _tensors(opt))


def save_config_yaml(path, config: dict):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    clean = json.loads(json.dumps(config, default=str))
    with open(path, "w") as f:
        yaml.safe_dump(clean, f)


def save_record(path, record_scores: dict):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record_scores, f, indent=4, separators=(",", ":"))


def load_record(path) -> dict:
    with open(path, "r") as f:
        return json.load(f)


def save_config_dedup(path, configs_name="configs.yaml", dataset_param=None, net_param=None,
                      train_param=None, optimizer_param=None, loss_param=None):
    """Config save with the already-trained dedup (utils/utils.py:693-728).

    Returns (should_train, saved_record_scores_or_None)."""
    train_state = {
        "dataset": dataset_param,
        "train": train_param,
        "net": net_param,
        "optimizer": optimizer_param,
        "loss": loss_param,
    }
    path = Path(path)
    file_path = path / configs_name
    path.mkdir(parents=True, exist_ok=True)
    if file_path.exists():
        with open(file_path, "r") as f:
            saved = yaml.safe_load(f)
        if json.dumps(saved, sort_keys=True, default=str) == json.dumps(
            train_state, sort_keys=True, default=str
        ):
            if (path / "hold_out/trained_model").exists():
                with open(path / "hold_out/train_trace/record_scores.json", "r") as f:
                    return False, yaml.safe_load(f)
            return True, None
    save_config_yaml(file_path, train_state)
    return True, None
