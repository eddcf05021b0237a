"""Carry weights between the flax-named flat dict and the port's modules.

Every ``.pt`` checkpoint (and ``flatten_params(model.params)`` on the JAX
side) holds a flat dict keyed by flax's module path, e.g.
``cond_pred_model.encoder.NSEncoderLayer_0.Dense_0.kernel``. The port names
its torch submodules after those flax names, so the mapping is only a leaf
rename plus a transpose:

  - Dense ``kernel [in, out]``        -> ``weight [out, in]``
  - Conv  ``kernel [k, in, out]``     -> ``weight [out, in, k]``
  - Projector ``series_conv_kernel [k, S, 1]`` -> ``[1, S, k]`` (same name)
  - LayerNorm ``scale``               -> ``weight`` (no transpose); a
    LayerNorm is flax's ``LayerNorm_<n>``, UGnet's ``norm`` or DiffusionTS's
    ``ln2``, and a ``GraphNorm_<n>`` scales the same way
  - a time-mixing Dense ``kernel [T_out, T_in]`` (DiffusionTS's ``proj``
    and ``combine_m``) -> ``weight [T_in, T_out]``, like any 2-D kernel
  - ``bias``, ``ConditionalLinear.embed [n_steps, 128]``, the GAT vectors
    ``att_src``/``att_dst``/``att`` [H, C], the UGnets'
    ``out_time_kernel``/``out_time_bias``, GraphNorm's ``alpha`` and
    DiffusionTS's position tables ``pe`` unchanged (not Dense kernels: no
    transpose)

``scaler_mean``/``scaler_std`` ride along untouched. Any other leaf name is
an error in both directions, so a key set that does not belong to the port
cannot slip through.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["torch_state_from_flax", "flax_flat_from_torch", "SCALER_KEYS"]

SCALER_KEYS = ("scaler_mean", "scaler_std")
_PLAIN_LEAVES = ("bias", "embed", "att_src", "att_dst", "att", "out_time_kernel",
                 "out_time_bias", "alpha", "pe")


def _is_layer_norm(parent: str) -> bool:
    name = parent.rpartition(".")[2]
    return name.startswith(("LayerNorm", "GraphNorm")) or name in ("norm", "ln2")


def _transpose_kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    if a.ndim == 3:
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    raise ValueError(f"kernel of rank {a.ndim} has no torch layout")


def torch_state_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flax-named flat dict (numpy leaves) -> the port's ``state_dict``."""
    out = {}
    for key, value in flat.items():
        a = np.array(value, dtype=np.float32)  # a writable copy
        if key in SCALER_KEYS:
            out[key] = torch.from_numpy(a)
            continue
        parent, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            new_key, a = f"{parent}.weight", _transpose_kernel(a)
        elif leaf == "series_conv_kernel":
            new_key, a = key, _transpose_kernel(a)
        elif leaf == "scale":
            new_key = f"{parent}.weight"
        elif leaf in _PLAIN_LEAVES:
            new_key = key
        else:
            raise KeyError(f"unknown flax parameter leaf {key!r}")
        out[new_key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def flax_flat_from_torch(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> flax-named flat dict (numpy leaves)."""
    out = {}
    for key, value in state.items():
        a = value.detach().to("cpu", torch.float32).numpy()
        if key in SCALER_KEYS:
            out[key] = a.copy()
            continue
        parent, _, leaf = key.rpartition(".")
        if leaf == "weight":
            if _is_layer_norm(parent):
                out[f"{parent}.scale"] = a.copy()
            else:
                out[f"{parent}.kernel"] = _transpose_kernel(a)
        elif leaf == "series_conv_kernel":
            out[key] = _transpose_kernel(a)
        elif leaf in _PLAIN_LEAVES:
            out[key] = a.copy()
        else:
            raise KeyError(f"unknown torch parameter leaf {key!r}")
    return out
