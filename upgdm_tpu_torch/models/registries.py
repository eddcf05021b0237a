"""Activation, graph-norm and global-pool name registries.

Counterpart of ``upgdm_tpu/models/registries.py`` (reference
models/act/gnn_act.py, models/norm/gnn_norm.py, models/pool/gnn_pool.py):
name -> op dispatchers for configurable GNN stacks, on dense node features
[..., V, C] with an optional node mask [..., V]. Numerics kept from flax:
``"gelu"`` is the tanh approximation, LayerNorm's epsilon is 1e-6,
BatchNorm is the running-average (eval-mode) form with epsilon 1e-5, and the
masked pools keep the JAX package's ``-inf`` fill (max) and ``max(count, 1)``
guard (mean).

Torch modules need their width at construction, flax infers it: ``gnn_norm``
takes the channel count C.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm

__all__ = ["gnn_act", "GraphNorm", "BatchNorm", "gnn_norm", "gnn_pool"]


def gnn_act(act_name: str):
    registry = {
        "relu": F.relu,
        "leaky_relu": F.leaky_relu,  # slope 0.01, as flax's
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softplus": F.softplus,
        "identity": lambda x: x,
    }
    if act_name not in registry:
        raise ValueError(f"unknown activation {act_name!r}")
    return registry[act_name]


class GraphNorm(nn.Module):
    """GraphNorm (Cai et al. 2021): per-graph mean shift with a learnable
    alpha, then scale and bias, over the node axis of [..., V, C]. Flax's
    ``scale`` is this module's ``weight`` (``utils/weights.py``)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(num_features))
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, node_mask=None):
        if node_mask is not None:
            m = node_mask[..., None].to(x.dtype)
            denom = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
            mean = (x * m).sum(dim=-2, keepdim=True) / denom
            centered = (x - self.alpha * mean) * m
            var = (centered ** 2).sum(dim=-2, keepdim=True) / denom
        else:
            mean = x.mean(dim=-2, keepdim=True)
            centered = x - self.alpha * mean
            var = (centered ** 2).mean(dim=-2, keepdim=True)
        return self.weight * centered * torch.rsqrt(var + 1e-5) + self.bias


class BatchNorm(nn.BatchNorm1d):
    """flax ``BatchNorm(use_running_average=True)`` over the last axis of
    any shape: torch's batch norm in eval mode with the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.eval()

    def forward(self, x):
        C = x.shape[-1]
        return F.batch_norm(x.reshape(-1, C), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps).reshape(x.shape)


def gnn_norm(norm_name, num_features: int, **kwargs):
    """name -> norm module over node features of width ``num_features``."""
    if norm_name in ("BatchNorm", "batch"):
        return BatchNorm(num_features, **kwargs)
    if norm_name in ("LayerNorm", "layer"):
        return LayerNorm(num_features, **{"eps": 1e-6, **kwargs})  # flax's epsilon
    if norm_name in ("GraphNorm", "graph"):
        return GraphNorm(num_features, **kwargs)
    if norm_name in (None, "None", "identity"):
        return lambda x: x
    raise ValueError(f"unknown norm {norm_name!r}")


def gnn_pool(pool_name: str):
    """name -> global pooling over the node axis of [..., V, C] (+ mask)."""

    def mean_pool(x, node_mask=None):
        if node_mask is None:
            return x.mean(dim=-2)
        m = node_mask[..., None].to(x.dtype)
        return (x * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)

    def max_pool(x, node_mask=None):
        if node_mask is None:
            return x.amax(dim=-2)
        return torch.where(node_mask[..., None], x, -torch.inf).amax(dim=-2)

    def add_pool(x, node_mask=None):
        if node_mask is None:
            return x.sum(dim=-2)
        return (x * node_mask[..., None].to(x.dtype)).sum(dim=-2)

    registry = {
        "global_mean_pool": mean_pool, "mean": mean_pool,
        "global_max_pool": max_pool, "max": max_pool,
        "global_add_pool": add_pool, "add": add_pool, "sum": add_pool,
    }
    if pool_name not in registry:
        raise ValueError(f"unknown pool {pool_name!r}")
    return registry[pool_name]
