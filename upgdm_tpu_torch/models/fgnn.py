"""Factor-graph neural network convolution (FGNN), edge-list form.

Counterpart of ``upgdm_tpu/models/fgnn.py`` (reference
models/layer/FGNNConv.py:13-150): bipartite message passing between variable
and factor nodes. Per-edge Q networks map edge features to [k, l] mixing
matrices, M networks map the concatenated endpoint features to vectors, and
the message Q @ M is summed at its destination. Also the clique finders
that build factor graphs (numpy, host side). Present but unused by the four
diffusion families, as in the JAX package. Flax infers the input widths at
init; here they are given (``var_dim``, ``factor_in_dim``, ``edge_dim``).
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np
import torch
from torch import nn

from .layers import Linear

__all__ = ["QNetwork", "MNetwork", "FGNNConv", "find_cliques", "find_maximal_cliques"]


class _MLP(nn.Module):
    """flax's auto-named ``Dense_0 .. Dense_{n-1}``, relu between them."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int, hidden: int):
        super().__init__()
        self.n = num_layers
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            setattr(self, f"Dense_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, h):
        for i in range(self.n - 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n - 1}")(h)


class QNetwork(_MLP):
    """edge features -> [k, l] mixing matrix per edge."""

    def __init__(self, edge_dim: int, k: int, l: int, num_layers: int = 2, hidden: int = 64):
        super().__init__(edge_dim, k * l, num_layers, hidden)
        self.k, self.l = k, l

    def forward(self, edge_features):
        h = super().forward(edge_features)
        return h.reshape(h.shape[:-1] + (self.k, self.l))


class MNetwork(_MLP):
    """concatenated endpoint features -> message vector."""

    def __init__(self, in_dim: int, output_dim: int, num_layers: int = 2, hidden: int = 64):
        super().__init__(in_dim, output_dim, num_layers, hidden)


class FGNNConv(nn.Module):
    """forward(var_features [Nv, Dv], factor_features [Nf, Df],
    v2f_edge_index [2, E], edge_attr [E, De], f2v_edge_index [2, E])
    -> (var_out [Nv, output_vdim], factor_out [Nf, factor_dim], edge_attr)."""

    def __init__(self, output_vdim: int, factor_dim: int, net_num_layers: int = 2,
                 var_dim: Optional[int] = None, factor_in_dim: Optional[int] = None,
                 edge_dim: Optional[int] = None):
        super().__init__()
        var_dim = output_vdim if var_dim is None else var_dim
        factor_in_dim = factor_dim if factor_in_dim is None else factor_in_dim
        edge_dim = factor_dim if edge_dim is None else edge_dim
        self.output_vdim, self.factor_dim = output_vdim, factor_dim
        self.Q_vf = QNetwork(edge_dim, factor_dim, output_vdim, net_num_layers)
        self.M_vf = MNetwork(factor_in_dim + var_dim, output_vdim, net_num_layers)
        self.Q_fv = QNetwork(edge_dim, output_vdim, factor_dim, net_num_layers)
        self.M_fv = MNetwork(var_dim + factor_in_dim, factor_dim, net_num_layers)

    @staticmethod
    def _scatter(q, m, dst, n, width):
        msg = torch.einsum("ekl,el->ek", q, m)
        return torch.zeros(n, width, dtype=msg.dtype, device=msg.device).index_add(0, dst, msg)

    def forward(self, var_features, factor_features, v2f_edge_index, edge_attr, f2v_edge_index):
        nv, nf = var_features.shape[0], factor_features.shape[0]
        src, dst = torch.as_tensor(v2f_edge_index, device=var_features.device).long()
        m = self.M_vf(torch.cat([factor_features[dst], var_features[src]], dim=-1))
        out_vf = self._scatter(self.Q_vf(edge_attr), m, dst, nf, self.factor_dim)

        src, dst = torch.as_tensor(f2v_edge_index, device=var_features.device).long()
        m = self.M_fv(torch.cat([var_features[dst], factor_features[src]], dim=-1))
        out_fv = self._scatter(self.Q_fv(edge_attr), m, dst, nv, self.output_vdim)
        return out_fv, out_vf, edge_attr


def _neighbors(adj):
    adj = np.asarray(adj)
    return [set(np.flatnonzero(adj[i]).tolist()) for i in range(adj.shape[0])]


def find_cliques(adj: np.ndarray) -> List[Set[int]]:
    """All triangle cliques of a dense adjacency (FGNNConv.py:102-124)."""
    neighbors = _neighbors(adj)
    triangles = []
    for node in range(len(neighbors)):
        nb = sorted(neighbors[node])
        for i in range(len(nb)):
            for j in range(i + 1, len(nb)):
                u, v = nb[i], nb[j]
                if v in neighbors[u]:
                    tri = {node, u, v}
                    if tri not in triangles:
                        triangles.append(tri)
    return triangles


def find_maximal_cliques(adj: np.ndarray) -> List[Set[int]]:
    """Bron–Kerbosch maximal cliques (FGNNConv.py:127-150)."""
    neighbors = _neighbors(adj)
    cliques: List[Set[int]] = []

    def bk(R, P, X):
        if not P and not X:
            cliques.append(R)
        P = set(P)
        while P:
            v = P.pop()
            bk(R | {v}, P & neighbors[v], X & neighbors[v])
            X.add(v)

    bk(set(), set(range(len(neighbors))), set())
    return cliques
