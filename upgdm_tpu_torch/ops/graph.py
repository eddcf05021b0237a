"""Dense-adjacency graph utilities.

Counterpart of ``upgdm_tpu/ops/graph.py``. A graph is a dense symmetric
adjacency [V, V] (float32, zero diagonal) plus an optional node mask for
padded batching; the GNN convolutions (``models/gnn.py``) aggregate with
``A @ X`` products, so there is no edge list on the device path.

``graphml_to_adjacency`` parses a ``.graphml`` file with the standard
library (``xml.etree.ElementTree``), so the port does not need ``networkx``:
nodes are numbered in the order ``networkx.convert_node_labels_to_integers``
gives them (declaration order, then nodes an edge names first), an edge's
``weight`` data counts as ``to_numpy_array`` reads it, and the result is
symmetrised and binarised with a zero diagonal, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

__all__ = ["DenseGraph", "edge_index_to_adjacency", "graphml_to_adjacency"]


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense symmetric adjacency (no self loops) + optional validity mask."""

    adj: np.ndarray  # [V, V] float32
    node_mask: Optional[np.ndarray] = None  # [V] bool; None = all valid

    @property
    def num_nodes(self) -> int:
        return int(self.adj.shape[0])

    @property
    def degree(self) -> np.ndarray:
        return self.adj.sum(axis=1)

    def padded(self, max_nodes: int) -> "DenseGraph":
        """Zero rows and columns up to ``max_nodes``, with the mask of the
        real nodes."""
        V = self.num_nodes
        if V == max_nodes:
            mask = self.node_mask if self.node_mask is not None else np.ones(V, bool)
            return DenseGraph(self.adj, mask)
        adj = np.zeros((max_nodes, max_nodes), np.float32)
        adj[:V, :V] = self.adj
        mask = np.zeros(max_nodes, bool)
        mask[:V] = self.node_mask if self.node_mask is not None else True
        return DenseGraph(adj, mask)


def edge_index_to_adjacency(edge_index: np.ndarray, num_nodes: int,
                            symmetric: bool = True) -> DenseGraph:
    """[2, E] int edge list -> DenseGraph (duplicate edges collapse to 1)."""
    adj = np.zeros((num_nodes, num_nodes), np.float32)
    src, dst = np.asarray(edge_index)
    adj[src, dst] = 1.0
    if symmetric:
        adj[dst, src] = 1.0
    np.fill_diagonal(adj, 0.0)
    return DenseGraph(adj)


def _local(tag: str) -> str:
    return tag.rpartition("}")[2]


def graphml_to_adjacency(path) -> DenseGraph:
    """Load a .graphml topology as a dense adjacency (utils/utils.py:322-326)."""
    root = ET.parse(str(path)).getroot()
    weight_keys = {k.get("id") for k in root if _local(k.tag) == "key"
                   and k.get("attr.name") == "weight" and k.get("for") in (None, "edge", "all")}
    graph = next(g for g in root if _local(g.tag) == "graph")
    index = {}

    def node(name):
        if name not in index:
            index[name] = len(index)
        return index[name]

    edges = []
    for el in graph:
        tag = _local(el.tag)
        if tag == "node":
            node(el.get("id"))
        elif tag == "edge":
            w = 1.0
            for d in el:
                if _local(d.tag) == "data" and d.get("key") in weight_keys:
                    w = float(d.text)
            edges.append((node(el.get("source")), node(el.get("target")), w))
    adj = np.zeros((len(index), len(index)), np.float32)
    for u, v, w in edges:
        adj[u, v] = w
    adj = ((adj + adj.T) > 0).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    return DenseGraph(adj)
