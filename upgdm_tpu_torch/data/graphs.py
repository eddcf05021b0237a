"""Graph topology generation, without networkx.

Counterpart of ``upgdm_tpu/data/graphs.py``, which calls networkx's
generators. The card's machine has no networkx, so the port carries its own
copies of the networkx 3.6.1 algorithms it needs, in numpy and Python's
``random``, with networkx's order of random draws: ``gnp_random_graph``,
``watts_strogatz_graph``, ``barabasi_albert_graph`` (with ``_random_subset``
over a ``set``, whose iteration order is CPython's, as networkx's is),
``powerlaw_sequence`` + ``configuration_model`` collapsed to a simple graph,
``random_regular_graph`` (with ``_try_creation``), and connectivity by
breadth-first search. Under the same seeds the adjacency equals networkx's bit
for bit. As in networkx, ``seed=None`` draws from the global ``random``
module, which is what ``gen_graph`` hands its generators (only the family's
parameters come from ``rng``).

A graph is the port's ``DenseGraph`` (a float32 [n, n] 0/1 adjacency with a
zero diagonal) where the JAX package returns an ``nx.Graph``; nodes are
0..n-1 in networkx's order.
"""
from __future__ import annotations

import itertools
import random
import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..ops.graph import DenseGraph

__all__ = [
    "gen_graph",
    "generate_network",
    "graph_properties",
    "save_graphml",
    "generate_graph_library",
]


def _py_random(seed):
    """networkx's ``create_py_random_state`` for None, an int or a
    ``random.Random``."""
    if seed is None or seed is random:
        return random._inst
    if isinstance(seed, random.Random):
        return seed
    if isinstance(seed, int):
        return random.Random(seed)
    raise ValueError(f"{seed} cannot be used to generate a random.Random instance")


def _dense(n, edges) -> DenseGraph:
    """A 0/1 adjacency of the edge pairs, self loops dropped."""
    adj = np.zeros((n, n), np.float32)
    for u, v in edges:
        if u != v:
            adj[u, v] = adj[v, u] = 1.0
    return DenseGraph(adj)


def _gnp(n, p, seed=None):
    """``nx.gnp_random_graph`` (= ``erdos_renyi_graph``), undirected."""
    seed = _py_random(seed)
    if p >= 1:
        return _dense(n, itertools.combinations(range(n), 2))
    if p <= 0:
        return _dense(n, ())
    return _dense(n, [e for e in itertools.combinations(range(n), 2) if seed.random() < p])


def _watts_strogatz(n, k, p, seed=None):
    """``nx.watts_strogatz_graph``: the k-nearest-neighbour ring, each edge
    rewired with probability p, no self loops or multiple edges."""
    seed = _py_random(seed)
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    if k == n:
        return _dense(n, itertools.combinations(range(n), 2))
    nbrs = [set() for _ in range(n)]
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            nbrs[u].add(v)
            nbrs[v].add(u)
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[0:j]):
            if seed.random() < p:
                w = seed.choice(nodes)
                while w == u or w in nbrs[u]:
                    w = seed.choice(nodes)
                    if len(nbrs[u]) >= n - 1:
                        break  # skip this rewiring
                else:
                    if v not in nbrs[u]:
                        raise ValueError(f"the edge {u}-{v} is not in the graph")
                    nbrs[u].discard(v)
                    nbrs[v].discard(u)
                    nbrs[u].add(w)
                    nbrs[w].add(u)
    return _dense(n, ((u, v) for u in range(n) for v in nbrs[u]))


def _random_subset(seq, m, rng):
    """m unique elements of seq (networkx's helper, a set in its order)."""
    targets = set()
    while len(targets) < m:
        targets.add(rng.choice(seq))
    return targets


def _barabasi_albert(n, m, seed=None):
    """``nx.barabasi_albert_graph`` from the star on m + 1 nodes."""
    seed = _py_random(seed)
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert network must have m >= 1 and m < n, m = {m}, n = {n}")
    edges = [(0, i) for i in range(1, m + 1)]
    repeated_nodes = [0] * m + list(range(1, m + 1))  # nodes in order, once a degree
    source = m + 1
    while source < n:
        targets = _random_subset(repeated_nodes, m, seed)
        edges.extend((source, t) for t in targets)
        repeated_nodes.extend(targets)
        repeated_nodes.extend([source] * m)
        source += 1
    return _dense(n, edges)


def _configuration_simple(deg_sequence, seed=None):
    """``nx.Graph(nx.configuration_model(seq))`` with its self loops removed:
    the stubs shuffled and halved, parallel edges collapsed."""
    seed = _py_random(seed)
    if sum(deg_sequence) % 2 != 0:
        raise ValueError("Invalid degree sequence: sum of degrees must be even, not odd")
    stublist = [v for v, d in enumerate(deg_sequence) for _ in range(d)]
    half = len(stublist) // 2
    seed.shuffle(stublist)
    return _dense(len(deg_sequence), zip(stublist[:half], stublist[half:]))


def _random_regular(d, n, seed=None):
    """``nx.random_regular_graph`` (Steger and Wormald, with networkx's
    retries)."""
    seed = _py_random(seed)
    if (n * d) % 2 != 0:
        raise ValueError("n * d must be even")
    if not 0 <= d < n:
        raise ValueError("the 0 <= d < n inequality must be satisfied")
    if d == 0:
        return _dense(n, ())

    def _suitable(edges, potential_edges):
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def _try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = defaultdict(lambda: 0)
            seed.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and ((s1, s2) not in edges):
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not _suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    edges = _try_creation()
    while edges is None:
        edges = _try_creation()
    return _dense(n, edges)


def _hops(adj: np.ndarray) -> np.ndarray:
    """[n, n] breadth-first hop counts (0 on the diagonal, -1 where a node is
    not reachable)."""
    n = adj.shape[0]
    step = (adj != 0).astype(np.int64)
    frontier = np.eye(n, dtype=bool)
    seen = frontier.copy()
    dist = np.where(frontier, 0, -1)
    hop = 0
    while frontier.any():
        hop += 1
        frontier = ((frontier.astype(np.int64) @ step) > 0) & ~seen
        dist[frontier] = hop
        seen |= frontier
    return dist


def _is_connected(g: DenseGraph) -> bool:
    if g.num_nodes == 0:
        raise ValueError("Connectivity is undefined for the null graph.")
    return bool((_hops(g.adj)[0] >= 0).all())


def gen_graph(g_type: str, num_min: int = 20, num_max: int = 40, rng: random.Random = None) -> DenseGraph:
    """Random graph of the requested family with connectivity retry: the
    family's parameters from ``rng``, the edges from the global ``random``
    module (the JAX package hands networkx no seed). Returns a ``DenseGraph``
    where the JAX package returns an ``nx.Graph``; its adjacency is
    networkx's."""
    rng = rng or random.Random()
    cur_n = rng.randint(num_min, num_max)
    while True:
        if g_type == "erdos_renyi":
            g = _gnp(cur_n, rng.uniform(0.1, 0.9))
        elif g_type == "small-world":
            nei = rng.randint(round(0.15 * cur_n), round(0.35 * cur_n))
            g = _watts_strogatz(cur_n, max(2, 2 * nei), rng.uniform(0, 0.15))
        elif g_type == "barabasi_albert":
            m = rng.randint(max(1, round(0.1 * cur_n)), max(1, round(0.25 * cur_n)))
            g = _barabasi_albert(cur_n, m)
        elif g_type == "static_power_law":
            exp = rng.uniform(2, 3)
            seq = [min(cur_n - 1, max(1, int(random.paretovariate(exp - 1))))
                   for _ in range(cur_n)]
            if sum(seq) % 2:
                seq[0] += 1
            g = _configuration_simple(seq)
        elif g_type == "K_Regular":
            k = rng.randint(round(0.2 * cur_n), cur_n - 2)
            if (k * cur_n) % 2 or cur_n < k + 1:
                continue
            g = _random_regular(k, cur_n)
        else:
            raise ValueError(f"unknown graph type {g_type!r}")
        if _is_connected(g):
            return g


def generate_network(net_type: str, num_nodes: int, **params) -> DenseGraph:
    """ER/BA/WS generator used by the SDE scripts (``seed`` an int, a
    ``random.Random`` or None for the global ``random``)."""
    seed = params.get("seed")
    if net_type == "ER":
        return _gnp(num_nodes, params.get("p", 0.1), seed)
    if net_type == "BA":
        return _barabasi_albert(num_nodes, params.get("m", 3), seed)
    if net_type == "WS":
        return _watts_strogatz(num_nodes, params.get("k", 4), params.get("p", 0.1), seed)
    raise ValueError(f"unknown network type: {net_type}")


def graph_properties(adj: np.ndarray, node_mask: np.ndarray, targets: str) -> float:
    """Statistics of the masked subgraph as networkx computes them (an entry
    that is not 0 is an edge; a diagonal entry a self loop): LCC size,
    transitivity, average clustering, natural connectivity (log of the
    Estrada index over n), global efficiency, density."""
    adj = np.asarray(adj)
    keep = np.flatnonzero(np.asarray(node_mask))
    A = adj[np.ix_(keep, keep)] != 0
    n = len(keep)
    loops = np.diag(A).copy()
    B = A & ~np.eye(n, dtype=bool)  # neighbours, self excluded
    if targets == "LCC":
        return float((_hops(B) >= 0).sum(axis=1).max()) if n else 0.0
    Bi = B.astype(np.int64)
    deg = [int(d) for d in Bi.sum(axis=1)]
    tri = [int(t) for t in ((Bi @ Bi) * Bi).sum(axis=1)]  # ordered neighbour pairs joined
    if targets == "global_CC":
        if n == 0:
            return 0.0
        triangles, contri = sum(tri), sum(d * (d - 1) for d in deg)
        return float(0 if triangles == 0 else triangles / contri)
    if targets == "average_CC":
        c = [0 if t == 0 else t / (d * (d - 1)) for d, t in zip(deg, tri)]
        return float(sum(c) / len(c))
    if targets == "natural_connectivity":
        w, v = np.linalg.eigh(A.astype(np.float64))
        estrada = sum(map(float, (np.array(v) ** 2) @ np.exp(w)))
        return float(np.log(estrada / n))
    if targets == "global_efficiency":
        if n * (n - 1) == 0:
            return 0.0
        dist = _hops(B)
        return float(np.sum(1.0 / dist[dist > 0]) / (n * (n - 1)))
    if targets == "density":
        m = (int(B.sum()) // 2) + int(loops.sum())
        if m == 0 or n <= 1:
            return 0.0
        return float(m / (n * (n - 1)) * 2)
    raise ValueError(f"Error fitness_func_type:{targets}")


_GRAPHML_NS = "http://graphml.graphdrawing.org/xmlns"


def save_graphml(g: DenseGraph, path):
    """Write the graph as undirected GraphML (nodes "0".."n-1" in order, then
    the edges): networkx's ``read_graphml`` and ``ops/graph.py::
    graphml_to_adjacency`` read it back in the same node order."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    root = ET.Element("graphml", {
        "xmlns": _GRAPHML_NS,
        "xmlns:xsi": "http://www.w3.org/2001/XMLSchema-instance",
        "xsi:schemaLocation": f"{_GRAPHML_NS} {_GRAPHML_NS}/1.0/graphml.xsd",
    })
    graph = ET.SubElement(root, "graph", {"edgedefault": "undirected"})
    n = g.num_nodes
    for v in range(n):
        ET.SubElement(graph, "node", {"id": str(v)})
    us, vs = np.nonzero(np.triu(np.asarray(g.adj) != 0, k=1))
    for u, v in zip(us.tolist(), vs.tolist()):
        ET.SubElement(graph, "edge", {"source": str(u), "target": str(v)})
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)


def generate_graph_library(
    out_dir, types=("erdos_renyi", "small-world", "barabasi_albert"),
    sizes=(30, 50, 70, 100), seeds=range(10),
):
    """The shipped graph library layout: <type>_<n>_<seed>.graphml (120 files).
    Each graph's parameters draw from ``random.Random(hash((type, n, seed)))``,
    as in the JAX package: the hash of a string changes with
    ``PYTHONHASHSEED``, so the library differs from process to process."""
    out_dir = Path(out_dir)
    for g_type in types:
        for n in sizes:
            for seed in seeds:
                rng = random.Random(hash((g_type, n, seed)) & 0xFFFFFFFF)
                g = gen_graph(g_type, n, n, rng=rng)
                save_graphml(g, out_dir / f"{g_type}_{n}_{seed}.graphml")
