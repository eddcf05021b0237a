"""Training-curve plots on a caller's matplotlib figure, and the network plot
of predictions against labels.

Counterpart of ``upgdm_tpu/utils/data_visualization.py``: the curve functions
draw on the figure they are given and import nothing; ``visualization_evalution``
lays the graph out with ``kamada_kawai_layout`` (networkx's Kamada-Kawai
layout restated in numpy and scipy: the card's machine has no networkx) and
draws with matplotlib, imported in the call.
"""
from __future__ import annotations

import numpy as np

__all__ = ["model_evaluation_metrics_curves", "model_evaluation_metrics_curves_vanilla",
           "kamada_kawai_layout", "visualization_evalution"]


def model_evaluation_metrics_curves(fig, record_scores):
    ax = fig.add_subplot(111)
    ax.plot(record_scores["epoch"], record_scores["train_scores"], color="red", label="train")
    ax.plot(record_scores["epoch"], record_scores["val_scores"], color="skyblue",
            label="validation")
    ax.set_title("train and validation ")
    ax.legend()


def _undirected_weights(adj: np.ndarray) -> np.ndarray:
    """The symmetric weight matrix of ``networkx.from_numpy_array(adj)``: an
    undirected edge for every nonzero entry, the later entry in row-major
    order setting the weight of a pair."""
    adj = np.asarray(adj, np.float64)
    lower = np.tril(adj, -1)  # entries (j, i) with j > i: the later ones
    w = np.where(lower != 0, lower, np.triu(adj, 1).T)
    return w + w.T


def kamada_kawai_layout(adj: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """[n, 2] node positions of networkx 3.6's ``kamada_kawai_layout`` of the
    graph ``from_numpy_array(adj)`` in 2 dimensions: weighted shortest-path
    lengths (1e6 between components) as the preferred distances, the circular
    layout (float32 angles) as the start, the Kamada-Kawai energy with its
    mean-position term minimised by L-BFGS-B, then rescaled to [-scale,
    scale]."""
    from scipy.optimize import minimize
    from scipy.sparse.csgraph import shortest_path

    n = len(adj)
    if n == 0:
        return np.zeros((0, 2))
    if n == 1:
        return np.zeros((1, 2))
    w = _undirected_weights(adj)
    dist = shortest_path(w, method="D", directed=False)
    dist_mtx = np.where(np.isinf(dist), 1e6, dist)
    theta = (np.linspace(0, 1, n + 1)[:-1] * 2 * np.pi).astype(np.float32)
    pos = _rescale(np.column_stack([np.cos(theta), np.sin(theta), np.zeros((n, 0))]), scale)
    meanwt = 1e-3
    invdist = 1 / (dist_mtx + np.eye(n) * 1e-3)
    res = minimize(_kamada_kawai_cost, pos.ravel(), method="L-BFGS-B",
                   args=(invdist, meanwt, 2), jac=True)
    return _rescale(res.x.reshape((-1, 2)), scale)


def _rescale(pos: np.ndarray, scale: float) -> np.ndarray:
    """networkx's ``rescale_layout``: centred, the largest |coordinate| at
    ``scale``."""
    pos = pos - pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= scale / lim
    return pos


def _kamada_kawai_cost(pos_vec, invdist, meanweight, dim):
    """The Kamada-Kawai energy and its gradient (networkx's cost function)."""
    n = invdist.shape[0]
    pos_arr = pos_vec.reshape((n, dim))
    delta = pos_arr[:, np.newaxis, :] - pos_arr[np.newaxis, :, :]
    nodesep = np.linalg.norm(delta, axis=-1)
    direction = np.einsum("ijk,ij->ijk", delta, 1 / (nodesep + np.eye(n) * 1e-3))
    offset = nodesep * invdist - 1.0
    offset[np.diag_indices(n)] = 0
    cost = 0.5 * np.sum(offset**2)
    grad = np.einsum("ij,ij,ijk->ik", invdist, offset, direction) - np.einsum(
        "ij,ij,ijk->jk", invdist, offset, direction
    )
    sumpos = np.sum(pos_arr, axis=0)
    cost += 0.5 * meanweight * np.sum(sumpos**2)
    grad += meanweight * sumpos
    return (cost, grad.ravel())


def visualization_evalution(pred, adj, target, save_path=None):
    """2-panel network plot of predictions against labels: node colours
    sigmoid(pred) and target on the Kamada-Kawai layout of the dense
    adjacency (the edges of its nonzero entries)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    adj = np.asarray(adj)
    pos = kamada_kawai_layout(adj)
    w = _undirected_weights(adj)
    segments = [(pos[i], pos[j]) for i, j in zip(*np.nonzero(np.triu(w, 1)))]
    out = 1.0 / (1.0 + np.exp(-np.asarray(pred, float)))
    fig = plt.figure("2d visualization of predict")
    for k, (title, colour) in enumerate((("Prediction", out),
                                         ("Labels of network key nodes",
                                          np.asarray(target, float)))):
        ax = fig.add_subplot(211 + k)
        ax.set(title=title)
        ax.add_collection(LineCollection(segments, colors="k", linewidths=1, zorder=1))
        nodes = ax.scatter(pos[:, 0], pos[:, 1], c=colour, s=300, zorder=2)
        ax.tick_params(axis="both", which="both", bottom=False, left=False,
                       labelbottom=False, labelleft=False)
        fig.colorbar(nodes, ax=ax)
    if save_path is not None:
        fig.savefig(save_path, dpi=200, bbox_inches="tight")
    return fig


def model_evaluation_metrics_curves_vanilla(fig, record_scores, score_metrics,
                                            subplot_numCols=2):
    n_rows = int(np.ceil(len(score_metrics) / subplot_numCols))
    for i, score_metric in enumerate(score_metrics, start=1):
        ax = fig.add_subplot(n_rows, subplot_numCols, i)
        ax.plot(record_scores["epoch"], record_scores[score_metric]["train_scores"],
                color="red", label="train")
        ax.plot(record_scores["epoch"], record_scores[score_metric]["val_scores"],
                color="skyblue", label="validation")
        ax.set_title(score_metric)
        ax.legend()
