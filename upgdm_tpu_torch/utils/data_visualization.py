"""Training-curve plots on a caller's matplotlib figure.

Counterpart of the curve functions of ``upgdm_tpu/utils/data_visualization.py``
(its ``__all__``); they draw on the figure they are given and import nothing.
The network plot ``visualization_evalution`` needs networkx's Kamada-Kawai
layout and has no counterpart here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["model_evaluation_metrics_curves", "model_evaluation_metrics_curves_vanilla"]


def model_evaluation_metrics_curves(fig, record_scores):
    ax = fig.add_subplot(111)
    ax.plot(record_scores["epoch"], record_scores["train_scores"], color="red", label="train")
    ax.plot(record_scores["epoch"], record_scores["val_scores"], color="skyblue",
            label="validation")
    ax.set_title("train and validation ")
    ax.legend()


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
