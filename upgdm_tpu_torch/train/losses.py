"""Loss registry, evaluation-score registry and the CEP contrastive loss.

Counterpart of ``upgdm_tpu/train/losses.py``: ``train_loss`` /
``loss_wrapper`` / ``evaluation_score`` dispatch, and CEPLoss with its three
forward corruption processes (Gaussian, categorical, discrete flow). These
drive the supervised graph-regression loop (``train/vanilla.py``); the four
diffusion families carry their losses inside their wrappers.

The Gaussian forward process and CEPLoss's timesteps draw from a
``torch.Generator``, where the JAX package splits a key; both also take the
draws from the caller (``eps``, ``t``), so a test can feed JAX's. The
evaluation scores are numpy versions of scikit-learn's ``mean_squared_error``,
``r2_score``, ``accuracy_score``, ``f1_score`` (binary) and
``roc_auc_score`` (binary), which the card's machine does not have; the
argument order is scikit-learn's ``(y_true, y_pred)``, and callers pass
what the JAX package passes.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "train_loss",
    "loss_wrapper",
    "evaluation_score",
    "CEPLoss",
    "CEPGaussianDiffusion",
    "CategoricalDiffusion",
    "DiscreteFlowDiffusion",
]


# ---------------------------------------------------------------------------
# simple losses
# ---------------------------------------------------------------------------

def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def bce_loss(pred, target):
    p = torch.clamp(pred, 1e-7, 1 - 1e-7)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def cross_entropy_loss(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


# ---------------------------------------------------------------------------
# CEP forward corruption processes
# ---------------------------------------------------------------------------

def _linear_or_cosine_beta(T, schedule):
    if schedule == "linear":
        return np.linspace(1e-4, 2e-2, T)
    if schedule == "cosine":
        offset = 0.008

        def cos_noise(t):
            return np.cos(math.pi * 0.5 * (t / T + offset) / (1 + offset)) ** 2

        alphabar = cos_noise(np.arange(0, T + 1, 1)) / cos_noise(0)
        return np.clip(1 - (alphabar[1:] / alphabar[:-1]), None, 0.999)
    raise ValueError(f"unknown schedule {schedule!r}")


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


class CEPGaussianDiffusion:
    """Gaussian corruption (1-indexed)."""

    def __init__(self, T, schedule="linear", loss_weight_schedule="constant", **_):
        self.T = T
        self.loss_weight_schedule = loss_weight_schedule
        self.beta = _linear_or_cosine_beta(T, schedule)
        self.alpha = np.concatenate([[1.0], 1.0 - self.beta])
        self.alphabar = np.cumprod(self.alpha)

    def sample(self, x0, t, generator=None, eps=None):
        """sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, eps ~ N(0, 1) from
        ``generator`` unless given."""
        atbar = torch.as_tensor(self.alphabar, dtype=x0.dtype, device=x0.device)[t]
        atbar = _expand(atbar, x0)
        if eps is None:
            eps = torch.randn(x0.shape, dtype=x0.dtype, device=x0.device, generator=generator)
        return torch.sqrt(atbar) * x0 + torch.sqrt(1.0 - atbar) * eps


class CategoricalDiffusion:
    """Binary categorical corruption via uniform-flip transition matrices."""

    def __init__(self, T, schedule="linear", loss_weight_schedule="constant", **_):
        self.T = T
        self.loss_weight_schedule = loss_weight_schedule
        self.beta = _linear_or_cosine_beta(T, schedule)
        beta = self.beta.reshape(-1, 1, 1)
        eye = np.eye(2)[None]
        ones = np.ones((1, 2, 2))
        Qs = (1 - beta) * eye + (beta / 2) * ones
        Q_bar = [np.eye(2)]
        for Q in Qs:
            Q_bar.append(Q_bar[-1] @ Q)
        self.Q_bar = np.stack(Q_bar, axis=0)  # [T+1, 2, 2]

    def sample(self, x0, t, generator=None, eps=None):
        """x0 in {0,1} (or [0,1] probabilities); returns corrupted P(x_t = 1)."""
        x0_onehot = torch.stack([1.0 - x0, x0], dim=-1)  # [..., 2]
        Q_bar = torch.as_tensor(self.Q_bar, dtype=x0.dtype, device=x0.device)[t]
        probs = torch.einsum("...i,...ij->...j", x0_onehot, Q_bar)
        return torch.clamp(probs[..., 1], 0.0, 1.0)


class DiscreteFlowDiffusion:
    """Discrete-flow interpolation toward uniform."""

    def __init__(self, T, loss_weight_schedule="constant", discrete_classes=2, **_):
        self.T = T
        self.loss_weight_schedule = loss_weight_schedule
        self.S = discrete_classes

    def sample(self, x0, t, generator=None, eps=None):
        """p(x_t | x_1) = t/T * onehot(x0) + (1 - t/T)/S, class-1 prob."""
        frac = torch.as_tensor(t, dtype=torch.float32, device=x0.device) / self.T
        frac = _expand(frac, x0)
        p1 = frac * x0 + (1.0 - frac) / self.S
        return torch.clamp(p1, 0.0, 1.0)


class CEPLoss:
    """Contrastive energy prediction loss over a batch of noisy graphs:
    corrupt each graph's node features at a per-graph timestep, predict
    energies, and contrast the softmax of the predicted energies against the
    softmax of the true energies across the batch.

    model_fn(noisy_x, t) -> predicted energy per graph [B].
    """

    def __init__(self, diffusion_type, diffusion_params, **_):
        cls = {
            "GaussianDiffusion": CEPGaussianDiffusion,
            "CategoricalDiffusion": CategoricalDiffusion,
            "DiscreteFlowDiffusion": DiscreteFlowDiffusion,
        }.get(diffusion_type)
        if cls is None:
            raise ValueError("Invalid diffusion type")
        self.diffusion = cls(**diffusion_params)

    def __call__(self, model_fn: Callable, x, y, generator=None, t=None, eps=None):
        """x: [B, V, ...] node features in [0, 1]; y: [B] graph energies;
        ``t`` ([B] in 1..T) and the Gaussian ``eps`` are drawn from
        ``generator`` unless given."""
        B = x.shape[0]
        if t is None:
            t = torch.randint(1, self.diffusion.T + 1, (B,), device=x.device,
                              generator=generator)
        t_nodes = t.reshape((B,) + (1,) * (x.ndim - 1))  # per-graph t over nodes
        noisy_x = self.diffusion.sample(x, t_nodes, generator, eps)
        pred_energy = model_fn(noisy_x, t.float())  # [B]
        energy_matrix = y[None, :].expand(B, B)
        pred_matrix = pred_energy[None, :].expand(B, B)
        weights = torch.softmax(-energy_matrix, dim=1)
        log_probs = torch.log_softmax(-pred_matrix, dim=1)
        return -torch.sum(weights * log_probs) / B


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def train_loss(loss_metric: str, loss_param: Optional[dict] = None):
    loss_param = loss_param or {}
    if loss_metric == "MSELoss":
        return mse_loss
    if loss_metric == "BCELoss":
        return bce_loss
    if loss_metric == "CrossEntropyLoss":
        return cross_entropy_loss
    if loss_metric == "CEPLoss":
        return CEPLoss(**loss_param)
    raise ValueError("the definition don't exit\n\tyou can define it before using it")


def loss_wrapper(loss_metric, criterion, input, target=None, model_fn=None, generator=None,
                 **_):
    if loss_metric in ("MSELoss", "BCELoss", "CrossEntropyLoss"):
        return criterion(input, target)
    if loss_metric == "CEPLoss":
        x, y = input
        return criterion(model_fn, x, y, generator)
    raise ValueError("the definition don't exit\n\tyou can define it before using it")


def evaluation_score(score_metric: str):
    registry = {
        "mse": _mean_squared_error,
        "r2": _r2_score,
        "accuracy": _accuracy_score,
        "f1": _f1_score,
        "roc_auc": _roc_auc_score,
        "kendall_rank": _kendall_rank,
        "rank_accuracy": _rank_accuracy,
        "set_correlation": _set_correlation,
        "Min_nodes": None,
    }
    if score_metric not in registry:
        raise ValueError(f"the definition {score_metric} don't exit")
    return registry[score_metric]


def _pair(y_true, y_pred):
    a, b = np.asarray(y_true), np.asarray(y_pred)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"inconsistent numbers of samples: {a.shape[0]} and {b.shape[0]}")
    return a, b


def _mean_squared_error(y_true, y_pred):
    a, b = _pair(y_true, y_pred)
    return float(np.mean((a.astype(float) - b) ** 2))


def _r2_score(y_true, y_pred):
    """1 - SS_res / SS_tot; a constant ``y_true`` gives 1.0 when predicted
    exactly, else 0.0 (scikit-learn's ``force_finite``)."""
    a, b = _pair(y_true, y_pred)
    a = a.astype(float).reshape(len(a), -1)
    b = np.asarray(b, float).reshape(len(b), -1)
    ss_res = ((a - b) ** 2).sum(axis=0)
    ss_tot = ((a - a.mean(axis=0)) ** 2).sum(axis=0)
    out = np.ones(a.shape[1])
    nz = ss_tot != 0
    out[nz] = 1.0 - ss_res[nz] / ss_tot[nz]
    out[~nz & (ss_res != 0)] = 0.0
    return float(out.mean())


def _accuracy_score(y_true, y_pred):
    a, b = _pair(y_true, y_pred)
    return float(np.mean(a == b))


def _binary_labels(y_true, y_pred=None):
    labels = np.unique(np.concatenate([np.ravel(y_true)] + (
        [] if y_pred is None else [np.ravel(y_pred)])))
    if len(labels) > 2 or not set(labels.tolist()) <= {0, 1}:
        raise ValueError(f"binary 0/1 labels expected, got {labels.tolist()}")


def _f1_score(y_true, y_pred):
    """Binary F1 of the positive label 1 (0.0 where it is undefined)."""
    a, b = _pair(y_true, y_pred)
    _binary_labels(a, b)
    tp = np.sum((a == 1) & (b == 1))
    fp = np.sum((a != 1) & (b == 1))
    fn = np.sum((a == 1) & (b != 1))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def _roc_auc_score(y_true, y_score):
    """Binary ROC AUC: the Mann-Whitney statistic, ties counted half."""
    a, s = _pair(y_true, y_score)
    a, s = np.ravel(a), np.ravel(np.asarray(s, float))
    _binary_labels(a)
    pos, neg = a == 1, a != 1
    if not pos.any() or not neg.any():
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in "
                         "that case.")
    from scipy.stats import rankdata

    ranks = rankdata(s)
    n_pos, n_neg = pos.sum(), neg.sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _kendall_rank(pred, target, **_):
    from scipy import stats

    tau, _p = stats.kendalltau(np.asarray(pred).ravel(), np.asarray(target).ravel())
    return tau


def _rank_accuracy(pred, target, top_fraction=0.6, **_):
    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    c = int(np.ceil(len(pred) * top_fraction))
    return float(np.mean(np.argsort(pred)[:c] == np.argsort(target)[:c]))


def _set_correlation(pred, target, **_):
    pred_set = set(np.flatnonzero(np.asarray(pred) == 1).tolist())
    target_set = set(np.flatnonzero(np.asarray(target) == 1).tolist())
    union = len(pred_set | target_set)
    return len(pred_set & target_set) / union if union else 0.0
