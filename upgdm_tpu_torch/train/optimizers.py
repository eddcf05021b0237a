"""Optimizer and per-epoch learning-rate schedules on ``torch.optim``.

Counterpart of ``upgdm_tpu/train/optimizers.py`` (reference
optimizers/optimizers.py:4-27):

  - Adam, with ``weight_decay`` as L2 added to the gradient before the
    moments (``torch.optim.Adam``'s own meaning, optax's
    ``add_decayed_weights`` before ``adam``); SGD with momentum;
  - only the trainable top-level modules are optimised: the others get
    ``requires_grad=False`` and stay out of the optimizer, which leaves them
    unchanged as optax's ``set_to_zero`` does;
  - schedules map an epoch to a learning rate. The training loop evaluates
    them at ``applied_updates // steps_per_epoch`` and writes the result
    into the optimizer before each step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

__all__ = ["make_optimizer", "make_lr_schedule"]


def make_lr_schedule(optimizer_param: dict) -> Optional[Callable[[int], float]]:
    """epoch -> lr, or None without ``scheduler_set``."""
    if not optimizer_param.get("scheduler_set"):
        return None
    name = optimizer_param.get("scheduler", "StepLR")
    # YAML-1.1 parses "1e-5" as a string; coerce before arithmetic
    base_lr = float(optimizer_param["lr"])

    def _p(*keys, default):
        """First present key wins: the reference schema's names first, then
        the JAX package's aliases."""
        for k in keys:
            if k in optimizer_param:
                return optimizer_param[k]
        return default

    if name == "StepLR":
        step = _p("stepLR_stepsize", "steplr_step_size", "StepLR_step_size", default=30)
        gamma = _p("stepLR_gamma", "steplr_gamma", "StepLR_gamma", default=0.1)
        return lambda epoch: base_lr * gamma ** (epoch // step)
    if name == "MultiStepLR":
        milestones = [int(m) for m in optimizer_param.get("MstepLR_milestones", [30])]
        gamma = optimizer_param.get("MstepLR_gamma", 0.1)
        return lambda epoch: base_lr * gamma ** sum(epoch >= m for m in milestones)
    if name == "CosineAnnealingLR":
        # optax.cosine_decay_schedule: holds at eta_min after T_max, where
        # torch's CosineAnnealingLR would climb back up
        t_max = _p("CALR_Tmax", "CosLR_T_max", default=50)
        eta_min = float(_p("CALR_minlr", "CosLR_eta_min", default=0.0))
        alpha = eta_min / max(base_lr, 1e-12)

        def cosine(epoch):
            decay = 0.5 * (1.0 + math.cos(math.pi * min(epoch, t_max) / t_max))
            return base_lr * ((1.0 - alpha) * decay + alpha)

        return cosine
    if name == "CyclicLR":
        base = float(_p("CyclicLR_blr", "CyclicLR_base_lr", default=base_lr * 0.1))
        max_lr = float(_p("CyclicLR_mlr", "CyclicLR_max_lr", default=base_lr))
        step_size = _p("CyclicLR_upsteps", "CyclicLR_step_size_up", default=10)

        def cyclic(epoch):
            cycle = math.floor(1 + epoch / (2 * step_size))
            x = abs(epoch / step_size - 2 * cycle + 1)
            return base + (max_lr - base) * max(0.0, 1 - x)

        return cyclic
    raise ValueError(f"unknown scheduler {name!r}")


def make_optimizer(optimizer_param: dict, net: nn.ModuleDict,
                   trainable_mask: Optional[Dict[str, bool]] = None) -> torch.optim.Optimizer:
    """Adam or SGD over the parameters of the trainable top-level modules of
    ``net`` (``trainable_mask`` by name; missing names train); the frozen
    ones get ``requires_grad=False``. The learning rate is ``lr``; the
    training loop overwrites it per step where a schedule is set."""
    mask = trainable_mask or {}
    params = []
    for name, module in net.items():
        train = mask.get(name, True)
        module.requires_grad_(train)
        if train:
            params.extend(module.parameters())
    name = optimizer_param.get("optimizer_name", "Adam")
    lr = float(optimizer_param["lr"])
    wd = float(optimizer_param.get("weight_decay", 0.0) or 0.0)
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
    if name == "SGD":
        momentum = float(optimizer_param.get("momentum", 0.0) or 0.0)
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=wd)
    raise ValueError(f"unknown optimizer {name!r}")
