"""Model factory — string dispatch over the ported diffusion families.

Counterpart of ``upgdm_tpu/models/factory.py``: every family the JAX
package builds (DiffSTG, DiffusionTS, TMDM, NsDiff_spatial, NsDiff and its
ablation variants); another name raises ``ValueError``, as there.
"""
from __future__ import annotations

__all__ = ["diffusion_models"]


def diffusion_models(task_model: str, net_param: dict, **kwargs):
    """Build ``task_model`` from ``net_param``; keywords: ``seed``,
    ``device`` and, for NsDiff and NsDiff_spatial, ``train_model_select``
    (for the variants, which ablation). Both NsDiff read
    ``pretrain_f_path``/``pretrain_g_path`` from ``net_param``."""
    train_model_select = kwargs.get("train_model_select")
    seed = kwargs.get("seed", 0)
    device = kwargs.get("device")
    if task_model == "DiffusionTS":
        from .diffusionts import DiffusionTSModel

        return DiffusionTSModel(net_param=net_param, seed=seed, device=device)
    if task_model == "TMDM":
        from .tmdm import TMDMModel

        return TMDMModel(net_param=net_param, seed=seed, device=device)
    if task_model == "DiffSTG":
        from .diffstg import DiffSTGModel

        return DiffSTGModel(net_param=net_param, seed=seed, device=device)
    if task_model in ("NsDiff", "NsDiff_spatial"):
        from .nsdiff import NsDiffModel
        from .nsdiff_spatial import NsDiffSpatialModel

        cls = NsDiffModel if task_model == "NsDiff" else NsDiffSpatialModel
        return cls(
            net_param=net_param,
            train_model_select=train_model_select or "NsDiff_model",
            pretrain_f_path=net_param.get("pretrain_f_path") or None,
            pretrain_g_path=net_param.get("pretrain_g_path") or None,
            seed=seed,
            device=device,
        )
    if task_model == "NsDiff_model_variants":
        from .nsdiff import NsDiffVariants

        return NsDiffVariants(net_param=net_param, train_model_select=train_model_select,
                              seed=seed, device=device)
    raise ValueError("the definition don't exit\n\tyou can define it before using it")
