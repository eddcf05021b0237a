"""PyTorch/CUDA port of ``upgdm_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package module for module (``utils``, ``ops``,
``models``, ``eval``); the TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/`` with their Python wrappers in ``ops/kernels/``.

Importing the package pulls in ``torch``, ``numpy`` and ``yaml`` only — never
``jax``, ``flax``, ``optax`` or anything of ``upgdm_tpu``.

Entry points (``eval.uncertainty.uncertainty_ews``, ``diffusion_models``,
``NsDiffModel``, ``TMDMModel``, ``load_model_from_dir``, ``fast_mpv_sweep``,
``run_evaluation_cache``,
``train.loop.run_training``, ``python -m upgdm_tpu_torch.cli.train_timeseries``)
run on ``"cuda"`` unless the caller passes ``device="cpu"``; with no card and
no explicit CPU device they raise.
"""
from .models.factory import diffusion_models

__all__ = ["diffusion_models"]
