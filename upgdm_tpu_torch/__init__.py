"""PyTorch/CUDA port of ``upgdm_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package module for module (``utils``, ``ops``,
``models``, ``eval``, ``figures``, ``data``); the TPU's Pallas kernels become
hand-written CUDA kernels under ``csrc/`` with their Python wrappers in
``ops/kernels/``, and so does the Euler–Maruyama scan of the SDE simulators
(K4, ``ops/kernels/sde_scan.py``).

Importing the package pulls in ``torch``, ``numpy``, ``scipy`` and ``yaml`` only —
never ``jax``, ``flax``, ``optax``, ``networkx``, ``pandas`` or anything of
``upgdm_tpu``.

Entry points (``eval.uncertainty.uncertainty_ews``, ``diffusion_models``,
``NsDiffModel``, ``TMDMModel``, ``DiffSTGModel``, ``NsDiffSpatialModel``,
``DiffusionTSModel``, ``load_model_from_dir``,
``fast_mpv_sweep``, ``run_evaluation_cache``, ``run_diffstg_evaluation_cache``,
``train.loop.run_training``, ``python -m upgdm_tpu_torch.cli.train_timeseries``,
``python -m upgdm_tpu_torch.cli.train_spdata``, the ``slbp_*`` analyses of
``eval.uncertainty``, the figure CLIs ``python -m
upgdm_tpu_torch.figures.<fig> --device ...``, the simulators of ``data.sde``,
the drivers of ``data.generate`` and ``python -m upgdm_tpu_torch.data.generate
--device ...``)
run on ``"cuda"`` unless the caller passes ``device="cpu"``; with no card and
no explicit CPU device they raise.
"""
from .models.factory import diffusion_models

__all__ = ["diffusion_models"]
