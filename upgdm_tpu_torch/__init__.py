"""PyTorch/CUDA port of ``upgdm_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package module for module (``utils``, ``ops``,
``models``, ``eval``, ``figures``, ``data``, and the experiment drivers of
``examples/`` as ``examples``); the TPU's Pallas kernels become
hand-written CUDA kernels under ``csrc/`` with their Python wrappers in
``ops/kernels/``, and so does the Euler–Maruyama scan of the SDE simulators
(K4, ``ops/kernels/sde_scan.py``).

Importing the package pulls in ``torch`` and ``numpy`` only, and its modules
``scipy`` and ``yaml`` besides — never ``jax``, ``flax``, ``optax``,
``networkx``, ``pandas``, ``tensorflow``, ``h5py`` or anything of
``upgdm_tpu``. ``diffusion_models``, ``uncertainty_ews`` and
``run_training`` are exported lazily, as the JAX package exports them.

Entry points (``eval.uncertainty.uncertainty_ews``, ``diffusion_models``,
``NsDiffModel``, ``TMDMModel``, ``DiffSTGModel``, ``NsDiffSpatialModel``,
``DiffusionTSModel``, ``load_model_from_dir``,
``fast_mpv_sweep``, ``run_evaluation_cache``, ``run_diffstg_evaluation_cache``,
``train.loop.run_training``, ``python -m upgdm_tpu_torch.cli.train_timeseries``,
``python -m upgdm_tpu_torch.cli.train_spdata``, the ``slbp_*`` analyses of
``eval.uncertainty``, the figure CLIs ``python -m
upgdm_tpu_torch.figures.<fig> --device ...``, the simulators of ``data.sde``,
the drivers of ``data.generate`` and ``python -m upgdm_tpu_torch.data.generate
--device ...``, the real-data CLIs ``python -m upgdm_tpu_torch.eval.real_data``,
``python -m upgdm_tpu_torch.eval.bury`` and ``python -m
upgdm_tpu_torch.figures.real_systems``, each with ``--device``, the
multi-device dry run ``python -m upgdm_tpu_torch.parallel.dryrun N`` and the
experiment drivers ``python -m upgdm_tpu_torch.examples.<name> --device ...``)
run on ``"cuda"`` unless the caller passes ``device="cpu"``; with no card and
no explicit CPU device they raise.
"""
__version__ = "0.1.0"

__all__ = ["__version__", "diffusion_models", "uncertainty_ews", "run_training"]


def diffusion_models(*args, **kwargs):
    from .models.factory import diffusion_models as _f

    return _f(*args, **kwargs)


def uncertainty_ews(*args, **kwargs):
    from .eval.uncertainty import uncertainty_ews as _f

    return _f(*args, **kwargs)


def run_training(*args, **kwargs):
    from .train.loop import run_training as _f

    return _f(*args, **kwargs)
