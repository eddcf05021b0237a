"""Driver entry points of the port: a compile check and the multi-device dry run.

Counterpart of ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``):

    python -m upgdm_tpu_torch.parallel.dryrun N [--device cpu]

``entry()`` gives the tiny NsDiff loss and its example arguments;
``dryrun_multigpu(n)`` spawns n ranks (gloo on the CPU, NCCL on n cards),
runs a data-parallel step of NsDiff, of DiffSTG with its adjacency, of TMDM
and of DiffusionTS, DiffusionTS's sampler on each rank's rows, and
``sharded_fast_mpv_sweep`` at the bench geometry cut as the JAX package cuts
it (n_z 8, 10 steps, ``chunk_windows`` 2, 3n windows with a ragged last
block), and prints one ``dryrun_multigpu OK ...`` line. Every rank must
return the same losses and MPV.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

__all__ = ["entry", "dryrun_multigpu"]


def _tiny_net_param():
    return dict(
        dataset_nf=1, windows=32, pred_len=16, rolling_length=8, diffusion_steps=10,
        scaler_type="StandardScaler", d_model=32, n_heads=2, e_layers=1, d_layers=1,
        d_ff=32, p_hidden_dims=[16, 16], p_hidden_layers=2, n_z_samples=8,
        parallel_sample=4, task_model="NsDiff",
    )


# the bench geometry (bench.py NET_PARAM: 30 nodes, W/P 100/100, d512 e4/d2),
# the ensemble and chain cut to n_z 8 and 10 steps as the JAX dry run cuts them
BENCH_PARAM = dict(
    dataset_nf=1, windows=100, pred_len=100, rolling_length=50, diffusion_steps=10,
    scaler_type="StandardScaler", d_model=512, n_heads=8, e_layers=4, d_layers=2, d_ff=256,
    p_hidden_dims=[64, 64], p_hidden_layers=2, n_z_samples=8, parallel_sample=4,
    task_model="NsDiff", diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2,
    output_attention=False, dropout=0.05, factor=3, activation="gelu", load_pretrain=False,
    freeze_pretrain=False,
)


def entry(device=None):
    """(fn, example_args): the loss of the tiny NsDiff, ``fn(batch,
    generator)``, on ``device`` (default the card)."""
    from ..models.nsdiff import NsDiffModel

    model = NsDiffModel(_tiny_net_param(), device=device)

    def fn(batch, generator):
        return model.loss_fn(batch, train=False, generator=generator)

    gen = torch.Generator(device=model.device).manual_seed(0)
    return fn, (torch.zeros(8, 48, 1, device=model.device), gen)


def _adam(model):
    from ..train.optimizers import make_optimizer

    return make_optimizer({"optimizer_name": "Adam", "lr": 1e-3}, model.net,
                          model.trainable_mask())


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    from ..models.diffstg import DiffSTGModel
    from ..models.diffusionts import DiffusionTSModel
    from ..models.nsdiff import NsDiffModel
    from ..models.tmdm import TMDMModel
    from . import draws
    from .data_parallel import make_dp_train_step, sharded_fast_mpv_sweep
    from .mesh import dp_sharding, make_mesh

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh = make_mesh(n)
    rng = np.random.default_rng(0)
    out = {}

    model = NsDiffModel(_tiny_net_param(), device=device)
    step = make_dp_train_step(model, _adam(model), mesh)
    out["loss"] = step(np.zeros((2 * n, 48, 1), np.float32))

    # the graph family: the shared adjacency replicated, the batch sharded
    V = 6
    diffstg = DiffSTGModel(dict(
        T_h=8, T_p=8, F=1, diffusion_steps=10, inference_diffusion_steps=3,
        inference_trick="ddim", inference_schedule="cosine", diffusion_schedule="linear",
        scaler_type=None, d_h=4, Td_h=6, channel_multipliers=[1, 2], n_blocks=1,
        gnn_name="GCNConv", parallel_sampling=2, sequential_sampling=1, mask_ratio=0.1,
        init_num_nodes=V, task_model="DiffSTG"), device=device)
    gstep = make_dp_train_step(diffstg, _adam(diffstg), mesh, with_adj=True)
    gbatch = np.cumsum((rng.normal(size=(2 * n, V, 16, 1)) * 0.1).astype(np.float32), axis=2)
    out["diffstg_loss"] = gstep(gbatch, np.ones((V, V), np.float32))

    tmdm = TMDMModel(dict(
        dataset_nf=1, windows=16, pred_len=8, diffusion_steps=5, d_model=16, n_heads=2,
        e_layers=1, d_layers=1, d_ff=16, p_hidden_dims=[8, 8], p_hidden_layers=2,
        n_z_samples=4, scaler_type=None, task_model="TMDM"), device=device)
    tstep = make_dp_train_step(tmdm, _adam(tmdm), mesh)
    out["tmdm_loss"] = tstep(rng.normal(size=(2 * n, 24, 1)).astype(np.float32))

    dts = DiffusionTSModel(dict(
        dataset_nf=1, windows=16, pred_len=8, diffusion_steps=4, timesteps=8, d_model=16,
        n_heads=2, n_layer_enc=1, n_layer_dec=2, n_z_samples=2, scaler_type=None,
        task_model="DiffusionTS"), device=device)
    dstep = make_dp_train_step(dts, _adam(dts), mesh)
    out["diffusionts_loss"] = dstep(rng.normal(size=(2 * n, 24, 1)).astype(np.float32))
    # the sampling surface (DDIM + Langevin infill) on each rank's rows
    dx = rng.normal(size=(n, 24, 1)).astype(np.float32)
    rows = dp_sharding(mesh, n)
    with draws.row_shard(rows.start, rows.stop, n):
        douts, _ = dts.evaluation_step(dx[rows])
    out["diffusionts_finite"] = bool(torch.isfinite(douts).all())

    bench = NsDiffModel(BENCH_PARAM, device=device)
    traj = (rng.normal(size=(3 * n, 30, 100, 1)) * 0.05 + 1.0).astype(np.float32)
    bench.scaler_fit(traj.reshape(-1, 1))
    out["mpv"], _ = sharded_fast_mpv_sweep(bench, traj, 100, mesh=mesh, chunk_windows=2)
    return out


def dryrun_multigpu(n: int, device=None, deadline_s: float = 900.0) -> dict:
    """The dry run over ``n`` ranks: gloo processes with ``device="cpu"``,
    else one rank on each of ``n`` cards over NCCL. Raises when a rank
    fails, disagrees with rank 0 or gives a non-finite value; prints and
    returns rank 0's results."""
    from ..utils.device import resolve_device
    from .mesh import spawn_ranks

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multigpu({n}) needs {n} cards, "
                           f"{torch.cuda.device_count()} visible")
    results = spawn_ranks(_dryrun_rank, n, (n, dev.type), backend=backend, device=dev.type,
                          deadline_s=deadline_s)
    first = results[0]
    for r, res in enumerate(results):
        same = all(np.array_equal(np.asarray(res[k]), np.asarray(first[k])) for k in first)
        if not same:
            raise RuntimeError(f"rank {r} returned {res}, rank 0 {first}")
    losses = [first[k] for k in ("loss", "diffstg_loss", "tmdm_loss", "diffusionts_loss")]
    if not (np.isfinite(losses).all() and first["diffusionts_finite"]
            and np.isfinite(first["mpv"]).all() and first["mpv"].shape == (3 * n,)):
        raise RuntimeError(f"dryrun_multigpu: non-finite results {first}")
    print(f"dryrun_multigpu OK on {n} ranks ({backend}); loss={first['loss']:.4f} "
          f"diffstg_loss={first['diffstg_loss']:.4f} tmdm_loss={first['tmdm_loss']:.4f} "
          f"diffusionts_loss={first['diffusionts_loss']:.4f} "
          f"bench_geometry_windows={first['mpv'].shape[0]}", flush=True)
    return first


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-device dry run of the port.")
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    ap.add_argument("--device", default=None, help="cpu for gloo ranks (default: the cards)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print("entry loss:", fn(*example).item(), flush=True)
    dryrun_multigpu(args.n, args.device)


if __name__ == "__main__":
    main()
