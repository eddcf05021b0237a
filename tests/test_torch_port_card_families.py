"""DiffSTG, NsDiff_spatial and DiffusionTS on the card, each against the CPU.

No hand-written denoiser kernel is on these paths (the JAX package runs them
in plain XLA); NsDiff_spatial's chain takes the posterior-update kernel, T
launches a window's chain. DiffSTG at the published model-comparison width on
the tracked 30-node graph: the cache runner over 16 windows, the card's
float32 ensemble per sample against the CPU's, bf16 against float32 MPV, the
loss and gradients against the CPU's, the train step, training through the
``adj`` path on a seeded corpus of the tracked 30- and 50-node graphs with the
checkpoint swept, and the DiffSTG branch of ``uncertainty_ews``.
NsDiff_spatial at the spdata grid's width over the same windows one graph at
a time, likewise, and its three stages trained and swept. DiffusionTS at the
model-comparison width through ``uncertainty_ews`` (forwards and Langevin
gradients counted), the card against the CPU on every forward of a chain,
bf16 against float32 MPV, and its train step. Every case skips without a
CUDA device; on the card (see ``card_checks.py``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_families.py -m card
"""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from card_checks import (
    DTS_PARAM, N_Z, PRED_LEN, SP_PARAM, SP_TRAIN_B, STEPS, STG_ATOL, STG_GRAPHS, STG_MPV_REL,
    STG_PARAM, STG_RTOL, STG_STEP, STG_TRAIN_B, STG_WINDOWS, Forwards,
    WINDOWS, card, card_vs_cpu, counts, kernel_counts, train_losses,  # noqa: F401
    zero_counts,
)

SP_BOUNDED = 100.0  # largest |sample| of a chain that stays bounded (scaled units)
# DiffusionTS: the facade over DTS_WINDOWS windows of a seeded SIS record on the
# tracked 30-node graph (a window is ~2 minutes of the card's time); a sampling
# round at DTS_ROWS rows; the train step at the yaml's batch
DTS_WINDOWS, DTS_TRAIN_B, DTS_ROWS = 1, 256, 32
# the port's module bar (tests/test_torch_port_dts.py: atol 1e-5 of the output's
# scale) on every forward; bf16 against float32 MPV at the JAX package's own
# DiffusionTS bar (tests/test_models_e2e.py:174-210: the chain is chaotic)
DTS_FWD_REL, DTS_MPV_REL = 1e-5, 0.05


def stg_trajectory(n_nodes, T, seed=0):
    """A seeded positive random walk [n_nodes, T] float32."""
    rng = np.random.default_rng(seed)
    walk = (rng.normal(size=(n_nodes, T)) * 0.01).cumsum(axis=1)
    return (0.3 + walk + np.linspace(0.0, 0.4, T)[None]).astype(np.float32)


def stg_windows(n_nodes):
    """(trajectory, STG_WINDOWS windows [n, V, W, 1] at STG_STEP) of the
    seed-0 walk."""
    traj = stg_trajectory(n_nodes, WINDOWS + (STG_WINDOWS - 1) * STG_STEP)
    idx = (np.arange(STG_WINDOWS) * STG_STEP)[:, None] + np.arange(WINDOWS)[None]
    return traj, np.ascontiguousarray(traj[:, idx].transpose(1, 0, 2))[..., None]


def real_nodes(bundle):
    """The node count of each graph of a padded (adjs, graph_ids) bundle:
    the nodes with an edge (every node of the tracked BA graphs has one)."""
    return [int(n) for n in (bundle[0].sum(axis=2) > 0).sum(axis=1)]


def write_stg_corpus(root):
    """A seeded spdata directory on the tracked 30- and 50-node BA graphs:
    <root>/spdata/<g>/rec.pt (ys_dynamic [T, V]) with <root>/graphs/<g>.graphml."""
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.utils.io import save_pt

    for i, src in enumerate(STG_GRAPHS):
        name = src.stem
        (root / "graphs").mkdir(parents=True, exist_ok=True)
        (root / "graphs" / src.name).write_bytes(src.read_bytes())
        n = graphml_to_adjacency(src).num_nodes
        # 8 windows of W + P at STG_STEP, each emitted flipped and original
        ys = stg_trajectory(n, WINDOWS + PRED_LEN + 7 * STG_STEP, seed=10 + i).T
        save_pt({"ys_dynamic": ys, "ts_dynamic": np.arange(len(ys), dtype=np.float32) * 0.1,
                 "tp_values": np.zeros(len(ys), np.float32)}, root / "spdata" / name / "rec.pt")


def spdata_split(root):
    """(x, adjacency bundle, dataset_param) of ``write_stg_corpus(root)``
    through ``cli.train_spdata``'s dataset."""
    from upgdm_tpu_torch.cli.train_spdata import build_dataset

    write_stg_corpus(root)
    dataset_param = dict(spdata_file_path=str(root / "spdata"),
                         graph_file_path=str(root / "graphs"), filter="*", sampling_t=0.1,
                         windows=WINDOWS, pred_len=PRED_LEN, interval_step=STG_STEP)
    x, bundle, _ = build_dataset(dataset_param)
    return x, bundle, dataset_param


def ugnet_forwards():
    """A counter of the graph U-Net forwards (DiffSTG's UGnet and
    NsDiff_spatial's denoiser)."""
    from upgdm_tpu_torch.models.ugnet import GraphUNet

    return Forwards(GraphUNet)


def stg_off_by(got, want, rtol, atol):
    """Largest |got - want| - (atol + rtol |want|): <= 0 within the bar."""
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def save_model_dir(model_dir, model, net_param, dataset):
    """A checkpoint directory that ``uncertainty_ews`` loads."""
    from upgdm_tpu_torch.utils.io import save_checkpoint, save_config_yaml

    save_checkpoint(model_dir, "model_trained", model.state_dict(), net_param)
    save_config_yaml(model_dir / "model_trained.yaml", {
        "dataset": dataset, "train": {"train_model_select": None}, "net": net_param})


def save_sis_record(path, traj):
    from upgdm_tpu_torch.utils.io import save_pt

    save_pt({"ys_dynamic": traj.T.copy(),
             "ts_dynamic": np.arange(traj.shape[1], dtype=np.float32) * 0.1,
             "tp_values": np.zeros(traj.shape[1], np.float32)}, path)


# -- DiffSTG ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def diffstg(card, tmp_path_factory):
    """DiffSTG on the card: the cache runner over STG_WINDOWS windows with
    its UGnet forwards and kernel launches; 2 samples on the card and the
    CPU in float32 from the same weights and draws; bf16 (the default)
    against float32 MPV over S samples on the same draws; the loss and
    gradients against the CPU's; the train step; two epochs through the
    ``adj`` path on a seeded corpus and the checkpoint swept; the facade
    written, hit and its sidecar."""
    from upgdm_tpu_torch.cli.train_driver import hold_out_score
    from upgdm_tpu_torch.eval.uncertainty import (
        load_model_from_dir, run_diffstg_evaluation_cache, summarize_pred_future_list,
        uncertainty_ews,
    )
    from upgdm_tpu_torch.models.diffstg import DiffSTGModel
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency
    from upgdm_tpu_torch.train.loop import deterministic_cudnn

    tmp = tmp_path_factory.mktemp("diffstg")
    forwards = ugnet_forwards()
    graph = graphml_to_adjacency(STG_GRAPHS[0])
    V = graph.num_nodes
    traj, wins = stg_windows(V)
    steps = STG_PARAM["inference_diffusion_steps"]
    S = STG_PARAM["parallel_sampling"] * STG_PARAM["sequential_sampling"]
    out = SimpleNamespace(steps=steps)
    try:
        # -- the cache runner at full width
        model = DiffSTGModel(STG_PARAM, seed=0, device="cuda")
        model.scaler_fit(wins.reshape(-1, WINDOWS, 1))
        run_diffstg_evaluation_cache(model, wins[:1], PRED_LEN, graph, tmp / "warm.pt",
                                     device="cuda")
        zero_counts()
        forwards.n = 0
        ens = run_diffstg_evaluation_cache(model, wins, PRED_LEN, graph, tmp / "sweep.pt",
                                           device="cuda")
        out.sweep_forwards, out.sweep_launches = forwards.n, kernel_counts()
        out.mpv = np.asarray(summarize_pred_future_list(ens, model=model)[1])
        # card against CPU, float32 on both, the same weights and draws: 2 samples
        rng = np.random.default_rng(1)
        hist = np.asarray(model.scaler_transform(wins[0]), np.float32)
        f32 = dict(STG_PARAM, sampling_dtype="float32")
        card32 = DiffSTGModel(f32, seed=0, device="cuda")
        cpu32 = DiffSTGModel(f32, seed=0, device="cpu")
        draws = (rng.normal(size=(2, V, 2 * WINDOWS, 1)).astype(np.float32),
                 rng.normal(size=(steps, 2, V, 2 * WINDOWS, 1)).astype(np.float32))
        e_card = card32.sample_fn(hist, graph.adj, n_samples=2, noise=draws).cpu().numpy()
        e_cpu = cpu32.sample_fn(hist, graph.adj, n_samples=2, noise=draws).numpy()
        out.card_cpu = stg_off_by(e_card, e_cpu, STG_RTOL, STG_ATOL)
        # bf16 (the default) against float32 sampling on the card, the same draws
        draws = (rng.normal(size=(S, V, 2 * WINDOWS, 1)).astype(np.float32),
                 rng.normal(size=(steps, S, V, 2 * WINDOWS, 1)).astype(np.float32))
        m32 = card32.sample_fn(hist, graph.adj, n_samples=S, noise=draws).var(dim=-1).mean()
        card32.net_param["sampling_dtype"] = "bfloat16"
        m16 = card32.sample_fn(hist, graph.adj, n_samples=S, noise=draws).var(dim=-1).mean()
        out.bf16_rel = abs(m16.item() / m32.item() - 1.0)
        del card32, cpu32

        # -- loss and gradients, the train step, run_training, the swept checkpoint
        out.seams = dict(adj=torch.as_tensor(np.stack([graph.adj] * 4)),
                         t=torch.tensor([1, 57, 133, 200]),
                         noise=torch.as_tensor(rng.normal(size=(4, V, 2 * WINDOWS, 1)),
                                               dtype=torch.float32))
        out.batch = torch.as_tensor(rng.normal(size=(4, V, 2 * WINDOWS, 1)), dtype=torch.float32)
        step_batch = torch.as_tensor(
            rng.normal(size=(STG_TRAIN_B, V, WINDOWS + PRED_LEN, 1)).astype(np.float32),
            device="cuda")
        adj = torch.as_tensor(np.stack([graph.adj] * STG_TRAIN_B), device="cuda")
        with deterministic_cudnn():  # as run_training
            out.step_losses = train_losses(DiffSTGModel(STG_PARAM, seed=2, device="cuda"), None,
                                           step_batch, adj=adj)
        x, bundle, dataset_param = spdata_split(tmp / "corpus")
        out.x_shape, out.real_nodes = x.shape, real_nodes(bundle)
        train_param = dict(train_model_select=None, train_batch_size=STG_TRAIN_B,
                           val_batch_size=STG_TRAIN_B, train_epochs=2, test_set=True,
                           ckpt=False, traindata_size=0.75, model_evaluation="hold_out")
        opt = dict(optimizer_name="Adam", lr=1e-4, weight_decay=1e-5, scheduler_set=False)
        out.records = hold_out_score(
            x, train_param, dict(STG_PARAM), {"loss_metric": "KL divergence"}, opt,
            tmp / "train", adj_bundle=bundle, dataset_param=dataset_param, device="cuda")
        trained, _ = load_model_from_dir(tmp / "train/hold_out/trained_model", device="cuda")
        forwards.n = 0
        tens = run_diffstg_evaluation_cache(trained, wins[:2], PRED_LEN, graph,
                                            tmp / "trained.pt", device="cuda")
        out.swept_forwards = forwards.n
        out.swept_mpv = np.asarray(summarize_pred_future_list(tens, model=trained)[1])

        # -- uncertainty_ews from a checkpoint directory
        model_dir = tmp / "facade_model"
        save_model_dir(model_dir, model, STG_PARAM, {"windows": WINDOWS, "pred_len": PRED_LEN,
                                                     "sampling_t": 0.1,
                                                     "interval_step": STG_STEP})
        data_file = tmp / "SIS_dynamic_increase.pt"
        save_sis_record(data_file, traj)
        (tmp / "facade").mkdir()

        def facade():
            forwards.n = 0
            zero_counts()
            r = uncertainty_ews(model_save_file=model_dir, data_file=data_file,
                                dynamic_type="SIS", graph_file=STG_GRAPHS[0],
                                cache_path=tmp / "facade", device="cuda", cache_mode="write")
            return r, forwards.n, kernel_counts()

        out.write, out.hit = facade(), facade()
        cache = Path(out.write[0]["cache_path"])
        out.sidecar = json.loads(cache.with_name(cache.name + ".mpv.json").read_text())
    finally:
        forwards.remove()
    return out


@pytest.mark.card
def test_diffstg_cache_runner(diffstg):
    n_fwd, launched, mpv = diffstg.sweep_forwards, diffstg.sweep_launches, diffstg.mpv
    assert n_fwd == diffstg.steps * STG_WINDOWS and not any(launched), (
        f"{n_fwd} UGnet forwards for {STG_WINDOWS} windows, kernels {launched}")
    assert mpv.shape == (STG_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all(), (
        f"bad MPV {mpv}")


@pytest.mark.card
def test_diffstg_card_against_cpu_per_sample(diffstg):
    assert diffstg.card_cpu <= 0, f"card off the CPU by {diffstg.card_cpu} over the bar"


@pytest.mark.card
def test_diffstg_bf16_against_float32_mpv(diffstg):
    assert diffstg.bf16_rel <= STG_MPV_REL, f"bf16 MPV {diffstg.bf16_rel:.4%} off float32"


@pytest.mark.card
def test_diffstg_train_card_against_cpu(diffstg):
    from upgdm_tpu_torch.models.diffstg import DiffSTGModel

    card_vs_cpu(DiffSTGModel(STG_PARAM, seed=1, device="cuda"), DiffSTGModel, STG_PARAM,
                diffstg.batch, diffstg.seams)


@pytest.mark.card
def test_diffstg_train_step(diffstg):
    assert np.isfinite(diffstg.step_losses).all(), f"step losses {diffstg.step_losses}"


@pytest.mark.card
def test_diffstg_training_and_the_swept_checkpoint(diffstg):
    rs = diffstg.records
    assert (np.isfinite(rs["train_scores"]).all() and np.isfinite(rs["val_scores"]).all()
            and len(rs["train_scores"]) == 2), f"records {rs}"
    assert diffstg.x_shape[1] == 50 and sorted(diffstg.real_nodes) == [30, 50], (
        f"padding: {diffstg.x_shape}, real nodes {diffstg.real_nodes}")
    tmpv = diffstg.swept_mpv
    assert (diffstg.swept_forwards == 2 * diffstg.steps and np.isfinite(tmpv).all()
            and (tmpv > 0).all()), (
        f"swept checkpoint: {diffstg.swept_forwards} forwards, MPV {tmpv}")


@pytest.mark.card
def test_diffstg_facade(diffstg):
    (r_write, f_write, _), (r_hit, f_hit, _) = diffstg.write, diffstg.hit
    ews = np.asarray(r_write["ews"])
    n_fw = len(ews)
    assert (n_fw == STG_WINDOWS and np.isfinite(ews).all() and (ews > 0).all()
            and f_write == 20 * n_fw), f"{n_fw} windows, MPV {ews}, {f_write} UGnet forwards"
    assert f_hit == 0 and r_hit["ews"] == r_write["ews"], (
        f"cache hit: {f_hit} forwards, MPV {r_hit['ews']} vs {r_write['ews']}")
    side = diffstg.sidecar
    assert (side["complete"] and side["n_windows_done"] == n_fw
            and side["ews"] == [float(v) for v in ews]), f"sidecar {side}"


# -- NsDiff_spatial -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nsdiff_spatial(card, tmp_path_factory):
    """NsDiff_spatial on the card: the per-graph sweep through
    ``run_diffstg_evaluation_cache`` at the grid's width with its forwards
    and launches; the first seed whose float32 chain stays bounded; its
    float32 ensemble per sample against the CPU's on the same normals, bf16
    against float32 MPV on the same draws; the three stages through
    ``cli.train_spdata``'s dataset and ``hold_out_score`` (pretrain_f ->
    pretrain_g -> NsDiff_model with ``load_pretrain``) and the trained
    checkpoint swept."""
    from upgdm_tpu_torch.cli.train_driver import hold_out_score
    from upgdm_tpu_torch.eval.uncertainty import (
        load_model_from_dir, run_diffstg_evaluation_cache, summarize_pred_future_list,
    )
    from upgdm_tpu_torch.models.nsdiff_spatial import NsDiffSpatialModel
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency

    tmp = tmp_path_factory.mktemp("nsdiff_spatial")
    forwards = ugnet_forwards()
    graph = graphml_to_adjacency(STG_GRAPHS[0])
    V = graph.num_nodes
    _, wins = stg_windows(V)
    rng = np.random.default_rng(3)
    out = SimpleNamespace()
    try:
        model = NsDiffSpatialModel(SP_PARAM, seed=0, device="cuda")
        model.scaler_fit(wins.reshape(-1, WINDOWS, 1))  # per feature, as run_training
        run_diffstg_evaluation_cache(model, wins[:1], PRED_LEN, graph, tmp / "warm.pt",
                                     device="cuda")
        zero_counts()
        forwards.n = 0
        ens = run_diffstg_evaluation_cache(model, wins, PRED_LEN, graph, tmp / "sweep.pt",
                                           device="cuda")
        out.sweep_forwards, out.sweep_launches = forwards.n, counts()
        out.mpv = np.asarray(summarize_pred_future_list(ens, model=model)[1])
        hist = np.asarray(model.scaler_transform(wins[0]), np.float32)
        # The checks need a chain that stays bounded: with random weights at this
        # width about half the draws give a chain that diverges (to 1e6-1e10 in
        # both packages' arithmetic; the card equals the CPU there at the MPV
        # level), where bf16 against float32 is chaos, not precision. They take
        # the first seed whose float32 chain stays within SP_BOUNDED.
        f32 = dict(SP_PARAM, sampling_dtype="float32")
        out.screened = {}
        for seed in range(8):
            card32 = NsDiffSpatialModel(f32, seed=seed, device="cuda")
            top = card32.sample_fn(hist[None], graph.adj, torch.Generator(device="cuda")
                                   .manual_seed(0), n_z_samples=8).abs().max().item()
            out.screened[seed] = top
            if top <= SP_BOUNDED:
                break
        out.top = top
        if top <= SP_BOUNDED:
            # card against CPU, float32 on both, the same weights and normals: 2 samples
            cpu32 = NsDiffSpatialModel(f32, seed=seed, device="cpu")
            noise = [rng.normal(size=(2, 1, V, PRED_LEN, 1)).astype(np.float32)
                     for _ in range(STEPS)]
            e_card = card32.sample_fn(hist[None], graph.adj, n_z_samples=2, noise=noise)
            e_cpu = cpu32.sample_fn(hist[None], graph.adj, n_z_samples=2, noise=noise)
            out.card_cpu = stg_off_by(e_card.cpu().numpy(), e_cpu.numpy(), STG_RTOL, STG_ATOL)
            # bf16 (the default) against float32 on the card, the same draws
            draws = lambda: torch.Generator(device="cuda").manual_seed(5)
            m32 = card32.sample_fn(hist[None], graph.adj, draws()).var(dim=-1).mean().item()
            card32.net_param["sampling_dtype"] = "bfloat16"
            m16 = card32.sample_fn(hist[None], graph.adj, draws()).var(dim=-1).mean().item()
            out.bf16_rel = abs(m16 / m32 - 1.0)
            del cpu32
        del card32

        # -- the three stages, card against CPU, the swept checkpoint
        out.seams = dict(adj=torch.as_tensor(np.stack([graph.adj] * 4)),
                         t=torch.tensor([0, 7, 12, 19]),
                         noise=torch.as_tensor(rng.normal(size=(4, V, PRED_LEN, 1)),
                                               dtype=torch.float32))
        out.batch = torch.as_tensor(rng.normal(size=(4, V, WINDOWS + PRED_LEN, 1)),
                                    dtype=torch.float32)
        x, bundle, dataset_param = spdata_split(tmp / "corpus")
        train_param = dict(train_batch_size=SP_TRAIN_B, val_batch_size=SP_TRAIN_B,
                           train_epochs=1, test_set=True, ckpt=False, traindata_size=0.75,
                           model_evaluation="hold_out")
        opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
        out.stages, net = {}, dict(SP_PARAM)
        for select in ("pretrain_f", "pretrain_g", "NsDiff_model"):
            if select == "NsDiff_model":
                net.update(load_pretrain=True, load_pretrain_f=True,
                           pretrain_f_path=str(tmp / "sp/pretrain_f/hold_out/trained_model"),
                           pretrain_g_path=str(tmp / "sp/pretrain_g/hold_out/trained_model"))
            out.stages[select] = hold_out_score(
                x, dict(train_param, train_model_select=select), dict(net),
                {"loss_metric": "KL divergence"}, opt, tmp / "sp" / select, adj_bundle=bundle,
                dataset_param=dataset_param, device="cuda")
        trained, _ = load_model_from_dir(tmp / "sp/NsDiff_model/hold_out/trained_model",
                                         device="cuda")
        forwards.n = 0
        tens = run_diffstg_evaluation_cache(trained, wins[:2], PRED_LEN, graph,
                                            tmp / "trained.pt", device="cuda")
        out.swept_forwards = forwards.n
        out.swept_mpv = np.asarray(summarize_pred_future_list(tens, model=trained)[1])
    finally:
        forwards.remove()
    return out


@pytest.mark.card
def test_nsdiff_spatial_sweep(nsdiff_spatial):
    n_fwd, launched, mpv = (nsdiff_spatial.sweep_forwards, nsdiff_spatial.sweep_launches,
                            nsdiff_spatial.mpv)
    assert n_fwd == STEPS * STG_WINDOWS and not any(launched[:3]), (
        f"{n_fwd} denoiser forwards for {STG_WINDOWS} windows, kernels {launched[:3]}")
    assert launched[4] == STEPS * STG_WINDOWS, (
        f"the sweep: the chain's update launched {launched[4]} times, expected "
        f"{STEPS * STG_WINDOWS}")
    assert mpv.shape == (STG_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all(), (
        f"bad MPV {mpv}")


@pytest.mark.card
def test_nsdiff_spatial_card_against_cpu_per_sample(nsdiff_spatial):
    assert nsdiff_spatial.top <= SP_BOUNDED, (
        f"no seed with a bounded chain: {nsdiff_spatial.screened}")
    assert nsdiff_spatial.card_cpu <= 0, (
        f"card off the CPU by {nsdiff_spatial.card_cpu} over the bar")


@pytest.mark.card
def test_nsdiff_spatial_bf16_against_float32_mpv(nsdiff_spatial):
    assert nsdiff_spatial.top <= SP_BOUNDED, (
        f"no seed with a bounded chain: {nsdiff_spatial.screened}")
    assert nsdiff_spatial.bf16_rel <= STG_MPV_REL, (
        f"bf16 MPV {nsdiff_spatial.bf16_rel:.4%} off float32")


@pytest.mark.card
def test_nsdiff_spatial_train_card_against_cpu(nsdiff_spatial):
    from upgdm_tpu_torch.models.nsdiff_spatial import NsDiffSpatialModel

    card_vs_cpu(NsDiffSpatialModel(SP_PARAM, seed=1, device="cuda"), NsDiffSpatialModel,
                SP_PARAM, nsdiff_spatial.batch, nsdiff_spatial.seams)


@pytest.mark.card
@pytest.mark.parametrize("select", ("pretrain_f", "pretrain_g", "NsDiff_model"))
def test_nsdiff_spatial_stage(nsdiff_spatial, select):
    rs = nsdiff_spatial.stages[select]
    assert np.isfinite(rs["train_scores"]).all() and np.isfinite(rs["val_scores"]).all(), (
        f"{select} records {rs}")


@pytest.mark.card
def test_nsdiff_spatial_swept_checkpoint(nsdiff_spatial):
    tmpv = nsdiff_spatial.swept_mpv
    assert (nsdiff_spatial.swept_forwards == 2 * STEPS and np.isfinite(tmpv).all()
            and (tmpv > 0).all()), (
        f"swept checkpoint: {nsdiff_spatial.swept_forwards} forwards, MPV {tmpv}")


# -- DiffusionTS ----------------------------------------------------------------------------

class GradCalls:
    """Counts ``torch.autograd.grad`` calls (the Langevin corrector's
    gradients) while it is installed; ``remove()`` restores the function."""

    def __init__(self):
        self.n, self._orig = 0, torch.autograd.grad

        def counting(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)

        torch.autograd.grad = counting

    def remove(self):
        torch.autograd.grad = self._orig


@pytest.fixture(scope="module")
def diffusionts(card, tmp_path_factory):
    """DiffusionTS on the card: ``uncertainty_ews`` on a seeded SIS record
    over the 30-node graph, written then hit, with the forwards and Langevin
    gradients a window counted; every forward of the CPU's float32 chain with
    the corrector off fed to the card's transformer (the DFT-matmul route on
    both); bf16 against float32 MPV on the same draws; the train step at the
    yaml's batch; the batch and seams of the card-against-CPU loss."""
    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel
    from upgdm_tpu_torch.models.diffusionts_net import DTSTransformer, FourierLayer
    from upgdm_tpu_torch.ops.graph import graphml_to_adjacency

    tmp = tmp_path_factory.mktemp("diffusionts")
    V = graphml_to_adjacency(STG_GRAPHS[0]).num_nodes
    traj = stg_trajectory(V, WINDOWS + (DTS_WINDOWS + 1) * STG_STEP, seed=4)
    rng = np.random.default_rng(4)
    model = DiffusionTSModel(DTS_PARAM, seed=0, device="cuda")
    model.scaler_fit(traj.reshape(-1, 1))
    _, rows = model.ddim_step_table()
    per_round = {"forwards": len(rows) + 1, "grads": sum(r[4] for r in rows)}
    per_round["forwards"] += per_round["grads"]
    out = SimpleNamespace(per_round=per_round, chain_steps=len(rows) + 1,
                          rounds=-(-model.n_z_samples // model.parallel_sample))
    forwards, grads = Forwards(DTSTransformer), GradCalls()
    try:
        model_dir = tmp / "model"
        save_model_dir(model_dir, model, DTS_PARAM,
                       {"windows": WINDOWS, "pred_len": PRED_LEN, "sampling_t": 0.1})
        data_file = tmp / "SIS_dynamic_increase.pt"
        save_sis_record(data_file, traj)
        (tmp / "facade").mkdir()

        def facade():
            forwards.n = grads.n = 0
            zero_counts()
            r = uncertainty_ews(model_save_file=model_dir, data_file=data_file,
                                dynamic_type="SIS", cache_path=tmp / "facade", device="cuda",
                                cache_mode="write", max_windows=DTS_WINDOWS)
            return r, forwards.n, grads.n, kernel_counts()

        out.write, out.hit = facade(), facade()
        rows32 = torch.as_tensor(rng.normal(size=(DTS_ROWS, WINDOWS, 1)),
                                 dtype=torch.float32, device="cuda")
        # card against CPU, float32, corrector off, 2 rows x 2 draws: every
        # forward of the CPU's chain fed to the card's transformer on the same
        # state and timestep (the DFT-matmul route on both), at the module bar.
        # The whole chains are not held to a bar: a top-k selection of the
        # FourierLayer that a last-bit difference flips, or the +-1 clamp, sends
        # a sample elsewhere (the JAX package calls the chain chaotic,
        # tests/test_models_e2e.py:178-183)
        f32 = dict(DTS_PARAM, sampling_dtype="float32", infill_learning_rate=0.0)
        card32 = DiffusionTSModel(f32, seed=0, device="cuda")
        cpu32 = DiffusionTSModel(f32, seed=0, device="cpu")
        for m in cpu32.net.modules():  # the card's route on the CPU too
            if isinstance(m, FourierLayer):
                m.use_dft_matmul = True
        T = WINDOWS + PRED_LEN
        hist = rows32[:2].cpu().numpy()
        noise = (rng.normal(size=(2, 2, T, 1)).astype(np.float32),
                 rng.normal(size=(len(rows), 2, 2, T, 1)).astype(np.float32),
                 rng.normal(size=(len(rows), 2, 2, T, 1)).astype(np.float32))
        calls, plain_output = [], cpu32._output

        def recorded(net, x, t, gen=None):
            y = plain_output(net, x, t, gen)
            calls.append((x, t, y))
            return y

        cpu32._output = recorded
        cpu32.sample_fn(hist, n_z_samples=2, noise=noise)
        out.fwd_rel = []
        with torch.no_grad():
            for x, t, y in calls:
                yc = card32._output(card32.net["model"], x.to("cuda"), t.to("cuda")).cpu()
                out.fwd_rel.append(((yc - y).abs().max() / y.abs().max()).item())
        del card32, cpu32
        # bf16 (the default) against float32, corrector on, 8 rows x 100 draws
        # in one call each, the same draws
        rows8 = torch.as_tensor(model.scaler_transform(traj[:8, :WINDOWS, None]),
                                dtype=torch.float32, device="cuda")
        mpvs = {}
        for dt in ("float32", "bfloat16"):
            model.net_param.update(sampling_dtype=dt, sample_chunk=N_Z)
            gen = torch.Generator(device="cuda").manual_seed(11)
            mpvs[dt] = model.sample_fn(rows8, gen, N_Z).var(dim=-1).mean().item()
        del model.net_param["sample_chunk"]
        out.bf16_rel = abs(mpvs["bfloat16"] / mpvs["float32"] - 1.0)
        # the train step at the yaml's batch; card against CPU on 4 rows
        tb = torch.as_tensor(rng.normal(size=(DTS_TRAIN_B, T, 1)), dtype=torch.float32,
                             device="cuda")
        out.step_losses = train_losses(DiffusionTSModel(DTS_PARAM, seed=1, device="cuda"), None,
                                       tb)
        n_t = DTS_PARAM["timesteps"]
        out.seams = dict(t=torch.tensor([0, n_t // 3, 2 * n_t // 3, n_t - 1]),
                         noise=torch.as_tensor(rng.normal(size=(4, T, 1)), dtype=torch.float32))
        out.batch = tb[:4].cpu()
    finally:
        forwards.remove()
        grads.remove()
    return out


@pytest.mark.card
def test_diffusionts_facade_written_then_hit(diffusionts):
    (r_write, f_write, g_write, l_write), (r_hit, f_hit, g_hit, _) = (diffusionts.write,
                                                                     diffusionts.hit)
    ews = np.asarray(r_write["ews"])
    n_fw, rounds, per_round = len(ews), diffusionts.rounds, diffusionts.per_round
    assert (n_fw == DTS_WINDOWS and np.isfinite(ews).all() and (ews > 0).all()
            and f_write == n_fw * rounds * per_round["forwards"]
            and g_write == n_fw * rounds * per_round["grads"] and not any(l_write)), (
        f"{n_fw} windows, MPV {ews}, {f_write} forwards, {g_write} grads")
    assert f_hit == 0 and g_hit == 0 and r_hit["ews"] == r_write["ews"], (
        f"cache hit: {f_hit} forwards, MPV {r_hit['ews']} vs {r_write['ews']}")


@pytest.mark.card
def test_diffusionts_card_against_cpu_on_every_forward(diffusionts):
    fwd_rel = diffusionts.fwd_rel
    assert len(fwd_rel) == diffusionts.chain_steps, (
        f"{len(fwd_rel)} forwards in a chain of {diffusionts.chain_steps} steps, corrector off")
    assert max(fwd_rel) <= DTS_FWD_REL, (
        f"card off the CPU on a forward by {max(fwd_rel)} of its scale")


@pytest.mark.card
def test_diffusionts_bf16_against_float32_mpv(diffusionts):
    assert diffusionts.bf16_rel <= DTS_MPV_REL, (
        f"bf16 MPV {diffusionts.bf16_rel:.4%} off float32")


@pytest.mark.card
def test_diffusionts_train_step(diffusionts):
    assert np.isfinite(diffusionts.step_losses).all(), f"step losses {diffusionts.step_losses}"


@pytest.mark.card
def test_diffusionts_train_card_against_cpu(diffusionts):
    from upgdm_tpu_torch.models.diffusionts import DiffusionTSModel

    card_vs_cpu(DiffusionTSModel(DTS_PARAM, seed=1, device="cuda"), DiffusionTSModel,
                DTS_PARAM, diffusionts.batch, diffusionts.seams)
