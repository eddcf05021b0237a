"""What the ``card`` test files share: the fixture that skips without a CUDA
device, the kernels' launch counters, the geometries and bars, and the
helpers more than one file uses.

The ``card`` cases run on a machine with the card and without JAX, which
``tests/conftest.py`` imports:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_*.py tests/test_torch_port_train_graph.py -m card

Without a CUDA device every case skips. Several cases of a file share a
module-scoped fixture that runs a phase's work once in a fixed order (its
inputs are drawn from seeded generators in that order); each case then
asserts one of the phase's conditions.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import make_windows  # the bench geometry's windows

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- the kernels' launch counters ---------------------------------------------------------

def _wrappers():
    from upgdm_tpu_torch.ops.kernels.chain_resident import fused_chain_rows
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import fused_denoiser_rows
    from upgdm_tpu_torch.ops.kernels.fused_tmdm import fused_tmdm_rows
    from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import nsdiff_chain_update
    from upgdm_tpu_torch.ops.kernels.sde_scan import sde_scan

    return fused_denoiser_rows, fused_chain_rows, fused_tmdm_rows, sde_scan, nsdiff_chain_update


def zero_counts():
    k1, k2, k3, k4, upd = _wrappers()
    k1.launches = k1.launches_act_bf16 = 0
    k2.launches = k2.launches_act_bf16 = 0
    k3.launches = k4.launches = upd.launches = 0


def counts():
    """Launches of (K1, K2, K3, K4, the posterior update) since ``zero_counts``."""
    return tuple(int(w.launches) for w in _wrappers())


def kernel_counts():
    """Launches of (K1, K2, K3) since ``zero_counts``."""
    return counts()[:3]


def assert_updates(what, expected):
    """The posterior-update kernel's launches since ``zero_counts``. A chain of
    T steps takes T launches (one a step and one for t = 0), so a flat NsDiff
    chain takes one a K1 launch and NsDiff_spatial's one a denoiser forward."""
    n = counts()[4]
    assert n == expected, f"{what}: the chain's update launched {n} times, expected {expected}"


# -- geometries -----------------------------------------------------------------------------

# the step kernels' bar against their twins: kernel and twin round the same
# operands to bf16 and sum exact products in float32 in different orders, and
# the tensor-core arm's softplus is good to ~3e-5 relative; an activation within
# that of a bf16 rounding boundary rounds the other way (a 2^-8 relative step in
# one of 128 terms), so the bf16 arm is held to 2e-3 and the float32 arm to 2e-5
TOL = {"float32": 2e-5, "bfloat16": 2e-3}

# bench geometry (bench.py:34-56)
NODE, WINDOWS, PRED_LEN, STEPS, N_Z = 30, 100, 100, 20, 100
N_WINDOWS, CHUNK = 64, 16
NET_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, rolling_length=50,
    diffusion_steps=STEPS, scaler_type="StandardScaler", d_model=512, n_heads=8,
    e_layers=4, d_layers=2, d_ff=256, p_hidden_dims=[64, 64], p_hidden_layers=2,
    n_z_samples=N_Z, task_model="NsDiff", diffusion_schedule="linear",
    beta_start=1e-4, beta_end=2e-2, activation="gelu",
)
M_MAIN = N_Z * CHUNK * NODE * PRED_LEN  # rows per denoiser call on the main path: 4.8 M

# TMDM geometry (benchmarks/ab_tmdm.py:48-53 and the demo_zoo TMDM yaml)
T_STEPS, T_LABEL, T_WINDOWS, T_CHUNK = 100, 50, 16, 8
TMDM_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, label_len=T_LABEL,
    diffusion_steps=T_STEPS, scaler_type="StandardScaler", d_model=64, n_heads=4,
    e_layers=2, d_layers=1, d_ff=128, p_hidden_dims=[64, 64], p_hidden_layers=2,
    n_z_samples=N_Z, task_model="TMDM", beta_schedule="linear", beta_start=1e-4,
    beta_end=2e-2, activation="gelu",
)
M_TMDM = N_Z * T_CHUNK * NODE * (T_LABEL + PRED_LEN)  # rows per K3 call: 3.6 M

# NsDiff train-bench geometry (bench_train.py:33-38) and TMDM's above, B 64
TRAIN_B = 64
TRAIN_PARAM = dict(NET_PARAM, scaler_type=None, dropout=0.05)
TMDM_TRAIN_PARAM = dict(TMDM_PARAM, scaler_type=None, dropout=0.05)
TRAIN_STEPS = 12  # steps a train-step check runs, each loss finite
# card against CPU on one batch, dropout off: float32 on both sides, sums in
# another order through the transformer and back. The attention key biases
# have a zero gradient in exact arithmetic (a shift shared by a query's
# scores leaves the softmax unchanged): only rounding is left in them, held
# below TRAIN_GRAD_ZERO of the model's largest gradient on both sides
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_ZERO = 1e-4, 1e-3, 1e-6

# the demo's protocol (examples/slbp_demo.py:69-130) and its committed records
DEMO = REPO / "demo_artifacts"
SIS_MODEL = REPO / "demo_fig1/ews_results/model_compare/NsDiff/SIS"
SIS_DATA = REPO / "demo_fig1/spdata_sde_SIS/barabasi_albert_12_0/SIS_dynamic_eta0.0001d0.5_increase.pt"

# DiffSTG at the published model-comparison width
# (demo_zoo/ews_results/model_compare/DiffSTG/SIS/model_trained.yaml): ResGatedGraphConv,
# d_h 4, multipliers [2, 2], 2 blocks, Td_h 10, T_h = T_p = 100, 200 training steps,
# 20 DDIM cosine steps, 10 x 10 samples; on the tracked 30-node BA graph
# (benchmarks/ab_diffstg.py:24), 16 windows at the interval step 50
STG_PARAM = dict(
    T_h=WINDOWS, T_p=PRED_LEN, F=1, windows=WINDOWS, pred_len=PRED_LEN, dataset_nf=1, d_h=4,
    Td_h=10, channel_multipliers=[2, 2], n_blocks=2, gnn_name="ResGatedGraphConv",
    gnn_param={"bias": True, "root_weight": True}, diffusion_steps=200,
    diffusion_schedule="linear", inference_diffusion_steps=20, inference_trick="ddim",
    inference_schedule="cosine", loss_weight_schedule="constant", mask_ratio=0.0,
    parallel_sampling=10, sequential_sampling=10, scaler_type="StandardScaler",
    task_model="DiffSTG",
)
STG_GRAPHS = (REPO / "dataset/train_dataset_graph/barabasi_albert_30_0.graphml",
              REPO / "dataset/train_dataset_graph/barabasi_albert_50_0.graphml")
STG_WINDOWS, STG_STEP, STG_TRAIN_B = 16, 50, 16
# the JAX package's bars: a sampled chain against its plain twin
# (tests/test_torch_parity.py) and bf16 against float32 sampling
# (tests/test_models_e2e.py:171)
STG_RTOL, STG_ATOL, STG_MPV_REL = 2e-4, 2e-5, 0.01

# NsDiff_spatial at the spdata grid's width
# (configs/grid_search/diffusion_model_NsDiff_spdata.yaml): GCNConv with self
# loops in f and the denoiser, d_model 64 e2/d1, d_ff 128, d_h 4, [1, 2], 2
# blocks, fT_h = Td_h = 10, W/P 100/100, 20 steps, n_z 100; swept one graph
# at a time (examples/n100_scale_demo.py:108-127) over the DiffSTG windows,
# trained at the grid's batch of 16 graphs
SP_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, rolling_length=50, diffusion_steps=STEPS,
    diffusion_schedule="linear", beta_start=1e-4, beta_end=2e-2, scaler_type="StandardScaler",
    d_model=64, n_heads=4, e_layers=2, d_layers=1, d_ff=128, dropout=0.05, activation="gelu",
    p_hidden_dims=[64, 64], p_hidden_layers=2, spatial_layers=1, fT_h=10, d_h=4, Td_h=10,
    channel_multipliers=[1, 2], n_blocks=2, gnn_name="GCNConv",
    gnn_param={"add_self_loops": True}, f_gnn_name="GCNConv",
    f_gnn_param={"add_self_loops": True}, n_z_samples=N_Z, parallel_sample=10,
    task_model="NsDiff_spatial",
)
SP_TRAIN_B = 16

# DiffusionTS at the published model-comparison width
# (demo_zoo/ews_results/model_compare/DiffusionTS/SIS/model_trained.yaml): d_model 64,
# enc 3 / dec 6, 4 heads, mlp x 4, W/P 100/100, 100 timesteps, 100 DDIM steps,
# eta 0, n_z 100 in rounds of 10, trained at its batch of 256
DTS_PARAM = dict(
    dataset_nf=1, windows=WINDOWS, pred_len=PRED_LEN, timesteps=100, diffusion_steps=100,
    beta_schedule="cosine", n_layer_enc=3, n_layer_dec=6, d_model=64, n_heads=4,
    mlp_hidden_times=4, attn_pd=0.0, resid_pd=0.0, eta=0.0, infill_coef=0.1,
    infill_learning_rate=0.05, loss_type="l2", use_ff=True, n_z_samples=N_Z,
    parallel_sample=10, scaler_type="StandardScaler", task_model="DiffusionTS",
)


# -- the NsDiff chain's eager posterior update ------------------------------------------------

def eager_nsdiff_step(sched_dev, t, y, y_T_mean, gx, eps_theta, sigma_theta, z,
                      use_gx_directly):
    """A step of ``nsdiff_p_sample_loop`` as the eager tensor arithmetic it
    was before the update became one kernel: 0-d gathers of the schedule on
    the data's device, ~50 launches. ``z=None`` is the final step."""
    from upgdm_tpu_torch.ops.diffusion import nsdiff_gather

    c = nsdiff_gather(sched_dev, t, y)
    sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
    if use_gx_directly:
        sigma_y0, noise_var = gx, c.betas_bar_t * gx
    else:
        a, bt_m1, bb_m1 = c.alpha_t, c.betas_tilde_m_1_t, c.betas_bar_m_1_t
        lam0 = a * (1.0 - a) * bt_m1
        lam1 = ((1.0 - a) ** 2 * bt_m1 + a * (1.0 - a) * (bb_m1 - bt_m1)) * gx - sigma_theta * (
            a * bt_m1 + a * (1.0 - a))
        lam2 = gx ** 2 * (1.0 - a) ** 2 * (bb_m1 - bt_m1) - sigma_theta * gx * (
            a * bb_m1 - a * bt_m1 + (1.0 - a) ** 2)
        disc = torch.clamp(lam1 ** 2 - 4.0 * lam0 * lam2, min=0.0)
        sigma_y0 = (-lam1 + torch.sqrt(disc)) / (2.0 * lam0)
        noise_var = (c.betas_bar_t - c.betas_tilde_t) * gx + c.betas_tilde_t * sigma_y0
    y0_reparam = (y - (1.0 - sqrt_abar) * y_T_mean
                  - eps_theta * torch.sqrt(noise_var)) / sqrt_abar
    if z is None:
        return y0_reparam
    a = c.alpha_t
    s1 = (1.0 - a) ** 2 * gx + a * (1.0 - a) * sigma_y0
    s2 = (c.betas_bar_m_1_t - c.betas_tilde_m_1_t) * gx + c.betas_tilde_m_1_t * sigma_y0
    sqrt_a, sqrt_abar_prev = torch.sqrt(a), torch.sqrt(c.alphas_cumprod_prev_t)
    denom = a * s2 + s1
    g0, g1 = sqrt_abar_prev * s1 / denom, sqrt_a * s2 / denom
    g2 = ((sqrt_a * (a - 1.0)) * s2 + (1.0 - sqrt_abar_prev) * s1) / denom
    y_mean = g0 * y0_reparam + g1 * y + g2 * y_T_mean
    return y_mean + torch.sqrt(sigma_theta) * z


def eager_nsdiff_chain(model_fn, y0, gx, sched_dev, generator, use_gx_directly, noise,
                       members):
    """``nsdiff_p_sample_loop`` with ``eager_nsdiff_step`` for its update:
    the same draws in the same order."""
    from upgdm_tpu_torch.ops.diffusion import _chain_draw

    draw = _chain_draw(y0, generator, noise, members)
    y = torch.sqrt(gx) * draw(0) + y0
    for i, t in enumerate(range(sched_dev.num_timesteps - 1, 0, -1)):
        eps, sig = model_fn(y, t)
        y = eager_nsdiff_step(sched_dev, t, y, y0, gx, eps, sig, draw(i + 1), use_gx_directly)
    eps, sig = model_fn(y, 0)
    return eager_nsdiff_step(sched_dev, 0, y, y0, gx, eps, sig, None, use_gx_directly)


# -- training -------------------------------------------------------------------------------

def train_losses(model, select, batch, dtype="float32", n=TRAIN_STEPS, **step_kw):
    """The losses of ``n`` train steps of one stage in float32 or bf16 with
    Adam at lr 1e-3; ``step_kw`` go to the step (a graph batch's ``adj``)."""
    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    model.net_param["train_dtype"] = dtype
    opt = make_optimizer({"optimizer_name": "Adam", "lr": 1e-3}, model.net,
                         model.trainable_mask(select))
    step = make_train_step(model, opt, select)
    return [step(batch, **step_kw) for _ in range(n)]


def card_vs_cpu(card_model, cls, net_param, batch, seams):
    """The loss and gradients of ``card_model`` on one batch against the
    port's CPU run on the same weights and draws, dropout off; AssertionError
    over a bar."""
    from upgdm_tpu_torch.utils.weights import flax_flat_from_torch

    cpu = cls(net_param, device="cpu")
    cpu.load_state_dict(card_model.state_dict(), strict=True)
    out = []
    for m in (card_model, cpu):
        m.net.zero_grad(set_to_none=True)
        m.net.requires_grad_(True)
        kw = {k: v.to(m.device) if torch.is_tensor(v) else v for k, v in seams.items()}
        loss = m.loss_fn(batch.to(m.device), train=False, **kw)
        loss.backward()
        out.append((loss.item(), flax_flat_from_torch({
            k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in m.net.named_parameters()})))
    (l_card, g_card), (l_cpu, g_cpu) = out
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    assert rel <= TRAIN_LOSS_RTOL, f"loss on the card {l_card} vs CPU {l_cpu}: {rel} relative"
    top = max(np.abs(g).max() for g in g_cpu.values())
    for k, g in g_cpu.items():
        if k.endswith(".key.bias"):
            size = float(max(np.abs(g).max(), np.abs(g_card[k]).max()))
            assert size <= TRAIN_GRAD_ZERO * top, f"gradient {k}: {size}, not zero beside {top}"
            continue
        bar = float(TRAIN_GRAD_REL * np.abs(g).max())
        err = float(np.abs(g_card[k] - g).max())
        assert err <= bar, f"gradient {k}: card off the CPU by {err} > {bar}"


def demo_split():
    """The demo's dataset and split: default_rng(0) permutation, n_train a
    multiple of 32 of 90% (examples/slbp_demo.py:75-84)."""
    from upgdm_tpu_torch.utils.data_prep import pre_dataset_timeseries

    dataset_param = dict(file_path=str(DEMO / "slbp_data"), filter="*", sampling_t=100,
                         windows=100, pred_len=100, interval_step=20, STG_exist=False)
    dataset = pre_dataset_timeseries(**dataset_param)
    n_train = (int(len(dataset) * 0.9) // 32) * 32
    perm = np.random.default_rng(0).permutation(len(dataset))
    return dataset[perm[:n_train]], dataset[perm[n_train:]], dataset_param


class Forwards:
    """Counts the forwards of every module of class ``cls`` (a global forward
    pre-hook); ``remove()`` takes the hook out."""

    def __init__(self, cls):
        self.n = 0

        def hook(module, args):
            if isinstance(module, cls):
                self.n += 1

        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)

    def remove(self):
        self.handle.remove()


# -- several processes on the one card ---------------------------------------------------------
MG_SEED, MG_STEPS, MG_TRAIN_B = 5, 3, 64
MG_SGD = dict(optimizer_name="SGD", lr=1e-3, momentum=0.9, weight_decay=0.0)
MG_CHUNK_2 = 8  # chunk_windows of each of the two gloo ranks: the same 16-window blocks


def dp_train_steps(mesh, batch):
    """(model, step, losses, first step's gradients) of MG_STEPS data-parallel
    steps at the train-bench geometry (NsDiff_model, float32, SGD with
    momentum: its update is linear in the gradient, so two runs' weights part
    only by their gradients' rounding), or the plain step with ``mesh`` None."""
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.parallel.data_parallel import make_dp_train_step
    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer
    from upgdm_tpu_torch.utils.weights import flax_flat_from_torch

    model = NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")
    opt = make_optimizer(MG_SGD, model.net, model.trainable_mask())
    step = (make_train_step(model, opt, None) if mesh is None
            else make_dp_train_step(model, opt, mesh))
    losses, grads = [], None
    for _ in range(MG_STEPS):
        losses.append(step(batch))
        grads = grads or flax_flat_from_torch(
            {k: p.grad for k, p in model.net.named_parameters() if p.grad is not None})
    return model, step, losses, grads


def two_rank_check(rank, batch, n_windows):
    """One of two gloo ranks on cuda:0: the NsDiff sweep over ``n_windows``
    bench windows in blocks of 2 x MG_CHUNK_2 (K1 counted), then the
    data-parallel step on ``batch``."""
    import torch.distributed as dist

    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import fused_denoiser_rows
    from upgdm_tpu_torch.parallel.data_parallel import sharded_fast_mpv_sweep
    from upgdm_tpu_torch.parallel.mesh import make_mesh
    from upgdm_tpu_torch.train.loop import deterministic_cudnn

    mesh = make_mesh(2)
    model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
    sharded_fast_mpv_sweep(model, make_windows(2 * MG_CHUNK_2), PRED_LEN, mesh, MG_CHUNK_2)
    model.generator.manual_seed(MG_SEED)
    dist.barrier()
    fused_denoiser_rows.launches = 0
    mpv, pm = sharded_fast_mpv_sweep(model, make_windows(n_windows), PRED_LEN, mesh, MG_CHUNK_2)
    launches = fused_denoiser_rows.launches
    del model
    with deterministic_cudnn():
        _, _, losses, grads = dp_train_steps(mesh, batch)
    return dict(mpv=mpv, pred_mean=pm, k1_launches=launches, losses=losses, grads=grads)


def grid_dataset(dataset_param):
    """The grid search's dataset, the demo corpus (module level: the grid's
    spawned processes import it)."""
    from upgdm_tpu_torch.utils.data_prep import pre_dataset_timeseries

    x = pre_dataset_timeseries(**dataset_param)
    return x, None, x.shape[-1]
