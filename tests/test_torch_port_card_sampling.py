"""The port's sampling paths on the card.

The NsDiff sampling-MPV sweep at the bench geometry (``bench.py``: Node 30,
W/P 100/100, 20 steps, 100 samples, d_model 512, e4/d2) and the TMDM sweep at
the model-comparison geometry (label 50, 100 steps, d_model 64, e2/d1), with
their launch counts; each kernel chain against the chain with no kernel
(float32) and its bf16 chain against its float32 chain at the MPV level; the
K2 arm and its bf16-activation arm against the K1 path; the cache-first
runner; the trained SIS model of ``demo_fig1`` against the CPU; and the
``uncertainty_ews`` facade on that model straight from the device, through
its cache and with bf16 activations. Every case skips without a CUDA device;
on the card (see ``card_checks.py``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_sampling.py -m card
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from card_checks import (
    CHUNK, N_WINDOWS, N_Z, NET_PARAM, NODE, PRED_LEN, SIS_DATA, SIS_MODEL, STEPS, T_CHUNK,
    T_LABEL, T_STEPS, T_WINDOWS, TMDM_PARAM, WINDOWS, assert_updates, card,  # noqa: F401
    counts, eager_nsdiff_chain, make_windows, zero_counts,
)

# a bf16 chain's ensemble MPV against the float32 chain's, same draws: the JAX
# package's bar for its bf16 kernel
# (tests/test_pallas_denoiser.py::test_bf16_chain_mpv_parity); the K2 arm's
# against the K1 path's and the bf16-activation arms' against the
# float32-activation arms' at the same bar
MPV_REL = 0.01
# a kernel chain against the plain chain, float32 on both sides with sums in
# another order, carried through the reverse steps (the CPU test holds the
# plain path to JAX at the same)
CHAIN_RTOL = CHAIN_ATOL = 1e-4


def chunk_mpv(ens):
    """Ensemble variance over the members (last axis), averaged."""
    return ens.var(dim=-1, correction=0).mean().item()


@pytest.fixture(scope="module")
def nsdiff(card):
    """The NsDiff main path at full width: a warm-up sweep, the 64-window
    sweep with its launches, the first chunk's f/g and its K1 chain."""
    from upgdm_tpu_torch.eval.uncertainty import fast_mpv_sweep, mpv_reduce
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel

    model = NsDiffModel(NET_PARAM, seed=0, device="cuda")
    fast_mpv_sweep(model, make_windows(CHUNK), PRED_LEN, chunk_windows=CHUNK)
    wins = make_windows(N_WINDOWS)
    zero_counts()
    mpv, pmean = fast_mpv_sweep(model, wins, PRED_LEN, chunk_windows=CHUNK)
    launches = counts()
    x0 = torch.as_tensor(model.scaler_transform(wins[:CHUNK].reshape(-1, WINDOWS, 1)),
                         dtype=torch.float32, device=card)
    y0h, gxh = model.f_and_g(x0)
    ens = model.sample_chain(y0h, gxh, torch.Generator(device=card).manual_seed(3), N_Z)
    std = torch.ones(1, device=card)
    mpv_k1, _ = mpv_reduce(ens, std, 0 * std, CHUNK, NODE, PRED_LEN)
    return SimpleNamespace(model=model, mpv=mpv, pmean=pmean, launches=launches, y0h=y0h,
                           gxh=gxh, mpv_k1=mpv_k1, std=std)


@pytest.mark.card
def test_nsdiff_sweep_launches_and_mpv(nsdiff):
    n_chunks = -(-N_WINDOWS // CHUNK)
    k1, upd = nsdiff.launches[0], nsdiff.launches[4]
    assert k1 == STEPS * n_chunks, f"K1 launched {k1} times, expected {STEPS * n_chunks}"
    assert upd == k1, f"the sweep: the chain's update launched {upd} times, expected {k1}"
    mpv, pmean = nsdiff.mpv, nsdiff.pmean
    assert (mpv.shape == (N_WINDOWS,) and np.isfinite(mpv).all() and (mpv > 0).all()
            and np.isfinite(pmean).all()), f"bad MPV {mpv[:4]}"


@pytest.fixture(scope="module")
def nsdiff_chains(nsdiff, card):
    """The first chunk's chain through K1 and the update kernel, float32
    (a), through the plain denoiser and the eager update (b), and in the
    model's own matmul type (c), from one generator seed (the noise is drawn
    outside the kernels), with the launches of a and b."""
    from upgdm_tpu_torch.ops.diffusion import schedule_on

    model, y0h, gxh = nsdiff.model, nsdiff.y0h, nsdiff.gxh
    mm_main = str(model.sampling_dtype()).replace("torch.", "")
    model.net_param["sampling_dtype"] = "float32"
    zero_counts()
    a = model.sample_chain(y0h, gxh, torch.Generator(device=card).manual_seed(9), N_Z,
                           use_kernel=True)
    launches_a = counts()
    with torch.inference_mode():
        rows = lambda v: v[None].expand(N_Z, *v.shape).reshape(-1, *v.shape[1:]).contiguous()
        y0r, gxr = rows(y0h), rows(gxh)
        zero_counts()
        b = eager_nsdiff_chain(model.denoiser_fn(y0r, gxr, use_kernel=False), y0r, gxr,
                               schedule_on(model.sched, card),
                               torch.Generator(device=card).manual_seed(9), False, None, N_Z)
        b = b.reshape(N_Z, *y0h.shape).permute(1, 2, 3, 0)
        launches_b = counts()
        del y0r, gxr
    model.net_param["sampling_dtype"] = mm_main
    c = model.sample_chain(y0h, gxh, torch.Generator(device=card).manual_seed(9), N_Z)
    yield SimpleNamespace(a=a, b=b, c=c, launches_a=launches_a, launches_b=launches_b,
                          mm_main=mm_main)
    del a, b, c


@pytest.mark.card
def test_nsdiff_kernel_chain_against_the_plain_chain(nsdiff_chains):
    a, b = nsdiff_chains.a, nsdiff_chains.b
    k1_a, upd_a = nsdiff_chains.launches_a[0], nsdiff_chains.launches_a[4]
    assert upd_a == k1_a, f"the K1 chain: the chain's update launched {upd_a} times, " \
                          f"expected {k1_a}"
    assert nsdiff_chains.launches_b[0] == 0, "K1 in the plain chain"
    assert nsdiff_chains.launches_b[4] == 0, (
        f"the plain chain: the chain's update launched {nsdiff_chains.launches_b[4]} times, "
        f"expected 0")
    excess = ((a - b).abs() - (CHAIN_ATOL + CHAIN_RTOL * b.abs())).max().item()
    assert excess <= 0, f"K1 chain off the plain chain by {excess}"


@pytest.mark.card
def test_nsdiff_bf16_chain_against_float32_mpv(nsdiff_chains):
    mm_main = nsdiff_chains.mm_main
    mpv32, mpv16 = chunk_mpv(nsdiff_chains.a), chunk_mpv(nsdiff_chains.c)
    rel = abs(mpv16 - mpv32) / mpv32
    assert mm_main == "bfloat16" and rel <= MPV_REL, (
        f"{mm_main} chain MPV {mpv16} vs float32 {mpv32}: {rel:.4%}")


def k2_arm(nsdiff, **act):
    """The K2 arm on the first chunk, seed 11, in the model's matmul type:
    (per-window MPV, K2 launches, K2 launches with bf16 activations)."""
    from upgdm_tpu_torch.eval.uncertainty import mpv_reduce
    from upgdm_tpu_torch.ops.kernels.chain_resident import fused_chain_rows, fused_nsdiff_chain

    model, std = nsdiff.model, nsdiff.std
    zero_counts()
    ens = fused_nsdiff_chain(model.denoiser, nsdiff.y0h, nsdiff.gxh, model.sched, seed=11,
                             n_z_samples=N_Z,
                             matmul_dtype=str(model.sampling_dtype()).replace("torch.", ""),
                             **act)
    launches = (fused_chain_rows.launches, fused_chain_rows.launches_act_bf16)
    return mpv_reduce(ens, std, 0 * std, CHUNK, NODE, PRED_LEN)[0], *launches


@pytest.mark.card
def test_k2_arm_against_the_k1_path(nsdiff):
    mpv_k2, k2, k2_act = k2_arm(nsdiff)
    assert k2 == 1 and k2_act == 0, (
        f"K2 launched {k2} times, expected 1, with float32 activations")
    m1, m2 = nsdiff.mpv_k1.mean().item(), mpv_k2.mean().item()
    rel = abs(m2 - m1) / m1
    assert rel <= MPV_REL, f"K2 arm MPV {m2} vs K1 path {m1}: {rel:.4%}"


@pytest.mark.card
def test_k2_arm_bf16_activations(nsdiff):
    """The same arm with bf16 activations, same seed (the same normals): chunk
    MPV within 1% of the float32-activation arm's, window by window."""
    mpv_k2 = k2_arm(nsdiff)[0]
    mpv_k2a, k2, k2_act = k2_arm(nsdiff, act_dtype="bfloat16")
    rel = ((mpv_k2a - mpv_k2).abs() / mpv_k2).max().item()
    assert k2_act == k2 == 1 and 0 < rel <= MPV_REL, (
        f"{k2_act} bf16-activation launches, per-window MPV {rel:.4%} off the float32-act arm")


@pytest.fixture(scope="module")
def tmdm(card):
    """The TMDM path at full width: a warm-up sweep, the 16-window sweep with
    its launches, the first chunk's condition, its chain through K3 and the
    plain TMDMDenoiser (float32) and in the model's matmul type, one seed."""
    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.eval.uncertainty import fast_mpv_sweep

    model = diffusion_models("TMDM", TMDM_PARAM, seed=0, device="cuda")
    fast_mpv_sweep(model, make_windows(T_CHUNK), PRED_LEN, chunk_windows=T_CHUNK)
    twins = make_windows(T_WINDOWS)
    zero_counts()
    mpv, pmean = fast_mpv_sweep(model, twins, PRED_LEN, chunk_windows=T_CHUNK)
    launches = counts()
    x0 = torch.as_tensor(model.scaler_transform(twins[:T_CHUNK].reshape(-1, WINDOWS, 1)),
                         dtype=torch.float32, device=card)
    y0t, embt = model.cond_fn(x0)
    mm_main = str(model.sampling_dtype()).replace("torch.", "")
    model.net_param["sampling_dtype"] = "float32"
    a = model.sample_chain(y0t, embt, torch.Generator(device=card).manual_seed(9), N_Z,
                           use_kernel=True)
    b = model.sample_chain(y0t, embt, torch.Generator(device=card).manual_seed(9), N_Z,
                           use_kernel=False)
    model.net_param["sampling_dtype"] = mm_main
    c = model.sample_chain(y0t, embt, torch.Generator(device=card).manual_seed(9), N_Z)
    return SimpleNamespace(model=model, twins=twins, mpv=mpv, pmean=pmean, launches=launches,
                           y0_shape=tuple(y0t.shape), a=a, b=b, c=c)


@pytest.mark.card
def test_tmdm_sweep_launches_and_mpv(tmdm):
    t_chunks = -(-T_WINDOWS // T_CHUNK)
    k1, k2, k3 = tmdm.launches[:3]
    assert k3 == T_STEPS * t_chunks, f"K3 launched {k3} times, expected {T_STEPS * t_chunks}"
    assert k1 == 0 and k2 == 0, "the TMDM path launched an NsDiff kernel"
    assert (tmdm.mpv.shape == (T_WINDOWS,) and np.isfinite(tmdm.mpv).all()
            and (tmdm.mpv > 0).all() and np.isfinite(tmdm.pmean).all()), (
        f"bad MPV {tmdm.mpv[:4]}")
    assert tmdm.y0_shape == (T_CHUNK * NODE, T_LABEL + PRED_LEN, 1), (
        f"y_0_hat shape {tmdm.y0_shape}")


@pytest.mark.card
def test_tmdm_kernel_chain_against_the_plain_chain(tmdm):
    a, b = tmdm.a, tmdm.b
    excess = ((a - b).abs() - (CHAIN_ATOL + CHAIN_RTOL * b.abs())).max().item()
    assert a.shape == (T_CHUNK * NODE, PRED_LEN, 1, N_Z) and excess <= 0, (
        f"K3 chain off the plain chain by {excess}")


@pytest.mark.card
def test_tmdm_bf16_chain_against_float32_mpv(tmdm):
    mpv32, mpv16 = chunk_mpv(tmdm.a), chunk_mpv(tmdm.c)
    rel = abs(mpv16 - mpv32) / mpv32
    assert rel <= MPV_REL, f"bf16 chain MPV {mpv16} vs float32 {mpv32}: {rel:.4%}"


@pytest.mark.card
def test_cache_first_runner(tmdm, tmp_path):
    from upgdm_tpu_torch.eval.uncertainty import run_evaluation_cache
    from upgdm_tpu_torch.utils.io import load_tensor_list

    cache = tmp_path / "pred_future.pt"
    zero_counts()
    ens_list = run_evaluation_cache(tmdm.model, tmdm.twins[:4], PRED_LEN, cache,
                                    chunk_windows=T_CHUNK, checkpoint_every=2)
    swept = counts()[2]
    assert swept == 2 * T_STEPS, f"K3 launched {swept} times, expected {2 * T_STEPS}"
    loaded = load_tensor_list(cache)
    assert len(loaded) == len(ens_list) == 4 and all(
        a.shape == (NODE, PRED_LEN, 1, N_Z) and np.isfinite(a).all() for a in loaded), (
        f"the .pt cache does not hold 4 finite [{NODE},{PRED_LEN},1,{N_Z}] arrays")
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["pred_future.pt", "pred_future.pt.mpv.json"], f"left behind: {left}"
    again = run_evaluation_cache(tmdm.model, tmdm.twins[:4], PRED_LEN, cache,
                                 chunk_windows=T_CHUNK)
    assert counts()[2] == swept and len(again) == 4 and all(
        np.array_equal(x, y) for x, y in zip(again, loaded)), (
        "the second call did not return the cache as it was")


@pytest.mark.card
def test_trained_sis_model(card):
    from upgdm_tpu_torch.eval.uncertainty import (
        fast_mpv_sweep, load_dynamic_data, load_model_from_dir,
    )
    from upgdm_tpu_torch.ops.windows import sample_time_series, sliding_windows
    from upgdm_tpu_torch.utils.io import read_model_config

    cfg = read_model_config(SIS_MODEL)
    sis, _ = load_model_from_dir(SIS_MODEL, device="cuda")
    data = load_dynamic_data(SIS_DATA, dynamic_type="SIS")
    series, tdata = sample_time_series(data["torch_time_series"], data["time_data"],
                                       cfg["dataset"]["sampling_t"])
    sis_w, _ = sliding_windows(series, tdata, cfg["dataset"]["windows"],
                               cfg["dataset"]["interval_step"])
    sis_w = sis_w[:8]
    sis_mpv, _ = fast_mpv_sweep(sis, sis_w, cfg["dataset"]["pred_len"], chunk_windows=8)
    assert sis_mpv.shape == (8,) and np.isfinite(sis_mpv).all() and (sis_mpv > 0).all(), (
        f"bad SIS MPV {sis_mpv}")
    # f(x), g(x) on the card against the port on the CPU, same weights
    cpu, _ = load_model_from_dir(SIS_MODEL, device="cpu")
    xs = sis.scaler_transform(sis_w.reshape(-1, sis_w.shape[2], 1)).astype(np.float32)
    f_c, g_c = sis.f_and_g(xs)
    f_h, g_h = cpu.f_and_g(xs)
    fg_err = max((f_c.cpu() - f_h).abs().max().item(), (g_c.cpu() - g_h).abs().max().item())
    assert fg_err <= 1e-4, f"f/g on the card off the CPU by {fg_err}"


@pytest.fixture(scope="module")
def facade(card, tmp_path_factory):
    """The trained SIS model over its whole trajectory through
    ``uncertainty_ews``, as a figure calls it: straight from the device, then
    through the ``.pt`` cache and its sidecar (the second call served from
    them), then with bf16 activations through ``infer_params`` (K1's other
    arm, on the same normals: each call builds its model afresh from the
    seed). Each call's result and its (K1, K1 with bf16 activations)
    launches."""
    from upgdm_tpu_torch.eval.uncertainty import uncertainty_ews
    from upgdm_tpu_torch.ops.kernels.fused_denoiser import fused_denoiser_rows

    tmp = tmp_path_factory.mktemp("facade")

    def call(sub, **kw):
        (tmp / sub).mkdir(exist_ok=True)
        zero_counts()
        r = uncertainty_ews(model_save_file=SIS_MODEL, data_file=SIS_DATA, dynamic_type="SIS",
                            cache_path=tmp / sub, device="cuda", **kw)
        assert_updates(sub, fused_denoiser_rows.launches)
        return r, (fused_denoiser_rows.launches, fused_denoiser_rows.launches_act_bf16)

    runs = {"none": call("none", cache_mode="none"), "write": call("write"),
            "hit": call("write"),
            "act": call("act", cache_mode="none", infer_params={
                "sampling_act_dtype": "bfloat16", "sampling_matmul_dtype": "bfloat16"})}
    return {k: (np.asarray(r["ews"]), launches) for k, (r, launches) in runs.items()}


@pytest.mark.card
def test_facade_straight_from_the_device(facade):
    ews, launches = facade["none"]
    assert (len(ews) > 0 and np.isfinite(ews).all() and (ews > 0).all()
            and launches[0] > 0 and launches[1] == 0), (
        f"bad MPV {ews} or K1 launches {launches} (all, act bf16)")


@pytest.mark.card
def test_facade_through_its_cache(facade):
    none, hit, write = facade["none"][0], facade["hit"], facade["write"][0]
    write_rel = float(np.max(np.abs(write - none) / none))
    assert hit[1] == (0, 0) and np.array_equal(hit[0], write) and write_rel <= MPV_REL, (
        f"cache hit: {hit[1]} launches; write vs none {write_rel:.4%}")


@pytest.mark.card
def test_facade_bf16_activations(facade):
    none, (act, launches) = facade["none"][0], facade["act"]
    act_rel = float(np.max(np.abs(act - none) / none))
    assert launches[1] == launches[0] > 0 and 0 < act_rel <= MPV_REL, (
        f"act bf16: K1 launches {launches} (all, act bf16), MPV {act_rel:.4%} off the "
        "float32-act arm")
