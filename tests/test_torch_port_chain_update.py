"""The NsDiff posterior update as one function (``ops/kernels/nsdiff_chain_update.py``)
against the eager step arithmetic it replaced in ``nsdiff_p_sample_loop``.

The host table must hold, bit for bit, the float32 values the eager code's
0-d tensors gave; the plain twin (the CPU path) must give the eager step's
bits, so the port's CPU parity with the JAX package is the same as before.
The CUDA kernel is held against the same twin on the card by
``chip_smoke.py`` (``check_chain_update_kernel``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from upgdm_tpu_torch.ops import diffusion as D
from upgdm_tpu_torch.ops.kernels import _build
from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import (
    COLUMNS,
    chain_table,
    chain_update_bytes,
    nsdiff_chain_update,
    nsdiff_chain_update_reference,
)
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCHEDULES = ("linear", "const", "quad", "jsd", "sigmoid", "cosine", "cosine_reverse",
             "cosine_anneal")
CSRC = Path(__file__).resolve().parents[1] / "upgdm_tpu_torch" / "csrc"


# -- the eager arithmetic as it stood in ops/diffusion.py -----------------------

def _eager_scalars(c):
    """The 0-d float32 tensors the eager step computed from the gathers."""
    a, bt1, bb1 = c.alpha_t, c.betas_tilde_m_1_t, c.betas_bar_m_1_t
    sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
    lam0 = a * (1.0 - a) * bt1
    sqrt_a = torch.sqrt(c.alpha_t)
    sqrt_abar_prev = torch.sqrt(c.alphas_cumprod_prev_t)
    return dict(
        sqrt_abar=sqrt_abar,
        shift=1.0 - sqrt_abar,
        lam0_2=2.0 * lam0,
        lam0_4=4.0 * lam0,
        lam1_gx=(1.0 - a) ** 2 * bt1 + a * (1.0 - a) * (bb1 - bt1),
        lam1_sigma=a * bt1 + a * (1.0 - a),
        one_m_a_sq=(1.0 - a) ** 2,
        bb1_m_bt1=bb1 - bt1,
        lam2_sigma=a * bb1 - a * bt1 + (1.0 - a) ** 2,
        bb_m_bt=c.betas_bar_t - c.betas_tilde_t,
        bt=c.betas_tilde_t,
        bb=c.betas_bar_t,
        a_one_m_a=c.alpha_t * (1.0 - c.alpha_t),
        bt1=bt1,
        alpha=a,
        sqrt_a=sqrt_a,
        sqrt_abar_prev=sqrt_abar_prev,
        sqrt_a_am1=sqrt_a * (c.alpha_t - 1.0),
        one_m_sqrt_abar_prev=1.0 - sqrt_abar_prev,
    )


def _eager_sigma_y0_hat(c, gx, sigma_theta):
    a = c.alpha_t
    bt_m1 = c.betas_tilde_m_1_t
    bb_m1 = c.betas_bar_m_1_t
    lam0 = a * (1.0 - a) * bt_m1
    lam1 = ((1.0 - a) ** 2 * bt_m1 + a * (1.0 - a) * (bb_m1 - bt_m1)) * gx - sigma_theta * (
        a * bt_m1 + a * (1.0 - a)
    )
    lam2 = gx ** 2 * (1.0 - a) ** 2 * (bb_m1 - bt_m1) - sigma_theta * gx * (
        a * bb_m1 - a * bt_m1 + (1.0 - a) ** 2
    )
    disc = torch.clamp(lam1 ** 2 - 4.0 * lam0 * lam2, min=0.0)
    return (-lam1 + torch.sqrt(disc)) / (2.0 * lam0)


def _eager_noise_var(c, gx, sigma_theta, use_gx_directly):
    if use_gx_directly:
        return gx, c.betas_bar_t * gx
    sigma_y0 = _eager_sigma_y0_hat(c, gx, sigma_theta)
    return sigma_y0, (c.betas_bar_t - c.betas_tilde_t) * gx + c.betas_tilde_t * sigma_y0


def _eager_gammas(c, gx, y_sigma):
    s1 = (1.0 - c.alpha_t) ** 2 * gx + c.alpha_t * (1.0 - c.alpha_t) * y_sigma
    s2 = (c.betas_bar_m_1_t - c.betas_tilde_m_1_t) * gx + c.betas_tilde_m_1_t * y_sigma
    sqrt_a = torch.sqrt(c.alpha_t)
    sqrt_abar_prev = torch.sqrt(c.alphas_cumprod_prev_t)
    denom = c.alpha_t * s2 + s1
    gamma_0 = sqrt_abar_prev * s1 / denom
    gamma_1 = sqrt_a * s2 / denom
    gamma_2 = ((sqrt_a * (c.alpha_t - 1.0)) * s2 + (1.0 - sqrt_abar_prev) * s1) / denom
    return gamma_0, gamma_1, gamma_2


def _eager_step(sched, t, y, y_T_mean, gx, eps_theta, sigma_theta, z, use_gx_directly):
    """One step of the eager loop; ``z=None`` is its final step."""
    c = D.nsdiff_gather(sched, t, y)
    sqrt_abar = torch.sqrt(1.0 - c.one_minus_abar_sqrt_t ** 2)
    sigma_y0, noise_var = _eager_noise_var(c, gx, sigma_theta, use_gx_directly)
    y0_reparam = (y - (1.0 - sqrt_abar) * y_T_mean
                  - eps_theta * torch.sqrt(noise_var)) / sqrt_abar
    if z is None:
        return y0_reparam
    g0, g1, g2 = _eager_gammas(c, gx, sigma_y0)
    y_mean = g0 * y0_reparam + g1 * y + g2 * y_T_mean
    return y_mean + torch.sqrt(sigma_theta) * z


def _eager_loop(model_fn, y_0_hat, gx, sched, generator, use_gx_directly, noise, members):
    draw = D._chain_draw(y_0_hat, generator, noise, members)
    y_T_mean = y_0_hat
    y = torch.sqrt(gx) * draw(0) + y_T_mean
    for i, t in enumerate(range(sched.num_timesteps - 1, 0, -1)):
        eps_theta, sigma_theta = model_fn(y, t)
        y = _eager_step(sched, t, y, y_T_mean, gx, eps_theta, sigma_theta, draw(i + 1),
                        use_gx_directly)
    eps_theta, sigma_theta = model_fn(y, 0)
    return _eager_step(sched, 0, y, y_T_mean, gx, eps_theta, sigma_theta, None,
                       use_gx_directly)


# -- helpers --------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and np.array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _rows(n, seed, F=1):
    """(y, y_T_mean, gx, eps, sigma, z) [n, F] float32 with edge rows: the
    discriminant's clamp (sigma far above gx), tiny gx and sigma, and a NaN
    sigma (torch.clamp keeps it)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, F)) * 2.0
    ytm = rng.normal(size=(n, F)) * 0.5 + 1.0
    gx = rng.uniform(0.05, 1.0, size=(n, F))
    eps = rng.normal(size=(n, F))
    sig = rng.uniform(0.01, 0.5, size=(n, F))
    z = rng.normal(size=(n, F))
    sig[:4, 0] = (50.0, 1e-6, 3.0, np.nan)
    gx[4:8, 0] = (1e-6, 1e-3, 2.0, 7.0)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (y, ytm, gx, eps, sig, z))


def _model_fn(y, t):
    """A deterministic stand-in for the denoiser: (eps_theta, sigma_theta)."""
    return torch.tanh(y) * (0.1 + 0.01 * t), torch.nn.functional.softplus(y) * 0.2 + 0.01


# -- the table ------------------------------------------------------------------

@pytest.mark.parametrize("T", [20, 100])
@pytest.mark.parametrize("name", SCHEDULES)
def test_table_equals_eager_scalars(name, T):
    """Every t's row holds the 0-d tensor arithmetic's float32 bits, from a
    numpy schedule and from one of tensors (``schedule_on``)."""
    sched = NsDiffSchedule.create(name, T, 1e-4, 2e-2)
    table = chain_table(sched)
    assert table.dtype == np.float32 and table.shape == (T, len(COLUMNS))
    from_tensors = chain_table(D.schedule_on(sched, "cpu"))
    assert np.array_equal(table.view(np.int32), from_tensors.view(np.int32))
    like = torch.zeros(3, 2)
    for t in range(T):
        want = _eager_scalars(D.nsdiff_gather(sched, t, like))
        for j, col in enumerate(COLUMNS):
            assert want[col].dtype == torch.float32 and want[col].ndim == 0
            assert _bits(table[t, j]) == _bits(want[col].numpy()), (name, t, col)


@pytest.mark.parametrize("name", SCHEDULES)
def test_card_table_takes_correctly_rounded_roots(name):
    """A CUDA chain's table: CUDA's float32 root is correctly rounded, so
    each root is the float64 root rounded once, and every column the roots
    do not enter is the CPU table's."""
    sched = NsDiffSchedule.create(name, 100, 1e-4, 2e-2)
    card, cpu = chain_table(sched, "cuda"), chain_table(sched, "cpu")
    col = {c: j for j, c in enumerate(COLUMNS)}
    f32 = lambda x: np.asarray(x, np.float32)
    radicands = {"sqrt_abar": f32(1.0) - f32(sched.one_minus_alphas_bar_sqrt) ** 2,
                 "sqrt_a": f32(sched.alphas), "sqrt_abar_prev": f32(sched.alphas_cumprod_prev)}
    for c, x in radicands.items():
        assert np.array_equal(card[:, col[c]], np.sqrt(x.astype(np.float64)).astype(np.float32))
    rooted = set(radicands) | {"shift", "sqrt_a_am1", "one_m_sqrt_abar_prev"}
    for c in COLUMNS:
        if c not in rooted:
            assert np.array_equal(card[:, col[c]].view(np.int32), cpu[:, col[c]].view(np.int32)), c


def test_columns_follow_the_kernels_enum():
    """``COLUMNS`` is the order in which the kernel reads the table."""
    src = (CSRC / "nsdiff_chain_update.cu").read_text()
    body = re.search(r"enum Column \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*([A-Z0-9_]+)\s*,?\s*(?://.*)?$", body, re.M)
    assert names == [c.upper() for c in COLUMNS] + ["N_COLUMNS"]


# -- the twin against the eager step ----------------------------------------------

@pytest.mark.parametrize("name", ["linear", "cosine"])
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("use_gx_directly", [False, True])
def test_twin_equals_eager_step(use_gx_directly, final, name):
    """Bit for bit on every step of a 20-step schedule, edge rows included."""
    sched = NsDiffSchedule.create(name, 20, 1e-4, 2e-2)
    table = chain_table(sched)
    y, ytm, gx, eps, sig, z = _rows(1003, seed=11)
    for t in ([0] if final else range(1, 20)):
        zz = None if final else z
        got = nsdiff_chain_update_reference(y, ytm, gx, eps, sig, zz, table[t], use_gx_directly)
        want = _eager_step(sched, t, y, ytm, gx, eps, sig, zz, use_gx_directly)
        assert _same_bits(got, want), (t, (got - want).abs().nan_to_num().max().item())
        assert torch.isnan(got).any().item() == torch.isnan(want).any().item()


@pytest.mark.parametrize("seam", ["generator", "noise", "noise_strided"])
@pytest.mark.parametrize("use_gx_directly", [False, True])
def test_cpu_chain_equals_eager_loop_without_the_library(monkeypatch, use_gx_directly, seam):
    """``nsdiff_p_sample_loop`` on the CPU gives the eager loop's bits over
    members x rows, neither loads the kernel library nor counts a launch."""
    def no_library():
        raise AssertionError("the CPU chain loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    sched = NsDiffSchedule.create("linear", 20, 1e-4, 2e-2)
    members, B = 3, 5
    rng = np.random.default_rng(3)
    y0 = torch.from_numpy(rng.normal(size=(B, 7, 2)).astype(np.float32))
    gx = torch.from_numpy(rng.uniform(0.05, 1.0, size=(B, 7, 2)).astype(np.float32))
    y0 = y0[None].expand(members, -1, -1, -1).reshape(members * B, 7, 2).contiguous()
    gx = gx[None].expand(members, -1, -1, -1).reshape(members * B, 7, 2).contiguous()
    noise = None
    if seam != "generator":
        z = torch.from_numpy(rng.normal(size=(20, 7, 2, members * B)).astype(np.float32))
        noise = [zi.permute(2, 0, 1) for zi in z]  # strided views of z
        if seam == "noise":
            noise = [zi.contiguous() for zi in noise]
    before = nsdiff_chain_update.launches
    runs = []
    for loop in (D.nsdiff_p_sample_loop, _eager_loop):
        gen = torch.Generator().manual_seed(7)
        runs.append(loop(_model_fn, y0, gx, sched, gen, use_gx_directly, noise, members))
    assert _same_bits(*runs)
    assert torch.isfinite(runs[0]).all()
    assert nsdiff_chain_update.launches == before


@pytest.mark.parametrize("use_gx_directly", [False, True])
def test_chain_hands_the_update_contiguous_rows(monkeypatch, use_gx_directly):
    """Strided y_0_hat, gx and model outputs (NsDiff_spatial's layouts) reach
    the update as contiguous rows, which the kernel needs, with the bits of
    the eager loop on the same strided operands."""
    def contiguous_only(*args):
        for a in args:
            if isinstance(a, torch.Tensor):
                assert a.is_contiguous(), "the update got strided rows"
        return nsdiff_chain_update(*args)

    def strided_model_fn(y, t):
        eps, sig = _model_fn(y, t)
        return torch.cat([eps, eps], dim=-1)[..., :1], torch.cat([sig, sig], dim=-1)[..., :1]

    sched = NsDiffSchedule.create("linear", 20, 1e-4, 2e-2)
    rng = np.random.default_rng(5)
    y0 = torch.from_numpy(rng.normal(size=(12, 9, 2)).astype(np.float32))[..., :1]
    gx = torch.from_numpy(rng.uniform(0.05, 1.0, size=(12, 9, 2)).astype(np.float32))[..., :1]
    assert not (y0.is_contiguous() or gx.is_contiguous())
    want = _eager_loop(strided_model_fn, y0, gx, sched, torch.Generator().manual_seed(4),
                       use_gx_directly, None, 3)
    monkeypatch.setattr(D, "nsdiff_chain_update", contiguous_only)
    got = D.nsdiff_p_sample_loop(strided_model_fn, y0, gx, sched,
                                 torch.Generator().manual_seed(4), use_gx_directly, None, 3)
    assert _same_bits(got, want)


# -- what the twin and the wrapper refuse -------------------------------------------

@pytest.mark.parametrize("case", ["gx_shape", "z_shape", "y_float64", "eps_float64",
                                  "z_float64", "unsupported_device"])
def test_rejects_mismatched_operands(case):
    y, ytm, gx, eps, sig, z = _rows(16, seed=2)
    coef = chain_table(NsDiffSchedule.create("linear", 20, 1e-4, 2e-2))[5]
    if case == "gx_shape":
        gx = gx[:8]
    elif case == "z_shape":
        z = z.reshape(1, 16)
    elif case == "y_float64":
        y = y.double()
    elif case == "eps_float64":
        eps = eps.double()
    elif case == "z_float64":
        z = z.double()
    else:
        y, ytm, gx, eps, sig, z = (a.to("meta") for a in (y, ytm, gx, eps, sig, z))
    with pytest.raises(ValueError, match="nsdiff_chain_update"):
        nsdiff_chain_update(y, ytm, gx, eps, sig, z, coef)


@pytest.mark.parametrize("final, direct, per_value", [(False, False, 28), (False, True, 28),
                                                      (True, False, 24), (True, True, 20)])
def test_bytes_bound(final, direct, per_value):
    assert chain_update_bytes(4_800_000, final, direct) == 4_800_000 * per_value
