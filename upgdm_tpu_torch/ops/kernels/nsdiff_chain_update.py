"""The NsDiff reverse chain's posterior update (wrapper of
``csrc/nsdiff_chain_update.cu``).

A port kernel with no Pallas site: the JAX package computes the update as
XLA-fused ``jnp`` between the denoiser's calls
(``upgdm_tpu/ops/diffusion.py::nsdiff_p_sample_loop``). One step t takes the
chain's state y, its prior mean y_T_mean (= y0_hat), gx, the denoiser's
eps_theta and sigma_theta and the step's normals z, all float32 of one shape,
and returns the next state (nsdiff_utils.py:143-158 of the reference):

    sigma_y0   = the quadratic solve of the step (gx with use_gx_directly)
    noise_var  = (betas_bar - betas_tilde) gx + betas_tilde sigma_y0
    y0_reparam = (y - (1 - sqrt(abar)) y_T_mean - eps sqrt(noise_var)) / sqrt(abar)
    y'         = g0 y0_reparam + g1 y + g2 y_T_mean + sqrt(sigma_theta) z

The final step (``z=None``) returns y0_reparam.

The step's scalars come from ``chain_table``: for every t, float32 host
arithmetic on the schedule's float32 arrays, operation for operation what
the 0-d tensors of ``ops/diffusion.py::nsdiff_gather`` give, taken once for a
chain. ``nsdiff_chain_update`` launches the kernel for CUDA tensors (one
launch a step, counted in ``.launches``) and runs the plain twin
``nsdiff_chain_update_reference`` for CPU tensors. The twin keeps the eager
arithmetic's order of operations, and the kernel rounds each operation as
the twin does, so the two agree bit for bit.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import _build

__all__ = [
    "COLUMNS",
    "chain_table",
    "chain_update_bytes",
    "nsdiff_chain_update",
    "nsdiff_chain_update_reference",
    "posterior_gammas",
    "sigma_y0_hat",
    "step_scalars",
]

# The table's columns, in the order of ``csrc/nsdiff_chain_update.cu::Column``.
# a: alphas, bt / bb: betas_tilde / betas_bar, bt1 / bb1: their t - 1 values.
COLUMNS = (
    "sqrt_abar",             # sqrt(1 - one_minus_alphas_bar_sqrt^2)
    "shift",                 # 1 - sqrt_abar
    "lam0_2",                # 2 lam0, lam0 = a (1 - a) bt1
    "lam0_4",                # 4 lam0
    "lam1_gx",               # (1 - a)^2 bt1 + a (1 - a) (bb1 - bt1)
    "lam1_sigma",            # a bt1 + a (1 - a)
    "one_m_a_sq",            # (1 - a)^2
    "bb1_m_bt1",             # bb1 - bt1
    "lam2_sigma",            # a bb1 - a bt1 + (1 - a)^2
    "bb_m_bt",               # bb - bt
    "bt",
    "bb",
    "a_one_m_a",             # a (1 - a)
    "bt1",
    "alpha",
    "sqrt_a",
    "sqrt_abar_prev",        # sqrt(alphas_cumprod_prev)
    "sqrt_a_am1",            # sqrt(a) (a - 1)
    "one_m_sqrt_abar_prev",  # 1 - sqrt_abar_prev
)


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, np.float32)


def chain_table(sched, device="cpu") -> np.ndarray:
    """[T, len(COLUMNS)] float32: row t holds step t's scalars, each the
    float32 value the eager code's 0-d tensor arithmetic gives it on
    ``device``. ``sched`` is an ``NsDiffSchedule`` of numpy arrays or of
    tensors (read once).

    Sums and products round alike in numpy and torch; roots do not
    everywhere: torch's float32 root on the CPU need not be correctly
    rounded (on AVX-512 ~0.5% of values sit one unit in the last place
    off), so a CPU chain takes its roots from torch, as the eager code did,
    and a CUDA chain from ``np.sqrt``, correctly rounded as CUDA's is."""
    if torch.device(device).type == "cpu":
        sqrt = lambda x: torch.sqrt(torch.tensor(x)).numpy()
    else:
        sqrt = np.sqrt
    one = np.float32(1.0)
    a = _host(sched.alphas)
    bt, bb = _host(sched.betas_tilde), _host(sched.betas_bar)
    bt1, bb1 = _host(sched.betas_tilde_m_1), _host(sched.betas_bar_m_1)
    om = _host(sched.one_minus_alphas_bar_sqrt)
    sqrt_abar = sqrt(one - om ** 2)
    lam0 = a * (one - a) * bt1
    sqrt_a = sqrt(a)
    sqrt_abar_prev = sqrt(_host(sched.alphas_cumprod_prev))
    cols = dict(
        sqrt_abar=sqrt_abar,
        shift=one - sqrt_abar,
        lam0_2=np.float32(2.0) * lam0,
        lam0_4=np.float32(4.0) * lam0,
        lam1_gx=(one - a) ** 2 * bt1 + a * (one - a) * (bb1 - bt1),
        lam1_sigma=a * bt1 + a * (one - a),
        one_m_a_sq=(one - a) ** 2,
        bb1_m_bt1=bb1 - bt1,
        lam2_sigma=a * bb1 - a * bt1 + (one - a) ** 2,
        bb_m_bt=bb - bt,
        bt=bt,
        bb=bb,
        a_one_m_a=a * (one - a),
        bt1=bt1,
        alpha=a,
        sqrt_a=sqrt_a,
        sqrt_abar_prev=sqrt_abar_prev,
        sqrt_a_am1=sqrt_a * (a - one),
        one_m_sqrt_abar_prev=one - sqrt_abar_prev,
    )
    return np.ascontiguousarray(np.stack([cols[c] for c in COLUMNS], axis=1), np.float32)


def chain_update_bytes(n: int, final: bool = False, use_gx_directly: bool = False) -> int:
    """Device-memory bytes of one launch on ``n`` floats: each input read
    once, the state written once (28 a value; the final step 24, 20 with
    ``use_gx_directly``, which reads no sigma_theta there)."""
    reads = 6 - int(final) - int(final and use_gx_directly)
    return 4 * n * (reads + 1)


def step_scalars(coef, device) -> SimpleNamespace:
    """Table row ``coef`` as named 0-d float32 tensors on ``device`` (a 0-d
    tensor on the data's device divides as the eager gathers did)."""
    return SimpleNamespace(**{c: torch.tensor(coef[i], dtype=torch.float32, device=device)
                              for i, c in enumerate(COLUMNS)})


def sigma_y0_hat(k, gx, sigma_theta):
    """Per-step quadratic solve for sigma_{Y0} (nsdiff_utils.py:143-146) on
    the scalars ``k`` of one table row (``step_scalars``)."""
    lam1 = k.lam1_gx * gx - sigma_theta * k.lam1_sigma
    lam2 = gx ** 2 * k.one_m_a_sq * k.bb1_m_bt1 - sigma_theta * gx * k.lam2_sigma
    disc = torch.clamp(lam1 ** 2 - k.lam0_4 * lam2, min=0.0)
    return (-lam1 + torch.sqrt(disc)) / k.lam0_2


def posterior_gammas(k, gx, sigma_y0):
    """Posterior mean coefficients gamma_0/1/2 (nsdiff_utils.py:80-92) on the
    scalars ``k`` of one table row (``step_scalars``)."""
    sigma_1 = k.one_m_a_sq * gx + k.a_one_m_a * sigma_y0
    sigma_2 = k.bb1_m_bt1 * gx + k.bt1 * sigma_y0
    denom = k.alpha * sigma_2 + sigma_1
    gamma_0 = k.sqrt_abar_prev * sigma_1 / denom
    gamma_1 = k.sqrt_a * sigma_2 / denom
    gamma_2 = (k.sqrt_a_am1 * sigma_2 + k.one_m_sqrt_abar_prev * sigma_1) / denom
    return gamma_0, gamma_1, gamma_2


def _operands(y, y_T_mean, gx, eps_theta, sigma_theta, z):
    """The named operands, after checking that each is float32 of y's shape
    on y's device."""
    named = [("y", y), ("y_T_mean", y_T_mean), ("gx", gx), ("eps_theta", eps_theta),
             ("sigma_theta", sigma_theta)]
    if z is not None:
        named.append(("z", z))
    for name, t in named:
        if t.dtype != torch.float32 or t.shape != y.shape or t.device != y.device:
            raise ValueError(f"nsdiff_chain_update: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected float32 {tuple(y.shape)} on {y.device}")
    return named


def nsdiff_chain_update_reference(y, y_T_mean, gx, eps_theta, sigma_theta, z, coef,
                                  use_gx_directly=False):
    """Plain PyTorch twin: the eager step of ``nsdiff_p_sample_loop`` on table
    row ``coef`` (``chain_table(sched, y.device)[t]``); ``z=None`` is the final step."""
    _operands(y, y_T_mean, gx, eps_theta, sigma_theta, z)
    k = step_scalars(coef, y.device)
    if use_gx_directly:
        sigma_y0, noise_var = gx, k.bb * gx
    else:
        sigma_y0 = sigma_y0_hat(k, gx, sigma_theta)
        noise_var = k.bb_m_bt * gx + k.bt * sigma_y0
    y0_reparam = (y - k.shift * y_T_mean - eps_theta * torch.sqrt(noise_var)) / k.sqrt_abar
    if z is None:
        return y0_reparam
    gamma_0, gamma_1, gamma_2 = posterior_gammas(k, gx, sigma_y0)
    y_mean = gamma_0 * y0_reparam + gamma_1 * y + gamma_2 * y_T_mean
    return y_mean + torch.sqrt(sigma_theta) * z


def nsdiff_chain_update(y, y_T_mean, gx, eps_theta, sigma_theta, z, coef,
                        use_gx_directly=False):
    """One step of the NsDiff posterior update on table row ``coef``
    (``chain_table(sched, y.device)[t]``): the next state, or y0_reparam for ``z=None``.
    CUDA tensors (contiguous float32 of one shape) launch the kernel on the
    current stream; CPU tensors run the twin."""
    if y.device.type == "cpu":
        return nsdiff_chain_update_reference(y, y_T_mean, gx, eps_theta, sigma_theta, z, coef,
                                             use_gx_directly)
    if y.device.type != "cuda":
        raise ValueError(f"nsdiff_chain_update: unsupported device {y.device}")
    for name, t in _operands(y, y_T_mean, gx, eps_theta, sigma_theta, z):
        if not t.is_contiguous():
            raise ValueError(f"nsdiff_chain_update: {name} is not contiguous")
    coef = np.ascontiguousarray(coef, np.float32)
    if coef.shape != (len(COLUMNS),):
        raise ValueError(f"nsdiff_chain_update: coef has shape {coef.shape}, "
                         f"expected ({len(COLUMNS)},)")
    out = torch.empty_like(y)
    lib = _build.load_library()
    code = lib.upgdm_nsdiff_chain_update(
        y.numel(), y.data_ptr(), y_T_mean.data_ptr(), gx.data_ptr(), eps_theta.data_ptr(),
        sigma_theta.data_ptr(), None if z is None else z.data_ptr(), coef.ctypes.data,
        len(COLUMNS), int(bool(use_gx_directly)), int(z is None), out.data_ptr(),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(code, "nsdiff_chain_update")
    nsdiff_chain_update.launches += 1
    return out


nsdiff_chain_update.launches = 0
