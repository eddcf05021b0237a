"""Plain twins of the port's CUDA kernels held against the TPU kernels.

On the CPU the wrappers run their plain PyTorch twins; the JAX kernels run
in Pallas interpret mode, as the JAX package's own tests run them. The CUDA
kernels themselves are held against the same twins on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.models.denoise import NsDiffDenoiser as JDenoiser
from upgdm_tpu.ops.pallas.chain_resident import fused_nsdiff_chain as j_chain
from upgdm_tpu.ops.pallas.fused_denoiser import (
    denoiser_gammas_from_params,
    denoiser_weights_from_params,
    fused_denoiser_rows as j_rows,
)
from upgdm_tpu.ops.schedules import NsDiffSchedule as JSchedule
from upgdm_tpu.utils.io import flatten_params
from upgdm_tpu_torch.models.denoise import NsDiffDenoiser
from upgdm_tpu_torch.ops.kernels.chain_resident import (
    fused_chain_rows,
    fused_nsdiff_chain,
    schedule_table,
)
from upgdm_tpu_torch.ops.kernels.fused_denoiser import (
    denoiser_gammas,
    denoiser_weights,
    fused_denoiser_rows,
    fused_nsdiff_denoiser,
)
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule
from upgdm_tpu_torch.utils.weights import torch_state_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 20


def _pair(F_=1, seed=0):
    """A flax NsDiffDenoiser's params and the port module carrying them."""
    jm = JDenoiser(enc_in=F_, n_steps=STEPS)
    y = jnp.zeros((2, 3, F_))
    params = jax.jit(jm.init)(jax.random.key(seed), y, y, y, jnp.zeros(2, jnp.int32))["params"]
    port = NsDiffDenoiser(F_, STEPS)
    port.load_state_dict(torch_state_from_flax(flatten_params(jax.device_get(params))))
    return params, port.eval()


def _rows(M, F_, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(M, F_))
    y0 = rng.normal(size=(M, F_))
    gx = rng.uniform(0.05, 1.0, size=(M, F_))
    return np.concatenate([y, y0, gx], axis=1).astype(np.float32)


# bf16 bar: both sides round the same operands to bf16 and sum exact
# products in float32, but in another order; an activation within an ulp of
# a bf16 rounding boundary can round the other way (a 2^-8 relative step in
# one of 128 terms), so the bf16 arm is held to 2e-3 instead of 2e-5.
@pytest.mark.parametrize("M", [128, 100])
@pytest.mark.parametrize("mm,atol", [("float32", 2e-5), ("bfloat16", 2e-3)])
@pytest.mark.parametrize("t", [0, 19])
def test_k1_twin_matches_pallas_kernel(M, mm, atol, t):
    params, port = _pair()
    x = _rows(M, 1, seed=M + t)
    want_e, want_s = j_rows(jnp.asarray(x), denoiser_gammas_from_params(params, t),
                            denoiser_weights_from_params(params), interpret=True,
                            matmul_dtype=mm, tile_m=64)
    with torch.no_grad():
        got_e, got_s = fused_denoiser_rows(torch.from_numpy(x), denoiser_gammas(port, t),
                                           denoiser_weights(port), matmul_dtype=mm)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=atol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=atol)


@pytest.mark.parametrize("F_", [1, 2])
def test_k1_drop_in_matches_plain_denoiser(F_):
    """fused_nsdiff_denoiser == NsDiffDenoiser at scalar t (atol 2e-5)."""
    _, port = _pair(F_, seed=F_)
    rng = np.random.default_rng(F_)
    y, y0 = (torch.from_numpy(rng.normal(size=(4, 7, F_)).astype(np.float32)) for _ in "ab")
    gx = torch.from_numpy(rng.uniform(0.1, 1, size=(4, 7, F_)).astype(np.float32))
    with torch.no_grad():
        e_w, s_w = port(y, y0, gx, 5)
        e, s = fused_nsdiff_denoiser(port, y, y0, gx, 5)
    assert e.shape == s.shape == (4, 7, F_)
    np.testing.assert_allclose(e.numpy(), e_w.numpy(), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), s_w.numpy(), atol=2e-5)


@pytest.mark.parametrize("use_gx,B", [(False, 6), (True, 6), (False, 5)])
def test_k2_twin_matches_pallas_chain_zero_noise(use_gx, B):
    """Noise-free chain: rtol 2e-5, atol 2e-6 (tests/test_chain_resident.py);
    B=5 gives 5*9*2 = 90 rows, ragged against the 64-row tile."""
    params, port = _pair(seed=3)
    rng = np.random.default_rng(B)
    y0 = rng.normal(size=(B, 9, 1)).astype(np.float32)
    gx = rng.uniform(0.05, 1.0, size=(B, 9, 1)).astype(np.float32)
    sched_j = JSchedule.create("linear", STEPS, 1e-4, 2e-2)
    want = np.asarray(j_chain(params, jnp.asarray(y0), jnp.asarray(gx), sched_j, seed=0,
                              n_z_samples=2, interpret=True, matmul_dtype="float32",
                              noise_mode="zero", use_gx_directly=use_gx, tile_m=64))
    with torch.no_grad():
        got = fused_nsdiff_chain(port, torch.from_numpy(y0), torch.from_numpy(gx),
                                 NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2), seed=0,
                                 n_z_samples=2, matmul_dtype="float32", noise_mode="zero",
                                 use_gx_directly=use_gx).numpy()
    assert got.shape == want.shape == (B, 9, 1, 2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_k2_twin_prng_is_seeded_and_spreads():
    """The CPU twin's noise comes from a generator seeded by `seed`: the same
    seed repeats, another seed differs, and the ensemble has spread."""
    _, port = _pair(seed=4)
    sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
    y0 = torch.zeros(3, 5, 1)
    gx = torch.full((3, 5, 1), 0.5)
    with torch.no_grad():
        a, b, c = (fused_nsdiff_chain(port, y0, gx, sched, seed=s, n_z_samples=8)
                   for s in (1, 1, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.var(dim=-1).mean() > 0


def test_wrappers_refuse_other_devices_and_bf16_activations():
    _, port = _pair()
    x = torch.from_numpy(_rows(8, 1, seed=0))
    gam, w = denoiser_gammas(port, 0), denoiser_weights(port)
    with pytest.raises(ValueError):
        fused_denoiser_rows(x.to("meta"), gam, w)
    with pytest.raises(ValueError, match="requires matmul_dtype=bfloat16"):
        fused_denoiser_rows(x, gam, w, act_dtype="bfloat16")  # float32 matmuls
    sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
    tables = tuple(e.detach() for e in (port.lin1.embed, port.lin2.embed, port.lin3.embed))
    y0 = torch.zeros(8, 1, device="meta")
    with pytest.raises(ValueError):
        fused_chain_rows(y0, y0, schedule_table(sched), 0, tables, w, STEPS)
    # the CPU path never touches a kernel
    assert fused_denoiser_rows.launches == 0 and fused_chain_rows.launches == 0
