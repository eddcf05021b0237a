"""The plain reference: it loads nothing of JAX or of the program, it holds
the weights the port holds, its schedules are the port's, and it follows the
port on the same weights, inputs and draws."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_NET
from bench_cuda import precision, reference, spec
from bench_cuda.reference import blocks, schedules
from bench_cuda.weights import host_copy, make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "upgdm_tpu", "upgdm_tpu_torch")


def test_imports_nothing_of_the_program_or_jax():
    code = ("import sys; import bench_cuda.reference.nsdiff, bench_cuda.reference.tmdm, "
            "bench_cuda.precision, bench_cuda.yardstick, bench_cuda.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = set(eval(out.stdout.strip()))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "torch" in loaded  # the names are compared whole: a prefix is no match


def _net(family, **kw):
    name = {"nsdiff": "nsdiff_d512", "tmdm": "tmdm_d64"}[family]
    net = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["net"]
    net.update(kw)
    return net


def _port(net):
    from upgdm_tpu_torch.models.factory import diffusion_models

    return diffusion_models(net["task_model"], net, seed=0, device="cpu")


@pytest.mark.parametrize("family", ["nsdiff", "tmdm"])
@pytest.mark.parametrize("tiny", [True, False])
def test_spec_is_the_ports_weights(family, tiny):
    net = _net(family, **(TINY_NET if tiny else {}))
    want = {k: v.shape for k, v in _port(net).state_dict().items()
            if k not in ("scaler_mean", "scaler_std")}
    got = {n: tuple(s) for n, s, _ in reference.family(family).param_spec(net)}
    assert got == {k: tuple(v) for k, v in want.items()}


def test_schedules_are_the_ports():
    from upgdm_tpu_torch.ops.schedules import NsDiffSchedule, card_schedule

    mine = schedules.nsdiff_tables(20, 1e-4, 2e-2)
    port = NsDiffSchedule.create("linear", 20, 1e-4, 2e-2)
    for a, b in ((mine.alphas, port.alphas), (mine.betas_bar, port.betas_bar),
                 (mine.betas_tilde, port.betas_tilde), (mine.betas_tilde_prev, port.betas_tilde_m_1),
                 (mine.betas_bar_prev, port.betas_bar_m_1),
                 (mine.alphas_cumprod_prev, port.alphas_cumprod_prev)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-9)
    card = schedules.card_tables(100, 1e-4, 2e-2)
    port = card_schedule("linear", 100, 1e-4, 2e-2)
    np.testing.assert_allclose(card.alphas_cumprod, port.alphas_cumprod, rtol=2e-6)


@pytest.mark.parametrize("products", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["nsdiff", "tmdm"])
def test_samples_follow_the_port(family, products):
    """float32: the port's plain modules; bfloat16: the step kernels' plain
    twins (the card's arithmetic) against the reference's bf16 products."""
    net = _net(family, **TINY_NET, sampling_dtype="float32", sampling_matmul_dtype=products)
    if family == "tmdm":
        net["diffusion_steps"] = 10
    ref = reference.family(family)
    W = make_weights(ref.param_spec(net), 99, "cpu")
    model = _port(net)
    model.load_state_dict(host_copy(W))
    x = torch.randn(3, net["windows"], 1, generator=torch.Generator().manual_seed(1)) + 1.0
    g = torch.Generator().manual_seed(5)
    S, L = 8, ref.horizon(net)
    noise = [torch.randn(S, 3, L, 1, generator=g) for _ in range(ref.draws_per_chunk(net))]
    mine = ref.samples(W, x, net, noise, precision.REFERENCE_MM[products])  # [S, B, pred, F]
    cond = model.f_and_g(x) if family == "nsdiff" else model.cond_fn(x)
    port = model.sample_chain(*cond, n_z_samples=S, noise=[z.numpy() for z in noise],
                              use_kernel=products == "bfloat16")  # [B, pred, F, S]
    # bf16: an operand within float32 noise of a rounding boundary rounds the
    # other way on one side (a 2^-8 step in one of 128 terms), so a few
    # samples move by up to ~1e-3; float32 sums in another order alone: 1e-4
    tol = 2e-3 if products == "bfloat16" else 1e-4
    torch.testing.assert_close(mine, port.permute(3, 0, 1, 2), rtol=tol, atol=tol)


def test_loss_and_gradients_follow_the_port():
    net = _net("nsdiff", **TINY_NET)
    ref = reference.family("nsdiff")
    W = make_weights(ref.param_spec(net), 3, "cpu")
    model = _port(net)
    model.load_state_dict(host_copy(W))
    batch = torch.randn(6, net["windows"] + net["pred_len"], 1,
                        generator=torch.Generator().manual_seed(2))
    P = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    mine = ref.train_loss(P, net, batch, torch.Generator().manual_seed(11), net["dropout"])
    port = model.loss_fn(batch, train=True, generator=torch.Generator().manual_seed(11))
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-6)
    g_mine = torch.autograd.grad(mine, list(P.values()))
    port.backward()
    norms = {n: float(p.grad.norm()) for n, p in model.net.named_parameters()}
    assert sum(float(g.norm()) ** 2 for g in g_mine) == pytest.approx(
        sum(v ** 2 for v in norms.values()), rel=1e-4)


def test_control_rounds_to_float8():
    from bench_cuda.precision import fp8_mm

    a = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    w = torch.randn(128, 8, generator=torch.Generator().manual_seed(1)) / 11
    exact = a @ w
    err = (fp8_mm(a, w) - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    assert blocks.f32_mm(a, w).equal(exact)
