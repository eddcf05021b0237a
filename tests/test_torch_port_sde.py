"""The port's SDE simulators against the JAX package's (CPU).

The drifts and K4's plain twin (``sde_scan_reference``) are held to
``upgdm_tpu/data/sde.py`` on numpy-seeded states: noise-free, and per sample
on JAX's own normals fed through the twin's ``increments`` seam (re-derived as
``_segment_scan`` and ``simulate_sde`` split their keys). The port's Philox
stream is checked for its moments and for not depending on the
segmentation; the wrappers for JAX's record contract, guard and retry; and a
networked system at ``examples/fig1_demo.py``'s settings against JAX's over
seeds, in distribution.

Bars. XLA contracts the scan's multiply-adds into FMAs and multiplies by the
reciprocal of a constant divisor (measured: ``y / 10.0`` under ``jit``), and
the matrix-vector product sums in another order than PyTorch's; the twin
rounds every operation of JAX's source apart. So a step of the two differs
by a few roundings of the state (u = 2^-24 of its scale). The runs here stay
on stable branches, where a difference decays instead of growing: the states
are held within 2^-20 of the run's largest |state| (16 roundings). The
drifts alone: rtol 1e-6 and 1e-6 of the largest |drift|.
"""
import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upgdm_tpu.data import sde as J
from upgdm_tpu_torch.data import sde as P
from upgdm_tpu_torch.data.graphs import gen_graph
from upgdm_tpu_torch.figures.mpv_collapse import locate_transition
from upgdm_tpu_torch.ops.kernels.chain_resident import philox_normal_reference
from upgdm_tpu_torch.ops.kernels.sde_scan import (
    STREAM_RUN, philox_increments, sde_scan, sde_scan_reference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STATE_BAR = 2.0 ** -20  # of the run's largest |state|: see the module docstring
N = 12
# examples/fig1_demo.py:38-47 (the paper's Fig-1 physics) at :74-77's settings
FIG1 = {
    "biomass": dict(control_range=(0.0, 4.0), base_params={"r": 0.7, "k": 10.0, "d": 0.05},
                    eta=0.005),
    "neuronal": dict(control_range=(0.0, 1.0), base_params={"tau": 2.0, "mu": 1.5}, eta=0.01),
    "SIS": dict(control_range=(1e-4, 0.5), base_params={"d": 0.5}, eta=1e-4),
}
SYSTEMS = ("biomass", "SIS", "neuronal", "SLBP")
# a state in each system's range; biomass reaches below zero (the clip)
STATE = {"biomass": (-2.0, 10.0), "SIS": (0.0, 1.0), "neuronal": (0.0, 3.0)}
RAMP = {"biomass": 2.0, "SIS": 0.3, "neuronal": 0.4, "SLBP": 2.6}


def _graph(n=N, seed=0):
    """A Barabási–Albert graph as examples/fig1_demo.py draws it
    (``gen_graph("barabasi_albert", 12, 12, rng=Random(0))``: m = 2), with the
    global ``random`` seeded so that it repeats."""
    random.seed(seed)
    return gen_graph("barabasi_albert", n, n, rng=random.Random(0)).adj


def _drifts(system, adj):
    """(JAX drift, port drift) with the fig1 parameters bound."""
    if system == "SLBP":
        p = dict(P.SLBP_DEFAULT_PARAMS)
        return partial(J.slbp_drift, p=p), P.SystemDrift("SLBP", **p)
    bp = FIG1[system]["base_params"]
    A = jnp.asarray(adj)
    jd = {"biomass": partial(J.biomass_drift, adj=A, deg=A.sum(axis=1), **bp),
          "SIS": partial(J.sis_drift, adj=A, **bp),
          "neuronal": partial(J.neuronal_drift, adj=A, **bp)}[system]
    return jd, P.SystemDrift(system, adj, **bp)


def _y0(system, rng):
    if system == "SLBP":
        return np.array([rng.uniform(20, 40), rng.uniform(0.5, 3)], np.float32)
    lo, hi = STATE[system]
    return rng.uniform(lo, hi, N).astype(np.float32)


def _sigma(system, D):
    if system == "SLBP":
        d = P.SLBP_DEFAULT_PARAMS["D"]
        return np.array([(2 * d) ** 0.5, (0.2 * d) ** 0.5], np.float32)
    return np.full(D, FIG1[system]["eta"], np.float32)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, n, D, noise):
    keys = jax.random.split(key, n)

    def body(carry, k):
        if noise == "scale_mixture":
            z = jax.random.normal(k, (2, D), jnp.float32)
            return carry, z[0] * z[1]
        return carry, jax.random.normal(k, (D,), jnp.float32)

    return jax.lax.scan(body, None, keys)[1]


def _jax_increments(key, n, D, noise):
    """The increments ``_segment_scan`` draws from ``key`` over n steps."""
    return np.array(_jax_draws(key, n, D, noise))


def _held(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_BAR * scale)


@pytest.mark.parametrize("system", SYSTEMS)
def test_drifts_match_jax(system):
    rng = np.random.default_rng(1)
    adj = _graph()
    jd, pd = _drifts(system, adj)
    for _ in range(4):
        y = _y0(system, rng)
        eps = np.float32(rng.uniform(0, RAMP[system]))
        want = np.asarray(jd(jnp.asarray(y), jnp.asarray(eps)))
        got = pd(torch.from_numpy(y), torch.tensor(eps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    if system == "biomass":  # the clip: a negative state has no logistic or harvest term
        y = np.full(N, -1.0, np.float32)
        got = pd(torch.from_numpy(y), torch.tensor(1.0)).numpy()
        np.testing.assert_array_equal(got, np.zeros(N, np.float32))


@pytest.mark.parametrize("system", SYSTEMS)
def test_noise_free_scan_matches_jax(system):
    """600 steps of a ramped control with sigma 0, every state held."""
    n, rng = 600, np.random.default_rng(2)
    jd, pd = _drifts(system, _graph())
    y0 = _y0(system, rng)
    eps = np.linspace(0.0, RAMP[system], n).astype(np.float32)
    zero = np.zeros_like(y0)
    _, want = J._segment_scan(jd, jnp.asarray(y0), jnp.asarray(eps), jnp.asarray(zero), 0.1,
                              jax.random.key(0), n, 1, noise="additive")
    end, got = sde_scan_reference(pd, torch.from_numpy(y0), torch.from_numpy(eps),
                                  torch.from_numpy(zero), 0.1, 0, STREAM_RUN)
    _held(got.numpy(), want)
    assert torch.equal(end, got[-1])


@pytest.mark.parametrize("save_every", [1, 4])
@pytest.mark.parametrize("system,noise", [("SIS", "scale_mixture"), ("biomass", "additive"),
                                          ("neuronal", "scale_mixture"), ("SLBP", "additive"),
                                          ("SLBP", "scale_mixture")])
def test_scan_matches_jax_per_sample_on_jax_normals(system, noise, save_every):
    """Two segments of 240 steps, each on its own key, both noise modes and
    both decimations: the twin on JAX's increments gives JAX's states."""
    n, rng = 240, np.random.default_rng(3)
    jd, pd = _drifts(system, _graph())
    y0 = _y0(system, rng)
    D = len(y0)
    sigma = _sigma(system, D) * 4.0  # noise that moves the state
    yj, yp = jnp.asarray(y0), torch.from_numpy(y0)
    for seg, key in enumerate(jax.random.split(jax.random.key(11), 2)):
        eps = np.linspace(0.1, 0.9, n).astype(np.float32) * RAMP[system]
        yj, want = J._segment_scan(jd, yj, jnp.asarray(eps), jnp.asarray(sigma), 0.1, key, n,
                                   save_every, noise=noise)
        inc = torch.from_numpy(_jax_increments(key, n, D, noise))
        yp, got = sde_scan_reference(pd, yp, torch.from_numpy(eps), torch.from_numpy(sigma),
                                     0.1, 0, STREAM_RUN, n * seg, save_every, noise, inc)
        assert got.shape == (n // save_every, D)
        _held(got.numpy(), want)
    _held(yp.numpy(), yj)


def _jax_sde_increments(seed, n_burn, n_total, mss, D, noise):
    """The increments JAX's ``simulate_sde`` draws: burn-in, then each segment."""
    key = jax.random.key(seed)
    out = []
    if n_burn > 0:
        key, kb = jax.random.split(key)
        out.append(_jax_increments(kb, n_burn, D, noise))
    for start in range(0, n_total, mss):
        key, ks = jax.random.split(key)
        out.append(_jax_increments(ks, min(mss, n_total - start), D, noise))
    return out


@pytest.mark.parametrize("system,ramp,mss,save_every", [
    ("SLBP", "increase", 1_000_000, 1),
    ("SLBP", "decrease", 1_000_000, 2),
    ("SLBP", "constant", 1_000_000, 1),
    ("SIS", "increase", 7, 3),  # 7 % 3 != 0: states and times drift apart, as in JAX
    ("neuronal", "decrease", 25, 5),
])
def test_simulate_sde_matches_jax(system, ramp, mss, save_every):
    """Burn-in, ramps and decimation on the same y0 and JAX's normals: ts and
    the control values bit for bit, the states within the bar."""
    total, dt, burn, seed = 6.0, 0.1, 1.0, 5
    jd, pd = _drifts(system, _graph())
    y0 = _y0(system, np.random.default_rng(4))
    sigma = _sigma(system, len(y0))
    lo, hi = 0.0, RAMP[system]
    control = (lambda t: np.full_like(np.asarray(t, np.float64), 0.7 * hi)) \
        if ramp == "constant" else J._linear_ramp(lo, hi, ramp, total)
    noise = "additive" if system == "SLBP" else "scale_mixture"
    kw = dict(burn_time=burn, burn_control=0.3 * hi, max_segment_steps=mss,
              save_every=save_every, noise=noise)
    ts_j, ys_j, eps_j = J.simulate_sde(jd, y0, sigma, control, total, dt, seed, **kw)
    incs = _jax_sde_increments(seed, int(burn / dt), int(total / dt), mss, len(y0), noise)
    ts_p, ys_p, eps_p = P.simulate_sde(pd, y0, sigma, control, total, dt, seed, device="cpu",
                                       increments=incs, **kw)
    np.testing.assert_array_equal(ts_p, ts_j)
    np.testing.assert_array_equal(eps_p, eps_j)
    assert ts_p.dtype == np.float64 and eps_p.dtype == np.float32
    _held(ys_p, np.asarray(ys_j))


def test_record_contracts_match_jax():
    adj = _graph()
    kw = dict(total_time=5.0, burn_time=0.5, dt=0.1, seed=2)
    for trend, const in (("increase", None), ("decrease", None), ("increase", 1.5)):
        want = J.simulate_slbp(trend=trend, constant_n=const, save_every=2, **kw)
        got = P.simulate_slbp(trend=trend, constant_n=const, save_every=2, device="cpu", **kw)
        assert set(got) == set(want) == {"ys_dynamic", "ts_dynamic", "N_values"}
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got["N_values"], want["N_values"])
        np.testing.assert_array_equal(got["ts_dynamic"], want["ts_dynamic"])
    for system, cfg in FIG1.items():
        want = J.simulate_network_system(system, adj, **cfg, **kw)
        got = P.simulate_network_system(system, adj, device="cpu", **cfg, **kw)
        assert set(got) == set(want) == {"ys_dynamic", "ts_dynamic", "tp_values"}
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got["tp_values"], want["tp_values"])
        assert np.isfinite(got["ys_dynamic"]).all()
    with pytest.raises(ValueError):
        P.simulate_network_system("SIR", adj, device="cpu", **kw)


@pytest.mark.parametrize("fault", ["partial_nan", "excursion"])
def test_divergence_guard_retries(monkeypatch, fault):
    """A record whose per-timestep node mean is NaN part-way or leaves
    (-10, 100) once is retried, as in tests/test_sde.py."""
    adj, T = _graph(6), 100
    calls = {"n": 0}
    real = P.simulate_sde

    def faulty(*args, **kwargs):
        calls["n"] += 1
        ts, ys, eps = real(*args, **kwargs)
        if calls["n"] == 1:
            ys = np.asarray(ys).copy()
            if fault == "partial_nan":
                ys[T // 2:] = np.nan
            else:
                ys[T // 3] = 500.0
        return ts, ys, eps

    monkeypatch.setattr(P, "simulate_sde", faulty)
    rec = P.simulate_network_system("SIS", adj, total_time=10.0, burn_time=1.0, dt=0.1, seed=3,
                                    control_range=(1e-4, 0.3), device="cpu")
    assert calls["n"] == 2
    assert np.isfinite(rec["ys_dynamic"]).all()
    again = real(P.SystemDrift("SIS", adj), P.philox_uniform(3001, 6), 0.05,
                 J._linear_ramp(1e-4, 0.3, "increase", 10.0), 10.0, 0.1, 3001, burn_time=1.0,
                 burn_control=1e-4, noise="scale_mixture", device="cpu")[1]
    np.testing.assert_array_equal(rec["ys_dynamic"], again)  # attempt 1 keys seed * 1000 + 1

    monkeypatch.setattr(P, "simulate_sde", lambda *a, **k: (np.zeros(3), np.full((3, 6), 1e3),
                                                            np.zeros(3, np.float32)))
    with pytest.raises(RuntimeError, match="diverged after 2 retries"):
        P.simulate_network_system("SIS", adj, max_retries=2, device="cpu")


def test_determinism():
    kw = dict(total_time=10.0, burn_time=1.0, dt=0.1, device="cpu")
    a = P.simulate_slbp(seed=7, **kw)
    b = P.simulate_slbp(seed=7, **kw)
    c = P.simulate_slbp(seed=8, **kw)
    np.testing.assert_array_equal(a["ys_dynamic"], b["ys_dynamic"])
    assert not np.array_equal(a["ys_dynamic"], c["ys_dynamic"])
    adj = _graph()
    a = P.simulate_network_system("neuronal", adj, seed=1, **FIG1["neuronal"], **kw)
    b = P.simulate_network_system("neuronal", adj, seed=1, **FIG1["neuronal"], **kw)
    np.testing.assert_array_equal(a["ys_dynamic"], b["ys_dynamic"])


@pytest.mark.parametrize("noise", ["additive", "scale_mixture"])
def test_stream_does_not_depend_on_segmentation(noise):
    """A trajectory is the same whatever ``max_segment_steps`` cuts it into,
    and one twin call equals three calls that carry the global step."""
    pd = P.SystemDrift("SLBP") if noise == "additive" else P.SystemDrift("SIS", _graph(), d=0.5)
    D = 2 if noise == "additive" else N
    y0 = P.philox_uniform(4, D)
    ramp = J._linear_ramp(0.0, RAMP[pd.system], "increase", 12.0)
    runs = [P.simulate_sde(pd, y0, 0.01, ramp, 12.0, 0.1, 4, burn_time=0.5, noise=noise,
                           max_segment_steps=mss, device="cpu")[1] for mss in (1000, 37, 8)]
    assert runs[0].shape == (120, D)
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
    eps = torch.linspace(0.0, 0.5, 90)
    sig = torch.full((D,), 0.02)
    y_one, ys_one = sde_scan(pd, torch.from_numpy(y0), eps, sig, 0.1, 9, STREAM_RUN, 0, 3, noise)
    y, parts = torch.from_numpy(y0), []
    for a, b in ((0, 30), (30, 33), (33, 90)):
        y, ys = sde_scan(pd, y, eps[a:b], sig, 0.1, 9, STREAM_RUN, a, 1, noise)
        parts.append(ys)
    assert torch.equal(y, y_one)
    assert torch.equal(torch.cat(parts)[2::3], ys_one)


def test_philox_increments_are_the_twins_normals():
    """The scale mixture is the product of the cosine and sine halves of the
    pair at counter (node, stream, step, 0); additive feature f is the
    normal of counter (0, stream, step, f // 2)."""
    inc = philox_increments(5, STREAM_RUN, 100, 3, 4, "scale_mixture")
    for s in range(3):
        rows = (STREAM_RUN << 32) + torch.arange(4)
        z = philox_normal_reference(5, rows, 100 + s, 2)
        assert torch.equal(inc[s], z[:, 0] * z[:, 1])
    add = philox_increments(5, STREAM_RUN, 7, 2, 3, "additive")
    assert torch.equal(add[1], philox_normal_reference(5, torch.tensor([STREAM_RUN << 32]), 8, 3)[0])
    assert not torch.equal(philox_increments(5, 1, 7, 2, 3, "additive"), add)  # streams differ


def test_scale_mixture_moments():
    """1e5 draws of z1 z2 (one node, 1e5 steps): E[z1 z2] = 0, E[(z1 z2)^2] = 1
    and kurtosis 9 (E[z^4]^2 = 9), each within five standard errors (the
    variances of z1 z2, (z1 z2)^2 and (z1 z2)^4 are 1, 8 and 105^2 - 81)."""
    n = 100_000
    rows = torch.full((n,), STREAM_RUN << 32)
    z = philox_normal_reference(3, rows, torch.arange(n), 2).double()
    w = z[:, 0] * z[:, 1]
    assert abs(w.mean().item()) <= 5 * (1.0 / n) ** 0.5
    assert abs((w ** 2).mean().item() - 1.0) <= 5 * (8.0 / n) ** 0.5
    assert abs((w ** 4).mean().item() - 9.0) <= 5 * ((105.0 ** 2 - 81.0) / n) ** 0.5
    assert abs(torch.corrcoef(z.T)[0, 1].item()) <= 5 / n ** 0.5  # independent halves
    got = philox_increments(3, STREAM_RUN, 0, n, 1, "scale_mixture")[:, 0]
    assert torch.equal(got, (z[:, 0].float() * z[:, 1].float()))


# the bar of the distributional check: K standard deviations of JAX's own
# five seeds, plus the grid step (transition time) or a float32 rounding of
# the level (the node mean at the end)
K_SPREAD = 4.0


@pytest.mark.parametrize("system", list(FIG1))
def test_fig1_settings_match_jax_in_distribution(system):
    """``simulate_network_system`` at fig1_demo's settings (total 40, burn 20,
    dt 0.1) over five seeds in each package on a BA(12, 2) graph: the mean
    transition time (``locate_transition`` on the node mean) and the mean node
    mean at the end agree within K_SPREAD of JAX's spread. The tracked
    ``demo_fig1/spdata_sde_*`` records ran on a graph the repo does not track
    (``demo_fig1/.gitignore`` drops ``test_graph/``; ``gen_graph`` hands
    networkx no seed), so the same family and m stands in for it."""
    adj, cfg, seeds = _graph(), FIG1[system], range(3, 8)
    kw = dict(total_time=40.0, burn_time=20.0, dt=0.1, **cfg)

    def stats(rec):
        ys = np.asarray(rec["ys_dynamic"], float)
        ts = np.asarray(rec["ts_dynamic"], float)
        tr = locate_transition(ts, ys.mean(axis=1), system, "increase")
        return tr["transition_time"], ys[-1].mean(), ts[1] - ts[0]

    jax_s = np.array([stats(J.simulate_network_system(system, adj, seed=s, **kw)) for s in seeds])
    port_s = np.array([stats(P.simulate_network_system(system, adj, seed=s, device="cpu", **kw))
                       for s in seeds])
    spread = jax_s.std(axis=0, ddof=1)
    floor = (jax_s[0, 2], 2.0 ** -23 * abs(jax_s[:, 1].mean()))
    for col in (0, 1):
        gap = abs(port_s[:, col].mean() - jax_s[:, col].mean())
        assert gap <= K_SPREAD * spread[col] + floor[col], (col, port_s[:, col], jax_s[:, col])


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_slbp(total_time=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_network_system("SIS", _graph(), total_time=1.0)
