"""Closed-loop MPV sweeps through the program's
``eval.uncertainty.fast_mpv_sweep``: each call takes one trajectory of the
seeded pool (``[windows, nodes, W, F]``, cycled) in chunks of
``chunk_windows`` and returns each window's mean predictive variance and
mean; the next call starts when the last one has returned.

The benchmark owns the model's generator and seeds it before every call from
``--seed`` and the call's index, so the reference can draw the same standard
normals again: the chain draws T of them a chunk, each shaped
``[samples, chunk x nodes, horizon, F]``, chunk after chunk. Once the window
has closed the reference recomputes a seeded sample of the windows answered
in it, from the same inputs and weights, and each answer is held to it. The
reference's denoiser products are in the precision the configuration states
(bfloat16 operands, float32 sums), the rest in float32 (``precision.py``).
"""
from __future__ import annotations

import collections
import time

import numpy as np

from .. import faults, precision, traffic_gen
from ..reference import family
from ..seeds import derive, rng
from ..weights import host_copy, make_weights

SPANS = ("sweep.call", "sweep.dispatch", "sweep.drain", "sweep.backbone", "sweep.chain",
         "sweep.reduce")


def _span(name, fn):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def _spanned_buffering(orig):
    def double_buffered(dispatch, drain, chunks):
        return orig(_span("sweep.dispatch", dispatch), _span("sweep.drain", drain), chunks)
    return double_buffered


def run(r):
    import torch
    from upgdm_tpu_torch.eval import uncertainty as U
    from upgdm_tpu_torch.models.factory import diffusion_models

    r.mark("imports")
    cfg, trf = r.cell.config, r.cell.traffic
    net = dict(cfg["net"])
    ref = family(cfg["reference"])
    dev = torch.device(r.device)
    pool = traffic_gen.trajectories(trf, net, r.seed)
    mean, std = traffic_gen.scaler_of(pool)
    r.mark("inputs")
    weights = make_weights(ref.param_spec(net), r.seed, dev)
    r.mark("weights")
    model = diffusion_models(net["task_model"], net, seed=0, device=dev)
    r.mark("model")
    flat = host_copy(weights)
    flat.update(scaler_mean=mean, scaler_std=std)
    model.load_state_dict(flat)
    r.mark("load")
    chunk, pred = trf["chunk_windows"], net["pred_len"]

    def call(i):
        model.generator.manual_seed(derive(r.seed, "call", i))
        return U.fast_mpv_sweep(model, pool[i % len(pool)], pred, chunk, device=dev)

    for i in range(trf["warmup_calls"]):
        call(-1 - i)
    results = []
    info = {"series_per_chunk": chunk * trf["nodes"], "samples": net["n_z_samples"],
            "chain_rows": net["n_z_samples"] * chunk * trf["nodes"] * ref.horizon(net)}
    with faults.sweep_fault(r.fault, U, call) as timed:
        r.setup_done()
        if r.traced:
            method = cfg["backbone_method"]
            saved = {n: getattr(model, n) for n in (method, "sample_chain")}
            model.__dict__[method] = _span("sweep.backbone", saved[method])
            model.__dict__["sample_chain"] = _span("sweep.chain", saved["sample_chain"])
            reduce0, buffering0 = U.mpv_reduce, U._double_buffered
            U.mpv_reduce = _span("sweep.reduce", reduce0)
            U._double_buffered = _spanned_buffering(buffering0)
            traced_call = _span("sweep.call", timed)
            try:
                r.trace_run(lambda: [results.append((i,) + traced_call(i))
                                     for i in range(trf["trace_calls"])], SPANS)
            finally:
                U.mpv_reduce, U._double_buffered = reduce0, buffering0
                for n in saved:
                    del model.__dict__[n]
            info["chunks"] = r.trace.span_count("sweep.chain")
        else:
            t0 = time.perf_counter()
            i = 0
            while True:
                results.append((i,) + timed(i))
                i += 1
                if time.perf_counter() - t0 >= r.seconds:
                    break
            elapsed = time.perf_counter() - t0
    r.read_memory()
    n_windows = sum(len(m) for _, m, _ in results)
    failed = int(sum((~np.isfinite(m)).sum() for _, m, _ in results))
    del model, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings = _check(r, ref, net, trf, pool, weights, (mean, std), results)
    e2e = {} if r.traced else {"windows_per_hr": n_windows / elapsed * 3600.0}
    return dict(attempted=n_windows, failed=failed, e2e=e2e, checks=checks,
                readings=readings, info=info)


def _replay(r, ref, net, trf, call_index, chunk_index, dev):
    """The T normals the chain drew for chunk ``chunk_index`` of a call."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(derive(r.seed, "call", call_index))
    shape = (net["n_z_samples"], trf["chunk_windows"] * trf["nodes"], ref.horizon(net),
             net["dataset_nf"])
    T = ref.draws_per_chunk(net)
    for _ in range(chunk_index * T):
        torch.randn(shape, generator=gen, device=dev)
    return [torch.randn(shape, generator=gen, device=dev) for _ in range(T)]


def _window_stats(ref, weights, net, x, noise, n, scaler, mm, tf32_on):
    """(MPV [n], mean [n]) of n windows' series x, float64 on the host."""
    import torch

    mean, std = scaler
    with torch.no_grad(), precision.tf32(tf32_on):
        s = ref.samples(weights, x, net, noise, mm) * std + mean  # [S, n*node, pred, F]
    per = lambda v: v.reshape(n, -1).mean(dim=1).double().cpu().numpy()
    return per(s.var(dim=0, unbiased=False)), per(s.mean(dim=0))


def _fold(into, mv, mn, mv_r, mn_r):
    """Fold the worst gaps of answers (mv, mn) to the reference's into ``into``;
    a gap that is not a number counts as infinite."""
    g_mpv = np.abs(np.asarray(mv, np.float64) - mv_r) / mv_r
    g_mean = np.abs(np.asarray(mn, np.float64) - mn_r) / np.sqrt(mv_r)
    for key, g in (("mpv_gap", g_mpv), ("mean_gap", g_mean)):
        g = np.where(np.isfinite(g), g, np.inf)
        into[key] = max(into[key], float(g.max()))


def _check(r, ref, net, trf, pool, weights, scaler, results):
    """Each sampled answer against the reference: the worst relative gap of
    the MPV and the worst gap of the mean in units of the ensemble's spread."""
    import torch

    dev = torch.device(r.device)
    nodes, chunk = trf["nodes"], trf["chunk_windows"]
    pairs = [(ci, w) for ci, (_, m, _) in enumerate(results) for w in range(len(m))]
    k = min(trf["check_windows"], len(pairs))
    picked = [pairs[j] for j in sorted(rng(r.seed, "check").choice(len(pairs), k, replace=False))]
    groups = collections.defaultdict(list)
    for ci, w in picked:
        groups[(ci, w // chunk)].append(w)
    mean = torch.as_tensor(scaler[0], device=dev)
    std = torch.as_tensor(scaler[1], device=dev)
    mm_ref = precision.REFERENCE_MM[precision.stated(net)]
    mm_ctl = precision.CONTROL_MM[precision.stated(net)]
    gaps = {"mpv_gap": 0.0, "mean_gap": 0.0}
    ctl = {"mpv_gap": 0.0, "mean_gap": 0.0}
    for (ci, j), ws in groups.items():
        call_index, mpv_p, mean_p = results[ci]
        z = _replay(r, ref, net, trf, call_index, j, dev)
        rows = torch.as_tensor(np.concatenate([np.arange((w - j * chunk) * nodes,
                                                         (w - j * chunk + 1) * nodes) for w in ws]),
                               device=dev)
        noise = [zz.index_select(1, rows) for zz in z]
        del z
        raw = pool[call_index % len(pool)][ws]  # [n, nodes, W, F]
        x = torch.as_tensor(raw.reshape(-1, *raw.shape[2:]), device=dev)
        x = (x - mean) / std
        mv_r, mn_r = _window_stats(ref, weights, net, x, noise, len(ws), (mean, std), mm_ref,
                                   False)
        _fold(gaps, mpv_p[ws], mean_p[ws], mv_r, mn_r)
        if r.readings:
            _fold(ctl, *_window_stats(ref, weights, net, x, noise, len(ws), (mean, std), mm_ctl,
                                      True), mv_r, mn_r)
    readings = {"control": ctl, "windows_checked": k} if r.readings else {"windows_checked": k}
    return gaps, readings


