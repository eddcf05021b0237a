"""Closed-loop training through the program's
``train.loop.make_train_step``: one step after another on batches of
``batch`` windows drawn without replacement from a seeded corpus resident on
the device (a fresh permutation each pass), each step ending in the loop's
own ``.item()``.

Set-up builds the model, the optimizer and the step once, from weights made
on the device from ``--seed``, and drives them through their first
``warmup_steps`` steps with the window's own call; the benchmark owns the
model's generator (dropout masks, timesteps, noise), seeded from ``--seed``.
From the first three steps it keeps each loss, the first gradient as the
optimizer got it (Adam's first moment after one step over 1 - beta1) and
the weights after the third; once the window has closed the reference
follows the same three steps from the same weights, batches and draws, and
the three are compared leaf by leaf.

The measured window times each iteration, the batch's draw and the step, on
the card's clock. The traced run first times ``trace_steps`` untraced steps
together on the host's clock (the step time that the per-layer metrics
divide by, since the profiler slows the host's dispatch), then profiles as
many more.
"""
from __future__ import annotations

import statistics
import time

import numpy as np

from .. import faults, precision, traffic_gen
from ..reference import family
from ..seeds import derive, rng
from ..weights import host_copy, make_weights

SPANS = ("train.step", "train.forward", "train.optimizer")
CHECKED_STEPS = 3
# leaves whose reference gradient is below this share of the median leaf's are
# rounding alone (a key's bias under the softmax): left out of the change
ZERO_GRAD_SHARE = 1e-3


def _flax_name(torch_name: str) -> str:
    parent, _, leaf = torch_name.rpartition(".")
    if leaf != "weight":
        return torch_name
    return parent + (".scale" if parent.rpartition(".")[2].startswith("LayerNorm") else ".kernel")


class _Batches:
    """Batches of distinct corpus rows, a fresh seeded permutation each pass."""

    def __init__(self, corpus, batch, seed):
        self.corpus, self.batch = corpus, batch
        self.g = rng(seed, "batches")
        self.order, self.at = None, 0

    def __call__(self):
        import torch

        n = self.corpus.shape[0]
        if self.order is None or self.at + self.batch > n:
            self.order = torch.as_tensor(self.g.permutation(n), device=self.corpus.device)
            self.at = 0
        idx = self.order[self.at:self.at + self.batch]
        self.at += self.batch
        return self.corpus.index_select(0, idx)


class _StepClock:
    """Per-iteration times: CUDA events on the card, the host clock elsewhere.
    Each step ends in ``.item()``, which empties the stream, so the events
    fall when the host records them and a stall in the batch's draw or in
    the step counts in full."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.marks = []
        self.torch = torch

    def time(self, fn):
        if self.cuda:
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            self.marks.append((a, b))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.marks.append(time.perf_counter() - t0)
        return out

    def ms(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [s * 1e3 for s in self.marks]


def _span(name, fn):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def run(r):
    import torch
    from upgdm_tpu_torch.models.factory import diffusion_models
    from upgdm_tpu_torch.train.loop import make_train_step
    from upgdm_tpu_torch.train.optimizers import make_optimizer

    r.mark("imports")
    cfg, trf = r.cell.config, r.cell.traffic
    net = dict(cfg["net"])
    ref = family(cfg["reference"])
    dev = torch.device(r.device)
    select = trf["select"]
    weights = make_weights(ref.param_spec(net), r.seed, dev)
    r.mark("weights")
    model = diffusion_models(net["task_model"], net, seed=0, device=dev, train_model_select=select)
    r.mark("model")
    model.load_state_dict(host_copy(weights))
    r.mark("load")
    model.generator.manual_seed(derive(r.seed, "train_draws"))
    opt = make_optimizer(trf["optimizer"], model.net, model.trainable_mask(select))
    step = make_train_step(model, opt, select)
    corpus = torch.as_tensor(traffic_gen.corpus(trf, net, r.seed), device=dev)
    next_batch = _Batches(corpus, trf["batch"], r.seed)
    r.mark("inputs")
    names = {p: _flax_name(n) for n, p in model.net.named_parameters() if p.requires_grad}
    beta1 = opt.param_groups[0]["betas"][0]

    checked, losses, grad1, after = [], [], {}, {}
    before = {names[p]: p.detach().clone() for p in names}  # the program's own layout
    with faults.train_fault(r.fault, model, opt):
        for k in range(trf["warmup_steps"]):
            b = next_batch()
            loss = step(b)
            if k < CHECKED_STEPS:
                checked.append(b)
                losses.append(loss)
            if k == 0:
                grad1 = {names[p]: (opt.state[p]["exp_avg"] / (1 - beta1)).clone()
                         for p in names if p in opt.state}
            if k == CHECKED_STEPS - 1:
                after = {names[p]: p.detach().clone() for p in names}
        r.setup_done()
        window_losses = []
        if r.traced:
            t0 = time.perf_counter()
            for _ in range(trf["trace_steps"]):
                window_losses.append(step(next_batch()))
            step_s = (time.perf_counter() - t0) / trf["trace_steps"]
            model.__dict__["loss_fn"] = _span("train.forward", model.loss_fn)
            opt.__dict__["step"] = _span("train.optimizer", opt.step)
            one = _span("train.step", step)
            try:
                r.trace_run(lambda: [window_losses.append(one(next_batch()))
                                     for _ in range(trf["trace_steps"])], SPANS)
            finally:
                del model.__dict__["loss_fn"], opt.__dict__["step"]
        else:
            clock = _StepClock(dev)
            t0 = time.perf_counter()
            while True:
                window_losses.append(clock.time(lambda: step(next_batch())))
                if time.perf_counter() - t0 >= r.seconds:
                    break
            elapsed = time.perf_counter() - t0
    r.read_memory()
    n = len(window_losses)
    failed = int(sum(not np.isfinite(v) for v in window_losses))
    e2e = {}
    if not r.traced:
        per = clock.ms()
        e2e = {"train_step_ms": elapsed / n * 1e3,
               "train_step_ms_p95": statistics.quantiles(per, n=20)[18] if n > 1 else per[0]}
    info = {"batch": trf["batch"]}
    if r.traced:
        info.update(steps=trf["trace_steps"], step_s=step_s)
    program = {"losses": losses, "grad1": grad1,
               "delta": {k: v - before[k] for k, v in after.items()}}
    del model, opt, step, corpus
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings = _check(r, ref, net, trf, weights, checked, program)
    return dict(attempted=n, failed=failed, e2e=e2e, checks=checks, readings=readings,
                info=info)


def _reference_steps(r, ref, net, trf, weights, batches, tf32_on, dtype=None):
    """The reference's losses, first gradients (as Adam gets them, and raw)
    and weights after the checked steps, by hand-written Adam with L2 decay;
    ``dtype`` float64 makes the witness of the float32 runs."""
    import torch

    opt = trf["optimizer"]
    lr, wd = float(opt["lr"]), float(opt.get("weight_decay", 0.0))
    b1, b2, eps = 0.9, 0.999, 1e-8
    dev = torch.device(r.device)
    dtype = dtype or torch.float32
    P = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    gen = torch.Generator(device=dev).manual_seed(derive(r.seed, "train_draws"))
    keys = list(P)
    losses, grad1, raw1 = [], {}, {}
    with precision.tf32(tf32_on):
        for k, batch in enumerate(batches, start=1):
            loss = ref.train_loss(P, net, batch.to(dtype), gen, float(net.get("dropout", 0.0)))
            grads = torch.autograd.grad(loss, [P[n] for n in keys])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for n, g in zip(keys, grads):
                    p = P[n]
                    full = g + wd * p
                    if k == 1:
                        grad1[n], raw1[n] = full.clone(), g.clone()
                    m[n].mul_(b1).add_(full, alpha=1 - b1)
                    v2[n].mul_(b2).addcmul_(full, full, value=1 - b2)
                    denom = (v2[n] / (1 - b2 ** k)).sqrt() + eps
                    p.sub_(lr * (m[n] / (1 - b1 ** k)) / denom)
    delta = {n: P[n].detach() - weights[n].to(dtype) for n in keys}
    return {"losses": losses, "grad1": grad1, "raw1": raw1, "delta": delta}


def _leaf_gaps(prog, refv, keep=None):
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the leaf's
    reference norm and the median leaf's (infinite for a missing leaf)."""
    keys = [k for k in refv if keep is None or k in keep]
    rn = {k: float(refv[k].norm()) for k in keys}
    med = statistics.median(rn.values())
    out = {}
    for k in keys:
        g = abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30) if k in prog else np.inf
        out[k] = float(g) if np.isfinite(g) else float("inf")
    return out


def _gaps(run, base, keep):
    """The three numbers of ``run`` (the program's or a reference's steps)
    against ``base``, with the worst leaves and the first step's loss gap."""
    rel = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
           for a, b in zip(run["losses"], base["losses"])]
    grad = _leaf_gaps(run["grad1"], base["grad1"])
    upd = _leaf_gaps(run["delta"], base["delta"], keep)
    worst = lambda d: max(d, key=d.get)
    return {"loss_gap": max(rel), "grad_gap": grad[worst(grad)], "update_gap": upd[worst(upd)]}, \
        {"loss1_gap": rel[0], "grad_leaf": worst(grad), "update_leaf": worst(upd)}


def _check(r, ref, net, trf, weights, batches, program):
    import torch

    base = _reference_steps(r, ref, net, trf, weights, batches, False)
    med = statistics.median(float(g.norm()) for g in base["raw1"].values())
    keep = {k for k, g in base["raw1"].items() if float(g.norm()) >= ZERO_GRAD_SHARE * med}
    checks, where = _gaps(program, base, keep)
    readings = {"leaves_left_out": sorted(set(base["raw1"]) - keep), "program": where,
                "losses": {"program": program["losses"], "reference": base["losses"]}}
    if r.readings:
        ctl = _reference_steps(r, ref, net, trf, weights, batches, True)
        readings["control"], readings["control_where"] = _gaps(ctl, base, keep)
        w64 = _reference_steps(r, ref, net, trf, weights, batches, False, torch.float64)
        readings["losses"]["float64"] = w64["losses"]
        readings["witness64"] = {"program": _gaps(program, w64, keep),
                                 "reference": _gaps(base, w64, keep)}
    return checks, readings
