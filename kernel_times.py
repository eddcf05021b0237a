#!/usr/bin/env python3
"""Time each of the port's CUDA kernels alone on one card, against its bound.

    python3 kernel_times.py

K1 and K3 at the sweeps' own row counts (4.8 M rows of the NsDiff bench
geometry, 3.6 M of the TMDM one), K2 over the same 4.8 M rows for 20 steps,
each in both matmul types and K1's and K2's bf16-activation arms; K4 on the
default SLBP corpus's 10^4-step burn-in launch, a 10^6-step segment and 10^5
steps of SIS on the tracked 100-node graph; the NsDiff chain's posterior
update at 4.8 M rows, a step and the final one; the de-stationary attention
at the NsDiff sweep's three calls (B 480, H 8, E 64: the encoder's (L, S) =
(100, 100) with tau and delta, the decoder's causal (150, 150) with tau, its
cross (150, 100) with both), at the TMDM sweep's (B 240, H 4, E 16) and at
longer windows and other head widths (``ATTN_CALLS``), each in the layout
AttentionLayer makes, and at the sweeps' calls the same attention as one
``scaled_dot_product_attention`` call (``library_ms``, with its largest
difference from the twin, ``library_err``). Prints the card's name and
power limit, then one JSON line a kernel and arm: the median of 10 calls
between CUDA events after 2 of warm-up, the plain twin's median (3 calls, 1
for K4's Python step loop; null where a call takes minutes), and the bound
with what bounds it (``ops/kernels/roofline.py`` at the card's highest SM
clock). It checks nothing: the ``card`` tests hold each kernel to its twin.

Imports nothing of JAX or of the JAX package.
"""
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from upgdm_tpu_torch.data import sde  # noqa: E402
from upgdm_tpu_torch.models.denoise import NsDiffDenoiser, TMDMDenoiser  # noqa: E402
from upgdm_tpu_torch.ops.graph import graphml_to_adjacency  # noqa: E402
from upgdm_tpu_torch.ops.kernels import roofline  # noqa: E402
from upgdm_tpu_torch.ops.kernels.chain_resident import (  # noqa: E402
    chain_operands, fused_chain_rows, fused_chain_rows_reference, schedule_table,
)
from upgdm_tpu_torch.ops.kernels.ds_attention import (  # noqa: E402
    ds_attention, ds_attention_reference, kernel_unfit,
)
from upgdm_tpu_torch.ops.kernels.fused_denoiser import (  # noqa: E402
    denoiser_gammas, denoiser_weights, fused_denoiser_rows, fused_denoiser_rows_reference,
    step_weights,
)
from upgdm_tpu_torch.ops.kernels.fused_tmdm import (  # noqa: E402
    fused_tmdm_rows, fused_tmdm_rows_reference, tmdm_gammas, tmdm_weights,
)
from upgdm_tpu_torch.ops.kernels.nsdiff_chain_update import (  # noqa: E402
    chain_table, chain_update_bytes, nsdiff_chain_update, nsdiff_chain_update_reference,
)
from upgdm_tpu_torch.ops.kernels.sde_scan import STREAM_RUN, sde_scan, sde_scan_reference  # noqa: E402
from upgdm_tpu_torch.ops.schedules import NsDiffSchedule  # noqa: E402

M_K1 = 100 * 16 * 30 * 100  # n_z x chunk x nodes x pred_len: 4.8 M rows a K1 call
M_K3 = 100 * 8 * 30 * 150  # n_z x chunk x nodes x (label + pred_len): 3.6 M rows a K3 call
STEPS = 20
# the de-stationary attention's calls, (B, H, E, name, L, S, causal, delta):
# the NsDiff sweep's (d_model 512, 8 heads) and the TMDM sweep's (d_model 64,
# 4 heads), then past them: the SLBP grid's W/P 200/200 at E 64, the paper
# models' E 8 (d_model 16, 2 heads) at W/P 200/200 and 500/200, and W/P
# 200/1000's 1,100 keys (K and V read from device memory)
ATTN_CALLS = tuple((B, H, E, *call) for B, H, E in ((480, 8, 64), (240, 4, 16))
                   for call in (("encoder", 100, 100, False, True),
                                ("decoder_self", 150, 150, True, False),
                                ("cross", 150, 100, False, True))) + (
    (480, 8, 64, "w200_encoder", 200, 200, False, True),
    (480, 8, 64, "w200_decoder_self", 300, 300, True, False),
    (480, 8, 64, "w200_cross", 300, 200, False, True),
    (480, 2, 8, "w200_decoder_self", 300, 300, True, False),
    (480, 2, 8, "w500_encoder", 500, 500, False, True),
    (60, 8, 64, "p1000_decoder_self", 1100, 1100, True, False))
GRAPH_100 = Path(__file__).resolve().parent / "dataset/train_dataset_graph/barabasi_albert_100_0.graphml"


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of fn() over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_attention(q, k, v, tau, delta, causal):
    """The attention as one library call: ``scaled_dot_product_attention``
    on its memory-efficient backend in float32, q times tau, the scaled delta
    and the causal fill as an additive mask, q, k and v as transposed views;
    out as [B, L, H E]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, L, H, E = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(E)
    mask = torch.zeros(B, 1, L, S, device=q.device)
    if delta is not None:
        mask = mask + scale * delta[:, None, None, :]
    if causal:
        keep = torch.ones(L, S, dtype=torch.bool, device=q.device).tril()
        mask = mask.masked_fill(~keep, float("-inf"))
    if tau is not None:
        q = q * tau[:, :, None, None]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), attn_mask=mask.expand(B, H, L, S),
                                             scale=scale)
    return out.transpose(1, 2).reshape(B, L, H * E)


def nvidia_smi(fields, fmt="csv,noheader"):
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    print(card, flush=True)

    def line(kernel, arm, rows, fn, twin, work, mm, twin_reps=3, library=None):
        ms, by = roofline.bound_ms(*work, mm, clock_hz)
        print(json.dumps({
            "kernel": kernel, "arm": arm, "rows": rows, "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(twin, reps=twin_reps, warmup=min(1, twin_reps - 1))
            if twin else None, "bound_ms": ms, "bound_by": by,
            **({"library_ms": cuda_ms(library[0]), "library_err": library[1]} if library else {}),
            "card": card}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(1)
    torch.manual_seed(0)
    with torch.no_grad():
        # K1 and its bf16-activation arm
        den = NsDiffDenoiser(1, STEPS).to(dev).eval()
        W, g = denoiser_weights(den), denoiser_gammas(den, 7)
        x = torch.cat([torch.randn(M_K1, 2, generator=gen, device=dev),
                       torch.rand(M_K1, 1, generator=gen, device=dev) * 0.95 + 0.05], dim=1)
        for mm in ("bfloat16", "float32"):
            kw = step_weights(W, getattr(torch, mm))
            line("K1", mm, M_K1, lambda: fused_denoiser_rows(x, g, kw, matmul_dtype=mm),
                 lambda: fused_denoiser_rows_reference(x, g, W, matmul_dtype=mm),
                 roofline.k1_work(M_K1), mm)
        act = dict(matmul_dtype="bfloat16", act_dtype="bfloat16")
        kw = step_weights(W, torch.bfloat16)
        line("K1", "act_bfloat16", M_K1, lambda: fused_denoiser_rows(x, g, kw, **act),
             lambda: fused_denoiser_rows_reference(x, g, W, **act), roofline.k1_work(M_K1),
             "bfloat16")
        del x

        # K2 and its bf16-activation arm, 20 steps
        sched = NsDiffSchedule.create("linear", STEPS, 1e-4, 2e-2)
        tab = torch.as_tensor(schedule_table(sched), device=dev)
        tables = tuple(e.detach() for e in (den.lin1.embed, den.lin2.embed, den.lin3.embed))
        y0 = torch.randn(M_K1, 1, generator=gen, device=dev) * 0.3 + 1.0
        gx = torch.rand(M_K1, 1, generator=gen, device=dev) * 0.5 + 0.05
        tgen = torch.Generator(device=dev).manual_seed(5)
        for act in ("float32", "bfloat16"):
            for mm in ("bfloat16", "float32"):
                ops = chain_operands(tables, W, getattr(torch, mm),
                                     *(("bfloat16",) if act == "bfloat16" else ()))
                kwa = dict(matmul_dtype=mm, act_dtype=act)
                line("K2", mm if act == "float32" else f"act_bfloat16_{mm}", M_K1,
                     lambda: fused_chain_rows(y0, gx, tab, 5, *ops, STEPS, **kwa),
                     lambda: fused_chain_rows_reference(y0, gx, tab, tables, W, STEPS,
                                                        generator=tgen, **kwa),
                     roofline.k2_work(M_K1, STEPS), mm)

        # the posterior update, a step and the final one
        ops = [torch.randn(M_K1, 1, generator=gen, device=dev) for _ in range(6)]
        ops[2], ops[4] = ops[2].abs() + 0.05, ops[4].abs() + 0.05  # gx, sigma > 0
        table = chain_table(sched, dev)
        for arm, z, t in (("step", ops[5], 7), ("final", None, 0)):
            line("update", arm, M_K1,
                 lambda: nsdiff_chain_update(*ops[:5], z, table[t], False),
                 lambda: nsdiff_chain_update_reference(*ops[:5], z, table[t], False),
                 (0.0, chain_update_bytes(M_K1, arm == "final"), 0.0), "float32")
        del y0, gx, ops

        # the de-stationary attention at the sweeps' calls and past them, and
        # the one-library-call design beside it
        for B, H, E, name, L, S, causal, has_delta in ATTN_CALLS:
            q = torch.randn(B, L, H * E, generator=gen, device=dev).view(B, L, H, E)
            k, v = (torch.randn(B, S, H * E, generator=gen, device=dev).view(B, S, H, E)
                    for _ in range(2))
            tau = torch.rand(B, 1, generator=gen, device=dev) + 0.5
            delta = torch.randn(B, S, generator=gen, device=dev) if has_delta else None
            assert kernel_unfit(q, k, v, tau, delta) is None
            library = None
            if (B, H, E) in ((480, 8, 64), (240, 4, 16)):
                want = ds_attention_reference(q, k, v, tau, delta, causal).reshape(B, L, H * E)
                err = (library_attention(q, k, v, tau, delta, causal) - want).abs().max().item()
                library = (lambda: library_attention(q, k, v, tau, delta, causal), err)
                del want
            line("ds_attention", f"E{E}_{name}", B * H * L,
                 lambda: ds_attention(q, k, v, tau, delta, causal).reshape(B, L, H * E),
                 lambda: ds_attention_reference(q, k, v, tau, delta, causal),
                 roofline.ds_attention_work(B, H, L, S, E, causal, True, has_delta),
                 "float32", twin_reps=10, library=library)
            del q, k, v

        # K3
        tden = TMDMDenoiser(1, 101).to(dev).eval()
        Wt, gt = tmdm_weights(tden), tmdm_gammas(tden, 50)
        x = torch.randn(M_K3, 2, generator=gen, device=dev)
        for mm in ("bfloat16", "float32"):
            kw = step_weights(Wt, getattr(torch, mm))
            line("K3", mm, M_K3, lambda: fused_tmdm_rows(x, gt, kw, matmul_dtype=mm),
                 lambda: fused_tmdm_rows_reference(x, gt, Wt, matmul_dtype=mm),
                 roofline.k3_work(M_K3), mm)
        del x

    # K4: the SLBP burn-in launch, a segment of the default corpus, SIS at N 100
    def k4_args(drift, N, steps, noise, sig, lo, hi):
        return (drift.to(dev), torch.rand(N, device=dev) * 0.8 + 0.2,
                torch.linspace(lo, hi, steps, device=dev), torch.full((N,), sig, device=dev),
                0.1, 1, STREAM_RUN, 0, 1, noise)

    slbp = sde.SystemDrift("SLBP")
    sis = sde.SystemDrift("SIS", graphml_to_adjacency(GRAPH_100).adj, d=0.1)
    for arm, args, work, twin in (
            ("SLBP_1e4_steps", k4_args(slbp, 2, 10_000, "additive", 1e-3, 0.0, 2.6),
             roofline.k4_work(10_000, 2), True),
            ("SLBP_1e6_steps", k4_args(slbp, 2, 1_000_000, "additive", 1e-3, 0.0, 2.6),
             roofline.k4_work(1_000_000, 2), False),
            ("SIS_N100_1e5_steps", k4_args(sis, 100, 100_000, "scale_mixture", 1e-4, 0.1, 0.2),
             roofline.k4_work(100_000, 100, 1, "SIS", "scale_mixture"), False)):
        line("K4", arm, None, lambda: sde_scan(*args),
             (lambda: sde_scan_reference(*args)) if twin else None, work, "float32", twin_reps=1)


if __name__ == "__main__":
    main()
