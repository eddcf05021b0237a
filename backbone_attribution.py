#!/usr/bin/env python3
"""Split the device time of the backbones of ``nsdiff_sweep`` chunks by the
code that launched each kernel, on one card.

    python3 backbone_attribution.py [--chunks 8] [--seed 918273645]

Builds the cell's model with the benchmark's weights and windows
(``bench_cuda``), runs ``f_and_g`` over ``--chunks`` chunks of 16 windows
under ``torch.profiler`` and maps each kernel to the host operations open
when it was launched (the profiler's correlation ids). Prints the backbone's
device ms a chunk, then the ms a chunk of each scope (the attention core,
``DSAttention``; its projections, ``AttentionLayer``; the rest) and one JSON
line a (scope, outermost aten op, innermost aten op, kernel) of 0.05 ms a
chunk or more, with its launches a chunk. Imports nothing of JAX or of the
JAX package.
"""
import argparse
import collections
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_cuda import spec, traffic_gen  # noqa: E402
from bench_cuda.reference import family  # noqa: E402
from bench_cuda.weights import host_copy, make_weights  # noqa: E402
from upgdm_tpu_torch.models import attention  # noqa: E402
from upgdm_tpu_torch.models.factory import diffusion_models  # noqa: E402

CHUNK = 16  # windows a chunk, as the cell samples them


def labelled(cls, label):
    """Run ``cls.forward`` inside a profiler range named ``label``."""
    forward = cls.forward

    def run(self, *args, **kwargs):
        with record_function(label):
            return forward(self, *args, **kwargs)

    cls.forward = run


def model_and_chunks(n_chunks, seed, dev):
    cell = spec.find_cell("nsdiff_sweep")
    net = dict(cell.config["net"])
    pool = traffic_gen.trajectories(cell.traffic, net, seed)
    mean, std = traffic_gen.scaler_of(pool)
    weights = host_copy(make_weights(family(cell.config["reference"]).param_spec(net), seed, dev))
    weights.update(scaler_mean=mean, scaler_std=std)
    model = diffusion_models(net["task_model"], net, seed=0, device=dev)
    model.load_state_dict(weights)
    chunks = []
    for i in range(n_chunks):
        w = pool[i % len(pool)][CHUNK * (i % 4):CHUNK * (i % 4 + 1)]  # [16, nodes, T, F]
        x = w.reshape(-1, *w.shape[2:])[:, :net["windows"], :]
        chunks.append(torch.as_tensor(((x - mean) / std).astype("float32"), device=dev))
    return model, chunks


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--seed", type=int, default=918273645)
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("backbone_attribution: no CUDA device")
    labelled(attention.DSAttention, "attn.core")
    labelled(attention.AttentionLayer, "attn.layer")
    model, chunks = model_and_chunks(a.chunks, a.seed, torch.device("cuda"))
    with torch.no_grad():
        for x in chunks[:2]:
            model.f_and_g(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in chunks:
                with record_function("chunk.backbone"):
                    model.f_and_g(x)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    events = json.loads(Path(path).read_text())["traceEvents"]
    os.unlink(path)

    host, launch, kernels = collections.defaultdict(list), {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e["ts"])
        if cat in ("cpu_op", "user_annotation"):
            host[e["tid"]].append((ts, ts + float(e.get("dur", 0)), e["name"], cat))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], ts)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append((e["name"], float(e.get("dur", 0)), e.get("args", {}).get("correlation")))

    table, launches, scopes, total = (collections.defaultdict(float), collections.Counter(),
                                      collections.defaultdict(float), 0.0)
    for name, dur, corr in kernels:
        if corr not in launch:
            continue
        tid, ts = launch[corr]
        stack = sorted((h for h in host[tid] if h[0] <= ts <= h[1]), key=lambda h: (h[0], -h[1]))
        labels = [h[2] for h in stack if h[3] == "user_annotation"]
        if "chunk.backbone" not in labels:
            continue
        scope = ("attn.core" if "attn.core" in labels
                 else "attn.proj" if "attn.layer" in labels else "other")
        inner = max(i for i, h in enumerate(stack) if h[3] == "user_annotation")
        ops = [h[2] for h in stack[inner + 1:] if h[3] == "cpu_op"] or ["?"]
        key = (scope, ops[0], ops[-1], name[:60])
        table[key] += dur
        launches[key] += 1
        scopes[scope] += dur
        total += dur
    n = len(chunks)
    print(f"backbone device ms/chunk {total / 1e3 / n:.3f}")
    for scope, us in sorted(scopes.items(), key=lambda kv: -kv[1]):
        print(f"SCOPE {scope}: {us / 1e3 / n:.3f} ms/chunk")
    for key, us in sorted(table.items(), key=lambda kv: -kv[1]):
        if us / 1e3 / n >= 0.05:
            print(json.dumps({"scope": key[0], "op": key[1], "leaf": key[2], "kernel": key[3],
                              "ms_per_chunk": round(us / 1e3 / n, 3),
                              "launches_per_chunk": launches[key] / n}))


if __name__ == "__main__":
    main()
