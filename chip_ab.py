#!/usr/bin/env python3
"""Time the port's default sampling sweeps of two checkouts in turns on one card.

    python3 chip_ab.py <checkout_a> <checkout_b> [--order ABBABAAB] [--reps 5]

Each checkout is a directory that holds ``upgdm_tpu_torch/`` and
``chip_smoke.py`` (for instance the parent commit and the change, each
unpacked with ``git archive``). For every letter of ``--order`` a fresh
process builds that checkout's kernels (into its own ``build/kernels/``, once)
and times ``--reps`` sweeps of ``fast_mpv_sweep`` at ``chip_smoke.py``'s
geometries: NsDiff over 64 bench windows (phase 6) and TMDM over 16
model-comparison windows (phase 8), after a warm-up sweep of each. It prints
the card's name and power limit, one JSON line a process, and a last line
with each checkout's median and interquartile range in windows/hr. Runs in
turns on one card are the comparison that the card's power limit and its
neighbours leave fair.

Imports nothing of JAX or of the JAX package.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def one(tree: Path, reps: int) -> dict:
    """The sweeps of one checkout in this process."""
    sys.path.insert(0, str(tree))
    import chip_smoke as C
    from upgdm_tpu_torch import diffusion_models
    from upgdm_tpu_torch.eval.uncertainty import fast_mpv_sweep
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.ops.kernels import _build

    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the checkout {tree}")
    _build.build_library()
    _build.load_library()
    out = {"checkout": str(tree)}
    for name, build, n, chunk in (
            ("nsdiff", lambda: NsDiffModel(C.NET_PARAM, seed=0, device="cuda"), C.N_WINDOWS,
             C.CHUNK),
            ("tmdm", lambda: diffusion_models("TMDM", C.TMDM_PARAM, seed=0, device="cuda"),
             C.T_WINDOWS, C.T_CHUNK)):
        model = build()
        fast_mpv_sweep(model, C.make_windows(chunk), C.PRED_LEN, chunk_windows=chunk)
        wins = C.make_windows(n)
        out[name] = [n / C.host_s(lambda: fast_mpv_sweep(model, wins, C.PRED_LEN,
                                                         chunk_windows=chunk))[0] * 3600.0
                     for _ in range(reps)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", type=Path)
    ap.add_argument("--order", default="ABBABAAB")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.reps)), flush=True)
        return
    if len(args.checkouts) != 2 or set(args.order) - {"A", "B"}:
        ap.error("give two checkouts and an --order of A and B")
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = {"A": [], "B": []}
    for letter in args.order:
        tree = args.checkouts["AB".index(letter)].resolve()
        res = subprocess.run([sys.executable, __file__, "--one", str(tree), "--reps",
                              str(args.reps)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            sys.exit(1)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": letter, **line}), flush=True)
        runs[letter].append(line)

    def summary(lines, key):
        v = sorted(x for line in lines for x in line[key])
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2], "n": len(v)}

    print(json.dumps({letter: {"checkout": str(args.checkouts["AB".index(letter)]),
                               **{k: summary(runs[letter], k) for k in ("nsdiff", "tmdm")}}
                      for letter in "AB"}), flush=True)


if __name__ == "__main__":
    main()
